"""Speech enhancement front-ends (port of speech_recognition_tools_tpu/
enhance): STFT, mask estimation, MVDR / GEV beamforming, WPE
dereverberation, the device chain and the recipes' stage-0 pipeline."""

from speech_recognition_tools_tpu_torch.enhance.beamforming import (
    apply_beamforming_vector,
    blind_analytic_normalization,
    gev_beamform,
    gev_vector,
    mvdr_beamform,
    mvdr_vector,
    pca_vector,
    power_spectral_density_matrix,
)
from speech_recognition_tools_tpu_torch.enhance.mask_model import (
    BLSTMMaskEstimator,
    SimpleFWMaskEstimator,
    mask_estimator_loss,
    train_mask_estimator,
)
from speech_recognition_tools_tpu_torch.enhance.masks import (
    estimate_ibm,
    quantile_mask,
    simple_ideal_soft_mask,
    voiced_unvoiced_split,
)
from speech_recognition_tools_tpu_torch.enhance.onchip import (
    gev_beamform_onchip,
    gev_enhance_chain,
    mvdr_beamform_onchip,
    wpe_onchip,
)
from speech_recognition_tools_tpu_torch.enhance.stft import (
    biorthogonal_synthesis_window,
    istft,
    stft,
)
from speech_recognition_tools_tpu_torch.enhance.wpe import wpe_dereverberate
