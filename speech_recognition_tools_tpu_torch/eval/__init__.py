"""Evaluation (port of speech_recognition_tools_tpu/eval): word error
rates, speech-enhancement metrics, SRMR and the feature-label
information-theoretic analysis."""

from speech_recognition_tools_tpu_torch.eval.enhancement_metrics import (
    cepsdist,
    fwsegsnr,
    lpcllr,
    sdr,
    stoi,
)
from speech_recognition_tools_tpu_torch.eval.info_theory import (
    combine_histograms,
    feats_minmax,
    mark_transitions,
    mutual_information,
    signal_label_histogram,
)
from speech_recognition_tools_tpu_torch.eval.srmr import srmr
