"""MFCC features for a batch of waveforms.

Port of speech_recognition_tools_tpu/dsp/mfcc.py (reference:
featgen/computeMfccFeatures.py extractMelEnergyFeats). The reference's
quirks are kept: the signal is scaled by 2^-15 (unlike the FDLP and mel
paths); the spectrum is the magnitude of a complex FFT of each windowed
frame at n = nfft/2 + 1 points (the frame zero-padded to that length, not
an rfft at nfft); the mel energies' log10; the unnormalised DCT-II, of
which the first `num_ceps` coefficients are kept; optional splicing of
`context` frames per utterance (whose last `context` rows are zero).

Splicing ends each utterance at its own frame count, as the reference
splices one utterance at a time. The JAX package splices the padded batch,
so there the last `context` valid rows of every utterance shorter than
the batch take frames past its end (garbage, NaN in its framing); the port
gives those rows the reference's zeros, and equals the JAX function run on
each utterance alone.
"""

from dataclasses import dataclass

import torch

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.dsp.filterbanks import mel_filterbank
from speech_recognition_tools_tpu_torch.ops.dct import dct2
from speech_recognition_tools_tpu_torch.ops.framing import (
    frame_count,
    frame_params,
    frame_signal,
)
from speech_recognition_tools_tpu_torch.ops.windows import WINDOWS
from speech_recognition_tools_tpu_torch.utils.splice import splice_feats


@dataclass(frozen=True)
class MfccConfig:
    srate: int = 16000
    nfilters: int = 30
    fduration: float = 0.02
    frate: int = 100
    nfft: int = 1024
    context: int | None = None
    window: str = "hamming"
    num_ceps: int = 13


def windowed_frames(signals, num_samples, srate, frate, fduration, window, dtype, device,
                    scale=1.0):
    """(device, windowed frames (B, max_frames, flen), num_frames (B,)) of a
    zero-padded batch scaled by `scale` on the device, shared by the MFCC
    and mel front-ends. On CUDA it switches TF32 off process-wide
    (device.configure_cuda): the JAX package contracts at
    Precision.HIGHEST."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        configure_cuda()
    fp = frame_params(srate, frate, fduration)
    signals = torch.as_tensor(signals).to(device=dev, dtype=dtype)
    if scale != 1.0:
        signals = signals * scale
    num_samples = torch.as_tensor(num_samples).to(device=dev, dtype=torch.int64)
    win = torch.as_tensor(WINDOWS[window](fp.flength_samples)).to(device=dev, dtype=dtype)
    frames, num_frames = frame_signal(signals, num_samples, fp, win,
                                      frame_count(signals.shape[1], fp))
    return dev, frames, num_frames


def mfcc_batch(signals, num_samples, cfg: MfccConfig = MfccConfig(), *,
               dtype: torch.dtype = torch.float32, device="cuda"):
    """MFCCs of a zero-padded batch.

    Args:
      signals: (B, Nmax) int16-scale waveforms, numpy array or tensor.
      num_samples: (B,) true sample counts.
      cfg: configuration.
      dtype: work dtype (float32; float64 for CPU parity checks).
      device: "cuda" (default) or "cpu".

    Returns (feats (B, Fmax, num_ceps * (2 * context + 1)), num_frames (B,));
    rows past an utterance's frame count are garbage.
    """
    dev, frames, num_frames = windowed_frames(signals, num_samples, cfg.srate, cfg.frate,
                                              cfg.fduration, cfg.window, dtype, device,
                                              scale=2.0**-15)
    npts = int(cfg.nfft / 2 + 1)
    mag = torch.fft.fft(frames, n=npts, dim=-1).abs()
    fbank = torch.as_tensor(mel_filterbank(cfg.nfilters, cfg.nfft, cfg.srate))
    mel = torch.log10(mag @ fbank.to(device=dev, dtype=dtype).T)
    mfcc = dct2(mel)[..., : cfg.num_ceps]
    if cfg.context:
        mfcc = splice_feats(mfcc, cfg.context, num_frames)
    return mfcc, num_frames
