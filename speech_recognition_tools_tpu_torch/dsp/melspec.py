"""Log or power mel spectrum for a batch of waveforms.

Port of speech_recognition_tools_tpu/dsp/melspec.py (reference:
featgen/computeMelSpectrum.py compute_mel_spectrum):
|rfft(frames, nfft)|[:, :nfft/2+1] @ fbank.T, then log10 or the square.
"""

from dataclasses import dataclass

import torch

from speech_recognition_tools_tpu_torch.dsp.filterbanks import parse_fbank_type
from speech_recognition_tools_tpu_torch.dsp.mfcc import windowed_frames


@dataclass(frozen=True)
class MelConfig:
    srate: int = 16000
    nfilters: int = 23
    fduration: float = 0.02
    frate: int = 100
    nfft: int = 1024
    spectrum_type: str = "log"  # 'log' | 'power'
    fbank_type: str = "mel,1"
    window: str = "hamming"


def mel_spectrum_batch(signals, num_samples, cfg: MelConfig = MelConfig(), *,
                       dtype: torch.dtype = torch.float32, device="cuda"):
    """Mel spectrum of a zero-padded batch: (feats (B, Fmax, nfilters),
    num_frames (B,)); arguments as in dsp/mfcc.py::mfcc_batch."""
    if cfg.spectrum_type not in ("log", "power"):
        raise ValueError("spectrum_type must be 'log' or 'power'")
    fbank = torch.as_tensor(parse_fbank_type(cfg.fbank_type, cfg.nfilters, cfg.nfft,
                                             cfg.srate))
    dev, frames, num_frames = windowed_frames(signals, num_samples, cfg.srate, cfg.frate,
                                              cfg.fduration, cfg.window, dtype, device)
    nbins = cfg.nfft // 2 + 1
    mag = torch.fft.rfft(frames, n=cfg.nfft, dim=-1).abs()[..., :nbins]
    mel = mag @ fbank.to(device=dev, dtype=dtype).T
    feats = torch.log10(mel) if cfg.spectrum_type == "log" else mel**2
    return feats, num_frames
