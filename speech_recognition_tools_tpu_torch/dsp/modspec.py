"""FDLP modulation spectral features (M-vectors).

Port of speech_recognition_tools_tpu/dsp/modspec.py (reference:
featgen/computeModulationSpectrum.py getFeats, :30-205): per 10 ms frame
and mel/cochlear band, the LPC -> cepstral modulation coefficients
coeff_0..coeff_n, with optional complex modulation (analytic ifft, complex
LPC), 1/f noise compensation, absolute value, even-coefficient subsetting
and unity gain; output frames x (nfilters * feat_len). The analysis window
is hanning (square with no_window).

The lags of every (frame x band) problem come, when no band's support
wraps the spectrum ends (every mel bank), from the banded autocorrelation
(ops/autocorr.py): the signal lag products are shared by all bands, real
or complex, over chunks of frames that bound the lag workspace at about
0.25 GB. Otherwise each problem's circular autocorrelation is taken
(ops/autocorr.py::circular_autocorr), in chunks of `problem_chunk`.

Real float32 lags (with the f32 white-noise ridge) go through kernel K1
(ops/lpc_cepstra.py) with unity_gain=set_unity_gain: on a CUDA tensor the
kernel, on a CPU tensor its plain version. Complex and float64 lags go
through the plain Levinson and cepstrum loops on either device (K1 is
real float32 only). The JAX package does the same on its shared-lag path;
on its wrap path it runs scans even for real float32 lags, which compute
the same function as K1.

torch.fft.ifft takes the place of the JAX package's Bluestein ifft (a
workaround for non-power-of-two FFTs on the TPU). Under
complex_modulation in float32 the JAX package's frames past an
utterance's end can be NaN; valid frames are not affected.
"""

from dataclasses import dataclass

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.dsp.filterbanks import parse_fbank_type
from speech_recognition_tools_tpu_torch.ops.autocorr import (
    banded_autocorr,
    banded_supports_separable,
    circular_autocorr,
)
from speech_recognition_tools_tpu_torch.ops.dct import dct2
from speech_recognition_tools_tpu_torch.ops.framing import (
    frame_count,
    frame_params,
    frame_signal,
)
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
    lpc_cepstra,
    lpc_cepstra_reference,
)
from speech_recognition_tools_tpu_torch.ops.windows import WINDOWS

LAG_WORKSPACE_BYTES = 1 << 28  # the shared-lag path's frame-chunk budget


@dataclass(frozen=True)
class ModSpecConfig:
    srate: int = 16000
    nfilters: int = 15
    coeff_0: int = 5
    coeff_n: int = 30
    order: int = 50
    fduration: float = 0.5
    frate: int = 100
    fbank_type: str = "mel,1"
    keep_even: bool = False
    complex_modulation: bool = False
    compensate_noise: bool = False
    absolute_value: bool = False
    set_unity_gain: bool = False
    no_window: bool = False
    problem_chunk: int = 4096  # problems per chunk on the wrap path

    @property
    def coeff_num(self) -> int:
        return self.coeff_n - self.coeff_0 + 1

    @property
    def feat_len(self) -> int:
        if self.keep_even:
            temp = np.arange(0, self.coeff_num)
            if self.coeff_0 % 2 == 0:
                return temp[1::2].shape[0]
            return temp[0::2].shape[0]
        if self.complex_modulation:
            return self.coeff_num if self.absolute_value else 2 * self.coeff_num
        return self.coeff_num


def _ridge(r):
    """The f32 diagonal loading of dsp/fdlp.py (the near-periodic
    pole-explosion guard), in place on real float32 lags."""
    if r.dtype == torch.float32:
        r[..., 0] *= 1.0 + 1e-4
    return r


def _cepstra(r, cfg: ModSpecConfig):
    """(P, order+2) lags -> (P, coeff_n) cepstra: K1 for real float32 lags
    (after the f32 ridge), the plain loops otherwise."""
    r = _ridge(r)
    if r.dtype == torch.float32:
        return lpc_cepstra(r, cfg.order, cfg.coeff_n, unity_gain=cfg.set_unity_gain)
    return lpc_cepstra_reference(r, cfg.order, cfg.coeff_n, unity_gain=cfg.set_unity_gain)


def _shared_lags(trans, fbank, nlags):
    """(P0, ndct) transforms -> (P0 * nb, nlags) banded lags, over chunks
    of frames whose lag products stay within LAG_WORKSPACE_BYTES."""
    P0, ndct = trans.shape
    isz = 8 if trans.is_complex() else 4
    chunk = max(64, min(P0, LAG_WORKSPACE_BYTES // (isz * 2 * ndct * 4)))
    r = torch.cat([banded_autocorr(trans[i : i + chunk], fbank, nlags)
                   for i in range(0, P0, chunk)])
    return r.reshape(-1, nlags)


def _wrap_cepstra(trans, fbank, cfg: ModSpecConfig):
    """Per-problem circular autocorrelation, then the cepstra, over chunks
    of `problem_chunk` (frame, band) problems: (P0 * nb, coeff_n)."""
    P0, nb = trans.shape[0], fbank.shape[0]
    P = P0 * nb
    out = []
    for lo in range(0, P, cfg.problem_chunk):
        idx = torch.arange(lo, min(lo + cfg.problem_chunk, P), device=trans.device)
        z = trans[idx // nb] * fbank[idx % nb]
        r = circular_autocorr(z, cfg.order + 2, keepreal=not cfg.complex_modulation)
        out.append(_cepstra(r, cfg))
    return torch.cat(out)


def _transforms(signals, num_samples, cfg: ModSpecConfig, dtype, device):
    """Windowed frames -> DCT (or analytic ifft) rows: (trans (B * Fmax,
    ndct), num_frames (B,), the host filterbank, its tensor, B, Fmax)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        configure_cuda()
    fp = frame_params(cfg.srate, cfg.frate, cfg.fduration)
    dur = (int(cfg.fduration * cfg.srate) if cfg.complex_modulation
           else int(2 * cfg.fduration * cfg.srate))
    fbank = parse_fbank_type(cfg.fbank_type, cfg.nfilters, dur, cfg.srate)[:, :-1]

    signals = torch.as_tensor(signals).to(device=dev, dtype=dtype)
    num_samples = torch.as_tensor(num_samples).to(device=dev, dtype=torch.int64)
    B = signals.shape[0]
    max_frames = frame_count(signals.shape[1], fp)
    win = torch.as_tensor(WINDOWS["square" if cfg.no_window else "hanning"](
        fp.flength_samples), dtype=dtype, device=dev)
    frames, num_frames = frame_signal(signals, num_samples, fp, win, max_frames)

    if cfg.complex_modulation:
        trans = torch.fft.ifft(frames, dim=-1)[..., : int(cfg.fduration * cfg.srate / 2)]
    else:
        trans = dct2(frames) * (1.0 / np.sqrt(2 * int(cfg.srate * cfg.fduration)))
    ndct = trans.shape[-1]
    if fbank.shape[1] != ndct:
        raise ValueError(f"filterbank width {fbank.shape[1]} != transform {ndct}")
    fbank_d = torch.as_tensor(fbank, dtype=dtype, device=dev)
    return trans.reshape(B * max_frames, ndct), num_frames, fbank, fbank_d, B, max_frames


def modulation_spectrum_lags(signals, num_samples, cfg: ModSpecConfig = ModSpecConfig(), *,
                             dtype: torch.dtype = torch.float32, device="cuda"):
    """The (B * Fmax * nfilters, order + 2) lags that modulation_spectrum_batch
    solves on its shared-lag path, with the f32 ridge applied, and the
    frame counts (B,). Raises where the filterbank wraps (the per-problem
    path has no shared lags)."""
    trans, num_frames, fbank, fbank_d, _, _ = _transforms(signals, num_samples, cfg, dtype,
                                                          device)
    if not banded_supports_separable(fbank, cfg.order + 2):
        raise ValueError("a filterbank band wraps the spectrum ends: no shared lags")
    return _ridge(_shared_lags(trans, fbank_d, cfg.order + 2)), num_frames


def modulation_spectrum_batch(signals, num_samples, cfg: ModSpecConfig = ModSpecConfig(),
                              *, dtype: torch.dtype = torch.float32, device="cuda"):
    """M-vector features for a zero-padded batch of waveforms.

    Args:
      signals: (B, Nmax) waveforms, numpy array or tensor.
      num_samples: (B,) true sample counts.
      cfg: configuration.
      dtype: compute and output dtype (float32; float64 for CPU parity).
      device: "cuda" (default) or "cpu". On CUDA this switches TF32 off
        process-wide (device.configure_cuda).

    Returns (feats (B, Fmax, nfilters * feat_len), num_frames (B,) int64);
    rows past an utterance's frame count are garbage.
    """
    trans, num_frames, fbank, fbank_d, B, max_frames = _transforms(
        signals, num_samples, cfg, dtype, device)
    NB, lim = cfg.nfilters, cfg.coeff_n
    if banded_supports_separable(fbank, cfg.order + 2):
        cep = _cepstra(_shared_lags(trans, fbank_d, cfg.order + 2), cfg)
    else:
        cep = _wrap_cepstra(trans, fbank_d, cfg)
    if not cfg.complex_modulation:
        cep = torch.real(cep)
    ceps = cep.reshape(B, max_frames, NB, lim)

    if cfg.compensate_noise:
        fmax = cfg.coeff_num / (cfg.fduration if cfg.complex_modulation
                                else 2 * cfg.fduration)
        ceps = ceps * torch.as_tensor(np.linspace(0, fmax, cfg.coeff_n),
                                      dtype=ceps.real.dtype, device=ceps.device)

    sel = ceps[..., cfg.coeff_0 - 1 : cfg.coeff_n]  # coeff_0..coeff_n, 1-based
    if cfg.complex_modulation and not cfg.absolute_value:
        feat = torch.cat([sel.real, sel.imag], dim=-1)
    else:
        feat = sel.abs() if cfg.absolute_value else sel
    if cfg.keep_even:
        feat = feat[..., (1 if cfg.coeff_0 % 2 == 0 else 0)::2]
    feat = feat.reshape(B, max_frames, NB * cfg.feat_len).to(dtype)
    return feat, num_frames
