"""Waveform augmentation: additive noise at a target SNR, reverberation by
RIR convolution with cross-correlation alignment, AWGN, and the 'diff' FIR.

Port of speech_recognition_tools_tpu/dsp/augment.py (parity targets: the
reference's src/featgen/features.py:24-60,110-115, add_noise_to_wav,
add_agwn and addReverb, and the 'diff' FIR branch of the featgen CLIs,
computeFDLPSpectrogram.py:162-166).

Randomness is explicit: where the JAX package draws the noise offset from
a jax.random key, `add_noise_snr` takes the uniforms (`uniforms`, e.g.
jax.random's own draws) or draws them from a torch.Generator. The featgen
CLIs do not call this module: they augment on the host with numpy, as the
JAX CLIs do (cli/common.py).
"""

import numpy as np
import torch
import torch.nn.functional as F

from speech_recognition_tools_tpu_torch.enhance.stft import as_tensor

# FIR of the reference's `--add_noise diff` branch.
DIFF_FIR = np.array([1, 2, 3, 2, 0, -2, -5, -2, 0, 2, 3, 2, 1], dtype=np.float64)


def add_noise_snr(sig, noise, snr_db, num_samples=None, *, uniforms=None,
                  generator: torch.Generator | None = None, device=None):
    """Mix a random segment of `noise` into `sig` at `snr_db`.

    sig: (N,) or (B, N); noise: (M,), M >= N. The noise offset of row b is
    floor(u_b * max(M - n_b, 1)), the reference's floor(rand * (len(noise)
    - len(sig))), with u_b from `uniforms` (B,) or from `generator`."""
    sig = as_tensor(sig, device)
    noise = as_tensor(noise, sig.device).to(sig.dtype)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[None]
    B, N = sig.shape
    M = noise.shape[0]
    if uniforms is None:
        uniforms = torch.rand(B, generator=generator, dtype=torch.float64)
    u = as_tensor(uniforms, sig.device).to(torch.float64)
    n = (torch.full((B,), N, device=sig.device) if num_samples is None
         else as_tensor(num_samples, sig.device).reshape(B))
    max_off = torch.clamp(M - n, min=1)
    off = torch.floor(u * max_off).to(torch.int64)
    idx = (off[:, None] + torch.arange(N, device=sig.device)[None, :]).clamp(0, M - 1)
    ns = noise[idx]
    if num_samples is not None:
        mask = (torch.arange(N, device=sig.device)[None, :] < n[:, None]).to(sig.dtype)
    else:
        mask = torch.ones_like(sig)
    denom = mask.sum(1)
    e_s = ((sig * mask) ** 2).sum(1) / denom
    e_n = ((ns * mask) ** 2).sum(1) / denom
    alp = torch.sqrt(e_s / (e_n * (10.0 ** (snr_db / 10.0))))
    out = sig + alp[:, None] * ns * mask
    return out[0] if squeeze else out


def add_awgn(sig, noise, snr_db, device=None):
    """Scaled additive noise of the same length (features.py:47-60)."""
    sig = as_tensor(sig, device)
    noise = as_tensor(noise, sig.device).to(sig.dtype)
    p_sig = (sig**2).mean(-1, keepdim=True)
    p_noise = (noise**2).mean(-1, keepdim=True)
    return sig + torch.sqrt(p_sig / (p_noise * 10.0 ** (snr_db / 10.0))) * noise


def _convolve_full(x, h):
    """np.convolve(x, h) of (B, N) rows with one (L,) filter, direct."""
    L = h.shape[-1]
    return F.conv1d(x[:, None], h.flip(-1)[None, None], padding=L - 1)[:, 0]


def apply_diff_fir(sig, device=None):
    """'diff' augmentation: convolve with the fixed FIR, mode='same'."""
    sig = as_tensor(sig, device)
    fir = torch.as_tensor(DIFF_FIR, dtype=sig.dtype, device=sig.device)
    x = sig[None] if sig.ndim == 1 else sig
    start = (len(DIFF_FIR) - 1) // 2
    out = _convolve_full(x, fir)[:, start : start + x.shape[-1]]
    return out[0] if sig.ndim == 1 else out


def add_reverb(sig, rir, device=None):
    """Convolve one (N,) utterance with a RIR and re-align it by the
    cross-correlation peak (features.py:110-115): out = conv(sig, rir);
    xxc = correlate(sig, out, 'valid'); ind = len(xxc) - argmax(xxc);
    return out[ind : ind + N]. Both products are direct convolutions."""
    sig = as_tensor(sig, device)
    rir = as_tensor(rir, sig.device).to(sig.dtype)
    n, m = sig.shape[-1], rir.shape[-1]
    full = _convolve_full(sig[None], rir)[0]  # n + m - 1
    # c[k] = sum_j sig[j] full[j + k], k < m; numpy's correlate(sig, full)
    # runs the shorter array over the longer one, so xxc[k] = c[m - 1 - k]
    c = F.conv1d(full[None, None], sig[None, None])[0, 0]
    ind = m - int(torch.argmax(c.flip(0)))
    ind = min(ind, m - 1)  # jax.lax.dynamic_slice clamps the start so n samples fit
    return full[ind : ind + n]
