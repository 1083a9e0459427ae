"""STFT / iSTFT with the biorthogonal synthesis window.

Port of speech_recognition_tools_tpu/enhance/stft.py (parity target:
nn-gev/fgnt/signal_processing.py:37-199): a blackman analysis window,
perfect reconstruction through the biorthogonal synthesis window (Krueger
A.92), and the optional fade-in/out zero padding of
(size // shift - 1) * shift samples on both ends.

Framing is `unfold` over the padded signal, synthesis an overlap-add of
size // shift shifted block sums (no atomics, so the sum's order is
fixed). torch.stft / torch.istft are not used: their centring, padding and
window normalisation differ from nn-gev's.
"""

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.device import resolve_device


def blackman(size: int) -> np.ndarray:
    """scipy.signal.windows.blackman(size, sym=True), computed as scipy
    computes it (general_cosine over linspace(-pi, pi, size))."""
    if size == 1:
        return np.ones(1)
    fac = np.linspace(-np.pi, np.pi, size)
    w = np.zeros(size)
    for k, a in enumerate((0.42, 0.50, 0.08)):
        w += a * np.cos(k * fac)
    return w


def biorthogonal_synthesis_window(analysis_window: np.ndarray, shift: int):
    """Vectorised _biorthogonal_window_loopy (nn-gev :37-64)."""
    fft_size = len(analysis_window)
    assert fft_size % shift == 0
    k = fft_size // shift
    # sum of squares of the window taps congruent mod shift, without the
    # last tap (analysis_index + 1 < fft_size in the reference loop)
    w2 = np.asarray(analysis_window, np.float64) ** 2
    w2[-1] = 0.0
    sums = w2.reshape(k, shift).sum(axis=0)
    return analysis_window / np.kron(np.ones(k), sums) / fft_size


def as_tensor(x, device=None) -> torch.Tensor:
    """`x` as a tensor: a tensor stays on its device unless `device` is
    given; anything else goes to resolve_device(device or "cuda")."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device or "cuda"))


def stft(time_signal, size: int = 1024, shift: int = 256, window=None,
         fading: bool = True, device=None) -> torch.Tensor:
    """STFT of (..., samples) -> (..., frames, size // 2 + 1) complex, in
    the input's precision (float32 -> complex64, float64 -> complex128).

    With fading=True the signal is padded with (size // shift - 1) * shift
    zeros on both ends, then on the right so that the last frame is
    complete: ceil((n - size + shift) / shift) frames."""
    x = as_tensor(time_signal, device)
    win = torch.as_tensor(window if window is not None else blackman(size),
                          dtype=x.dtype, device=x.device)
    pad = (size // shift - 1) * shift if fading else 0
    n = x.shape[-1] + 2 * pad
    frames = max(1, int(np.ceil((n - size + shift) / shift)))
    total = (frames - 1) * shift + size
    x = torch.nn.functional.pad(x, (pad, pad + max(total - n, 0)))
    segs = x.unfold(-1, size, shift)[..., :frames, :] * win
    return torch.fft.rfft(segs, n=size, dim=-1)


def istft(stft_signal, size: int = 1024, shift: int = 256, window=None,
          fading: bool = True, device=None) -> torch.Tensor:
    """Inverse STFT by the biorthogonal synthesis window and overlap-add:
    (..., frames, size // 2 + 1) -> (..., samples)."""
    X = as_tensor(stft_signal, device)
    awin = np.asarray(window if window is not None else blackman(size))
    swin = torch.as_tensor(biorthogonal_synthesis_window(awin, shift) * size,
                           dtype=X.real.dtype, device=X.device)
    segs = torch.fft.irfft(X, n=size, dim=-1) * swin
    frames, k = segs.shape[-2], size // shift
    lead = segs.shape[:-2]
    blocks = segs.new_zeros(lead + (frames + k - 1, shift))
    for j in range(k):
        blocks[..., j : j + frames, :] += segs[..., j * shift : (j + 1) * shift]
    out = blocks.reshape(lead + ((frames + k - 1) * shift,))
    if fading:
        pad = (k - 1) * shift
        out = out[..., pad : out.shape[-1] - pad]
    return out
