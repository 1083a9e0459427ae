"""DCT-II with scipy.fftpack scaling (unnormalised), via torch.fft.

Port of speech_recognition_tools_tpu/ops/dct.py::dct2:

    y[k] = 2 * sum_n x[n] cos(pi k (2n+1) / (2N)).

Makhoul's reordering (even samples, then odd samples reversed) turns the
DCT-II into one length-N FFT at any N, in float32 or float64:
y[k] = 2 Re(exp(-i pi k / (2N)) FFT(v)[k]). The JAX package's Bluestein
form and hand-written f64 FFT work around XLA on the TPU and are not
needed here.
"""

import numpy as np
import torch


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised DCT-II along the last axis (scipy.fftpack semantics)."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], torch.flip(x[..., 1::2], dims=(-1,))], dim=-1)
    spec = torch.fft.fft(v, dim=-1)
    # twiddle computed in float64 on the host, then cast to the FFT's type
    tw = np.exp(-1j * np.pi * np.arange(n) / (2.0 * n))
    tw = torch.as_tensor(tw, device=x.device).to(spec.dtype)
    return 2.0 * torch.real(spec * tw)
