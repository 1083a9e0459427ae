"""Banded circular autocorrelation for LPC (real signals).

Port of speech_recognition_tools_tpu/ops/autocorr.py::banded_autocorr
(real branch) and ::banded_supports_separable. The reference computes
each band's circular autocorrelation of the band-masked DCT
(featgen/features.py:222-224 computeLpcFast). The masked lag products
factor as

    z_b[n] z_b[n+k] = (x[n] x[n+k]) * (fb[b,n] fb[b,n+k]),

so each lag k is one (P, N-k) @ (N-k, nb) product shared by all bands.
These are plain products outside any kernel and go to torch.matmul. The
result equals the circular autocorrelation whenever no band's support
wraps the spectrum ends, which banded_supports_separable checks.
"""

import numpy as np
import torch


def banded_supports_separable(fbank, nlags: int) -> bool:
    """True when no band's support touches both ends of the spectrum, so
    every band's circular wrap-around terms vanish. Host check on the numpy
    filterbank."""
    fb = np.asarray(fbank)
    n = fb.shape[-1]
    for row in fb:
        nz = np.nonzero(row)[0]
        if nz.size and nz[0] < nlags and nz[-1] >= n - nlags + 1:
            return False
    return True


def banded_autocorr(x: torch.Tensor, fbank: torch.Tensor, nlags: int) -> torch.Tensor:
    """y[..., b, k] = sum_n (fb[b,n] x[..., n]) (fb[b,n+k] x[..., n+k]).

    Args:
      x: (..., N) real signals.
      fbank: (nb, N) real filterbank rows, same dtype and device as x.
      nlags: number of lags (order + 2 upstream).

    Returns: (..., nb, nlags).
    """
    if x.is_complex():
        raise NotImplementedError("complex signals are not yet ported")
    n = x.shape[-1]
    outs = []
    for k in range(nlags):
        u = x[..., : n - k] * x[..., k:]
        w = fbank[:, : n - k] * fbank[:, k:]
        outs.append(torch.matmul(u, w.T))
    return torch.stack(outs, dim=-1)
