"""Autocorrelation for LPC: banded (all filterbank bands at once), support-
compacted, and circular.

Port of speech_recognition_tools_tpu/ops/autocorr.py. The reference
computes each band's circular autocorrelation of the band-masked DCT
(featgen/features.py:222-224 computeLpcFast). The masked lag products
factor as

    z_b[n] z_b[n+k] = (x[n] x[n+k]) * (fb[b,n] fb[b,n+k]),

so each lag k is one (P, N-k) @ (N-k, nb) product shared by all bands;
complex signals (the complex-modulation M-vectors) take conj(x[n]) x[n+k]
and run as two real products against the real filterbank. These are plain
products outside any kernel and go to torch.matmul. The result equals the
circular autocorrelation whenever no band's support wraps the spectrum
ends, which banded_supports_separable checks.

banded_autocorr_compact computes the same sums over each band's own
support window only (the float64 FDLP path's form, ~20-40x less work at
the production filterbank), from the host plan of banded_support_plan.
circular_autocorr is the per-signal circular form (FFT of length a power
of two >= 2N, then the wrap folded in), which the modulation spectrum
uses where a band's support wraps; circular_autocorr_direct computes it
without an FFT.
"""

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def circular_autocorr(x: torch.Tensor, nlags: int, keepreal: bool = True) -> torch.Tensor:
    """First `nlags` lags of the circular autocorrelation along the last axis,
    y[k] = sum_m conj(x[m]) x[(m + k) mod N].

    Args:
      x: (..., N) real or complex signal.
      nlags: number of lags (<= N).
      keepreal: return the real part (the reference's keepreal=True).

    Returns: (..., nlags).
    """
    n = x.shape[-1]
    m = _next_pow2(2 * n)
    if x.is_complex():
        spec = torch.fft.fft(x, n=m, dim=-1)
        lin = torch.fft.ifft(spec * torch.conj(spec), dim=-1)
    else:
        spec = torch.fft.rfft(x, n=m, dim=-1)
        lin = torch.fft.irfft(spec * torch.conj(spec), n=m, dim=-1)
    y = lin[..., :nlags].clone()
    # the wrap term of lag k >= 1 is the linear lag N - k (conjugated)
    tail = torch.flip(lin[..., n - nlags + 1 : n], dims=(-1,))
    y[..., 1:] += torch.conj(tail) if x.is_complex() else tail
    return torch.real(y) if keepreal else y


def circular_autocorr_direct(x: torch.Tensor, nlags: int) -> torch.Tensor:
    """Circular autocorrelation of a real signal without an FFT:

        y[k] = sum_m x[m] x[m+k]  +  sum_{m<k} x[m] x[m+N-k]."""
    n = x.shape[-1]
    outs = [torch.sum(x[..., : n - k] * x[..., k:], dim=-1)
            + torch.sum(x[..., :k] * x[..., n - k :], dim=-1) for k in range(nlags)]
    return torch.stack(outs, dim=-1)


def circular_autocorr_f64(x: torch.Tensor, nlags: int) -> torch.Tensor:
    """circular_autocorr_direct in float64."""
    return circular_autocorr_direct(x.to(torch.float64), nlags)


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


def banded_support_plan(fbank, nlags: int, n_classes: int = 4, align: int = 128):
    """Host plan for banded_autocorr_compact: each band's support window,
    the bands bucketed into at most `n_classes` width classes.

    Bands are sorted by support width and cut into contiguous classes by a
    DP minimising sum(class size * padded class width), widths padded to a
    multiple of `align`. Returns ((W, ((band, start), ...)), ...) per class;
    `start` is clipped so that [start, start + W) stays inside [0, N). The
    plan is the JAX package's, entry for entry. (`nlags` is unused, as in
    the JAX package: the lag extension reads a zero-padded tail.)
    """
    fb = np.asarray(fbank)
    nb, n = fb.shape
    sup = []
    for b in range(nb):
        nz = np.nonzero(fb[b])[0]
        sup.append((0, 1) if nz.size == 0 else (int(nz[0]), int(nz[-1]) + 1))
    widths = [hi - lo for lo, hi in sup]
    order = sorted(range(nb), key=lambda b: widths[b])

    def padded(w):
        return -(-max(w, 1) // align) * align

    m = len(order)
    inf = 1 << 62
    # dp[c][j]: least cost of the first j sorted bands in c classes
    dp = [[inf] * (m + 1) for _ in range(n_classes + 1)]
    back = [[0] * (m + 1) for _ in range(n_classes + 1)]
    dp[0][0] = 0
    for c in range(1, n_classes + 1):
        for j in range(1, m + 1):
            wmax = 0
            for i in range(j - 1, -1, -1):
                wmax = max(wmax, padded(widths[order[i]]))
                cost = dp[c - 1][i] + (j - i) * wmax
                if cost < dp[c][j]:
                    dp[c][j] = cost
                    back[c][j] = i
    c = min(range(1, n_classes + 1), key=lambda cc: dp[cc][m])
    bounds = []
    j = m
    while c > 0:
        i = back[c][j]
        bounds.append((i, j))
        j, c = i, c - 1
    plan = []
    for i, j in bounds[::-1]:
        cls = order[i:j]
        W = min(max(padded(widths[b]) for b in cls), n)
        plan.append((W, tuple((b, min(sup[b][0], max(n - W, 0))) for b in cls)))
    return tuple(plan)


def banded_autocorr_compact(x: torch.Tensor, fbank: torch.Tensor, nlags: int,
                            plan) -> torch.Tensor:
    """The sums of banded_autocorr restricted to each band's support window
    (the masked signal is zero outside it, so the truncation is exact).

    Args:
      x: (P, N) real signals (float64 on the high-precision FDLP path).
      fbank: (nb, N) filterbank rows, same dtype and device.
      nlags: number of lags (order + 2).
      plan: banded_support_plan(fbank, nlags).

    Returns: (P, nb, nlags).
    """
    nb = fbank.shape[0]
    # zero tails so that every window's +nlags extension is in bounds
    x = torch.nn.functional.pad(x, (0, nlags))
    fbank = torch.nn.functional.pad(fbank, (0, nlags))
    out = x.new_empty((x.shape[0], nb, nlags))
    for W, entries in plan:
        bands = [b for b, _ in entries]
        # (bands of the class, P, W + nlags) masked windows
        z = torch.stack([fbank[b, s : s + W + nlags] * x[:, s : s + W + nlags]
                         for b, s in entries])
        head = z[..., :W]
        out[:, bands] = torch.stack(
            [torch.sum(head * z[..., k : k + W], dim=-1) for k in range(nlags)],
            dim=-1).transpose(0, 1)
    return out


def banded_autocorr(x: torch.Tensor, fbank: torch.Tensor, nlags: int) -> torch.Tensor:
    """y[..., b, k] = sum_n conj(fb[b,n] x[..., n]) (fb[b,n+k] x[..., n+k]).

    Args:
      x: (..., N) real or complex signals.
      fbank: (nb, N) real filterbank rows, of x's (real) dtype, on x's device.
      nlags: number of lags (order + 2 upstream).

    Returns: (..., nb, nlags), of x's dtype.
    """
    n = x.shape[-1]
    xc = torch.conj(x) if x.is_complex() else x
    outs = []
    for k in range(nlags):
        u = xc[..., : n - k] * x[..., k:]
        w = (fbank[:, : n - k] * fbank[:, k:]).T
        if x.is_complex():
            outs.append(torch.complex(torch.matmul(u.real, w), torch.matmul(u.imag, w)))
        else:
            outs.append(torch.matmul(u, w))
    return torch.stack(outs, dim=-1)
