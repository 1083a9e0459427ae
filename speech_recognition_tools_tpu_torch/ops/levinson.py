"""Batched Levinson-Durbin recursion, plain PyTorch: the step loop (real and
complex Hermitian lags) and the blocked Schur/Szego form (real lags).

Port of speech_recognition_tools_tpu/ops/levinson.py::levinson_durbin,
::levinson_durbin_blocked and ::lpc_from_autocorr. Solves T a = -r[1:p+1]
with T the (Hermitian) Toeplitz matrix of r[0:p] — the system the
reference solves with scipy.linalg.solve_toeplitz — batched over every
leading dimension.

Kept from the JAX version: lags normalised by r0 (r0 == 0 -> 1); the error
floored at finfo.tiny before each division (|e| for complex lags); the
stability clamp |k| <= 1 - 16 eps; the reference gain quirk
gg = r0 + sum([1, a] * r[1:p+2]) = r0 + r1 + sum_k a_k r_{k+1}; and, for
real lags, the fallback max(E_p r0, 0) floored at finfo.tiny where
gg <= 0.

On CUDA f32 tensors the FDLP and modulation-spectrum paths run the fused
kernel of ops/lpc_cepstra.py instead; these loops are its plain version
and serve the float64 and complex paths.
"""

import torch
from torch.nn import functional as F


def _normalised_lags(r: torch.Tensor, p: int) -> torch.Tensor:
    r0 = r[..., 0]
    safe_r0 = torch.where(r0 == 0, torch.ones_like(r0), r0)
    return r[..., 1 : p + 1] / safe_r0[..., None]


def levinson_durbin(r: torch.Tensor, order: int):
    """Levinson-Durbin solve of the Yule-Walker system.

    Args:
      r: (..., >= order+1) autocorrelation lags; complex lags are taken as
        Hermitian Toeplitz (scipy solve_toeplitz's r = conj(c) default).
      order: LPC order p.

    Returns:
      a: (..., order) predictor coefficients and e: (...,) the final
      prediction error E_p (normalised by r0; complex for complex lags).
    """
    p = order
    cplx = r.is_complex()
    rn = _normalised_lags(r, p)
    finfo = torch.finfo(rn.real.dtype)
    kmax = 1.0 - 16.0 * finfo.eps
    # u[m] = a_{i-m} (the predictor reversed and anchored at step i), so the
    # step's inner product is sum_m u[m] rn_m against the fixed lag vector
    a = torch.zeros_like(rn)
    u = torch.zeros_like(rn)
    e = torch.ones_like(rn[..., 0])
    for i in range(p):
        acc = torch.sum(u * rn, dim=-1)
        if cplx:
            e_safe = torch.where(e.abs() < finfo.tiny, finfo.tiny, e)
            num = rn[..., i] + acc
            k = -num / e_safe
            kmag = k.abs()
            k = torch.where(kmag > kmax, k * (kmax / kmag.clamp_min(finfo.tiny)), k)
            # once the error has collapsed, -num / e_safe can overflow, and
            # the clamp above turns inf * 0 into NaN: there k takes the
            # clamp's magnitude in the direction of -num / e
            d = -num * torch.conj(e_safe)
            k = torch.where(torch.isfinite(k), k, kmax * d / d.abs().clamp_min(finfo.tiny))
            kc = k[..., None]
            a_new = a + kc * torch.conj(u)
            e = e * (1.0 - k * torch.conj(k))
            ah = torch.conj(a[..., :-1])
        else:
            k = torch.clamp(-(rn[..., i] + acc) / torch.clamp(e, min=finfo.tiny), -kmax, kmax)
            kc = k[..., None]
            a_new = a + kc * u
            e = e * (1.0 - k * k)
            ah = a[..., :-1]
        a_new[..., i] += k
        # u'[0] = k ; u'[m] = u[m-1] + k conj(a_{m-1})
        u = torch.cat([kc, u[..., :-1] + kc * ah], dim=-1)
        a = a_new
    return a, e


def _theta_apply(x, y, t0, t1):
    """The first len(x) coefficients of the polynomial t0 * x + t1 * y.

    x, y: (..., n) coefficient vectors; t0, t1: (..., d + 1) polynomials.
    Each output is a dot of the two polynomials with a window of the
    inputs (unfold over a left zero pad), one batched product per call.
    """
    d = t0.shape[-1] - 1
    wx = F.pad(x, (d, 0)).unfold(-1, d + 1, 1)  # (..., n, d+1): x[n-d .. n]
    wy = F.pad(y, (d, 0)).unfold(-1, d + 1, 1)
    return (torch.einsum("...ne,...e->...n", wx, t0.flip(-1))
            + torch.einsum("...ne,...e->...n", wy, t1.flip(-1)))


def _shift1(v):
    """v shifted one place up (multiplied by z), its top entry dropped."""
    return F.pad(v[..., :-1], (1, 0))


def levinson_durbin_blocked(r: torch.Tensor, order: int, block: int = 15):
    """Blocked Schur/Szego Levinson-Durbin (real lags only).

    The same reflection coefficients and predictor as levinson_durbin,
    regrouped. With the generators phi_i[n] = sum_j a_{i,j} r_{n-j} and
    psi_i[n] = sum_j b_{i,j} r_{n-j} (b_i = a_i reversed, the backward
    predictor), one step is the same 2 x 2 polynomial map for the
    generators and the predictors:

        phi' = phi + k (z psi),   psi' = z psi + k phi,   k = -phi_i[i+1] / e_i.

    The k's of `block` consecutive steps depend only on a block-long window
    of the generators. So each block runs its steps on those windows,
    accumulating the block's transfer matrix Theta (polynomials of degree
    <= block), then advances the full-length generators and the predictor
    once by Theta (_theta_apply). The guards are levinson_durbin's: the
    error floored at tiny, |k| clamped to 1 - 16 eps, e' = e (1 - k^2).

    Args:
      r: (..., >= order+1) real lags.
      order: LPC order p.
      block: steps per block.

    Returns: a (..., order) and e (...,), as levinson_durbin.
    """
    if r.is_complex():
        raise NotImplementedError("levinson_durbin_blocked is real-only; use levinson_durbin")
    p = order
    rn = _normalised_lags(r, p)
    finfo = torch.finfo(rn.dtype)
    kmax = 1.0 - 16.0 * finfo.eps
    one = torch.ones_like(rn[..., :1])
    # live generator tails based at the current order i (phi keeps the entry
    # below its window, which psi's advance reads), and the predictor head
    phi = psi = torch.cat([one, rn], dim=-1)
    a = one
    e = one[..., 0]
    i = 0
    while i < p:
        bc = min(block, p - i)
        wphi, wpsi = phi[..., 1 : 1 + bc], psi[..., :bc]
        t00 = F.pad(one, (0, bc))  # the identity map: 1, 0, 0, 1
        t11, t01, t10 = t00, torch.zeros_like(t00), torch.zeros_like(t00)
        for s in range(bc):
            k = torch.clamp(-wphi[..., s] / torch.clamp(e, min=finfo.tiny), -kmax, kmax)
            e = e * (1.0 - k * k)
            kk = k[..., None]
            wphi, wpsi = wphi + kk * wpsi, _shift1(wpsi + kk * wphi)
            t00, t01, t10, t11 = (t00 + kk * _shift1(t10), t01 + kk * _shift1(t11),
                                  kk * t00 + _shift1(t10), kk * t01 + _shift1(t11))
        phi, psi = (_theta_apply(phi, psi, t00, t01)[..., bc:],
                    _theta_apply(phi, psi, t10, t11)[..., bc:])
        a_ext = F.pad(a, (0, bc))
        a = _theta_apply(a_ext, F.pad(a.flip(-1), (0, bc)), t00, t01)
        i += bc
    return a[..., 1 : p + 1], e


def lpc_from_autocorr(r: torch.Tensor, order: int, block: int | None = None):
    """LPC polynomial and gain with the reference's gain formula.

    `block` (real lags only) solves with levinson_durbin_blocked(block=)
    instead of the step loop.

    Returns:
      xlpc: (..., order+1) = [1, a_1..a_p].
      gg:   (...,) gain; for real lags, where it is not positive, the
            fallback E_p r0 floored at tiny.
    """
    if block is not None and not r.is_complex():
        a, e = levinson_durbin_blocked(r, order, block=block)
    else:
        a, e = levinson_durbin(r, order)
    xlpc = torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)
    gg = r[..., 0] + torch.sum(xlpc * r[..., 1 : order + 2], dim=-1)
    if gg.is_complex():
        return xlpc, gg
    tiny = torch.finfo(gg.dtype).tiny
    fallback = torch.clamp(torch.clamp(e * r[..., 0], min=0.0), min=tiny)
    gg = torch.where(gg > 0, gg, fallback)
    return xlpc, gg
