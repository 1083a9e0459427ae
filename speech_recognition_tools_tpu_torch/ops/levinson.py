"""Batched Levinson-Durbin recursion (real lags), plain PyTorch.

Port of speech_recognition_tools_tpu/ops/levinson.py::levinson_durbin
(real branch) and ::lpc_from_autocorr. Solves T a = -r[1:p+1] with T the
Toeplitz matrix of r[0:p] — the system the reference solves with
scipy.linalg.solve_toeplitz — as a loop over the order, batched over every
leading dimension.

Kept from the JAX version: lags normalised by r0 (r0 == 0 -> 1); the error
floored at finfo.tiny before each division; the stability clamp
|k| <= 1 - 16 eps; the reference gain quirk
gg = r0 + sum([1, a] * r[1:p+2]) = r0 + r1 + sum_k a_k r_{k+1}; and the
fallback max(E_p r0, 0) floored at finfo.tiny where gg <= 0.

On CUDA f32 tensors the FDLP path runs the fused kernel of
ops/lpc_cepstra.py instead; this loop is its plain version.
"""

import torch


def levinson_durbin(r: torch.Tensor, order: int):
    """Levinson-Durbin solve of the Yule-Walker system.

    Args:
      r: (..., >= order+1) real autocorrelation lags.
      order: LPC order p.

    Returns:
      a: (..., order) predictor coefficients and e: (...,) the final
      prediction error E_p (normalised by r0).
    """
    if r.is_complex():
        raise NotImplementedError("complex lags are not yet ported")
    p = order
    r0 = r[..., 0]
    safe_r0 = torch.where(r0 == 0, torch.ones_like(r0), r0)
    rn = r[..., 1 : p + 1] / safe_r0[..., None]
    finfo = torch.finfo(rn.dtype)
    kmax = 1.0 - 16.0 * finfo.eps
    # u[m] = a_{i-m} (the predictor reversed and anchored at step i), so the
    # step's inner product is sum_m u[m] rn_m against the fixed lag vector
    a = torch.zeros_like(rn)
    u = torch.zeros_like(rn)
    e = torch.ones_like(r0)
    for i in range(p):
        acc = torch.sum(u * rn, dim=-1)
        e_safe = torch.clamp(e, min=finfo.tiny)
        k = torch.clamp(-(rn[..., i] + acc) / e_safe, -kmax, kmax)
        kc = k[..., None]
        a_new = a + kc * u
        a_new[..., i] += k
        # u'[0] = k ; u'[m] = u[m-1] + k a_{m-1}
        u_new = torch.empty_like(u)
        u_new[..., 0] = k
        u_new[..., 1:] = u[..., :-1] + kc * a[..., :-1]
        e = e * (1.0 - k * k)
        a, u = a_new, u_new
    return a, e


def lpc_from_autocorr(r: torch.Tensor, order: int):
    """LPC polynomial and gain with the reference's gain formula.

    Returns:
      xlpc: (..., order+1) = [1, a_1..a_p].
      gg:   (...,) gain (negative-gain fallback to E_p r0, floored at tiny).
    """
    a, e = levinson_durbin(r, order)
    xlpc = torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)
    gg = r[..., 0] + torch.sum(xlpc * r[..., 1 : order + 2], dim=-1)
    tiny = torch.finfo(gg.dtype).tiny
    fallback = torch.clamp(torch.clamp(e * r[..., 0], min=0.0), min=tiny)
    gg = torch.where(gg > 0, gg, fallback)
    return xlpc, gg
