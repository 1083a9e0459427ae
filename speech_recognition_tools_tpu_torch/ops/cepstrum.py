"""LPC -> cepstral modulation coefficients, plain PyTorch.

Port of speech_recognition_tools_tpu/ops/cepstrum.py::lpc_to_cepstrum
(reference computeModSpecFromLpc). With the sign-flipped predictor
b = [1, -a_1..-a_p], zero-padded when p+1 < lim:

    cep[0] = log(sqrt(gg))
    cep[1] = b[1]
    cep[n] = sum_{m=1}^{n-1} (m/n) * b[n-m] * cep[m] + b[n]   (n >= 2)

The recursion is dtype-generic: complex predictors (the complex-modulation
path) take the complex log of the gain in their own dtype.
"""

import torch


def lpc_to_cepstrum(xlpc: torch.Tensor, gg: torch.Tensor, lim: int) -> torch.Tensor:
    """`lim` cepstral coefficients from the LPC polynomial and gain.

    Args:
      xlpc: (..., p+1) LPC polynomial [1, a_1..a_p], signs as returned by
        lpc_from_autocorr (the reference's sign flip is applied here).
      gg: (...,) gain.
      lim: number of cepstral coefficients.

    Returns: (..., lim) cepstra.
    """
    b = torch.cat([xlpc[..., :1], -xlpc[..., 1:]], dim=-1)
    pad = max(0, lim + 1 - b.shape[-1])
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    cep = b.new_zeros(b.shape[:-1] + (lim,))
    if b.is_complex():
        gg = gg.to(b.dtype)
    cep[..., 0] = torch.log(torch.sqrt(gg))
    if lim > 1:
        cep[..., 1] = b[..., 1]
    for n in range(2, lim):
        m = torch.arange(1, n, dtype=b.real.dtype, device=b.device)
        # b[n-m] for m = 1..n-1 is b[n-1], ..., b[1]
        win = torch.flip(b[..., 1:n], dims=(-1,))
        cep[..., n] = torch.sum((m / n) * win * cep[..., 1:n], dim=-1) + b[..., n]
    return cep
