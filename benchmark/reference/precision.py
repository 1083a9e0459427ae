"""The precision a plain reference computes in.

"f64": every tensor float64, the reference proper. "tf32": float32
tensors whose matrix products and convolutions take their operands
rounded to TF32 (10 mantissa bits, round to nearest) and accumulate in
float32, as cuBLAS and cuDNN compute with TF32 on. That is the correctness
control: the configurations state float32 with TF32 off, and TF32 is the
nearest precision below it. The rounding is done here, not with the
torch.backends flags, so the control reads the same on the CPU.
"""

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties to even)."""
    xi = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    lsb = (xi >> 13) & 1
    xi = (xi + 0xFFF + lsb) & ~0x1FFF
    return ((xi + 2**31) % 2**32 - 2**31).to(torch.int32).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so in the backward
    pass: the products cuBLAS would form with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = rg @ rb.transpose(-1, -2)
        gb = ra.transpose(-1, -2) @ rg
        # sum out broadcast batch axes
        while ga.dim() > ra.dim():
            ga = ga.sum(0)
        while gb.dim() > rb.dim():
            gb = gb.sum(0)
        return ga, gb


def _straight_through(x):
    """TF32-rounded in the forward pass, the identity in the backward."""
    return x + (round_tf32(x.detach()) - x).detach()


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32
        self.tf32 = name == "tf32"

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def _r(self, x):
        return _straight_through(x) if self.tf32 else x

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.tf32 else a @ b

    def linear(self, x, w, b=None):
        y = self.mm(x, w.T)
        return y if b is None else y + b

    def conv2d(self, x, w, b, stride):
        return F.conv2d(self._r(x), self._r(w), b, stride=stride)
