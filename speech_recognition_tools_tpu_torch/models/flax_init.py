"""Initialisers that draw from the distributions flax's defaults draw from.

The JAX package's models take flax's default initialisers: Dense and Conv
kernels lecun_normal (a normal truncated at two standard deviations,
rescaled so the variance is 1 / fan_in), GRU recurrent kernels orthogonal,
Embed N(0, 1 / features), biases zero, LayerNorm scales one. The port
draws from the same distributions (not the same bits: torch's generator is
not jax.random) on the CPU from an explicit torch.Generator, then copies
the draw to the parameter's device, so one seed gives the same weights on
the card and on the CPU.
"""

import math

import torch

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fill(param: torch.Tensor, draw: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(draw.to(param.dtype))


def lecun_normal_(param: torch.Tensor, fan_in: int, generator=None) -> None:
    draw = torch.empty(param.shape)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    _fill(param, draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def normal_(param: torch.Tensor, std: float, generator=None) -> None:
    _fill(param, torch.randn(param.shape, generator=generator) * std)


def orthogonal_(param: torch.Tensor, generator=None) -> None:
    draw = torch.empty(param.shape)
    torch.nn.init.orthogonal_(draw, generator=generator)
    _fill(param, draw)


def zeros_(param: torch.Tensor) -> None:
    with torch.no_grad():
        param.zero_()


def ones_(param: torch.Tensor) -> None:
    with torch.no_grad():
        param.fill_(1.0)


def uniform_(param: torch.Tensor, generator=None) -> None:
    """flax's initializers.uniform(1.0): U[0, 1)."""
    _fill(param, torch.rand(param.shape, generator=generator))


def conv_(conv, generator=None) -> None:
    """flax.linen.Conv's (and ConvTranspose's) defaults on a torch conv of
    weight (out, in / groups, *kernel): lecun_normal over the fan-in
    in / groups x kernel size, zero bias."""
    lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
    zeros_(conv.bias)


class FlaxDrawn(torch.nn.Module):
    """A module whose parameters are not Linears, convs or recurrent
    layers; `reset_parameters(generator)` draws them as flax's `init`
    does (models/recurrent.py::flax_reset_ calls it)."""

    def reset_parameters(self, generator=None):
        raise NotImplementedError


def dense_(linear: torch.nn.Linear, generator=None) -> None:
    """flax.linen.Dense's defaults on a Linear: lecun_normal, zero bias."""
    lecun_normal_(linear.weight, linear.in_features, generator)
    zeros_(linear.bias)
