"""Weight-only int8 quantization of the encoder for serving.

Port of speech_recognition_tools_tpu/infer/quantize.py. Small-batch online
serving re-reads the encoder's weights every scheduling round while the
activations are tiny (B x chunk x adim), so the big encoder kernels are
kept as int8 codes with one float32 scale per output channel, both on the
device. Compute precision is unchanged: this is weight compression, not
int8 arithmetic, and max |w - deq(q(w))| <= scale / 2.

Selection and scales are the JAX package's exactly: the weights of the
flax kernels (every nn.Linear, Conv1d and Conv2d of the port: Dense,
DenseGeneral and Conv in flax) with at least `min_size` (1024) elements;
the abs-max over the contraction axes, scale = amax / 127 in float32 (1
where amax is 0), the codes round(w / scale) half to even, clipped to
+-127. LayerNorms and biases stay float32. In torch's layouts the output
channel is axis 0 of every such weight: flax's q/k/v kernels (in, heads,
head_dim) get one scale per (head, head_dim), which is one per output row
of the port's (heads * head_dim, in) weight; the attention out-projection
(heads, head_dim, out), a Dense (in, out), a Conv2d (kh, kw, in, out) and
the conformer's depthwise conv (k, 1, C) reduce over all but `out`.

A quantized module keeps its codes as the buffer
`<module>.parametrizations.weight.original` (int8) and its scales as
`<module>.parametrizations.weight.0.scale` (float32, shaped (out, 1, ...)),
through torch.nn.utils.parametrize: every read of `module.weight`
dequantizes `q * scale` in float32 (one fused multiply: int8 times float32
promotes to float32), and the module casts that to its compute dtype as
before. No float32 copy is kept between calls. In eager mode this costs
one extra kernel per weight per call, where XLA fuses the dequantization
into each consumer (infer/quantize.py:1-12 of the JAX package).
io/jax_params.py carries a JAX tree of {int8_q, int8_scale} leaves into
such a model and back (`load_quantized_state_dict` here loads it).
"""

import torch
from torch import nn
from torch.nn.utils import parametrize

# the port's modules whose `weight` is a flax `kernel`
_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d)
_ORIGINAL = ".parametrizations.weight.original"
_SCALE = ".parametrizations.weight.0.scale"


class Int8Weight(nn.Module):
    """The parametrization of a quantized weight: int8 codes -> q * scale."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, q):
        return q * self.scale


def quantize_leaf(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a weight in torch's
    layout (output channels on axis 0): (codes int8, scales float32 shaped
    (out, 1, ...)), the abs-max taken over every other axis. It runs on the
    host, as numpy runs it in the JAX package, so the scales are the same
    bits whatever the weight's device (CUDA divides by a Python scalar as
    a multiply by its reciprocal, a last-bit difference)."""
    w = w.detach().to("cpu", torch.float32)
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def is_quantized(module: nn.Module) -> bool:
    return parametrize.is_parametrized(module, "weight") and any(
        isinstance(p, Int8Weight) for p in module.parametrizations.weight)


def quantize_module(module: nn.Module, q: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None) -> None:
    """Replace `module.weight` by int8 codes and scales on its device, in
    place: quantize_leaf of the weight, or the given (q, scale)."""
    if q is None:
        q, scale = quantize_leaf(module.weight)
    dev = module.weight.device
    del module.weight
    module.register_buffer("weight", q.to(device=dev, dtype=torch.int8))
    parametrize.register_parametrization(
        module, "weight", Int8Weight(scale.to(device=dev, dtype=torch.float32)), unsafe=True)


def quantize_tree(module: nn.Module, min_size: int = 1024) -> nn.Module:
    """Quantize, in place, every kernel module under `module` whose float
    weight has at least `min_size` elements; returns `module`."""
    for sub in module.modules():
        if (isinstance(sub, _KERNEL_MODULES) and not is_quantized(sub)
                and sub.weight.is_floating_point() and sub.weight.numel() >= min_size):
            quantize_module(sub)
    return module


def has_quantized(module: nn.Module) -> bool:
    return any(is_quantized(m) for m in module.modules())


def quantize_encoder(model: nn.Module, min_size: int = 1024) -> nn.Module:
    """Quantize a TransformerASR's encoder in place (the part every
    streaming round re-reads); the decoder and ctc_head stay float32, so
    beam finals and rescored partials are untouched. Returns `model`."""
    if not isinstance(getattr(model, "encoder", None), nn.Module):
        raise ValueError("expected a TransformerASR with an `encoder`")
    quantize_tree(model.encoder, min_size=min_size)
    return model


def load_quantized_state_dict(model: nn.Module, sd: dict) -> nn.Module:
    """Load a state_dict that holds quantized weights (the form
    io/jax_params.py::transformer_asr_from_jax gives a JAX tree of
    {int8_q, int8_scale} leaves): the modules it names in int8 form are
    quantized with its codes and scales first."""
    for k in sd:
        if k.endswith(_ORIGINAL):
            name = k[: -len(_ORIGINAL)]
            mod = model.get_submodule(name)
            if not is_quantized(mod):
                quantize_module(mod, sd[k], sd[name + _SCALE])
    model.load_state_dict(sd)
    return model


def quantized_bytes(module: nn.Module):
    """(bytes of the quantized form, bytes of its float32 equivalent) over
    the module's parameters and buffers: the JAX package's pair for the
    same tree (an int8 code counts 4 bytes in the second, the scales count
    in both)."""
    qb = fb = 0
    for t in module.state_dict().values():
        qb += t.numel() * t.element_size()
        fb += t.numel() * 4 if t.dtype == torch.int8 else t.numel() * t.element_size()
    return qb, fb
