"""End-to-end CTC/attention transformer ASR.

Port of speech_recognition_tools_tpu/models/transformer_asr.py:
TransformerASRConfig, chunk_attention_mask, posenc_host, _embed_scale,
_MHABlock, _ConformerBlock, Conv2dSubsampling, TransformerEncoder (either
block type), TransformerDecoder (full-prefix and KV-cached decode modes),
TransformerASR (`forward`, `encode`, `decode_step`, `decode_init_cache`,
`decode_incremental`), greedy_ctc, the training half: the joint
CTC/attention loss (`ctc_loss`, `joint_loss`, `asr_loss`),
`noam_schedule` and `average_checkpoints`, the continual-learning
decode `cl_decode`, and the parallel paths over a parallel/mesh.py Mesh:
`encode_pipelined` and `asr_loss_pipelined` (the encoder blocks as GPipe
stages, `pipeline_stage` a rank's blocks), the pipeline layout's
`split_pipeline_params` / `merge_pipeline_params` and
`pp_opt_state_from_loop` / `pp_opt_state_to_loop`, and `encode_ring`
(every encoder self-attention through ring attention). The reference's headline model is ESPnet's
e2e_asr_transformer (conf/train.yaml: 12 encoder / 6 decoder layers, adim
256, 4 heads, FFN 2048, conv2d subsampling, mtlalpha 0.3, label smoothing
0.1).

The modules compute what the flax modules compute, to float32 rounding:

  - LayerNorm is flax's: epsilon 1e-6 and the variance as E[x^2] - E[x]^2
    (clipped at 0), not torch's nn.LayerNorm (epsilon 1e-5, two-pass);
  - attention is flax's MultiHeadDotProductAttention: q, k, v and out are
    DenseGenerals (kept here as Linears over the flattened (heads,
    head_dim) axis), the query is scaled by 1/sqrt(head_dim), and masked
    logits are set to finfo(float32).min, so a fully masked row gives a
    uniform softmax, not NaN;
  - the conv front-end is flax's NHWC (H = time, W = feature) with VALID
    padding; its output is flattened channel-minor, (B, T2, D2, C) ->
    D2 * C, before the Dense, exactly as flax reshapes it;
  - dropout (training mode only) sits where flax's does: after the
    positional encoding of the encoder and of the decoder, on each
    attention output and on the FFN output before its residual add, and on
    the FFN's inner activation; attention weights get none;
  - `reset_parameters(generator)` draws flax's default distributions
    (models/flax_init.py).

The conformer block (encoder_type "conformer") is the JAX package's, not
the paper's: LayerNorm in place of BatchNorm in the conv module, absolute
sinusoidal positions. Its conv module zeroes padded frames after
`conv_norm`, but `conv_pointwise_in`'s bias makes them nonzero again, so
with the non-causal ("SAME") depthwise conv of attn_chunk 0 a batch's
padding reaches the last conv_kernel // 2 valid frames once that bias is
nonzero. The port computes exactly this, as the JAX package does; the
causal conv of attn_chunk > 0 looks only left and is not affected.

The KV-cached decode mode is flax's decode=True attention: each decoder
layer's self-attention keeps a key/value cache as long as the dummy tokens
it was initialised from (max_len + 1), writes a step's key and value at
the cache index and attends to the positions up to it, with no token mask;
the position's encoding is the row `pos` of the sinusoidal table.
Cross-attention is computed from the memory at every step, as in the JAX
package.

The fixed-buffer step (`decode_fixed_buffers`, `decode_fixed_load`,
`decode_fixed_step`, `decode_fixed_reorder`) is the beam search's: a
self-attention cache of `cap` slots written at a slot held in a device
tensor, the slots past it masked, and the cross-attention keys and values
projected once a search from the B utterances' memory, against which the K
beams of an utterance attend as K query positions (exact: beams do not
attend to one another). Nothing in it depends on the step on the host, so
decode/beam_jit.py captures it in a CUDA graph.

Mixed precision (compute_dtype "bfloat16") is flax's `dtype=` idiom,
written out module by module rather than with torch.autocast: the
parameters stay float32 master weights (so checkpoints and the Adam state
keep the float32 layout), and each Dense, Conv, Embed and attention casts
its input and its weights to bfloat16 and computes there, the bias added
after the product as flax adds it. A LayerNorm takes its statistics and
its affine in float32 and returns bfloat16, and the attention takes its
softmax in bfloat16, so the residual stream, the attention weights, the
positional rows (cast to the activations' dtype) and the decode-mode
key/value cache are bfloat16, as in the JAX model. The two logit heads
(`ctc_head` and the decoder's `output`) are float32 Denses on the
bfloat16 activations promoted to float32, so the logits, the loss and the
gradients are float32. At "float32" every module computes exactly as
before.

io/jax_params.py carries a flax parameter tree over in both directions.
"""

import math
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.models import flax_init
from speech_recognition_tools_tpu_torch.parallel.collectives import global_mean, global_ratio
from speech_recognition_tools_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class TransformerASRConfig:
    vocab_size: int = 52  # chars incl. <blank>=0, <sos/eos>=vocab-1
    adim: int = 256
    aheads: int = 4
    elayers: int = 12
    eunits: int = 2048
    dlayers: int = 6
    dunits: int = 2048
    dropout: float = 0.1
    mtlalpha: float = 0.3  # CTC weight in the joint loss
    lsm_weight: float = 0.1  # label smoothing of the attention loss
    encoder_type: str = "transformer"  # or 'conformer'
    conv_kernel: int = 15  # the conformer's depthwise conv width
    # chunked encoder self-attention: each frame attends within its chunk
    # of `attn_chunk` frames plus `attn_left_chunks` chunks of left context
    # (-1 = unbounded); 0 = full attention
    attn_chunk: int = 0
    attn_left_chunks: int = -1
    # "bfloat16": mixed precision with float32 master weights and logit heads
    compute_dtype: str = "float32"

    @property
    def cdtype(self):
        """The torch dtype the modules compute in (flax's `dtype=`): None
        at float32, where every module computes as without the option."""
        if self.compute_dtype == "float32":
            return None
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        # the JAX config takes any jnp dtype name; its CLIs offer these two
        raise NotImplementedError(f"compute_dtype={self.compute_dtype!r} is not ported "
                                  "(float32 and bfloat16 are)")

    @property
    def blank_id(self):
        return 0

    @property
    def sos_id(self):
        return self.vocab_size - 1

    @property
    def eos_id(self):
        return self.vocab_size - 1


def chunk_attention_mask(T: int, chunk: int, left_chunks: int = -1,
                         device=None) -> torch.Tensor:
    """(T, T) bool mask for chunked self-attention: query frame t (chunk
    c = t // chunk) may attend keys in chunks [c - left, c]."""
    c = torch.arange(T, device=device) // chunk
    allowed = c[None, :] <= c[:, None]
    if left_chunks >= 0:
        allowed &= c[None, :] >= c[:, None] - left_chunks
    return allowed


def posenc_host(length, dim, pos0=0):
    """Rows [pos0, pos0+length) of the sinusoidal table as float32 numpy,
    byte-identical to the JAX package's table."""
    pos = np.arange(pos0, pos0 + length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@lru_cache(maxsize=16)
def _posenc_table(rows: int, dim: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(posenc_host(rows, dim), device=device)


def _posenc(length: int, dim: int, device) -> torch.Tensor:
    """The first `length` rows of the table on `device`. A row depends only
    on its position, so rows sliced from a longer table (kept per
    power-of-two size, so that a decode loop's growing lengths reuse one)
    are the same bytes as posenc_host(length, dim)."""
    rows = max(256, 1 << (length - 1).bit_length())
    return _posenc_table(rows, dim, torch.device(device))[:length]


def scalar_as(value: float, dtype: torch.dtype) -> float:
    """A Python float rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the dtype of the array it multiplies (a no-op in effect at
    float32, where torch rounds the scalar the same way)."""
    return float(torch.tensor(value, dtype=dtype))


def _embed_scale(h: torch.Tensor, adim: int) -> torch.Tensor:
    """h * sqrt(adim) + sinusoidal positions, in h's own dtype."""
    pe = _posenc(h.shape[1], adim, h.device).to(h.dtype)
    return h * scalar_as(float(np.sqrt(adim)), h.dtype) + pe[None]


class Dense(nn.Linear):
    """A Linear that computes as flax's Dense(dtype=cdtype): with a compute
    dtype, the input, kernel and bias are cast to it and the bias is added
    after the product; with None, F.linear in the parameters' float32."""

    def __init__(self, in_features: int, out_features: int, cdtype=None, *, device=None):
        super().__init__(in_features, out_features, device=device)
        self.cdtype = cdtype

    def forward(self, x):
        if self.cdtype is None:
            return super().forward(x)
        c = self.cdtype
        return x.to(c) @ self.weight.to(c).T + self.bias.to(c)


class _CastConv:
    """flax's Conv(dtype=cdtype) for a torch conv subclass: input, kernel
    and bias cast to the compute dtype, the bias added after the conv."""

    def __init__(self, *args, cdtype=None, **kw):
        super().__init__(*args, **kw)
        self.cdtype = cdtype

    def forward(self, x):
        if self.cdtype is None:
            return super().forward(x)
        c = self.cdtype
        y = self._conv_forward(x.to(c), self.weight.to(c), None)
        return y + self.bias.to(c).view(-1, *[1] * (y.dim() - 2))


class Conv1d(_CastConv, nn.Conv1d):
    pass


class Conv2d(_CastConv, nn.Conv2d):
    pass


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: epsilon 1e-6, variance E[x^2] - E[x]^2. With
    a compute dtype (flax's dtype=), the statistics and the affine are
    taken in float32 and the result is cast to it."""

    def __init__(self, dim: int, eps: float = 1e-6, cdtype=None, *, device=None):
        super().__init__()
        self.eps = eps
        self.cdtype = cdtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        if self.cdtype is not None:
            return self._normalize(x.float()).to(self.cdtype)
        return self._normalize(x)

    def _normalize(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MultiHeadAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention(num_heads, qkv_features=dim,
    dtype=cdtype) without dropout. `mask` is a bool tensor broadcastable
    to (B, heads, Tq, Tk); True = attend. The logits, the softmax and the
    weighted sum are in the projections' dtype."""

    def __init__(self, dim: int, heads: int, cdtype=None, *, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"adim {dim} is not divisible by {heads} heads")
        self.heads = heads
        self.head_dim = dim // heads
        self.query = Dense(dim, dim, cdtype, device=device)
        self.key = Dense(dim, dim, cdtype, device=device)
        self.value = Dense(dim, dim, cdtype, device=device)
        self.out = Dense(dim, dim, cdtype, device=device)

    def _split(self, x):  # (B, T, D) -> (B, H, T, hd)
        # heads: all of them, or this rank's under tensor parallelism
        return x.view(x.shape[0], x.shape[1], self.heads, self.head_dim).transpose(1, 2)

    def kv(self, kv_in):
        """The keys and values of kv_in (B, T, D), each (B, H, T, hd)."""
        return self._split(self.key(kv_in)), self._split(self.value(kv_in))

    def attend(self, q_in, k, v, mask):
        """The queries of q_in (B, Tq, D) against keys and values already
        projected (B, H, Tk, hd) under `mask` -> (B, Tq, D)."""
        B, Tq = q_in.shape[:2]
        q = self.query(q_in)
        q = self._split(q) / scalar_as(math.sqrt(self.head_dim), q.dtype)
        w = torch.where(mask, q @ k.transpose(-1, -2), torch.finfo(q.dtype).min)
        o = torch.softmax(w, dim=-1) @ v
        return self.out(o.transpose(1, 2).reshape(B, Tq, self.heads * self.head_dim))

    def forward(self, q_in, kv_in, mask, kv_cache=None, index=None):
        """kv_cache: a layer's {"k", "v"} (B, H, L, hd) cache (decode mode):
        this call's keys and values are written at [index, index + Tq) and
        the query attends to the whole cache under `mask`."""
        k, v = self.kv(kv_in)
        if kv_cache is not None:
            Tq = q_in.shape[1]
            kv_cache["k"][:, :, index : index + Tq] = k
            kv_cache["v"][:, :, index : index + Tq] = v
            k, v = kv_cache["k"], kv_cache["v"]
        return self.attend(q_in, k, v, mask)


class MHABlock(nn.Module):
    """Port of _MHABlock: pre-norm self-attention, optional cross-attention
    to `memory`, ReLU FFN, each with a residual. The caller builds the
    masks (the encoder's padding/chunk mask, the decoder's causal one)."""

    def __init__(self, cfg: TransformerASRConfig, ff_dim: int, cross: bool = False,
                 *, device=None):
        super().__init__()
        D, c = cfg.adim, cfg.cdtype
        self.norm_self = LayerNorm(D, cdtype=c, device=device)
        self.self_attn = MultiHeadAttention(D, cfg.aheads, c, device=device)
        if cross:
            self.norm_src = LayerNorm(D, cdtype=c, device=device)
            self.src_attn = MultiHeadAttention(D, cfg.aheads, c, device=device)
        self.cross = cross
        self.norm_ff = LayerNorm(D, cdtype=c, device=device)
        self.ff_in = Dense(D, ff_dim, c, device=device)
        self.ff_out = Dense(ff_dim, D, c, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, self_mask, memory=None, memory_mask=None, kv_cache=None,
                index=None):
        h = self.norm_self(x)
        x = x + self.drop(self.self_attn(h, h, self_mask, kv_cache, index))
        if self.cross:
            x = x + self.drop(self.src_attn(self.norm_src(x), memory, memory_mask))
        h = self.drop(F.relu(self.ff_in(self.norm_ff(x))))
        return x + self.drop(self.ff_out(h))

    def fixed_step(self, x, self_mask, kv, slot, cross, memory_mask):
        """A decoder block's step over fixed buffers, without dropout: x
        (N, 1, D) for N = B x K rows, its key and value written into kv
        (2, N, H, cap, hd) at the device index `slot` (1,); the B x K rows
        attend to cross (2, B, H, T2, hd), the keys and values of the B
        utterances' memory, as K query positions of their utterance."""
        h = _fixed_norm(self.norm_self, x)
        k, v = self.self_attn.kv(h)
        kv[0].index_copy_(2, slot, k)
        kv[1].index_copy_(2, slot, v)
        x = x + self.self_attn.attend(h, kv[0], kv[1], self_mask)
        q = _fixed_norm(self.norm_src, x).view(cross.shape[1], -1, x.shape[-1])  # (B, K, D)
        x = x + self.src_attn.attend(q, cross[0], cross[1], memory_mask).view(x.shape)
        return x + self.ff_out(F.relu(self.ff_in(_fixed_norm(self.norm_ff, x))))


def _fixed_norm(norm: LayerNorm, x):
    """`norm` as one kernel for the fixed-buffer step: F.layer_norm takes
    the variance in two passes where flax's LayerNorm takes E[x^2] -
    E[x]^2 in a dozen elementwise kernels; the two agree to float32
    rounding (F.layer_norm the nearer to float64), and the step's scores
    to ~1e-7 relative. With a compute dtype, statistics and affine in
    float32, as LayerNorm."""
    y = F.layer_norm(x if norm.cdtype is None else x.float(), x.shape[-1:], norm.weight,
                     norm.bias, norm.eps)
    return y if norm.cdtype is None else y.to(norm.cdtype)


def _ffn(norm, lin_in, lin_out, x, drop):
    """The conformer's macaron FFN: LayerNorm, Dense, swish, dropout,
    Dense, dropout (the caller halves it)."""
    return drop(lin_out(drop(F.silu(lin_in(norm(x))))))


def _no_drop(x):
    return x


class ConformerBlock(nn.Module):
    """Port of _ConformerBlock: x + FFN/2, pre-norm self-attention, the
    conv module (LayerNorm, padded frames zeroed, pointwise Dense to 2 x
    adim, GLU, depthwise conv over time, LayerNorm, swish, pointwise
    Dense), x + FFN/2, then a final LayerNorm. The depthwise conv pads as
    flax's "SAME" (the extra pad of an even kernel on the right) when
    attn_chunk == 0, and causally (k - 1 zeros on the left) when
    attn_chunk > 0. Submodules carry flax's names for the tree's leaves."""

    def __init__(self, cfg: TransformerASRConfig, ff_dim: int, *, device=None):
        super().__init__()
        D, k, c = cfg.adim, cfg.conv_kernel, cfg.cdtype
        self.ffn1_norm = LayerNorm(D, cdtype=c, device=device)
        self.ffn1_in = Dense(D, ff_dim, c, device=device)
        self.ffn1_out = Dense(ff_dim, D, c, device=device)
        self.mhsa_norm = LayerNorm(D, cdtype=c, device=device)
        self.mhsa = MultiHeadAttention(D, cfg.aheads, c, device=device)
        self.conv_norm = LayerNorm(D, cdtype=c, device=device)
        self.conv_pointwise_in = Dense(D, 2 * D, c, device=device)
        self.conv_depthwise = Conv1d(D, D, k, groups=D, cdtype=c, device=device)
        self.conv_mid_norm = LayerNorm(D, cdtype=c, device=device)
        self.conv_pointwise_out = Dense(D, D, c, device=device)
        self.ffn2_norm = LayerNorm(D, cdtype=c, device=device)
        self.ffn2_in = Dense(D, ff_dim, c, device=device)
        self.ffn2_out = Dense(ff_dim, D, c, device=device)
        self.final_norm = LayerNorm(D, cdtype=c, device=device)
        self.drop = nn.Dropout(cfg.dropout)
        left = k - 1 if cfg.attn_chunk > 0 else (k - 1) // 2
        self.conv_pad = (left, k - 1 - left)

    def ffn1(self, x, drop=_no_drop):
        return _ffn(self.ffn1_norm, self.ffn1_in, self.ffn1_out, x, drop)

    def ffn2(self, x, drop=_no_drop):
        return _ffn(self.ffn2_norm, self.ffn2_in, self.ffn2_out, x, drop)

    def conv_glu(self, x, valid):
        """The conv module up to the depthwise conv's input: LayerNorm,
        frames where `valid` (B, T) is False zeroed, pointwise Dense, GLU."""
        h = self.conv_norm(x) * valid[..., None].to(x.dtype)
        return F.glu(self.conv_pointwise_in(h), dim=-1)

    def conv_out(self, h):
        """The rest of the conv module on an already padded (B, T + k - 1,
        adim) input: VALID depthwise conv, LayerNorm, swish, pointwise Dense."""
        h = self.conv_depthwise(h.transpose(1, 2)).transpose(1, 2)
        return self.conv_pointwise_out(F.silu(self.conv_mid_norm(h)))

    def forward(self, x, self_mask, valid):
        x = x + 0.5 * self.ffn1(x, self.drop)
        h = self.mhsa_norm(x)
        x = x + self.drop(self.mhsa(h, h, self_mask))
        h = F.pad(self.conv_glu(x, valid), (0, 0, *self.conv_pad))
        x = x + self.drop(self.conv_out(h))
        x = x + 0.5 * self.ffn2(x, self.drop)
        return self.final_norm(x)


def subsampled_length(lengths: torch.Tensor) -> torch.Tensor:
    """Frames after two VALID stride-2 3x3 convs; 0 below 7 input frames."""
    half = torch.div(lengths - 1, 2, rounding_mode="floor")
    return torch.div(half - 1, 2, rounding_mode="floor").clamp_min(0)


class Conv2dSubsampling(nn.Module):
    """ESPnet-style conv2d input layer: two stride-2 VALID 3x3 convs with
    ReLU, then a Dense to adim. Subsampled frame j depends only on input
    frames 4j..4j+6, so batch padding never reaches a valid frame."""

    def __init__(self, idim: int, adim: int, cdtype=None, *, device=None):
        super().__init__()
        if idim < 7:
            raise ValueError(f"Conv2dSubsampling needs at least 7 feature dims; got {idim}")
        d2 = ((idim - 1) // 2 - 1) // 2
        self.conv0 = Conv2d(1, adim, 3, stride=2, cdtype=cdtype, device=device)
        self.conv1 = Conv2d(adim, adim, 3, stride=2, cdtype=cdtype, device=device)
        self.out = Dense(d2 * adim, adim, cdtype, device=device)

    def forward(self, x, lengths):
        B, T, D = x.shape
        if T < 7 or D < 7:
            raise ValueError(
                "Conv2dSubsampling (VALID convs) needs at least 7 frames "
                f"and 7 feature dims for one output; got (T={T}, D={D}). "
                "Pad or skip shorter utterances."
            )
        h = F.relu(self.conv0(x[:, None]))
        h = F.relu(self.conv1(h))  # (B, C, T2, D2)
        _, C, T2, D2 = h.shape
        # flax flattens (B, T2, D2, C) channel-minor
        h = self.out(h.permute(0, 2, 3, 1).reshape(B, T2, D2 * C))
        return h, subsampled_length(lengths)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: TransformerASRConfig, idim: int, *, device=None):
        super().__init__()
        if cfg.encoder_type not in ("transformer", "conformer"):
            raise ValueError(f"encoder_type={cfg.encoder_type!r}: use 'transformer' or "
                             "'conformer'")
        self.cfg = cfg
        self.conformer = cfg.encoder_type == "conformer"
        block = ConformerBlock if self.conformer else MHABlock
        self.embed = Conv2dSubsampling(idim, cfg.adim, cfg.cdtype, device=device)
        self.layers = nn.ModuleList(
            block(cfg, cfg.eunits, device=device) for _ in range(cfg.elayers))
        self.after_norm = LayerNorm(cfg.adim, cdtype=cfg.cdtype, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, feats, lengths):
        c = self.cfg
        h, out_len = self.embed(feats, lengths)
        h = self.drop(_embed_scale(h, c.adim))
        T2 = h.shape[1]
        mask = torch.arange(T2, device=h.device)[None, :] < out_len[:, None]
        self_mask = mask[:, None, None, :]
        if c.attn_chunk > 0:
            self_mask = self_mask & chunk_attention_mask(
                T2, c.attn_chunk, c.attn_left_chunks, device=h.device)[None, None]
        for layer in self.layers:
            h = layer(h, self_mask, mask) if self.conformer else layer(h, self_mask)
        return self.after_norm(h), out_len


def _head(linear: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    """A logit head: flax's Dense(dtype=None) promotes bfloat16 activations
    to its float32 parameters' dtype."""
    return linear(h.to(linear.weight.dtype))


class TransformerDecoder(nn.Module):
    """Full-prefix decoder: tokens (N, U) with -1 padding -> logits (N, U, V);
    `step` is one KV-cached step of decode mode."""

    def __init__(self, cfg: TransformerASRConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.adim, device=device)
        self.layers = nn.ModuleList(
            MHABlock(cfg, cfg.dunits, cross=True, device=device)
            for _ in range(cfg.dlayers))
        self.after_norm = LayerNorm(cfg.adim, cdtype=cfg.cdtype, device=device)
        # the logit head computes in float32 on the promoted activations
        self.output = nn.Linear(cfg.adim, cfg.vocab_size, device=device)
        self.drop = nn.Dropout(cfg.dropout)

    def _embed(self, tokens):
        """flax's Embed(dtype=cdtype): rows of the table cast to it."""
        w = self.embed.weight
        return F.embedding(tokens.clamp_min(0), w if self.cfg.cdtype is None
                           else w.to(self.cfg.cdtype))

    def forward(self, tokens, memory, memory_len):
        U = tokens.shape[1]
        dev = tokens.device
        h = self.drop(_embed_scale(self._embed(tokens), self.cfg.adim))
        causal = torch.ones(U, U, dtype=torch.bool, device=dev).tril()
        self_mask = (tokens != -1)[:, None, None, :] & causal[None, None]
        mem_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                    < memory_len[:, None])[:, None, None, :]
        for layer in self.layers:
            h = layer(h, self_mask, memory, mem_mask)
        return _head(self.output, self.after_norm(h))

    def init_cache(self, batch: int, length: int, device):
        """A zero key/value cache of `length` positions for each layer, in
        the compute dtype (the key/value projections'), its index at 0."""
        H = self.cfg.aheads
        shape = (batch, H, length, self.cfg.adim // H)
        dtype = self.cfg.cdtype or torch.float32
        return {"index": 0, "layers": [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in self.layers]}

    def step(self, last_tokens, pos: int, memory, memory_len, cache, pe_len: int = 4096):
        """One decode-mode step: last_tokens (N, 1) at position `pos` ->
        logits (N, 1, V); writes each layer's key and value at the cache
        index, then advances it."""
        if not 0 <= pos < pe_len:
            raise ValueError(f"position {pos} is outside the {pe_len}-row "
                             "positional table")
        index = cache["index"]
        L = cache["layers"][0]["k"].shape[2]
        if index >= L:
            raise ValueError(f"the decode cache holds {L} positions; step {index} "
                             "is past its end")
        dev = last_tokens.device
        h = self._embed(last_tokens)
        pe = _posenc(pos + 1, self.cfg.adim, dev)[pos].to(h.dtype)
        h = self.drop(h * scalar_as(float(np.sqrt(self.cfg.adim)), h.dtype) + pe)
        self_mask = (torch.arange(L, device=dev) <= index)[None, None, None, :]
        mem_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                    < memory_len[:, None])[:, None, None, :]
        for layer, kv in zip(self.layers, cache["layers"]):
            h = layer(h, self_mask, memory, mem_mask, kv, index)
        cache["index"] = index + 1
        return _head(self.output, self.after_norm(h))

    def fixed_buffers(self, batch: int, beams: int, cap: int, frames: int, device):
        """The fixed buffers of `fixed_step` for `batch` utterances of
        `frames` memory frames, `beams` rows each, and `cap` positions:
        "cache" (dlayers, 2, batch * beams, H, cap, hd) self-attention keys
        and values, "cross" (dlayers, 2, batch, H, frames, hd) the memory's
        cross-attention keys and values, both in the compute dtype;
        "memory_mask" (batch, 1, 1, frames); "pe" the first `cap` rows of
        the sinusoidal table and "slots" arange(cap), owned by the buffers
        (a captured graph reads every tensor where it was at capture)."""
        attn = self.layers[0].self_attn
        H, hd, L = attn.heads, attn.head_dim, len(self.layers)
        dtype = self.cfg.cdtype or torch.float32
        return {
            "cache": torch.zeros((L, 2, batch * beams, H, cap, hd), dtype=dtype, device=device),
            "cross": torch.zeros((L, 2, batch, H, frames, hd), dtype=dtype, device=device),
            "memory_mask": torch.zeros((batch, 1, 1, frames), dtype=torch.bool, device=device),
            "pe": torch.as_tensor(posenc_host(cap, self.cfg.adim), device=device),
            "slots": torch.arange(cap, device=device)}

    def fixed_load(self, bufs, memory, memory_len):
        """One search's inputs into `bufs`: the cache zeroed, and each layer's
        cross-attention keys and values projected once from memory (B, T2,
        D), one row per utterance."""
        bufs["cache"].zero_()
        for layer, cross in zip(self.layers, bufs["cross"]):
            k, v = layer.src_attn.kv(memory)
            cross[0].copy_(k)
            cross[1].copy_(v)
        frames = torch.arange(memory.shape[1], device=memory.device)
        bufs["memory_mask"].copy_((frames[None, :] < memory_len[:, None])[:, None, None, :])

    def fixed_step(self, last_tokens, slot, bufs):
        """One KV-cached step over the fixed buffers: last_tokens (N,) at the
        position held by the device tensor `slot` (1,) -> logits (N, V).
        The step's keys and values go to cache slot `slot`; slots past it
        are masked. No host sync and no shape that depends on the step, so
        a CUDA graph can hold it."""
        h = self._embed(last_tokens)[:, None]  # (N, 1, D)
        pe = bufs["pe"].index_select(0, slot).to(h.dtype)
        h = h * scalar_as(float(np.sqrt(self.cfg.adim)), h.dtype) + pe
        self_mask = (bufs["slots"] <= slot)[None, None, None, :]
        for layer, kv, cross in zip(self.layers, bufs["cache"], bufs["cross"]):
            h = layer.fixed_step(h, self_mask, kv, slot, cross, bufs["memory_mask"])
        return _head(self.output, _fixed_norm(self.after_norm, h))[:, 0]

    @staticmethod
    def fixed_reorder(bufs, rows):
        """The cache's rows taken at `rows` (the surviving beams' parents),
        in place."""
        cache = bufs["cache"]
        cache.copy_(cache.index_select(2, rows))


class TransformerASR(nn.Module):
    """Joint CTC/attention model: `forward` returns (ctc_logits,
    dec_logits, enc_len); `encode` and `decode_step` serve inference.

    `idim` is the feature dimension (flax infers it from the first input).
    `device` defaults to "cuda" and raises without a card; pass "cpu" to
    build the model on the CPU. On CUDA it sets the matmul flags
    process-wide (device.configure_cuda): no TF32, and bfloat16 products
    reduced in float32, as XLA computes them.
    """

    def __init__(self, cfg: TransformerASRConfig = TransformerASRConfig(),
                 idim: int = 80, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg, idim, device=dev)
        self.decoder = TransformerDecoder(cfg, device=dev)
        # the CTC head computes in float32 on the promoted activations
        self.ctc_head = nn.Linear(cfg.adim, cfg.vocab_size, device=dev)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw every parameter from the distribution the JAX model's `init`
        draws it from (flax's defaults), from `generator` (a CPU
        torch.Generator), module by module in a fixed order."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                flax_init.dense_(m, generator)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
                # a depthwise conv's fan_in is its kernel width x 1 channel
                fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
                flax_init.lecun_normal_(m.weight, fan_in, generator)
                flax_init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                flax_init.normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim), generator)
            elif isinstance(m, LayerNorm):
                flax_init.ones_(m.weight)
                flax_init.zeros_(m.bias)

    def forward(self, feats, lengths, tokens_in):
        memory, enc_len = self.encoder(feats, lengths)
        dec_logits = self.decoder(tokens_in, memory, enc_len)
        return _head(self.ctc_head, memory), dec_logits, enc_len

    def encode(self, feats, lengths):
        """(B, T, idim), (B,) -> memory (B, T2, adim), enc_len (B,),
        ctc_logits (B, T2, vocab); without dropout in either mode, as the
        JAX `encode` runs deterministically."""
        with span("asr.encode"), _eval_mode(self):
            memory, enc_len = self.encoder(feats, lengths)
            return memory, enc_len, _head(self.ctc_head, memory)

    def decode_step(self, tokens, memory, enc_len):
        """Full-prefix decoder pass, without dropout: the scores for the
        next token are logits[:, -1] (or at the last filled position of a
        -1-padded buffer)."""
        with _eval_mode(self):
            return self.decoder(tokens, memory, enc_len)

    def decode_init_cache(self, dummy_tokens, memory, enc_len):
        """The decode-mode cache sized by dummy_tokens (N, max_len + 1): zero
        keys and values of the compute dtype on memory's device, index 0
        (what the JAX method creates under mutable=['cache']; the full pass
        it also runs is discarded there)."""
        del enc_len
        return self.decoder.init_cache(dummy_tokens.shape[0], dummy_tokens.shape[1],
                                       memory.device)

    def decode_incremental(self, last_tokens, pos, memory, enc_len, cache, pe_len=4096):
        """One KV-cached decoder step, without dropout: last_tokens (N, 1) at
        position `pos` -> logits (N, 1, V), `cache` advanced in place. The
        scores equal decode_step's at that position; pe_len must exceed the
        largest position (the caller's max_len)."""
        with _eval_mode(self):
            return self.decoder.step(last_tokens, int(pos), memory, enc_len, cache,
                                     pe_len=pe_len)

    @staticmethod
    def reorder_cache(cache, rows):
        """The decode-mode cache with each layer's keys and values taken at
        `rows` (the surviving beams' parents); the index is shared."""
        return {"index": cache["index"],
                "layers": [{k: v[rows] for k, v in kv.items()} for kv in cache["layers"]]}

    def decode_fixed_buffers(self, batch, beams, cap, frames, device):
        """The fixed buffers of decode_fixed_step (TransformerDecoder.
        fixed_buffers): a search of `batch` utterances, `beams` rows each,
        over `frames` memory frames and `cap` >= max_len + 1 positions."""
        return self.decoder.fixed_buffers(batch, beams, cap, frames, device)

    def decode_fixed_load(self, bufs, memory, enc_len):
        """One search's memory (B, T2, D) into `bufs`: the cross-attention
        keys and values projected once an utterance, the cache zeroed."""
        with torch.no_grad():
            self.decoder.fixed_load(bufs, memory, enc_len)

    def decode_fixed_step(self, last_tokens, slot, bufs):
        """One KV-cached decoder step over fixed buffers, without dropout
        and without gradients: last_tokens (N,) at the position in the
        device tensor `slot` (1,) -> logits (N, V). Equal to decode_step's
        at that position, and free of host syncs, so that the beam search
        can capture it in a CUDA graph."""
        with torch.no_grad():
            return self.decoder.fixed_step(last_tokens, slot, bufs)

    @staticmethod
    def decode_fixed_reorder(bufs, rows):
        """The fixed cache's rows taken at `rows`, in place."""
        TransformerDecoder.fixed_reorder(bufs, rows)


@contextmanager
def _eval_mode(module: nn.Module):
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


def greedy_ctc(ctc_logits, enc_len, blank_id=0):
    """Best-path CTC decode (host-side collapse): a token list per row."""
    ids = torch.as_tensor(ctc_logits).argmax(-1).cpu().numpy()
    out = []
    for b in range(ids.shape[0]):
        seq = []
        prev = -1
        for t in range(int(enc_len[b])):
            i = int(ids[b, t])
            if i != prev and i != blank_id:
                seq.append(i)
            prev = i
        out.append(seq)
    return out


# ------------------------------------------------------------------ training


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id=0,
             log_epsilon=-1e5):
    """Per-sequence CTC loss (B,), as optax.ctc_loss computes it.

    logits (B, T, K); logit_paddings (B, T) and label_paddings (B, N) are 1.0
    at padded positions (labels right-padded); labels (B, N) int. The
    forward recursion is optax's: log-alphas of the blank and label states
    start at `log_epsilon` (an approximation of log 0) instead of -inf, a
    label repeated back to back must pass through a blank (the direct
    transition costs log_epsilon), and padded frames carry the state over.
    So a row whose labels cannot fit its frames gets a large finite loss
    (~ -log_epsilon) with a finite gradient where torch's F.ctc_loss gives
    inf. Autograd runs through the recursion: one set of small kernels per
    frame.
    """
    B, T, K = logits.shape
    N = labels.shape[1]
    dt = logits.dtype
    logprobs = torch.log_softmax(logits, -1)
    labels = labels.long()
    labellens = N - label_paddings.sum(1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    lp_phi = logprobs[:, :, blank_id : blank_id + 1].transpose(0, 1)  # (T, B, 1)
    lp_emit = logprobs.gather(2, labels[:, None, :].expand(B, T, N)).transpose(0, 1)
    pads = logit_paddings.to(dt).transpose(0, 1)[..., None]  # (T, B, 1)

    phi = torch.full((B, N + 1), log_epsilon, dtype=dt, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=dt, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    for t in range(T):
        prev_phi = phi
        phi_in = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(phi_in[:, :-1] + lp_emit[t], emit + lp_emit[t])
        next_phi = update_phi(phi_in + lp_phi[t],
                              emit + lp_phi[t] + log_epsilon * (1.0 - repeat))
        pad = pads[t]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -phi_last.gather(1, labellens[:, None])[:, 0]


def joint_loss(ctc_logits, dec_logits, enc_len, batch, cfg: TransformerASRConfig):
    """mtlalpha * CTC / token length + (1 - mtlalpha) * label-smoothed CE
    over the token_len + 1 positions (eos at token_len), as the JAX
    `_joint_loss`. Label smoothing is lsm_weight * -mean(logp) over the
    whole vocabulary, blank included. Returns (loss, {"ctc", "att"}).
    Under parallel.collectives.reduce_over(data group) both means are over
    the global batch (the sums and the counts reduced over the group), as
    GSPMD computes them for a batch sharded over 'data'."""
    tokens, token_len = batch["tokens"], batch["token_lengths"]
    U = tokens.shape[1]
    dev = tokens.device
    pos = torch.arange(U, device=dev)[None, :]
    tok_padmask = (pos >= token_len[:, None]).float()
    enc_padmask = (torch.arange(ctc_logits.shape[1], device=dev)[None, :]
                   >= enc_len[:, None]).float()
    ctc = ctc_loss(ctc_logits, enc_padmask, tokens.clamp_min(0), tok_padmask,
                   blank_id=cfg.blank_id)
    ctc = global_mean(ctc / token_len.clamp_min(1))
    tgt = torch.where(pos == token_len[:, None], cfg.eos_id, tokens)
    valid = (pos <= token_len[:, None]).float()
    logp = torch.log_softmax(dec_logits, -1)
    nll = -logp.gather(-1, tgt.clamp_min(0).long()[..., None])[..., 0]
    smooth = -logp.mean(-1)
    ce = (1 - cfg.lsm_weight) * nll + cfg.lsm_weight * smooth
    att = global_ratio((ce * valid).sum(), valid.sum().clamp_min(1))
    loss = cfg.mtlalpha * ctc + (1 - cfg.mtlalpha) * att
    return loss, {"ctc": ctc, "att": att}


def decoder_inputs(tokens, token_len, sos_id):
    """sos + tokens[:, :-1], with -1 past position token_len (the decoder's
    padding)."""
    B, U = tokens.shape
    sos = torch.full((B, 1), sos_id, dtype=tokens.dtype, device=tokens.device)
    tokens_in = torch.cat([sos, tokens[:, :-1]], dim=1)
    pos = torch.arange(U, device=tokens.device)[None, :]
    return torch.where(pos <= token_len[:, None], tokens_in, -1)


def asr_loss(model: TransformerASR, batch, cfg: TransformerASRConfig, train=True):
    """The joint loss of one batch (feats, lengths, tokens, token_lengths);
    dropout is on when `train` (the module is put in that mode)."""
    model.train(train)
    tokens_in = decoder_inputs(batch["tokens"], batch["token_lengths"], cfg.sos_id)
    ctc_logits, dec_logits, enc_len = model(batch["feats"], batch["lengths"], tokens_in)
    return joint_loss(ctc_logits, dec_logits, enc_len, batch, cfg)


def noam_schedule(adim, warmup=25000, factor=10.0):
    """ESPnet noam: factor * adim^-0.5 * min(step^-0.5, step*warmup^-1.5),
    with step clamped to >= 1 (a Python function of the step count)."""

    def sched(step):
        step = max(int(step), 1)
        return factor * adim**-0.5 * min(step**-0.5, step * warmup**-1.5)

    return sched


def average_checkpoints(param_list):
    """Average dicts of tensors key by key (run_fdlp_e1.sh:495-505
    average_checkpoints equivalent)."""
    n = len(param_list)
    return {k: sum(p[k] for p in param_list) / n for k in param_list[0]}


@torch.no_grad()
def cl_decode(models, pm_scores, feats, lengths, cfg: TransformerASRConfig, beam_size: int = 10,
              max_len: int = 100, beta: float = 300.0):
    """Continual-learning decode (the JAX cl_decode; asr_recog --api cl,
    run_cl_2stream.sh:250-254) of one utterance: task weights
    w = exp(beta * pm) / sum from the PM scores, then one beam search whose
    step scores are sum_k w_k log_softmax(model_k's full-prefix decoder
    logits). A finished beam can only append eos (at no cost); the ranking
    is jax.lax.top_k's (decode/beam_jit.py::_top_k), and the search stops
    once every beam has finished. As in the JAX function, zip pairs the
    weights with the models, so a shorter `pm_scores` drops the models past
    its end. feats (1, T, D), lengths (1,) -> the best hypothesis' tokens,
    without sos and eos."""
    from speech_recognition_tools_tpu_torch.decode.beam_jit import _top_k

    w = np.exp(beta * np.asarray(pm_scores, np.float64))
    w = w / w.sum()
    K, V, dev = beam_size, cfg.vocab_size, feats.device
    mem_b = []
    for model in models:
        memory, enc_len, _ = model.encode(feats, lengths)
        mem_b.append((model, memory.repeat_interleave(K, 0), enc_len.repeat_interleave(K, 0)))
    tokens = torch.full((K, max_len + 1), -1, dtype=torch.long, device=dev)
    tokens[:, 0] = cfg.sos_id
    scores = torch.full((K,), float("-inf"), device=dev)
    scores[0] = 0.0
    finished = torch.zeros(K, dtype=torch.bool, device=dev)
    eos_only = torch.full((K, V), float("-inf"), device=dev)
    eos_only[:, cfg.eos_id] = 0.0
    for step in range(max_len):
        logp = 0.0
        for wi, (model, memory, enc_len) in zip(w, mem_b):
            logits = model.decode_step(tokens[:, : step + 1], memory, enc_len)[:, step]
            logp = logp + float(wi) * F.log_softmax(logits.float(), dim=-1)
        logp = torch.where(finished[:, None], eos_only, logp)
        top_scores, top_idx = _top_k((scores[:, None] + logp).reshape(1, -1), K)
        beam_idx, tok_idx = top_idx[0] // V, top_idx[0] % V
        tokens = tokens[beam_idx]
        tokens[:, step + 1] = tok_idx
        scores = top_scores[0]
        finished = finished[beam_idx] | (tok_idx == cfg.eos_id)
        if bool(finished.all()):
            break
    best = int(torch.argmax(scores))
    return [t for t in tokens[best, 1:].tolist() if t >= 0 and t != cfg.eos_id]


# ------------------------------------------------------------- parallel paths


def _block_call(block, x, valid, cfg: TransformerASRConfig):
    """One encoder block on (B, T, adim) with the (B, T) bool validity mask,
    the encoder's padding (and chunk) mask built as TransformerEncoder
    builds it."""
    self_mask = valid[:, None, None, :]
    if cfg.attn_chunk > 0:
        self_mask = self_mask & chunk_attention_mask(
            x.shape[1], cfg.attn_chunk, cfg.attn_left_chunks, device=x.device)[None, None]
    if isinstance(block, ConformerBlock):
        return block(x, self_mask, valid)
    return block(x, self_mask)


def _stem(model: TransformerASR, feats, lengths):
    """Conv subsampling and the scaled positions: (h, enc_len)."""
    h, out_len = model.encoder.embed(feats, lengths)
    return _embed_scale(h, model.cfg.adim), out_len


def pipeline_stage(model: TransformerASR, mesh, axis: str = "pipe") -> nn.ModuleList:
    """This rank's stage of `model`'s encoder blocks: the elayers / S blocks
    [s*per, (s+1)*per) of pipe coordinate s (elayers must divide)."""
    S, L = mesh.size(axis), model.cfg.elayers
    if L % S:
        raise ValueError(f"elayers {L} not divisible by {S} stages")
    per = L // S
    s = mesh.index(axis)
    return nn.ModuleList(model.encoder.layers[s * per:(s + 1) * per])


def encode_pipelined(model: TransformerASR, feats, lengths, mesh, *, n_micro: int = 2,
                     axis: str = "pipe"):
    """`model.encode` with the encoder blocks run as GPipe stages over the
    mesh's `axis` (parallel/pp.py): rank s applies only its elayers / S
    blocks; the stem, after_norm and ctc_head run on every rank. Returns
    (memory, enc_len, ctc_logits) on every rank, equal to `encode` to
    float rounding."""
    from speech_recognition_tools_tpu_torch.parallel.pp import (
        microbatch,
        pipeline_apply,
        unmicrobatch,
    )

    c = model.cfg
    stage = pipeline_stage(model, mesh, axis)
    with _eval_mode(model):
        h, out_len = _stem(model, feats, lengths)
        mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < out_len[:, None]).to(h.dtype)

        def run(blocks, state):
            x, m = state
            for b in blocks:
                x = _block_call(b, x, m > 0.5, c)
            return x, m

        out_h, _ = pipeline_apply(run, stage, (microbatch(h, n_micro), microbatch(mask, n_micro)),
                                  mesh=mesh, axis=axis)
        memory = model.encoder.after_norm(unmicrobatch(out_h))
        return memory, out_len, _head(model.ctc_head, memory)


def split_pipeline_params(sd: dict, n_stages: int):
    """Loop-layout state dict -> (rest, stacked): `stacked` maps each
    encoder block parameter name (e.g. "self_attn.query.weight") to an
    (n_stages, per, ...) tensor, block i * per + j at [i, j]; `rest` is the
    state dict without the encoder blocks. Exact inverse:
    `merge_pipeline_params` (the JAX function's layout: stage-major)."""
    pre = "encoder.layers."
    idx = sorted({int(k[len(pre):].split(".")[0]) for k in sd if k.startswith(pre)})
    L = len(idx)
    if L % n_stages:
        raise ValueError(f"elayers {L} not divisible by {n_stages} stages")
    per = L // n_stages
    names = [k[len(pre) + 2:] for k in sd if k.startswith(pre + "0.")]
    stacked = {n: torch.stack([torch.stack([sd[f"{pre}{i * per + j}.{n}"] for j in range(per)])
                               for i in range(n_stages)]) for n in names}
    rest = {k: v for k, v in sd.items() if not k.startswith(pre)}
    return rest, stacked


def merge_pipeline_params(rest: dict, stacked: dict) -> dict:
    """Inverse of split_pipeline_params (bit-exact): the loop-layout state
    dict, in the order TransformerASR.state_dict() lists it."""
    first = next(iter(stacked.values()))
    S, per = first.shape[:2]
    blocks = {f"encoder.layers.{i * per + j}.{n}": v[i, j]
              for i in range(S) for j in range(per) for n, v in stacked.items()}
    out = {}
    for k, v in rest.items():
        if k.startswith("encoder.after_norm") and blocks:
            out.update(blocks)
            blocks = {}
        out[k] = v
    out.update(blocks)
    return out


def _is_param_dict(v) -> bool:
    return isinstance(v, dict) and any(k.startswith("encoder.") for k in v)


def pp_opt_state_from_loop(opt_state: dict, n_stages: int) -> dict:
    """An optimizer state over loop-layout parameters (train/optim.py's
    dicts: count, moments keyed like the state dict) -> the same with every
    moment dict split as {"rest": ..., "stacked": ...} for n_stages (the
    stage count may differ from the one that wrote it)."""
    out = {}
    for k, v in opt_state.items():
        if _is_param_dict(v):
            r, s = split_pipeline_params(v, n_stages)
            v = {"rest": r, "stacked": s}
        out[k] = v
    return out


def pp_opt_state_to_loop(opt_state: dict) -> dict:
    """Inverse of pp_opt_state_from_loop (bit-exact)."""
    return {k: (merge_pipeline_params(v["rest"], v["stacked"])
                if isinstance(v, dict) and set(v) == {"rest", "stacked"} else v)
            for k, v in opt_state.items()}


@contextmanager
def _seeded(key: int, device):
    """Within the context the global generators (the CPU one and `device`'s)
    draw from `key`; they are restored on exit."""
    with torch.random.fork_rng(devices=[device] if torch.device(device).type == "cuda" else []):
        torch.manual_seed(key % (2**63 - 1))
        yield


def _fold(seed: int, *xs: int) -> int:
    h = int(seed) & 0xFFFFFFFF
    for x in xs:
        h = (h * 1000003 + int(x) + 1) % (2**61 - 1)
    return h


def asr_loss_pipelined(model: TransformerASR, stage: nn.ModuleList, batch, cfg, mesh, *,
                       n_micro: int = 2, axis: str = "pipe", seed: int | None = None,
                       data_axis: str | None = None):
    """`asr_loss` with the encoder blocks trained as GPipe stages
    (parallel/pp.py): `stage` is this rank's blocks (pipeline_stage), and
    `model` supplies the stem, after_norm, ctc_head and decoder (its own
    encoder blocks are not used). `loss.backward()` through the hops gives
    both the stage's and the replicated modules' gradients.

    seed=None runs deterministic (== asr_loss with train=False). With a
    seed, dropout is on everywhere: the positional and decoder dropouts
    draw from streams folded from the seed, and each microbatch's mask in
    each block from one folded from (seed, microbatch, block, data shard),
    so every (microbatch, layer) pair gets its own reproducible mask.

    data_axis: DP x PP; `batch` is the whole batch, and this data shard
    takes its 1/dp of the examples of every microbatch (as the JAX
    function shards the microbatch examples over 'data'); the two means of
    the loss are then over the whole batch (collectives.reduce_over).

    Returns (loss, aux) like asr_loss.
    """
    from speech_recognition_tools_tpu_torch.parallel import collectives
    from speech_recognition_tools_tpu_torch.parallel.pp import (
        microbatch,
        pipeline_apply,
        unmicrobatch,
    )

    c = cfg
    train = seed is not None
    model.train(train)
    stage.train(train)
    if data_axis is not None and mesh.size(data_axis) > 1:
        dp, d = mesh.size(data_axis), mesh.index(data_axis)
        B = batch["feats"].shape[0]
        mb = B // n_micro
        if B % n_micro or mb % dp:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches "
                             f"over {dp} data shards")
        mbl = mb // dp
        rows = torch.cat([torch.arange(m * mb + d * mbl, m * mb + (d + 1) * mbl)
                          for m in range(n_micro)]).to(batch["feats"].device)
        batch = {k: v[rows] for k, v in batch.items()}
        group = mesh.group(data_axis)
        d_idx = d
    else:
        group, d_idx = None, 0
    dev = batch["feats"].device
    per = len(stage)
    s_idx = mesh.index(axis)

    with _seeded(_fold(seed, 0), dev) if train else nullcontext():
        h, enc_len = model.encoder.embed(batch["feats"], batch["lengths"])
        h = model.encoder.drop(_embed_scale(h, c.adim))
    mask = (torch.arange(h.shape[1], device=dev)[None, :] < enc_len[:, None]).to(h.dtype)
    mbi = torch.arange(n_micro, device=dev)[:, None].expand(n_micro, h.shape[0] // n_micro)

    def run(blocks, state):
        x, m, mi = state
        mb_index = int(mi[0]) if train else 0
        for j, b in enumerate(blocks):
            if train:
                with _seeded(_fold(seed, 2, mb_index, s_idx * per + j, d_idx), dev):
                    x = _block_call(b, x, m > 0.5, c)
            else:
                x = _block_call(b, x, m > 0.5, c)
        return x, m, mi

    out_h, _, _ = pipeline_apply(
        run, stage, (microbatch(h, n_micro), microbatch(mask, n_micro), mbi),
        mesh=mesh, axis=axis)
    memory = model.encoder.after_norm(unmicrobatch(out_h))
    ctc_logits = _head(model.ctc_head, memory)
    tokens_in = decoder_inputs(batch["tokens"], batch["token_lengths"], c.sos_id)
    with _seeded(_fold(seed, 1), dev) if train else nullcontext():
        dec_logits = model.decoder(tokens_in, memory, enc_len)
    with collectives.reduce_over(group):
        return joint_loss(ctc_logits, dec_logits, enc_len, batch, c)


def _ring_attention_block(attn: MultiHeadAttention, h, lengths, mesh, axis):
    """MultiHeadAttention's self-attention on this rank's block of rows with
    the scores routed through the time ring (parallel/ring.py)."""
    from speech_recognition_tools_tpu_torch.parallel.ring import ring_attention

    B, Tl = h.shape[:2]
    H, hd = attn.heads, attn.head_dim

    def split(x):
        return x.view(B, Tl, H, hd)

    o = ring_attention(split(attn.query(h)), split(attn.key(h)), split(attn.value(h)),
                       lengths, mesh=mesh, axis=axis, sharded=True)
    return attn.out(o.reshape(B, Tl, H * hd))


def _ring_block(block, x, lengths, Tl, mesh, axis, cfg):
    """One encoder block on this rank's rows of the time-sharded sequence:
    attention through the ring, the conformer's depthwise conv with a halo
    of its kernel's reach from each neighbour (zeros past the ends, as the
    unsharded SAME padding of the padded sequence)."""
    from speech_recognition_tools_tpu_torch.parallel import collectives

    if isinstance(block, MHABlock):
        x = x + _ring_attention_block(block.self_attn, block.norm_self(x), lengths, mesh, axis)
        return x + block.ff_out(F.relu(block.ff_in(block.norm_ff(x))))
    i = mesh.index(axis)
    valid = (i * Tl + torch.arange(Tl, device=x.device))[None, :] < lengths[:, None]
    x = x + 0.5 * block.ffn1(x)
    x = x + _ring_attention_block(block.mhsa, block.mhsa_norm(x), lengths, mesh, axis)
    h = block.conv_glu(x, valid)
    lp, rp = block.conv_pad
    if Tl >= max(lp, rp, 1):
        left, right = collectives.halo_exchange(h[:, :max(rp, 1)].contiguous(),
                                                h[:, Tl - max(lp, 1):].contiguous(),
                                                mesh.group(axis))
        h = torch.cat([left[:, left.shape[1] - lp:], h, right[:, :rp]], dim=1)
    else:  # the kernel reaches past the neighbours: gather the sequence
        full = F.pad(collectives.all_gather(h.contiguous(), mesh.group(axis), dim=1),
                     (0, 0, lp, rp))
        h = full[:, i * Tl:i * Tl + Tl + lp + rp]
    x = x + block.conv_out(h)
    x = x + 0.5 * block.ffn2(x)
    return block.final_norm(x)


@torch.no_grad()
def encode_ring(model: TransformerASR, feats, lengths, mesh, *, time_axis: str = "time"):
    """`model.encode` with every encoder self-attention routed through ring
    attention over the mesh's `time_axis` (the long-utterance path): the
    subsampled frames are padded to a multiple of the ring size S, rank i
    runs the blocks on its T/S rows (keys beyond `lengths` masked as in the
    unsharded mask), and the rows are all-gathered before after_norm and
    the CTC head. Returns (memory, enc_len, ctc_logits) on every rank.
    Offline (non-chunked) float32 models only, as the JAX function."""
    from speech_recognition_tools_tpu_torch.parallel import collectives

    c = model.cfg
    if c.attn_chunk > 0:
        raise ValueError("encode_ring does not support chunked (streaming) attention; "
                         "use infer/streaming_asr.py or the offline encode")
    S = mesh.size(time_axis)
    with _eval_mode(model):
        h, out_len = _stem(model, feats, lengths)
        T = h.shape[1]
        Tp = -(-T // S) * S
        h = F.pad(h, (0, 0, 0, Tp - T))
        Tl = Tp // S
        i = mesh.index(time_axis)
        x = h[:, i * Tl:(i + 1) * Tl]
        for block in model.encoder.layers:
            x = _ring_block(block, x, out_len, Tl, mesh, time_axis, c)
        x = collectives.all_gather(x.contiguous(), mesh.group(time_axis), dim=1)[:, :T]
        memory = model.encoder.after_norm(x)
        return memory, out_len, _head(model.ctc_head, memory)
