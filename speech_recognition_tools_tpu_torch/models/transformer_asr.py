"""End-to-end CTC/attention transformer ASR.

Port of speech_recognition_tools_tpu/models/transformer_asr.py:
TransformerASRConfig, chunk_attention_mask, posenc_host, _embed_scale,
_MHABlock, _ConformerBlock, Conv2dSubsampling, TransformerEncoder (either
block type), TransformerDecoder (full-prefix and KV-cached decode modes),
TransformerASR (`forward`, `encode`, `decode_step`, `decode_init_cache`,
`decode_incremental`),
greedy_ctc, and the training half: the joint CTC/attention loss
(`ctc_loss`, `joint_loss`, `asr_loss`), `noam_schedule` and
`average_checkpoints`. The reference's headline model is ESPnet's
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
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.models import flax_init


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
        self.query = Dense(dim, dim, cdtype, device=device)
        self.key = Dense(dim, dim, cdtype, device=device)
        self.value = Dense(dim, dim, cdtype, device=device)
        self.out = Dense(dim, dim, cdtype, device=device)

    def forward(self, q_in, kv_in, mask, kv_cache=None, index=None):
        """kv_cache: a layer's {"k", "v"} (B, H, L, hd) cache (decode mode):
        this call's keys and values are written at [index, index + Tq) and
        the query attends to the whole cache under `mask`."""
        B, Tq, D = q_in.shape
        H, hd = self.heads, D // self.heads

        def split(x):  # (B, T, D) -> (B, H, T, hd)
            return x.view(B, x.shape[1], H, hd).transpose(1, 2)

        q = self.query(q_in)
        q = split(q) / scalar_as(math.sqrt(hd), q.dtype)
        k = split(self.key(kv_in))
        v = split(self.value(kv_in))
        if kv_cache is not None:
            kv_cache["k"][:, :, index : index + Tq] = k
            kv_cache["v"][:, :, index : index + Tq] = v
            k, v = kv_cache["k"], kv_cache["v"]
        w = (q @ k.transpose(-1, -2)).masked_fill(~mask, torch.finfo(q.dtype).min)
        o = torch.softmax(w, dim=-1) @ v
        return self.out(o.transpose(1, 2).reshape(B, Tq, D))


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
        with _eval_mode(self):
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
    whole vocabulary, blank included. Returns (loss, {"ctc", "att"})."""
    tokens, token_len = batch["tokens"], batch["token_lengths"]
    U = tokens.shape[1]
    dev = tokens.device
    pos = torch.arange(U, device=dev)[None, :]
    tok_padmask = (pos >= token_len[:, None]).float()
    enc_padmask = (torch.arange(ctc_logits.shape[1], device=dev)[None, :]
                   >= enc_len[:, None]).float()
    ctc = ctc_loss(ctc_logits, enc_padmask, tokens.clamp_min(0), tok_padmask,
                   blank_id=cfg.blank_id)
    ctc = (ctc / token_len.clamp_min(1)).mean()
    tgt = torch.where(pos == token_len[:, None], cfg.eos_id, tokens)
    valid = (pos <= token_len[:, None]).float()
    logp = torch.log_softmax(dec_logits, -1)
    nll = -logp.gather(-1, tgt.clamp_min(0).long()[..., None])[..., 0]
    smooth = -logp.mean(-1)
    ce = (1 - cfg.lsm_weight) * nll + cfg.lsm_weight * smooth
    att = (ce * valid).sum() / valid.sum().clamp_min(1)
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
