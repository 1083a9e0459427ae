"""End-to-end CTC/attention transformer ASR, inference half.

Port of speech_recognition_tools_tpu/models/transformer_asr.py:
TransformerASRConfig, chunk_attention_mask, posenc_host, _embed_scale,
_MHABlock, Conv2dSubsampling, TransformerEncoder, TransformerDecoder (its
full-prefix mode), TransformerASR (`forward`, `encode`, `decode_step`) and
greedy_ctc. The reference's headline model is ESPnet's
e2e_asr_transformer (conf/train.yaml: 12 encoder / 6 decoder layers, adim
256, 4 heads, FFN 2048, conv2d subsampling).

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
    D2 * C, before the Dense, exactly as flax reshapes it.

io/jax_params.py::transformer_asr_from_jax carries a flax parameter tree
over. Inference only: training (and with it dropout, the joint-loss
weight and label smoothing) is not ported, so the config has no fields
for them; the compute type is float32 (bf16 raises NotImplementedError),
and the conformer encoder and the KV-cached incremental decoder are not
ported.
"""

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device


@dataclass(frozen=True)
class TransformerASRConfig:
    vocab_size: int = 52  # chars incl. <blank>=0, <sos/eos>=vocab-1
    adim: int = 256
    aheads: int = 4
    elayers: int = 12
    eunits: int = 2048
    dlayers: int = 6
    dunits: int = 2048
    encoder_type: str = "transformer"  # 'conformer' is not ported
    # chunked encoder self-attention: each frame attends within its chunk
    # of `attn_chunk` frames plus `attn_left_chunks` chunks of left context
    # (-1 = unbounded); 0 = full attention
    attn_chunk: int = 0
    attn_left_chunks: int = -1
    compute_dtype: str = "float32"  # 'bfloat16' is not ported

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


def _embed_scale(h: torch.Tensor, adim: int) -> torch.Tensor:
    """h * sqrt(adim) + sinusoidal positions."""
    return h * float(np.sqrt(adim)) + _posenc(h.shape[1], adim, h.device)[None]


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: epsilon 1e-6, variance E[x^2] - E[x]^2."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MultiHeadAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention(num_heads, qkv_features=dim)
    without dropout. `mask` is a bool tensor broadcastable to (B, heads,
    Tq, Tk); True = attend."""

    def __init__(self, dim: int, heads: int, *, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"adim {dim} is not divisible by {heads} heads")
        self.heads = heads
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, q_in, kv_in, mask):
        B, Tq, D = q_in.shape
        H, hd = self.heads, D // self.heads

        def split(x):  # (B, T, D) -> (B, H, T, hd)
            return x.view(B, x.shape[1], H, hd).transpose(1, 2)

        q = split(self.query(q_in)) / math.sqrt(hd)
        k = split(self.key(kv_in))
        v = split(self.value(kv_in))
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
        D = cfg.adim
        self.norm_self = LayerNorm(D, device=device)
        self.self_attn = MultiHeadAttention(D, cfg.aheads, device=device)
        if cross:
            self.norm_src = LayerNorm(D, device=device)
            self.src_attn = MultiHeadAttention(D, cfg.aheads, device=device)
        self.cross = cross
        self.norm_ff = LayerNorm(D, device=device)
        self.ff_in = nn.Linear(D, ff_dim, device=device)
        self.ff_out = nn.Linear(ff_dim, D, device=device)

    def forward(self, x, self_mask, memory=None, memory_mask=None):
        h = self.norm_self(x)
        x = x + self.self_attn(h, h, self_mask)
        if self.cross:
            x = x + self.src_attn(self.norm_src(x), memory, memory_mask)
        return x + self.ff_out(F.relu(self.ff_in(self.norm_ff(x))))


def subsampled_length(lengths: torch.Tensor) -> torch.Tensor:
    """Frames after two VALID stride-2 3x3 convs; 0 below 7 input frames."""
    half = torch.div(lengths - 1, 2, rounding_mode="floor")
    return torch.div(half - 1, 2, rounding_mode="floor").clamp_min(0)


class Conv2dSubsampling(nn.Module):
    """ESPnet-style conv2d input layer: two stride-2 VALID 3x3 convs with
    ReLU, then a Dense to adim. Subsampled frame j depends only on input
    frames 4j..4j+6, so batch padding never reaches a valid frame."""

    def __init__(self, idim: int, adim: int, *, device=None):
        super().__init__()
        if idim < 7:
            raise ValueError(f"Conv2dSubsampling needs at least 7 feature dims; got {idim}")
        d2 = ((idim - 1) // 2 - 1) // 2
        self.conv0 = nn.Conv2d(1, adim, 3, stride=2, device=device)
        self.conv1 = nn.Conv2d(adim, adim, 3, stride=2, device=device)
        self.out = nn.Linear(d2 * adim, adim, device=device)

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
        if cfg.encoder_type != "transformer":
            raise NotImplementedError(
                f"encoder_type={cfg.encoder_type!r} is not yet ported (transformer only)")
        self.cfg = cfg
        self.embed = Conv2dSubsampling(idim, cfg.adim, device=device)
        self.layers = nn.ModuleList(
            MHABlock(cfg, cfg.eunits, device=device) for _ in range(cfg.elayers))
        self.after_norm = LayerNorm(cfg.adim, device=device)

    def forward(self, feats, lengths):
        c = self.cfg
        h, out_len = self.embed(feats, lengths)
        h = _embed_scale(h, c.adim)
        T2 = h.shape[1]
        mask = torch.arange(T2, device=h.device)[None, :] < out_len[:, None]
        self_mask = mask[:, None, None, :]
        if c.attn_chunk > 0:
            self_mask = self_mask & chunk_attention_mask(
                T2, c.attn_chunk, c.attn_left_chunks, device=h.device)[None, None]
        for layer in self.layers:
            h = layer(h, self_mask)
        return self.after_norm(h), out_len


class TransformerDecoder(nn.Module):
    """Full-prefix decoder: tokens (N, U) with -1 padding -> logits (N, U, V)."""

    def __init__(self, cfg: TransformerASRConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.adim, device=device)
        self.layers = nn.ModuleList(
            MHABlock(cfg, cfg.dunits, cross=True, device=device)
            for _ in range(cfg.dlayers))
        self.after_norm = LayerNorm(cfg.adim, device=device)
        self.output = nn.Linear(cfg.adim, cfg.vocab_size, device=device)

    def forward(self, tokens, memory, memory_len):
        U = tokens.shape[1]
        dev = tokens.device
        h = _embed_scale(self.embed(tokens.clamp_min(0)), self.cfg.adim)
        causal = torch.ones(U, U, dtype=torch.bool, device=dev).tril()
        self_mask = (tokens != -1)[:, None, None, :] & causal[None, None]
        mem_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                    < memory_len[:, None])[:, None, None, :]
        for layer in self.layers:
            h = layer(h, self_mask, memory, mem_mask)
        return self.output(self.after_norm(h))


class TransformerASR(nn.Module):
    """Joint CTC/attention model: `forward` returns (ctc_logits,
    dec_logits, enc_len); `encode` and `decode_step` serve inference.

    `idim` is the feature dimension (flax infers it from the first input).
    `device` defaults to "cuda" and raises without a card; pass "cpu" to
    build the model on the CPU. On CUDA it switches TF32 off process-wide
    (device.configure_cuda): the JAX package computes in full float32.
    """

    def __init__(self, cfg: TransformerASRConfig = TransformerASRConfig(),
                 idim: int = 80, *, device="cuda"):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r} is not yet ported (float32 only)")
        dev = resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg, idim, device=dev)
        self.decoder = TransformerDecoder(cfg, device=dev)
        self.ctc_head = nn.Linear(cfg.adim, cfg.vocab_size, device=dev)

    def forward(self, feats, lengths, tokens_in):
        memory, enc_len = self.encoder(feats, lengths)
        dec_logits = self.decoder(tokens_in, memory, enc_len)
        return self.ctc_head(memory), dec_logits, enc_len

    def encode(self, feats, lengths):
        """(B, T, idim), (B,) -> memory (B, T2, adim), enc_len (B,),
        ctc_logits (B, T2, vocab)."""
        memory, enc_len = self.encoder(feats, lengths)
        return memory, enc_len, self.ctc_head(memory)

    def decode_step(self, tokens, memory, enc_len):
        """Full-prefix decoder pass: the scores for the next token are
        logits[:, -1] (or at the last filled position of a -1-padded
        buffer)."""
        return self.decoder(tokens, memory, enc_len)


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
