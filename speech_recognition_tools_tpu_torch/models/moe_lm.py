"""A DeepSeek-V3-style mixture-of-experts language model: multi-head latent
attention (MLA), a sigmoid router with a correction bias (DeepSeek's
`noaux_tc`), routed SwiGLU experts beside a shared one, and leading dense
layers. Moonlight-16B-A3B is one (`MoELMConfig()`'s defaults are its
config.json); the port decodes it as the speech LLM's decoder
(models/speech_llm.py).

The fields of MoELMConfig are the config.json keys. A layer is pre-norm:

    h   = x + attn(input_layernorm(x))
    out = h + mlp(post_attention_layernorm(h))

where mlp is a SwiGLU of width `intermediate_size` in the first
`first_k_dense_replace` layers and the expert layer in the others.

MLA (q_lora_rank null, as in Moonlight): q = q_proj(x) splits per head into
qk_nope_head_dim and qk_rope_head_dim parts; kv_a_proj_with_mqa(x) gives the
kv_lora_rank latent, normalised by kv_a_layernorm, and one k_pe of
qk_rope_head_dim shared by every head; kv_b_proj expands the latent to each
head's k_nope and v. Scores are (q_nope . k_nope + q_pe . k_pe) /
sqrt(qk_nope_head_dim + qk_rope_head_dim), and o_proj brings the heads'
values back to hidden_size.

RoPE is DeepSeek's convention: the rope part is first de-interleaved (its
even dims, then its odd ones: x.view(..., d/2, 2).transpose(-1, -2)), then
rotated as `x * cos + rotate_half(x) * sin` with cos, sin of
pos * theta^(-2i/d) repeated over both halves. The de-interleave is a fixed
permutation applied to q_pe and k_pe alike, so scores are those of the
interleaved (GPT-J) rotation; the rotated vectors stay in the permuted
order.

The router, in float32: s = sigmoid(x W_g^T); the top num_experts_per_tok
are chosen on s + e_score_correction_bias; their weights are the chosen s
(without the bias), normalised to sum 1 (norm_topk_prob) and multiplied by
routed_scaling_factor. With n_group = topk_group = 1 (Moonlight) the
group-limited step of noaux_tc keeps every expert; other group settings
are not ported. The routed experts' outputs are summed with those weights
and the shared experts' SwiGLU (width n_shared_experts *
moe_intermediate_size) is added.

Precision (`dtype` "bfloat16", the published one): weights and products in
bfloat16; RMSNorm statistics, the router, the correction bias, RoPE, the
attention softmax and the weighted sum of the experts in float32; the
head's bfloat16 logits are returned in float32, as the published model
returns them. `dtype` "float32" computes everything in float32.

The expert layer routes on the device, with no host synchronisation: the
token-expert assignments are sorted by expert and the experts' products
are two grouped matrix products (torch._grouped_mm) over the sorted rows,
with the group offsets on the device.

Decoding keeps a latent cache: per layer and position the normalised
kv_lora_rank latent and the rotated k_pe (kv_lora_rank + qk_rope_head_dim
values), never the per-head keys and values. A prefill fills it with the
full (expanded) attention; a decode step attends in the absorbed form: q_nope
is taken into the latent space through kv_b_proj's key part, the scores
are one product with the cached [latent | k_pe], and the weighted latent
goes out through kv_b_proj's value part. Rows are left-padded: each row
has its own count of leading pad slots, its RoPE position is its slot less
that count, and pad slots are never attended.

On the card a decode step runs as one CUDA graph. `decode_cache` hands out
the first slots of a buffer the model keeps for each row count; the graph
of a step over that buffer (captured at its first step: the token, the
slot and the rows' pad slots are copied into fixed inputs, and attention
runs over the whole buffer, the slots past the step's masked) is replayed
at every later step of every search with as many rows. While a profiler
session runs (utils/profiling.py) the step runs op by op instead, so that
its spans record. `cache["routes"]` holds the experts each expert layer
chose at the last call (expert layers, positions, num_experts_per_tok).
"""

from dataclasses import asdict, dataclass, fields

import torch
from torch import nn
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.utils.profiling import recording, span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class MoELMConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    max_position_embeddings: int = 8192
    hidden_act: str = "silu"
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        unported = {"q_lora_rank": (self.q_lora_rank, None),
                    "topk_method": (self.topk_method, "noaux_tc"),
                    "scoring_func": (self.scoring_func, "sigmoid"),
                    "n_group": (self.n_group, 1), "topk_group": (self.topk_group, 1),
                    "moe_layer_freq": (self.moe_layer_freq, 1),
                    "hidden_act": (self.hidden_act, "silu"),
                    "tie_word_embeddings": (self.tie_word_embeddings, False)}
        for key, (got, ported) in unported.items():
            if got != ported:
                raise NotImplementedError(f"{key}={got!r} is not ported (only {ported!r})")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype={self.dtype!r}: use one of {sorted(DTYPES)}")

    @classmethod
    def from_dict(cls, d: dict) -> "MoELMConfig":
        """The fields of a config.json (or of any dict holding its keys);
        other keys are ignored."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        return asdict(self)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a layer caches per position: the latent and k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, the statistics and the scale in
    float32, the result in x's dtype."""

    def __init__(self, dim: int, eps: float, *, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return (h * self.weight.float()).to(x.dtype)


def _linear(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=dtype, device=device)


def rope_tables(pos: torch.Tensor, dim: int, theta: float):
    """cos, sin (pos.shape + (dim,)) in float32 for integer positions."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=pos.device, dtype=torch.float32) / dim)
    freqs = pos.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's RoPE on x (..., d): de-interleave, then rotate_half; in
    float32, returned in x's dtype. cos, sin broadcast against x."""
    d = x.shape[-1]
    h = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-h[..., d // 2:], h[..., : d // 2]], dim=-1)
    return (h * cos + rot * sin).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, cfg: MoELMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        H, nh, dt = cfg.hidden_size, cfg.num_attention_heads, cfg.torch_dtype
        self.q_proj = _linear(H, nh * cfg.qk_head_dim, dt, device)
        self.kv_a_proj_with_mqa = _linear(H, cfg.latent_dim, dt, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dtype=dt,
                                      device=device)
        self.kv_b_proj = _linear(cfg.kv_lora_rank,
                                 nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt, device)
        self.o_proj = _linear(nh * cfg.v_head_dim, H, dt, device)
        self.scale = cfg.qk_head_dim ** -0.5

    def _project(self, x, cos, sin):
        """x (N, S, H) -> q_nope (N, S, nh, nope), rotated q_pe (N, S, nh,
        rope), the cache entries (N, S, latent + rope)."""
        c = self.cfg
        q = self.q_proj(x).unflatten(-1, (c.num_attention_heads, c.qk_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos[:, :, None], sin[:, :, None])
        lat, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, c.qk_rope_head_dim], -1)
        entry = torch.cat([self.kv_a_layernorm(lat), apply_rope(k_pe, cos, sin)], dim=-1)
        return q_nope, q_pe, entry

    def _softmax(self, scores, valid):
        s = scores.float() * self.scale
        s = s.masked_fill(~valid, torch.finfo(torch.float32).min)
        return torch.softmax(s, dim=-1).to(scores.dtype)

    def forward_full(self, x, cos, sin, valid):
        """Prefill attention over the S positions of x (N, S, H), keys and
        values expanded per head; valid (N, 1, S, S) says which key each
        query may attend. Returns (out (N, S, H), cache entries (N, S,
        latent + rope))."""
        c = self.cfg
        nh = c.num_attention_heads
        q_nope, q_pe, entry = self._project(x, cos, sin)
        lat, k_pe = entry.split([c.kv_lora_rank, c.qk_rope_head_dim], dim=-1)
        kv = self.kv_b_proj(lat).unflatten(-1, (nh, c.qk_nope_head_dim + c.v_head_dim))
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)  # (N, nh, S, qk)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, nh, -1)], dim=-1).transpose(1, 2)
        probs = self._softmax(q @ k.transpose(-1, -2), valid)
        o = (probs @ v.transpose(1, 2)).transpose(1, 2).flatten(2)
        return self.o_proj(o), entry

    def forward_cached(self, q_nope, q_pe, kv, valid):
        """One decode step in the absorbed form, from this step's q_nope
        (N, 1, nh, nope) and rotated q_pe (N, 1, nh, rope) (`_project`'s);
        kv (N, L, latent + rope) the layer's cache up to and with this
        step's slot, already written; valid (N, 1, L). Returns (N, 1, H)."""
        c = self.cfg
        nh, R = c.num_attention_heads, c.kv_lora_rank
        w = self.kv_b_proj.weight.view(nh, c.qk_nope_head_dim + c.v_head_dim, R)
        w_k, w_v = w.split([c.qk_nope_head_dim, c.v_head_dim], dim=1)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_k).transpose(0, 1)  # (N, nh, R)
        q = torch.cat([q_lat, q_pe[:, 0]], dim=-1)  # (N, nh, R + rope)
        probs = self._softmax(q @ kv.transpose(1, 2), valid)  # (N, nh, L)
        o_lat = probs @ kv[..., :R]  # (N, nh, R)
        o = torch.bmm(o_lat.transpose(0, 1), w_v.transpose(1, 2)).transpose(0, 1)
        return self.o_proj(o.flatten(1))[:, None]


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), gate and up as one product
    (gate_up_proj: the gate's rows, then the up's)."""

    def __init__(self, hidden: int, width: int, dtype, *, device=None):
        super().__init__()
        self.width = width
        self.gate_up_proj = _linear(hidden, 2 * width, dtype, device)
        self.down_proj = _linear(width, hidden, dtype, device)

    def forward(self, x):
        g, u = self.gate_up_proj(x).split(self.width, dim=-1)
        return self.down_proj(F.silu(g) * u)


class MoEGate(nn.Module):
    """The noaux_tc router: (expert ids (T, k), weights (T, k) float32) of
    x (T, H)."""

    def __init__(self, cfg: MoELMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size,
                                               dtype=cfg.torch_dtype, device=device))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts, dtype=torch.float32, device=device))

    def forward(self, x):
        c = self.cfg
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        _, idx = torch.topk(scores + self.e_score_correction_bias, c.num_experts_per_tok,
                            dim=-1)
        w = scores.gather(1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor


class RoutedExperts(nn.Module):
    """The routed SwiGLU experts as stacked weights: w13 (E, 2I, H) (each
    expert's gate rows, then its up rows) and w2 (E, H, I)."""

    def __init__(self, cfg: MoELMConfig, *, device=None):
        super().__init__()
        E, H, I, dt = (cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size,
                       cfg.torch_dtype)
        self.width = I
        self.w13 = nn.Parameter(torch.empty(E, 2 * I, H, dtype=dt, device=device))
        self.w2 = nn.Parameter(torch.empty(E, H, I, dtype=dt, device=device))

    def forward(self, x, idx, weights):
        """x (T, H), idx and weights (T, k) -> the weighted sum of each
        token's k experts (T, H) in float32, and the number of tokens each
        expert took (E,) int32. The T * k assignments are sorted by expert
        (stable), the rows gathered in that order, and each expert's
        contiguous rows go through its weights in one grouped product; no
        count leaves the device."""
        T, k = idx.shape
        E = self.w13.shape[0]
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        offs = counts.cumsum(0, dtype=torch.int32)
        rows = x[order // k]
        h = torch._grouped_mm(rows, self.w13.transpose(-2, -1), offs=offs)
        g, u = h.split(self.width, dim=-1)
        y = torch._grouped_mm(F.silu(g) * u, self.w2.transpose(-2, -1), offs=offs)
        y = y[torch.argsort(order)].view(T, k, -1)
        return (y.float() * weights[..., None]).sum(1), counts


class MoE(nn.Module):
    def __init__(self, cfg: MoELMConfig, *, device=None):
        super().__init__()
        self.gate = MoEGate(cfg, device=device)
        self.experts = RoutedExperts(cfg, device=device)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.n_shared_experts * cfg.moe_intermediate_size,
                                     cfg.torch_dtype, device=device)

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        with span("llm.moe") as sp:
            idx, w = self.gate(x)
            self.last_idx = idx  # read by the model after the layer
            routed, counts = self.experts(x, idx, w)
            out = (routed + self.shared_experts(x).float()).to(x.dtype)
            if sp:  # distinct experts active, read when the records are read
                sp.n = (counts > 0).sum()
        return out.view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoELMConfig, layer: int, *, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                       device=device)
        self.self_attn = MLA(cfg, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                                device=device)
        self.mlp = (MoE(cfg, device=device) if cfg.is_moe(layer)
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size, dt, device=device))


class MoELM(nn.Module):
    """The language model: `prefill` (fills the latent cache and returns the
    last layer's output), `step` (one cached token a row -> float32 logits)
    and `forward` (no cache: logits of every position).

    The cache is a dict: "kv" (layers, N, L, latent + rope) in the model's
    dtype, "pad" (N,) the leading pad slots of each row, "len" the slots
    filled (a Python int, the same for every row), "routes" the experts
    the last call chose; `decode_cache`'s also "graph" and "owner"."""

    def __init__(self, cfg: MoELMConfig = MoELMConfig(), *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dt,
                                         device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, device=device)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt, device=device)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dt, device)
        self.cuda_graphs = True  # False: `decode_cache`'s steps run op by op
        self._decode_graphs = {}  # rows -> DecodeGraph

    def head(self, h):
        with span("llm.head"):
            return self.lm_head(self.norm(h)).float()

    def _rope(self, slots, pad):
        """cos, sin (N, S, rope) at each row's positions: slot - pad."""
        pos = (slots[None, :] - pad[:, None]).clamp_min(0)
        return rope_tables(pos, self.cfg.qk_rope_head_dim, self.cfg.rope_theta)

    def new_cache(self, rows: int, length: int, pad: torch.Tensor) -> dict:
        c = self.cfg
        if length > c.max_position_embeddings:
            raise ValueError(f"{length} positions exceed max_position_embeddings "
                             f"{c.max_position_embeddings}")
        kv = torch.zeros(c.num_hidden_layers, rows, length, c.latent_dim,
                         dtype=c.torch_dtype, device=pad.device)
        return {"kv": kv, "pad": pad, "len": 0}

    def decode_cache(self, rows: int, length: int, pad: torch.Tensor) -> dict:
        """A cache for `step`, as `new_cache`'s. On the card its slots are
        the first `length` of the buffer the model keeps for `rows` rows
        (made, or made larger, as needed), over which a step is one CUDA
        graph; making a cache takes the buffer over, and an older cache of
        as many rows can no longer step."""
        if pad.device.type != "cuda":
            return self.new_cache(rows, length, pad)
        if length > self.cfg.max_position_embeddings:
            raise ValueError(f"{length} positions exceed max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        g = self._decode_graphs.get(rows)
        if g is None or g.buf.shape[2] < length:
            self._decode_graphs.pop(rows, None)  # the old buffer goes before the new comes
            g = self._decode_graphs[rows] = DecodeGraph(self.cfg, rows, -(-length // 64) * 64,
                                                        pad.device)
        g.owner = object()
        return {"kv": g.buf[:, :, :length], "pad": pad, "len": 0, "graph": g,
                "owner": g.owner}

    def _layers_full(self, h, pad, cache=None):
        """Every layer over the S positions of h (N, S, H) with full
        attention, rows left-padded by `pad`; fills cache["kv"][:, :, :S]
        when a cache is given."""
        N, S, _ = h.shape
        slots = torch.arange(S, device=h.device)
        cos, sin = self._rope(slots, pad)
        valid = (slots[None, None, :] <= slots[None, :, None]) & (
            slots[None, None, :] >= pad[:, None, None])
        valid = valid[:, None]  # (N, 1, S, S)
        routes = []
        for i, layer in enumerate(self.layers):
            with span("llm.attn", n=S):
                a, entry = layer.self_attn.forward_full(layer.input_layernorm(h), cos, sin,
                                                        valid)
            if cache is not None:
                cache["kv"][i, :, :S] = entry
            h = h + a
            h = h + layer.mlp(layer.post_attention_layernorm(h))
            if cache is not None and self.cfg.is_moe(i):
                routes.append(layer.mlp.last_idx)
        if cache is not None:
            cache["routes"] = torch.stack(routes) if routes else None
        return h

    def prefill(self, h, pad, length: int) -> tuple[dict, torch.Tensor]:
        """A cache of `length` slots for the left-padded input embeddings
        h (N, S, H), its first S slots filled; returns (cache, the last
        layer's output (N, S, H))."""
        cache = self.new_cache(h.shape[0], length, pad)
        out = self._layers_full(h, pad, cache)
        cache["len"] = h.shape[1]
        return cache, out

    def forward(self, tokens):
        """Logits (N, S, V) float32 of every position of tokens (N, S), no
        cache."""
        h = self.embed_tokens(tokens)
        pad = torch.zeros(h.shape[0], dtype=torch.long, device=h.device)
        return self.head(self._layers_full(h, pad))

    def step(self, tokens, cache: dict) -> torch.Tensor:
        """tokens (N,) at the cache's next slot -> logits (N, V) float32;
        writes each layer's entry there and advances the cache. With a
        `decode_cache`'s cache on the card, and no profiler session, the
        step is its buffer's CUDA graph, and the logits and routes it
        returns are that graph's: the next step overwrites them."""
        slot = cache["len"]
        kv, pad = cache["kv"], cache["pad"]
        if slot >= kv.shape[2]:
            raise ValueError(f"the cache holds {kv.shape[2]} slots; slot {slot} is past "
                             "its end")
        graph = cache.get("graph")
        if graph is not None and cache["owner"] is not graph.owner:
            raise ValueError("a newer decode cache of as many rows took this cache's "
                             "buffer over")
        if graph is not None and self.cuda_graphs and not recording():
            logits, routes = graph.run(self, tokens, slot, pad)
        else:
            # a fill, not a copy from the host, which would wait for the device
            slot_t = torch.full((1,), slot, dtype=torch.long, device=kv.device)
            logits, routes = self._step(tokens, slot_t, pad, kv, slot + 1)
        cache["len"] = slot + 1
        cache["routes"] = routes
        return logits

    def _step(self, tokens, slot, pad, kv, L: int):
        """`step`'s work: tokens (N,) into the slot `slot` ((1,) long, on the
        device) of kv (layers, N, >= L, latent + rope), attending the first
        L slots, of those only each row's from its pad up to `slot`.
        Returns (logits (N, V) float32, routes (expert layers, N, k))."""
        h = self.embed_tokens(tokens)[:, None]
        cos, sin = self._rope(slot, pad)
        j = torch.arange(L, device=h.device)[None, :]
        valid = ((j >= pad[:, None]) & (j <= slot))[:, None]
        routes = []
        for i, layer in enumerate(self.layers):
            with span("llm.attn", n=L):
                attn = layer.self_attn
                q_nope, q_pe, entry = attn._project(layer.input_layernorm(h), cos, sin)
                kv[i].index_copy_(1, slot, entry)
                a = attn.forward_cached(q_nope, q_pe, kv[i, :, :L], valid)
            h = h + a
            h = h + layer.mlp(layer.post_attention_layernorm(h))
            if self.cfg.is_moe(i):
                routes.append(layer.mlp.last_idx)
        return self.head(h[:, 0]), torch.stack(routes) if routes else None

    @staticmethod
    def reorder_cache(cache: dict, rows: torch.Tensor, fixed: int = 0) -> dict:
        """The cache with each row's entries taken from row `rows[i]`, in
        place. The first `fixed` slots are left as they are: the caller
        vouches that they are equal in every row and its parent (a prefix
        shared by the beams of one utterance)."""
        kv, n = cache["kv"], cache["len"]
        if n > fixed:
            kv[:, :, fixed:n] = kv[:, rows, fixed:n]
        cache["pad"] = cache["pad"][rows]
        return cache


class DecodeGraph:
    """The buffer of one row count's decode caches (layers, rows, cap,
    latent + rope), and the CUDA graph of `MoELM._step` over the whole of
    it, captured at the first step that runs over it. The step's token,
    slot and pad slots are copied into fixed inputs before each replay; its
    logits and routes are fixed outputs."""

    def __init__(self, cfg: MoELMConfig, rows: int, cap: int, device):
        self.buf = torch.zeros(cfg.num_hidden_layers, rows, cap, cfg.latent_dim,
                               dtype=cfg.torch_dtype, device=device)
        self.tokens = torch.zeros(rows, dtype=torch.long, device=device)
        self.slot = torch.zeros(1, dtype=torch.long, device=device)
        self.pad = torch.zeros(rows, dtype=torch.long, device=device)
        self.graph = self.logits = self.routes = None
        self.owner = None  # the token of the cache that holds the buffer

    def run(self, lm: MoELM, tokens, slot: int, pad):
        self.tokens.copy_(tokens)
        self.slot.fill_(slot)
        self.pad.copy_(pad)
        if self.graph is None:
            self._capture(lm)
        self.graph.replay()
        return self.logits, self.routes

    def _capture(self, lm: MoELM):
        args = (self.tokens, self.slot, self.pad, self.buf, self.buf.shape[2])
        dev = self.buf.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            lm._step(*args)  # warm-up; it writes what the replay writes
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits, self.routes = lm._step(*args)
        self.graph = graph
