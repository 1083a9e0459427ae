"""Plain reference of the speech LLM: the audio tower, the projector and the
DeepSeek-V3 mixture-of-experts decoder (Moonlight-16B-A3B's block), with
no cache, no batching tricks and no kernels.

Written from the published equations (DeepSeek-V3's modeling code for
`model_type` deepseek_v3, Kimi-VL's MLP projector), over a dict of weights
named as the port's state_dict names them. Imports nothing of the port.
The decoder runs in float32 with TF32 off; the audio tower is
reference/transformer.py's encoder, in its float64 `Precision`. Weights of
any dtype and device are cast to float32 where they are used, one layer
(and one expert) at a time, so that the reference fits beside the
program's bfloat16 weights on one card.

Departures from the published code, none of which changes the result
beyond float32 rounding:
  - the routed experts are stored stacked (w13 (E, 2I, H): each expert's
    gate_proj rows, then its up_proj rows; w2 (E, H, I) its down_proj),
    and the dense and shared SwiGLUs' gate_proj and up_proj as one
    gate_up_proj; the reference slices them;
  - every product is float32 (the published model computes in bfloat16);
  - the group-limited step of noaux_tc is left out: with n_group =
    topk_group = 1 it keeps every expert;
  - a batch of sequences is right-padded; with causal attention the
    padding reaches no real position.

`Options` gives the correctness controls: the expert weights rounded to
fp8 e4m3 (a scale per expert matrix, its largest magnitude at 448), top-k
routing at another k, the shared experts left out, the correction bias
left out of the choice.

`forced` routes: the experts a token goes through may be given (another
computation's choices, position by position); the reference then still
forms its own choice, for the caller to compare, but computes with the
given experts, weighted by its own router's scores for them. A choice
between two experts whose scores lie within rounding of each other goes
either way in bfloat16; forcing keeps such a flip from sending the two
computations down different paths, so that the gaps in the logits measure
the arithmetic, and the flips are counted apart.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import transformer as asr_ref
from benchmark.reference.precision import Precision


@dataclass(frozen=True)
class Options:
    fp8_experts: bool = False
    top_k: int | None = None  # None: the configuration's num_experts_per_tok
    shared: bool = True
    bias: bool = True


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded to fp8 e4m3 with one scale that maps its largest magnitude
    to e4m3's largest (448), back in float32."""
    scale = w.abs().amax().clamp_min(1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """The program's weights read by name as float32 (cast where used)."""

    def __init__(self, state: dict, opts: Options = Options()):
        self.state = state
        self.opts = opts

    def __getitem__(self, name) -> torch.Tensor:
        return self.state[name].float()

    def expert(self, prefix: str, e: int):
        """(w13 (2I, H), w2 (H, I)) of routed expert e, float32."""
        w13 = self.state[prefix + ".experts.w13"][e].float()
        w2 = self.state[prefix + ".experts.w2"][e].float()
        if self.opts.fp8_experts:
            w13, w2 = round_fp8(w13), round_fp8(w2)
        return w13, w2


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """DeepSeek's rotary embedding: x (..., S, d) de-interleaved (even dims,
    then odd), then x * cos + rotate_half(x) * sin at positions pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    freqs = pos.to(torch.float32)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], -1)
    x = x.view(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


def swiglu(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, dim=-1)
    return (F.silu(g) * u) @ down.T


def attention(W: Weights, p: str, x, cfg: dict):
    """MLA over x (N, S, H) with a causal mask, keys and values expanded
    per head."""
    N, S, _ = x.shape
    nh, dn, dr, dv, R = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    q = (x @ W[p + ".q_proj.weight"].T).view(N, S, nh, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], -1)
    q_pe = rope(q_pe, pos, cfg["rope_theta"])
    lat, k_pe = (x @ W[p + ".kv_a_proj_with_mqa.weight"].T).split([R, dr], -1)
    lat = rms_norm(lat, W[p + ".kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = rope(k_pe, pos, cfg["rope_theta"])[:, None]  # (N, 1, S, dr), every head's
    kv = (lat @ W[p + ".kv_b_proj.weight"].T).view(N, S, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], -1)
    k = torch.cat([k_nope, k_pe.expand(N, nh, S, dr)], -1)
    qf = torch.cat([q_nope, q_pe], -1)
    scores = (qf @ k.transpose(-1, -2)) / math.sqrt(dn + dr)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.softmax(scores, -1) @ v  # (N, nh, S, dv)
    return o.transpose(1, 2).reshape(N, S, nh * dv) @ W[p + ".o_proj.weight"].T


def route(W: Weights, p: str, x, cfg: dict, forced=None):
    """x (T, H) -> (the router's own choice of expert ids (T, k), the ids
    computed with: `forced` (T, k') where given, else the own choice, their
    weights)."""
    k = W.opts.top_k or cfg["num_experts_per_tok"]
    s = torch.sigmoid(x @ W[p + ".gate.weight"].T)
    choice = s + W[p + ".gate.e_score_correction_bias"] if W.opts.bias else s
    own = torch.topk(choice, k, dim=-1).indices
    idx = own if forced is None else forced
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return own, idx, w * cfg["routed_scaling_factor"]


def moe(W: Weights, p: str, x, cfg: dict, forced=None):
    """The expert layer on x (T, H): each token through its k experts
    (`forced`'s where given), weighted, plus the shared experts. Returns
    (out (T, H), the router's own choice (T, k))."""
    own, idx, w = route(W, p, x, cfg, forced)
    T, k = idx.shape
    out_k = x.new_zeros(T, k, x.shape[1])
    for e in range(cfg["n_routed_experts"]):
        t, j = (idx == e).nonzero(as_tuple=True)
        if len(t):
            w13, w2 = W.expert(p, e)
            out_k[t, j] = swiglu(x[t], w13, w2) * w[t, j, None]
    out = out_k.sum(1)
    if W.opts.shared:
        out = out + swiglu(x, W[p + ".shared_experts.gate_up_proj.weight"],
                           W[p + ".shared_experts.down_proj.weight"])
    return out, own


def decoder(W: Weights, h, lengths, cfg: dict, name: str = "llm", forced=None):
    """Every layer over h (N, S, H), rows right-padded to S (lengths (N,)),
    with `forced` (per expert layer (N, S, k') ids) where given. Returns
    (the final norm's output (N, S, H), the routes: for each expert layer
    the router's own ids (N, S, k), -1 at padding)."""
    N, S, H = h.shape
    eps = cfg["rms_norm_eps"]
    valid = torch.arange(S, device=h.device)[None, :] < lengths[:, None]
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        layer_forced = None if forced is None else forced[len(routes)][valid]
        p = f"{name}.layers.{i}"
        h = h + attention(W, p + ".self_attn", rms_norm(h, W[p + ".input_layernorm.weight"], eps),
                          cfg)
        x = rms_norm(h, W[p + ".post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            h = h + swiglu(x, W[p + ".mlp.gate_up_proj.weight"], W[p + ".mlp.down_proj.weight"])
            continue
        out, idx = moe(W, p + ".mlp", x[valid], cfg, layer_forced)
        h = h + torch.zeros_like(h).index_put_((valid,), out)
        r = torch.full((N, S, idx.shape[1]), -1, dtype=idx.dtype, device=h.device)
        routes.append(r.index_put_((valid,), idx))
    return rms_norm(h, W[f"{name}.norm.weight"], eps), routes


def lm_logits(W: Weights, tokens, cfg: dict, name: str = "llm"):
    """Logits (N, S, V) of every position of tokens (N, S)."""
    h = W[f"{name}.embed_tokens.weight"][tokens]
    lengths = torch.full((tokens.shape[0],), tokens.shape[1], device=tokens.device)
    out, _ = decoder(W, h, lengths, cfg, name)
    return out @ W[f"{name}.lm_head.weight"].T


def audio_prefix(state: dict, feats, lengths, am: dict, stack: int):
    """The audio tower in float64 (reference/transformer.py's encoder) and
    the projector in float32: (memory (B, T2, adim) float64, enc_len (B,),
    the prefixes: a list of (P_b, hidden) float32, P_b = enc_len // stack).
    The tower's reference also forms CTC log-probabilities; the speech LLM
    has no CTC head, so a one-class zero head stands in and its output is
    discarded."""
    enc = {k: v for k, v in state.items() if k.startswith("encoder.")}
    adim = am["adim"]
    enc["ctc_head.weight"] = torch.zeros(1, adim)
    enc["ctc_head.bias"] = torch.zeros(1)
    W64 = asr_ref.Weights(enc, Precision("f64"))
    dev = feats.device
    W64.w = {k: v.to(dev) for k, v in W64.w.items()}
    memory, enc_len, _ = asr_ref.encode(W64, feats, lengths, am)
    out = []
    for b in range(memory.shape[0]):
        P = int(enc_len[b]) // stack
        x = memory[b, : P * stack].float().reshape(P, stack * adim)
        x = F.layer_norm(x, (stack * adim,), state["projector.pre_norm.weight"].float(),
                         state["projector.pre_norm.bias"].float(), 1e-5)
        x = F.gelu(x @ state["projector.linear_1.weight"].float().T
                   + state["projector.linear_1.bias"].float())
        out.append(x @ state["projector.linear_2.weight"].float().T
                   + state["projector.linear_2.bias"].float())
    return memory, enc_len, out


def hypothesis_logp(state: dict, prefixes, rows, hyps, cfg: dict, sos: int,
                    opts: Options = Options(), forced=None, chunk: int = 2048):
    """The full forward pass of each hypothesis's [audio prefix, sos,
    tokens]: hyps[i] (a token list, up to and with its eos) after
    prefixes[rows[i]]; the positions are P (the prefix) then sos and the
    tokens but the last, right-padded. `forced`: per expert layer (N, S, k')
    ids to compute with. Returns (the summed log-probabilities of the
    hypotheses' tokens (N,) float64, the log-probabilities after sos of each
    hypothesis (N, V), the routes: per expert layer the router's own ids
    (N, S, k), -1 at padding)."""
    dev = prefixes[0].device
    W = Weights(state, opts)
    emb = state["llm.embed_tokens.weight"]
    seqs = []
    for r, h in zip(rows, hyps):
        ids = torch.tensor([sos] + list(h[:-1]), device=dev)
        seqs.append(torch.cat([prefixes[r], emb[ids].float()]))
    lengths = torch.tensor([len(s) for s in seqs], device=dev)
    S = int(lengths.max())
    x = torch.zeros(len(seqs), S, seqs[0].shape[1], device=dev)
    for i, s in enumerate(seqs):
        x[i, : len(s)] = s
    out, routes = decoder(W, x, lengths, cfg, forced=forced)
    # the positions whose logits score a token: sos and every token but the last
    at = [(i, len(prefixes[r]) + j, h[j]) for i, (r, h) in enumerate(zip(rows, hyps))
          for j in range(len(h))]
    head = W["llm.lm_head.weight"]
    total = torch.zeros(len(hyps), dtype=torch.float64, device=dev)
    first = torch.zeros(len(hyps), head.shape[0], device=dev)
    for s in range(0, len(at), chunk):
        part = at[s : s + chunk]
        i = torch.tensor([a[0] for a in part], device=dev)
        t = torch.tensor([a[1] for a in part], device=dev)
        y = torch.tensor([a[2] for a in part], device=dev)
        logp = torch.log_softmax(out[i, t] @ head.T, -1)
        total.index_add_(0, i, logp.gather(1, y[:, None])[:, 0].double())
        is_first = t == torch.tensor([len(prefixes[rows[a[0]]]) for a in part], device=dev)
        first[i[is_first]] = logp[is_first]
    return total, first, routes
