"""Plain reference of the joint CTC/attention transformer ASR, its GRU
RNNLM and the scores of the beam search's hypotheses.

Written from the model's equations (ESPnet's e2e_asr_transformer as the
JAX package defines it: conf/train.yaml's pre-norm blocks, conv2d
subsampling, sinusoidal positions), over a dict of weights named as the
port's state_dict names them. Imports nothing of the port. Everything
runs in one `Precision` (precision.py): float64, or the TF32 control.

The LayerNorm is flax's (epsilon 1e-6, no bias correction); masked
attention logits take finfo.min, as flax sets them; the GRU is flax's
GRUCell (r, z, n gates; the reset gate multiplies W_hn h + b_hn).
"""

import math

import torch

from benchmark.reference.precision import Precision


def layer_norm(x, w, b, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def posenc(length, dim, device, dtype):
    pos = torch.arange(length, device=device, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, device=device, dtype=torch.float64)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, device=device, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class Weights:
    """The weights in the reference's precision, read by name (tensors
    already of that dtype are kept as they are, autograd leaves too)."""

    def __init__(self, state: dict, P: Precision):
        self.P = P
        self.w = {k: P.t(v) for k, v in state.items()}

    def __getitem__(self, k):
        return self.w[k]

    def lin(self, x, name):
        return self.P.linear(x, self.w[name + ".weight"], self.w[name + ".bias"])

    def norm(self, x, name):
        return layer_norm(x, self.w[name + ".weight"], self.w[name + ".bias"])


def attention(W: Weights, name, q_in, kv_in, mask, heads):
    B, Tq, D = q_in.shape
    hd = D // heads

    def split(x):
        return x.view(B, x.shape[1], heads, hd).transpose(1, 2)

    q = split(W.lin(q_in, name + ".query")) / math.sqrt(hd)
    k = split(W.lin(kv_in, name + ".key"))
    v = split(W.lin(kv_in, name + ".value"))
    logits = W.P.mm(q, k.transpose(-1, -2))
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    o = W.P.mm(torch.softmax(logits, dim=-1), v)
    return W.lin(o.transpose(1, 2).reshape(B, Tq, D), name + ".out")


def block(W: Weights, name, x, mask, heads, memory=None, mem_mask=None):
    h = W.norm(x, name + ".norm_self")
    x = x + attention(W, name + ".self_attn", h, h, mask, heads)
    if memory is not None:
        x = x + attention(W, name + ".src_attn", W.norm(x, name + ".norm_src"), memory,
                          mem_mask, heads)
    h = torch.relu(W.lin(W.norm(x, name + ".norm_ff"), name + ".ff_in"))
    return x + W.lin(h, name + ".ff_out")


def subsampled(lengths):
    return torch.div(torch.div(lengths - 1, 2, rounding_mode="floor") - 1, 2,
                     rounding_mode="floor").clamp_min(0)


def chunk_mask(T, chunk, left, device):
    c = torch.arange(T, device=device) // chunk
    ok = c[None, :] <= c[:, None]
    if left >= 0:
        ok &= c[None, :] >= c[:, None] - left
    return ok


def encode(W: Weights, feats, lengths, am: dict):
    """feats (B, T, D), lengths (B,) -> memory (B, T2, adim), enc_len,
    CTC log-probabilities (B, T2, V)."""
    P, A = W.P, am["adim"]
    x = P.t(feats)[:, None]
    h = torch.relu(P.conv2d(x, W["encoder.embed.conv0.weight"],
                            W["encoder.embed.conv0.bias"], 2))
    h = torch.relu(P.conv2d(h, W["encoder.embed.conv1.weight"],
                            W["encoder.embed.conv1.bias"], 2))
    B, C, T2, D2 = h.shape
    h = W.lin(h.permute(0, 2, 3, 1).reshape(B, T2, D2 * C), "encoder.embed.out")
    h = h * math.sqrt(A) + posenc(T2, A, h.device, h.dtype)[None]
    enc_len = subsampled(lengths.to(h.device))
    valid = torch.arange(T2, device=h.device)[None, :] < enc_len[:, None]
    mask = valid[:, None, None, :]
    if am.get("attn_chunk", 0) > 0:
        mask = mask & chunk_mask(T2, am["attn_chunk"], am.get("attn_left_chunks", -1),
                                 h.device)[None, None]
    for i in range(am["elayers"]):
        h = block(W, f"encoder.layers.{i}", h, mask, am["aheads"])
    memory = W.norm(h, "encoder.after_norm")
    ctc = torch.log_softmax(W.lin(memory, "ctc_head"), dim=-1)
    return memory, enc_len, ctc


def decoder_logp(W: Weights, tokens_in, memory, mem_len, am: dict):
    """Teacher-forced decoder: tokens_in (N, U) (-1 padded) -> next-token
    log-probabilities (N, U, V)."""
    A = am["adim"]
    N, U = tokens_in.shape
    dev = memory.device
    h = W["decoder.embed.weight"][tokens_in.clamp_min(0)]
    h = h * math.sqrt(A) + posenc(U, A, dev, h.dtype)[None]
    causal = torch.ones(U, U, dtype=torch.bool, device=dev).tril()
    mask = (tokens_in != -1)[:, None, None, :] & causal[None, None]
    mem_mask = (torch.arange(memory.shape[1], device=dev)[None, :]
                < mem_len[:, None])[:, None, None, :]
    for i in range(am["dlayers"]):
        h = block(W, f"decoder.layers.{i}", h, mask, am["aheads"], memory, mem_mask)
    return torch.log_softmax(W.lin(W.norm(h, "decoder.after_norm"), "decoder.output"), -1)


def gru_cell(P, xi, h, w_hh, b_hn):
    H = h.shape[-1]
    hh = P.mm(h, w_hh.T)
    xr, xz, xn = xi.split(H, -1)
    hr, hz, hn = hh.split(H, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * (hn + b_hn))
    return (1 - z) * n + z * h


def lm_logp(W: Weights, tokens_in, layers: int):
    """GRU RNNLM: tokens_in (N, U) -> next-token log-probabilities (N, U, V)."""
    x = W["embed.weight"][tokens_in.clamp_min(0)]
    for i in range(layers):
        p = f"rnn.layers.{i}"
        xi = W.P.linear(x, W[p + ".weight_ih"], W[p + ".bias_ih"])
        h = xi.new_zeros(x.shape[0], W[p + ".weight_hh"].shape[1])
        outs = []
        for t in range(x.shape[1]):
            h = gru_cell(W.P, xi[:, t], h, W[p + ".weight_hh"], W[p + ".bias_hn"])
            outs.append(h)
        x = torch.stack(outs, 1)
    return torch.log_softmax(W.lin(x, "output"), -1)


def ctc_scores(logp, T, labels, L, blank=0):
    """CTC forward over each row's label sequence.

    logp (N, Tmax, V) log-probabilities, T (N,) valid frames, labels
    (N, Lmax) with L (N,) lengths (L >= 1). Returns (prefix, full): the log
    probability that the output begins with the whole sequence (the
    prefix score, Watanabe et al. 2017) and that it is exactly the
    sequence minus its last label (the full score of labels[:L-1])."""
    N, Tmax, _ = logp.shape
    dev, dt = logp.device, logp.dtype
    ninf = torch.tensor(float("-inf"), dtype=dt, device=dev)
    S = 2 * labels.shape[1] + 1
    s = torch.arange(S, device=dev)
    lab_idx = ((s - 1) // 2).clamp(0, labels.shape[1] - 1)
    ext = torch.where(s % 2 == 1, labels[:, lab_idx], blank)  # (N, S)
    prev2 = torch.where(s >= 2, ext[:, (s - 2).clamp_min(0)], -1)
    skip = (s % 2 == 1) & (s >= 2) & (ext != prev2)
    # the lattice of h = labels[:L-1]: states 0 .. 2(L-1); its last label
    # state 2L-3 and its final blank 2L-2
    Lh = L - 1
    in_h = s[None, :] <= 2 * Lh[:, None]
    emit = logp.gather(2, ext[:, None, :].expand(N, Tmax, S))  # (N, Tmax, S)
    c = labels.gather(1, (L - 1)[:, None])[:, 0]
    last_h = torch.where(Lh > 0, labels.gather(1, (L - 2).clamp_min(0)[:, None])[:, 0], -1)
    lp_c = logp.gather(2, c[:, None, None].expand(N, Tmax, 1))[..., 0]  # (N, Tmax)
    idx_n = (2 * Lh - 1).clamp_min(0)[:, None]
    idx_b = (2 * Lh)[:, None]
    alpha = torch.full((N, S), float("-inf"), dtype=dt, device=dev)
    phi_prev = torch.where(Lh == 0, torch.zeros((), dtype=dt, device=dev), ninf)
    terms = []
    for t in range(Tmax):
        live = t < T
        terms.append(torch.where(live, phi_prev + lp_c[:, t], ninf))
        if t == 0:
            new = torch.full_like(alpha, float("-inf"))
            new[:, :2] = emit[:, 0, :2]
        else:
            a1 = torch.cat([alpha.new_full((N, 1), float("-inf")), alpha[:, :-1]], 1)
            a2 = torch.cat([alpha.new_full((N, 2), float("-inf")), alpha[:, :-2]], 1)
            a2 = torch.where(skip, a2, ninf)
            new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[:, t]
        alpha = torch.where(live[:, None], new, alpha)
        a_h = torch.where(in_h, alpha, ninf)
        g_n = torch.where(Lh > 0, a_h.gather(1, idx_n)[:, 0], ninf)
        g_b = a_h.gather(1, idx_b)[:, 0]
        phi_prev = torch.where(c == last_h, g_b, torch.logaddexp(g_n, g_b))
    prefix = torch.logsumexp(torch.stack(terms, 1), 1)
    full = torch.logaddexp(
        torch.where(Lh > 0, alpha.gather(1, idx_n)[:, 0], ninf),
        alpha.gather(1, idx_b)[:, 0])
    return prefix, full


def hypothesis_scores(W_am: Weights, W_lm: Weights, memory, enc_len, ctc_logp, rows, hyps,
                      am: dict, lm_layers: int, decode: dict):
    """The joint score of each hypothesis as the search defines it:
    (1 - ctc_weight) att + ctc_weight ctc + lm_weight lm + penalty L.

    rows (N,) index each hypothesis's utterance in memory; hyps: N token
    lists [y_1 .. y_L] as the search returned them (sos stripped, up to and
    with the first eos). att and lm sum the log-probabilities of y_1 .. y_L
    given their prefixes; ctc is the prefix score of y_1 .. y_L, or for a
    hypothesis that ends in eos the full score of y_1 .. y_{L-1}. Returns
    (N,) scores."""
    eos = am["vocab_size"] - 1
    dev = memory.device
    N = len(hyps)
    U = max(len(h) for h in hyps)
    tok = torch.full((N, U), -1, dtype=torch.long, device=dev)
    L = torch.tensor([len(h) for h in hyps], device=dev)
    for i, h in enumerate(hyps):
        tok[i, : len(h)] = torch.tensor(h, device=dev)
    tok_in = torch.cat([torch.full((N, 1), eos, dtype=torch.long, device=dev), tok[:, :-1]], 1)
    tok_in = torch.where(torch.arange(U, device=dev)[None, :] < L[:, None], tok_in, -1)
    valid = torch.arange(U, device=dev)[None, :] < L[:, None]
    tgt = tok.clamp_min(0)[..., None]
    att_lp = decoder_logp(W_am, tok_in, memory[rows], enc_len[rows], am)
    att = (att_lp.gather(2, tgt)[..., 0] * valid).sum(1)
    lm_lp = lm_logp(W_lm, tok_in, lm_layers)
    lm = (lm_lp.gather(2, tgt)[..., 0] * valid).sum(1)
    ended = tok.gather(1, (L - 1)[:, None])[:, 0] == eos
    labels = torch.where(valid, tok, 0)
    prefix, full = ctc_scores(ctc_logp[rows], enc_len[rows], labels, L)
    ctc = torch.where(ended, full, prefix)
    w = decode["ctc_weight"]
    return ((1 - w) * att + w * ctc + decode["lm_weight"] * lm
            + decode.get("penalty", 0.0) * L.to(att.dtype))
