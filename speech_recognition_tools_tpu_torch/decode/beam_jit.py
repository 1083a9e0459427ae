"""Batched joint CTC/attention beam search with RNNLM shallow fusion.

Port of speech_recognition_tools_tpu/decode/beam_jit.py
(beam_search_jit_batched, tokens_to_list). The JAX search is one jitted
lax.scan over a static max_len, vmapped over a padded batch; here the step
loop is a host loop over one (B x K)-wide state, every utterance with its
own enc_len. Scores combine as in the JAX search:

    (1 - ctc_weight) * att + ctc_weight * ctc + lm_weight * lm
        + penalty * (step + 1)

where the CTC term of eos is the current prefix's full-sequence score and
that of blank is NEG_INF, and a finished beam only re-emits eos and keeps
its score.

Where the port differs in form, not in result:
  - the loop stops once every beam of every utterance has finished, as
    the host-loop beam_search does; a finished beam would only append eos,
    which tokens_to_list strips, so the returned buffer holds -1 where the
    JAX buffer holds those eos;
  - the decoder runs on tokens[:, :step + 1]; its causal and -1 masks make
    that the JAX search's fixed-width pass at position `step`;
  - the RNNLM carries each beam's state (a GRU's, or an LSTM's h and c)
    and reorders it with the beams, instead of rerunning the stack over
    the whole buffer;
  - the top K of each utterance come from a stable descending sort, so
    exact ties go to the lower flat index and NaN ranks below every score,
    as in jax.lax.top_k;
  - scores are float32 throughout (the JAX search holds them in float64
    under x64).

incremental=True runs the decoder in its KV-cached decode mode (one token
a step against each layer's key/value cache, the caches reordered with the
beams every step) instead of the full-prefix pass; the search is
token-identical either way.
"""

import time

import torch

from speech_recognition_tools_tpu_torch.decode.ctc_prefix import (
    NEG_INF,
    ctc_prefix_scores,
    init_prefix_state,
)
from speech_recognition_tools_tpu_torch.device import resolve_device


class _PartTimer:
    """Adds each part's wall seconds into `timings` (synchronising the
    device at every boundary); does nothing when `timings` is None."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = None

    def __call__(self, part=None):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if part is not None:
            self.timings[part] = self.timings.get(part, 0.0) + now - self.t
        self.t = now


def _top_k(flat: torch.Tensor, k: int):
    """The k largest entries of each row of `flat` (values, indices) in
    jax.lax.top_k's order: descending, exact ties to the lower index, and
    NaN below every number. A NaN arises where a beam that does not exist
    yet (att_cum -inf) meets ctc_weight 1.0: 0 * -inf. torch's sort would
    rank it above every number."""
    nan = torch.isnan(flat)
    _, order = torch.sort(flat.masked_fill(nan, float("-inf")), dim=1, descending=True,
                          stable=True)
    # a second stable sort moves the NaNs behind every number, in place
    _, last = torch.sort(nan.gather(1, order).to(torch.uint8), dim=1, stable=True)
    idx = order.gather(1, last[:, :k])
    return flat.gather(1, idx), idx


@torch.no_grad()
def beam_search_encoded(model, memory, enc_len, ctc_logits, *, beam_size=10,
                        max_len=100, ctc_weight=0.3, penalty=0.0, lm=None,
                        lm_weight=1.0, timings=None, incremental=False):
    """The search proper, from the encoder's output (model.encode).

    memory (B, T2, adim), enc_len (B,), ctc_logits (B, T2, V), all on the
    model's device; lm: an RNNLM on the same device, or None.

    timings: optional dict; when given, each step synchronises the device
    between its parts and adds their seconds under "decoder", "ctc",
    "lm", "topk" and "update" (the search is slower so measured).

    incremental: run the decoder KV-cached (model.decode_incremental), its
    cache initialised from the token buffer and its positional table
    max(max_len + 1, 16) rows long, as beam_search_jit(incremental=True).

    Returns (tokens (B, K, max_len+1) int64 with sos at 0 and -1 padding,
    scores (B, K) float32); feed each row to tokens_to_list.
    """
    cfg = model.cfg
    B, T2, _ = memory.shape
    K, V = beam_size, cfg.vocab_size
    dev = memory.device
    tick = _PartTimer(timings, dev)
    ctc_logp = torch.log_softmax(ctc_logits, dim=-1)
    # memory in the compute dtype once, not at every step's projections
    mem = memory.to(cfg.cdtype or memory.dtype).repeat_interleave(K, dim=0)
    mem_len = enc_len.repeat_interleave(K)
    utt = torch.arange(B, device=dev)[:, None]  # (B, 1)

    tokens = torch.full((B * K, max_len + 1), -1, dtype=torch.long, device=dev)
    tokens[:, 0] = cfg.sos_id
    att_cum = torch.full((B, K), float("-inf"), device=dev)
    att_cum[:, 0] = 0.0
    lm_cum = torch.zeros((B, K), device=dev)
    scores = att_cum.clone()
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    last_tokens = torch.full((B, K), -1, dtype=torch.long, device=dev)
    prefix_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    r_state = init_prefix_state(ctc_logp, enc_len, K, cfg.blank_id)
    last_f = (enc_len - 1).clamp(0, T2 - 1)
    lm_state = lm.init_state(B * K) if lm is not None else None
    cache = model.decode_init_cache(tokens, mem, mem_len) if incremental else None
    pe_len = max(max_len + 1, 16)

    tick()
    for step in range(max_len):
        if incremental:
            dec_logits = model.decode_incremental(tokens[:, step : step + 1], step, mem,
                                                  mem_len, cache, pe_len=pe_len)[:, 0]
        else:
            dec_logits = model.decode_step(tokens[:, : step + 1], mem, mem_len)[:, step]
        att_logp = torch.log_softmax(dec_logits, dim=-1).view(B, K, V)
        new_att = att_cum[..., None] + att_logp
        tick("decoder")
        new_lm = lm_cum[..., None]
        if lm is not None:
            lm_logits, lm_next = lm.step(tokens[:, step], lm_state)
            new_lm = new_lm + torch.log_softmax(lm_logits, dim=-1).view(B, K, V)
            tick("lm")

        psi, _, r_new = ctc_prefix_scores(ctc_logp, enc_len, prefix_lens, last_tokens,
                                          r_state, cfg.blank_id)
        r_last = r_state[utt[:, 0], :, last_f]  # (B, K, 2)
        ctc_part = psi.clone()
        ctc_part[..., cfg.eos_id] = torch.logaddexp(r_last[..., 0], r_last[..., 1])
        ctc_part[..., cfg.blank_id] = NEG_INF
        tick("ctc")

        total = ((1.0 - ctc_weight) * new_att + ctc_weight * ctc_part
                 + lm_weight * new_lm + penalty * (step + 1))
        done = torch.full_like(total, NEG_INF)
        done[..., cfg.eos_id] = 0.0
        done = done + torch.where(finished, scores, 0.0)[..., None]
        total = torch.where(finished[..., None], done, total)
        top_scores, top_idx = _top_k(total.view(B, K * V), K)
        beam_idx = torch.div(top_idx, V, rounding_mode="floor")
        tok = top_idx % V
        tick("topk")

        rows = (utt * K + beam_idx).view(-1)  # parent row of each new beam
        tokens = tokens[rows]
        if incremental:
            cache = model.reorder_cache(cache, rows)
        tokens[:, step + 1] = tok.view(-1)
        ends = finished.gather(1, beam_idx) | (tok == cfg.eos_id)
        att_cum = new_att.view(B, K * V).gather(1, top_idx)
        if lm is not None:
            lm_cum = new_lm.view(B, K * V).gather(1, top_idx)
            lm_state = lm.reorder_state(lm_next, rows)
        scores = top_scores
        finished = ends
        last_tokens = torch.where(ends, last_tokens.gather(1, beam_idx), tok)
        prefix_lens = prefix_lens.gather(1, beam_idx) + (~ends).long()
        r_state = torch.where(ends[..., None, None], r_state[utt, beam_idx],
                              r_new[utt, beam_idx, tok])
        stop = bool(finished.all())
        tick("update")
        if stop:
            break
    return tokens.view(B, K, max_len + 1), scores


def beam_search_batched(model, feats, lengths, *, beam_size=10, max_len=100,
                        ctc_weight=0.3, penalty=0.0, lm=None, lm_weight=1.0,
                        device="cuda", incremental=False):
    """Batched joint CTC/attention beam search: B independent searches in
    one (B x K)-wide loop, after one batched encoder pass.

    feats (B, T, D), lengths (B,): numpy arrays or tensors, moved to
    `device`, which must be the model's (and the LM's). `device` defaults
    to "cuda" and raises without a card. Returns (tokens (B, K,
    max_len+1), scores (B, K)); see beam_search_encoded (`incremental`
    runs the KV-cached decoder).
    """
    dev = resolve_device(device)
    feats = torch.as_tensor(feats).to(device=dev, dtype=torch.float32)
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.long)
    with torch.no_grad():
        memory, enc_len, ctc_logits = model.encode(feats, lengths)
    return beam_search_encoded(
        model, memory, enc_len, ctc_logits, beam_size=beam_size, max_len=max_len,
        ctc_weight=ctc_weight, penalty=penalty, lm=lm, lm_weight=lm_weight,
        incremental=incremental)


def tokens_to_list(tokens, scores, eos_id):
    """Host-side: the best hypothesis of one utterance (tokens (K, L),
    scores (K,)) as a python token list without sos, eos and padding."""
    best = int(torch.as_tensor(scores).argmax())
    seq = [int(t) for t in torch.as_tensor(tokens)[best, 1:].tolist() if t >= 0]
    return [t for t in seq if t != eos_id]
