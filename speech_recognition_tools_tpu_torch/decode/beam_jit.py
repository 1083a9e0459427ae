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
  - the eager loop's decoder runs on tokens[:, :step + 1]; its causal and
    -1 masks make that the JAX search's fixed-width pass at position
    `step`; a model with a fixed-buffer step (TransformerASR) runs one
    KV-cached token a step instead, over buffers whose shapes never change,
    and on a card the whole step is one CUDA graph (beam_search_fixed);
  - the RNNLM carries each beam's state (a GRU's, or an LSTM's h and c)
    and reorders it with the beams, instead of rerunning the stack over
    the whole buffer;
  - the top K of each utterance come from a stable descending sort, so
    exact ties go to the lower flat index and NaN ranks below every score,
    as in jax.lax.top_k;
  - scores are float32 throughout (the JAX search holds them in float64
    under x64).

prefix_scorer is the JAX host search's `lm_apply` hook (the look-ahead
word LM of decode/wordlm.py goes through it): raw scores of the token
prefixes, added to the LM column without normalisation.

In the eager loop, incremental=True runs the decoder in its KV-cached
decode mode (one token a step against each layer's key/value cache, the
caches reordered with the beams every step) instead of the full-prefix
pass; the search is token-identical either way. The cache is made once
from the B utterances' memory (`decode_init_cache` gets B rows and the B *
K token buffer), so a model that prefills its cache (models/speech_llm.py)
does so once an utterance, not once a beam.

A model with no CTC head (`ctc_logits` None, ctc_weight 0: the speech LLM)
scores with the decoder and the LM alone: the CTC prefix state, its
per-step scores and its reordering are skipped, and the total is what the
CTC branch gives at ctc_weight 0.
"""

import collections
import contextlib
import itertools
import threading

import torch

from speech_recognition_tools_tpu_torch.decode.ctc_prefix import (
    NEG_INF,
    count_launches,
    ctc_prefix_scores,
    init_prefix_state,
)
from speech_recognition_tools_tpu_torch.device import resolve_device
from speech_recognition_tools_tpu_torch.utils.profiling import span


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
                        lm_weight=1.0, incremental=False,
                        prefix_scorer=None):
    """The search proper, from the encoder's output (model.encode).

    memory (B, T2, adim), enc_len (B,), ctc_logits (B, T2, V) or None (no
    CTC head; ctc_weight must be 0), all on the model's device; lm: an
    RNNLM on the same device, or None.

    prefix_scorer: the JAX host search's `lm_apply` hook
    (models/transformer_asr.py::beam_search), e.g. decode/wordlm.py's
    LookaheadWordLM: a callable on the (B * K, step + 1) token prefixes
    (sos first) returning raw (B * K, V) scores, added to the LM column as
    they are (no log_softmax) and gathered with the beams. Exclusive with
    `lm`.

    A model with a fixed-buffer decoder step (`decode_fixed_step`:
    TransformerASR) searches over fixed buffers when no prefix_scorer is
    given (beam_search_fixed): on a card each step is one CUDA graph
    replay, on the CPU the same step runs eagerly. Every other search runs
    beam_search_eager's loop.

    incremental: in beam_search_eager's loop, run the decoder KV-cached
    (model.decode_incremental), its cache initialised from the token
    buffer and the B utterances' memory and its positional table
    max(max_len + 1, 16) rows long, as beam_search_jit(incremental=True).
    It selects nothing where the fixed-buffer step runs, which is
    KV-cached already.

    Counters: beam_search_encoded.steps counts the steps every search ran,
    .graph_steps those replayed as a CUDA graph, .graph_captures the graphs
    captured.

    Returns (tokens (B, K, max_len+1) int64 with sos at 0 and -1 padding,
    scores (B, K) float32); feed each row to tokens_to_list.
    """
    if lm is not None and prefix_scorer is not None:
        raise ValueError("lm and prefix_scorer are exclusive")
    if ctc_logits is None and ctc_weight != 0:
        raise ValueError(f"ctc_weight {ctc_weight} needs CTC logits; the model has no CTC head")
    kw = dict(beam_size=beam_size, max_len=max_len, ctc_weight=ctc_weight, penalty=penalty,
              lm=lm, lm_weight=lm_weight)
    if prefix_scorer is None and hasattr(model, "decode_fixed_step"):
        return beam_search_fixed(model, memory, enc_len, ctc_logits, **kw)
    return beam_search_eager(model, memory, enc_len, ctc_logits, incremental=incremental,
                             prefix_scorer=prefix_scorer, **kw)


beam_search_encoded.steps = 0
beam_search_encoded.graph_steps = 0
beam_search_encoded.graph_captures = 0
# the function that keeps the counters, also while a caller wraps the name
_COUNTERS = beam_search_encoded
_count_lock = threading.Lock()  # serving threads search concurrently


def _count(**counts):
    with _count_lock:
        for name, n in counts.items():
            setattr(_COUNTERS, name, getattr(_COUNTERS, name) + n)


@torch.no_grad()
def beam_search_eager(model, memory, enc_len, ctc_logits, *, beam_size=10, max_len=100,
                      ctc_weight=0.3, penalty=0.0, lm=None, lm_weight=1.0,
                      incremental=False, prefix_scorer=None):
    """beam_search_encoded's step loop as host code, one eager op after
    another: the decoder's full-prefix pass (or, with `incremental`, its
    KV-cached decode mode) a step. It runs the searches of a model without
    a fixed-buffer step (the speech LLM) and those with a prefix_scorer.

    Spans (utils/profiling.py): `search`, counting the steps run, holds
    `search.init` and per step `search.decoder`, `search.lm`,
    `search.ctc_prefix`, `search.topk`, `search.update` and `search.wait`
    (the step's one host sync, whether every beam has finished).
    """
    use_ctc = ctc_logits is not None
    cfg = model.cfg
    B, T2, _ = memory.shape
    K, V = beam_size, cfg.vocab_size
    dev = memory.device
    with span("search") as search:
        with span("search.init"):
            # memory in the compute dtype once, not at every step's projections
            mem_b = memory.to(cfg.cdtype or memory.dtype)
            mem = mem_b.repeat_interleave(K, dim=0)
            mem_len = enc_len.repeat_interleave(K)
            utt = torch.arange(B, device=dev)[:, None]  # (B, 1)

            tokens = torch.full((B * K, max_len + 1), -1, dtype=torch.long, device=dev)
            tokens[:, 0] = cfg.sos_id
            att_cum = torch.full((B, K), float("-inf"), device=dev)
            att_cum[:, 0] = 0.0
            lm_cum = torch.zeros((B, K), device=dev)
            scores = att_cum.clone()
            finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
            if use_ctc:
                last_tokens = torch.full((B, K), -1, dtype=torch.long, device=dev)
                prefix_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
                ctc_logp = torch.log_softmax(ctc_logits, dim=-1)
                r_state = init_prefix_state(ctc_logp, enc_len, K, cfg.blank_id)
                last_f = (enc_len - 1).clamp(0, T2 - 1)
            lm_state = lm.init_state(B * K) if lm is not None else None
            cache = model.decode_init_cache(tokens, mem_b, enc_len) if incremental else None
            pe_len = max(max_len + 1, 16)

        steps = 0
        for step in range(max_len):
            search.n = steps = step + 1
            with span("search.decoder"):
                if incremental:
                    dec_logits = model.decode_incremental(tokens[:, step : step + 1], step, mem,
                                                          mem_len, cache, pe_len=pe_len)[:, 0]
                else:
                    dec_logits = model.decode_step(tokens[:, : step + 1], mem, mem_len)[:, step]
                att_logp = torch.log_softmax(dec_logits, dim=-1).view(B, K, V)
                new_att = att_cum[..., None] + att_logp
            new_lm = lm_cum[..., None]
            if lm is not None:
                with span("search.lm"):
                    lm_logits, lm_next = lm.step(tokens[:, step], lm_state)
                    new_lm = new_lm + torch.log_softmax(lm_logits, dim=-1).view(B, K, V)
            elif prefix_scorer is not None:
                with span("search.lm"):
                    raw = torch.as_tensor(prefix_scorer(tokens[:, : step + 1]),
                                          dtype=torch.float32)
                    new_lm = new_lm + raw.to(dev).view(B, K, V)

            if use_ctc:
                with span("search.ctc_prefix"):
                    psi, _, r_new = ctc_prefix_scores(ctc_logp, enc_len, prefix_lens,
                                                      last_tokens, r_state, cfg.blank_id)
                    r_last = r_state[utt[:, 0], :, last_f]  # (B, K, 2)
                    ctc_part = psi.clone()
                    ctc_part[..., cfg.eos_id] = torch.logaddexp(r_last[..., 0], r_last[..., 1])
                    ctc_part[..., cfg.blank_id] = NEG_INF

            with span("search.topk"):
                total = (1.0 - ctc_weight) * new_att
                if use_ctc:
                    total = total + ctc_weight * ctc_part
                total = total + lm_weight * new_lm + penalty * (step + 1)
                done = torch.full_like(total, NEG_INF)
                done[..., cfg.eos_id] = 0.0
                done = done + torch.where(finished, scores, 0.0)[..., None]
                total = torch.where(finished[..., None], done, total)
                top_scores, top_idx = _top_k(total.view(B, K * V), K)
                beam_idx = torch.div(top_idx, V, rounding_mode="floor")
                tok = top_idx % V

            with span("search.update"):
                rows = (utt * K + beam_idx).view(-1)  # parent row of each new beam
                tokens = tokens[rows]
                if incremental:
                    cache = model.reorder_cache(cache, rows)
                tokens[:, step + 1] = tok.view(-1)
                ends = finished.gather(1, beam_idx) | (tok == cfg.eos_id)
                att_cum = new_att.view(B, K * V).gather(1, top_idx)
                if lm is not None or prefix_scorer is not None:
                    lm_cum = new_lm.view(B, K * V).gather(1, top_idx)
                if lm is not None:
                    lm_state = lm.reorder_state(lm_next, rows)
                scores = top_scores
                finished = ends
                if use_ctc:
                    last_tokens = torch.where(ends, last_tokens.gather(1, beam_idx), tok)
                    prefix_lens = prefix_lens.gather(1, beam_idx) + (~ends).long()
                    r_state = torch.where(ends[..., None, None], r_state[utt, beam_idx],
                                          r_new[utt, beam_idx, tok])
                all_done = finished.all()
            with span("search.wait"):
                stop = bool(all_done)
            if stop:
                break
    _count(steps=steps)
    return tokens.view(B, K, max_len + 1), scores


# the CUDA graphs of fixed-buffer searches, least recently used first;
# a shape meets its graph again until 16 others or 4 GiB of buffers push
# it out
_MAX_GRAPHS = 16
_MAX_GRAPH_BYTES = 4 << 30
_graphs = collections.OrderedDict()
# one graphed search at a time: the graphs share one memory pool a card
_graph_lock = threading.Lock()
_pools = {}


def fixed_cap(max_len: int) -> int:
    """The fixed search's positions: max_len + 1 rounded up to a multiple
    of 128, so that searches of most max_len meet one graph."""
    return -(-(max_len + 1) // 128) * 128


def _tensors(tree):
    return [tree] if isinstance(tree, torch.Tensor) else [t for x in tree for t in _tensors(x)]


def _copy_tree(dst, src):
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


class _FixedSearch:
    """One search shape's fixed buffers, the step over them (`step`: the
    decoder step and its log-softmax, the RNNLM step, the CTC prefix scores
    with the eos and blank columns, the top K and the whole update, every
    carried tensor written in place), and on a card that step's CUDA graph
    once captured."""

    def __init__(self, model, lm, B, K, T2, cap, ctc_dtype, weights, dev):
        cfg = model.cfg
        self.B, self.K, self.V = B, K, cfg.vocab_size
        N = B * K
        self.ctc_weight, self.lm_weight, penalty = weights
        self.use_ctc = ctc_dtype is not None
        self.dec = model.decode_fixed_buffers(B, K, cap, T2, dev)
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)  # the step
        # penalty * (step + 1) as the host loop rounds it, a row a step
        self.penalty = torch.tensor([penalty * (s + 1) for s in range(cap)],
                                    dtype=torch.float32, device=dev)
        self.tokens = torch.empty((N, cap), dtype=torch.long, device=dev)
        self.att_cum = torch.empty((B, K), device=dev)
        self.lm_cum = torch.empty((B, K), device=dev)
        self.scores = torch.empty((B, K), device=dev)
        self.finished = torch.empty((B, K), dtype=torch.bool, device=dev)
        self.all_done = torch.empty((), dtype=torch.bool, device=dev)
        self.utt = torch.arange(B, device=dev)[:, None]  # (B, 1)
        if self.use_ctc:
            self.last_tokens = torch.empty((B, K), dtype=torch.long, device=dev)
            self.prefix_lens = torch.empty((B, K), dtype=torch.long, device=dev)
            self.ctc_logp = torch.empty((B, T2, self.V), dtype=ctc_dtype, device=dev)
            self.enc_len = torch.empty(B, dtype=torch.long, device=dev)
            self.last_f = torch.empty(B, dtype=torch.long, device=dev)
            self.r_state = torch.empty((B, K, T2, 2), dtype=ctc_dtype, device=dev)
        self.lm_state = lm.init_state(N) if lm is not None else None  # fresh tensors
        self.graph = None
        self.nbytes = sum(t.nbytes for t in vars(self).values() if isinstance(t, torch.Tensor))
        self.nbytes += sum(t.nbytes for t in self.dec.values())

    def load(self, model, lm, mem_b, enc_len, ctc_logits):
        """One search's inputs and initial state into the buffers."""
        cfg = model.cfg
        self.slot.zero_()
        self.tokens.fill_(-1)
        self.tokens[:, 0] = cfg.sos_id
        self.att_cum.fill_(float("-inf"))
        self.att_cum[:, 0] = 0.0
        self.lm_cum.zero_()
        self.scores.copy_(self.att_cum)
        self.finished.zero_()
        if self.use_ctc:
            self.last_tokens.fill_(-1)
            self.prefix_lens.zero_()
            self.ctc_logp.copy_(torch.log_softmax(ctc_logits, dim=-1))
            self.enc_len.copy_(enc_len)
            self.last_f.copy_((self.enc_len - 1).clamp(0, self.ctc_logp.shape[1] - 1))
            self.r_state.copy_(init_prefix_state(self.ctc_logp, self.enc_len, self.K,
                                                 cfg.blank_id))
        if lm is not None:
            _copy_tree(self.lm_state, lm.init_state(self.B * self.K))
        model.decode_fixed_load(self.dec, mem_b, enc_len)

    def step(self, model, lm):
        """One search step over the buffers, with no host sync: what
        beam_search_eager's loop computes at step `slot`."""
        cfg = model.cfg
        B, K, V = self.B, self.K, self.V
        with span("search.decoder"):
            last = self.tokens.index_select(1, self.slot).view(-1)
            dec_logits = model.decode_fixed_step(last, self.slot, self.dec)
            new_att = self.att_cum[..., None] + torch.log_softmax(dec_logits, dim=-1).view(B, K, V)
        new_lm = self.lm_cum[..., None]
        if lm is not None:
            with span("search.lm"):
                lm_logits, lm_next = lm.step(last, self.lm_state)
                new_lm = new_lm + torch.log_softmax(lm_logits, dim=-1).view(B, K, V)
        if self.use_ctc:
            with span("search.ctc_prefix"):
                psi, _, r_new = ctc_prefix_scores(self.ctc_logp, self.enc_len, self.prefix_lens,
                                                  self.last_tokens, self.r_state, cfg.blank_id)
                r_last = self.r_state[self.utt[:, 0], :, self.last_f]  # (B, K, 2)
                ctc_part = psi.clone()
                ctc_part[..., cfg.eos_id] = torch.logaddexp(r_last[..., 0], r_last[..., 1])
                ctc_part[..., cfg.blank_id] = NEG_INF

        with span("search.topk"):
            total = (1.0 - self.ctc_weight) * new_att
            if self.use_ctc:
                total = total + self.ctc_weight * ctc_part
            total = total + self.lm_weight * new_lm + self.penalty.index_select(0, self.slot)
            done = torch.full_like(total, NEG_INF)
            done[..., cfg.eos_id] = 0.0
            done = done + torch.where(self.finished, self.scores, 0.0)[..., None]
            total = torch.where(self.finished[..., None], done, total)
            top_scores, top_idx = _top_k(total.view(B, K * V), K)
            beam_idx = torch.div(top_idx, V, rounding_mode="floor")
            tok = top_idx % V

        with span("search.update"):
            rows = (self.utt * K + beam_idx).view(-1)  # parent row of each new beam
            self.tokens.copy_(self.tokens.index_select(0, rows))
            self.tokens.index_copy_(1, self.slot + 1, tok.view(-1, 1))
            model.decode_fixed_reorder(self.dec, rows)
            ends = self.finished.gather(1, beam_idx) | (tok == cfg.eos_id)
            self.att_cum.copy_(new_att.view(B, K * V).gather(1, top_idx))
            if lm is not None:
                self.lm_cum.copy_(new_lm.view(B, K * V).gather(1, top_idx))
                _copy_tree(self.lm_state, lm.reorder_state(lm_next, rows))
            self.scores.copy_(top_scores)
            if self.use_ctc:
                self.last_tokens.copy_(torch.where(ends, self.last_tokens.gather(1, beam_idx), tok))
                self.prefix_lens.copy_(self.prefix_lens.gather(1, beam_idx) + (~ends).long())
                self.r_state.copy_(torch.where(ends[..., None, None],
                                               self.r_state[self.utt, beam_idx],
                                               r_new[self.utt, beam_idx, tok]))
            self.finished.copy_(ends)
            self.all_done.copy_(ends.all())
            self.slot.add_(1)

    def warm_up(self, model, lm):
        """The step run eagerly on a side stream, as before a capture."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(model, lm)
        cur.wait_stream(side)

    def capture(self, model, lm):
        """Record the step (which does not run) as this shape's graph."""
        dev = self.slot.device
        if dev not in _pools:
            _pools[dev] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_pools[dev], capture_error_mode="thread_local"):
            self.step(model, lm)
        self.graph = graph


def _params(module):
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))


def _cached_search(model, lm, B, K, T2, cap, ctc_dtype, weights, dev):
    """The shape's _FixedSearch from the graph cache, made (and older ones
    evicted) on its first search. The key holds where every weight lives,
    since a graph reads them from there."""
    key = (dev, B, K, T2, cap, ctc_dtype, weights, model.cfg, type(model), _params(model),
           None if lm is None else (type(lm), _params(lm)))
    st = _graphs.pop(key, None)
    if st is None:
        st = _FixedSearch(model, lm, B, K, T2, cap, ctc_dtype, weights, dev)
        while _graphs and (len(_graphs) >= _MAX_GRAPHS or st.nbytes + sum(
                g.nbytes for g in _graphs.values()) > _MAX_GRAPH_BYTES):
            _graphs.popitem(last=False)
    _graphs[key] = st
    return st


@torch.no_grad()
def beam_search_fixed(model, memory, enc_len, ctc_logits, *, beam_size=10, max_len=100,
                      ctc_weight=0.3, penalty=0.0, lm=None, lm_weight=1.0):
    """beam_search_encoded over fixed buffers, for a model with a
    fixed-buffer decoder step (models/transformer_asr.py): a self-attention
    cache of fixed_cap(max_len) slots written at a slot held on the
    device, cross-attention keys and values projected once a search from
    the B utterances' memory, and every carried tensor (tokens, scores,
    the CTC prefix state, the RNNLM state, the cache) a buffer written in
    place. The search is token-identical to beam_search_eager's.

    On a card every step is one replay of a CUDA graph of the whole step,
    captured at the second step of a shape's first search (the first runs
    eagerly, as the capture's warm-up) and kept for (B, K, T2, V, cap,
    dtypes, weights); the host loop keeps its one sync a step, whether
    every beam has finished, and stops where beam_search_eager stops. On
    the CPU the same step runs eagerly.

    Spans (utils/profiling.py): `search`, counting the steps run, holds
    `search.init` (the inputs into the buffers), per step `search.wait`
    (the host's sync) and either `search.replay` (the graph's launch) or,
    on a step that runs eagerly, `search.decoder`, `search.lm`,
    `search.ctc_prefix`, `search.topk` and `search.update`; and
    `search.capture` where a graph is captured.
    """
    cfg = model.cfg
    B, T2, _ = memory.shape
    dev = memory.device
    ctc_dtype = None if ctc_logits is None else ctc_logits.dtype
    weights = (float(ctc_weight), float(lm_weight), float(penalty))
    cap = fixed_cap(max_len)
    graphed = dev.type == "cuda"
    replayed = captured = steps = 0
    with (_graph_lock if graphed else contextlib.nullcontext()), \
            (torch.cuda.device(dev) if graphed else contextlib.nullcontext()), \
            span("search") as search:
        with span("search.init"):
            mem_b = memory.to(cfg.cdtype or memory.dtype)
            args = (model, lm, B, beam_size, T2, cap, ctc_dtype, weights, dev)
            st = _cached_search(*args) if graphed else _FixedSearch(*args)
            st.load(model, lm, mem_b, enc_len, ctc_logits)
        for step in range(max_len):
            search.n = steps = step + 1
            if st.graph is not None:
                with span("search.replay"):
                    st.graph.replay()
                replayed += 1
            elif graphed:
                st.warm_up(model, lm)
            else:
                st.step(model, lm)
            with span("search.wait"):
                stop = bool(st.all_done)
            if stop:
                break
            if graphed and st.graph is None:
                with span("search.capture"):
                    st.capture(model, lm)
                captured += 1
        tokens = st.tokens[:, :max_len + 1].reshape(B, beam_size, max_len + 1).clone()
        scores = st.scores.clone()
    _count(steps=steps, graph_steps=replayed, graph_captures=captured)
    if st.use_ctc and (replayed or captured):
        # a replay launches K2 past its wrapper; a capture launched nothing
        count_launches(replayed - captured)
    return tokens, scores


def beam_search_batched(model, feats, lengths, *, beam_size=10, max_len=100,
                        ctc_weight=0.3, penalty=0.0, lm=None, lm_weight=1.0,
                        device="cuda", incremental=False, prefix_scorer=None):
    """Batched joint CTC/attention beam search: B independent searches in
    one (B x K)-wide loop, after one batched encoder pass.

    feats (B, T, D), lengths (B,): numpy arrays or tensors, moved to
    `device`, which must be the model's (and the LM's). `device` defaults
    to "cuda" and raises without a card. Returns (tokens (B, K,
    max_len+1), scores (B, K)); see beam_search_encoded (`incremental`
    runs the KV-cached decoder, `prefix_scorer` is the host LM hook).
    """
    dev = resolve_device(device)
    feats = torch.as_tensor(feats).to(device=dev, dtype=torch.float32)
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.long)
    with torch.no_grad():
        memory, enc_len, ctc_logits = model.encode(feats, lengths)
    return beam_search_encoded(
        model, memory, enc_len, ctc_logits, beam_size=beam_size, max_len=max_len,
        ctc_weight=ctc_weight, penalty=penalty, lm=lm, lm_weight=lm_weight,
        incremental=incremental, prefix_scorer=prefix_scorer)


def tokens_to_list(tokens, scores, eos_id):
    """Host-side: the best hypothesis of one utterance (tokens (K, L),
    scores (K,)) as a python token list without sos, eos and padding."""
    best = int(torch.as_tensor(scores).argmax())
    seq = [int(t) for t in torch.as_tensor(tokens)[best, 1:].tolist() if t >= 0]
    return [t for t in seq if t != eos_id]
