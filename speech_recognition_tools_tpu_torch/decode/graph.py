"""Decoding-graph builder: HMM x lexicon x n-gram LM -> one WFST.

Native replacement for the reference's external Kaldi graph stage
(`utils/mkgraph.sh` building HCLG.fst, consumed by latgen-faster-mapped;
recipes/timit/local_pyspeech/decode_dnn.sh:121-143). Instead of the
generic compose/determinize/minimize cascade over separate H, C, L, G
transducers, the graph is *statically expanded* in one pass: the ARPA
n-gram becomes a back-off word automaton (states = LM contexts), and
every word arc is spliced with its lexicon phone chain expanded into
left-to-right HMM states — the construction a monophone HCLG reduces to.

Label conventions (matched by native/fst_decode.cpp):
  * input labels:  pdf-id + 1 (0 = epsilon); pdf = phone * states_per_phone
    + hmm_state, so an AM trained on these targets plugs in directly.
  * output labels: word ids from `words` (0 = epsilon).
  * weights: tropical costs in nats (-ln p); LM log10 scores are
    converted on the word-arc.

The text format written by `write()` is OpenFst-compatible
("src dst ilabel olabel cost" / "state cost" lines, state 0 = start).

Copy of speech_recognition_tools_tpu/decode/graph.py (host code).
"""

import math
from dataclasses import dataclass

from speech_recognition_tools_tpu_torch.align.forced import HmmTopology
from speech_recognition_tools_tpu_torch.models.ngram_lm import BOS, EOS, NgramLM

_LN10 = math.log(10.0)


@dataclass(frozen=True)
class GraphConfig:
    states_per_phone: int = 3
    self_loop_prob: float = 0.5
    # optional silence phone id inserted optionally after every word and
    # at sentence start (classic L_disambig optional-silence topology)
    silence_phone: int | None = None
    silence_prob: float = 0.5
    # topology tier (align/forced.HmmTopology, shared with the native
    # aligner): silence_states gives silence its own chain length
    # (Kaldi's 5-state silence); wpd_silence gives utterance-boundary
    # silence a distinct pdf block from inter-word silence
    silence_states: int | None = None
    wpd_silence: bool = False


class DecodingGraph:
    """Arcs + finals + symbol tables of a built decoding graph."""

    def __init__(self, arcs, finals, words, num_pdfs):
        self.arcs = arcs          # list[(src, dst, ilabel, olabel, cost)]
        self.finals = finals      # dict[state] = cost
        self.words = words        # dict[word] = id (>= 1)
        self.num_pdfs = num_pdfs

    @property
    def num_states(self):
        m = 0
        for s, d, *_ in self.arcs:
            m = max(m, s, d)
        return max([m] + list(self.finals)) + 1

    def write(self, path):
        with open(path, "w") as f:
            for s, d, il, ol, w in self.arcs:
                f.write(f"{s} {d} {il} {ol} {w:.6f}\n")
            for s, w in sorted(self.finals.items()):
                f.write(f"{s} {w:.6f}\n")
        return path

    def write_words(self, path):
        with open(path, "w") as f:
            f.write("<eps> 0\n")
            for w, i in sorted(self.words.items(), key=lambda kv: kv[1]):
                f.write(f"{w} {i}\n")
        return path

    def id_to_word(self):
        return {i: w for w, i in self.words.items()}


def build_decoding_graph(
    lm: NgramLM,
    lexicon: dict,
    cfg: GraphConfig = GraphConfig(),
) -> DecodingGraph:
    """Statically expand HMM x lexicon x LM into one decoding WFST.

    Args:
      lm: back-off n-gram LM (models.ngram_lm), ARPA log10 scores.
      lexicon: word -> list of phone ids (0-based). Words of the LM that
        are missing from the lexicon (e.g. <unk>) get no word arc.
      cfg: HMM topology knobs.

    Returns a DecodingGraph; pdf-id = phone * states_per_phone + state.
    """
    S = cfg.states_per_phone
    empty = [w for w, phones in lexicon.items() if not phones]
    if empty:
        # an empty pronunciation would splice a free zero-cost epsilon path
        # between LM context states (dropping the word label and LM cost),
        # which with a positive-log10 backoff can even form a negative-cost
        # epsilon cycle that hangs the decoder.
        raise ValueError(
            f"lexicon entries with no phones: {sorted(empty)[:10]}"
        )
    num_phones = 1 + max(
        [p for phones in lexicon.values() for p in phones]
        + ([cfg.silence_phone] if cfg.silence_phone is not None else [0])
    )
    topo = HmmTopology(
        num_phones, S, cfg.silence_phone,
        silence_states=cfg.silence_states, wpd_silence=cfg.wpd_silence,
    )
    num_pdfs = topo.num_pdfs

    words = {w: i + 1 for i, w in enumerate(sorted(lexicon))}

    arcs = []
    finals = {}
    next_state = [0]

    def new_state():
        next_state[0] += 1
        return next_state[0]

    # ---- LM back-off automaton over contexts ----
    contexts = {ctx for ctx in lm.backoff}
    contexts.update(g[:-1] for g in lm.logprob)
    contexts.add(())

    def suffix_state(ctx):
        """Longest suffix of ctx that is a known context."""
        while ctx not in contexts:
            ctx = ctx[1:]
        return ctx

    start_ctx = suffix_state((BOS,) * (lm.order - 1))
    ctx_ids = {start_ctx: 0}
    next_state[0] = 0

    def ctx_state(ctx):
        if ctx not in ctx_ids:
            ctx_ids[ctx] = new_state()
        return ctx_ids[ctx]

    final_state = new_state()
    finals[final_state] = 0.0

    self_cost = -math.log(cfg.self_loop_prob)
    fwd_cost = -math.log(1.0 - cfg.self_loop_prob)

    def splice_hmm_chain(src, dst, phones, olabel, cost):
        """src --[HMM chain for phones]--> dst; first emitting arc carries
        olabel + cost."""
        cur = src
        first = True
        for ph in phones:
            for st in range(topo.states(ph)):
                pdf = topo.pdf(ph, st)
                nxt = new_state()
                # entering arc (emits pdf)
                arcs.append(
                    (cur, nxt, pdf + 1, olabel if first else 0,
                     (cost if first else 0.0) + fwd_cost)
                )
                first = False
                # self loop
                arcs.append((nxt, nxt, pdf + 1, 0, self_cost))
                cur = nxt
        arcs.append((cur, dst, 0, 0, 0.0))

    def maybe_silence(src, dst, edge=False):
        """Optional silence between src and dst (plus direct epsilon).
        edge=True uses the utterance-boundary silence pdf block when the
        topology is word-position-dependent."""
        if cfg.silence_phone is None:
            arcs.append((src, dst, 0, 0, 0.0))
            return
        sil_cost = -math.log(cfg.silence_prob)
        nosil_cost = -math.log(1.0 - cfg.silence_prob)
        arcs.append((src, dst, 0, 0, nosil_cost))
        ph = topo.edge_silence_phone if edge else cfg.silence_phone
        splice_hmm_chain(src, dst, [ph], 0, sil_cost)

    # word arcs from every stored n-gram
    for g, lp in lm.logprob.items():
        w = g[-1]
        ctx = g[:-1]
        if ctx not in contexts:
            continue
        src = ctx_state(ctx)
        cost = -_LN10 * lp
        if w == EOS:
            if cfg.wpd_silence and cfg.silence_phone is not None:
                # utterance-final optional silence gets the boundary pdf
                # block (matches the aligner's trailing edge-silence)
                mid2 = new_state()
                arcs.append((src, mid2, 0, 0, cost))
                maybe_silence(mid2, final_state, edge=True)
            else:
                arcs.append((src, final_state, 0, 0, cost))
            continue
        if w == BOS or w not in words:
            continue
        if len(g) < lm.order:
            dst_ctx = suffix_state(g)
        else:
            dst_ctx = suffix_state(g[1:])
        dst = ctx_state(dst_ctx)
        # src --word HMM--> mid --optional sil--> dst
        mid = new_state()
        splice_hmm_chain(src, mid, lexicon[w], words[w], cost)
        maybe_silence(mid, dst)

    # back-off epsilon arcs
    for ctx, bo in lm.backoff.items():
        if ctx not in contexts or not ctx:
            continue
        src = ctx_state(ctx)
        dst = ctx_state(suffix_state(ctx[1:]))
        arcs.append((src, dst, 0, 0, -_LN10 * bo))

    # optional sentence-initial silence: a silence HMM looping on the
    # start context (state 0 stays the start state); boundary pdf block
    # under a word-position-dependent topology
    if cfg.silence_phone is not None:
        splice_hmm_chain(0, 0, [topo.edge_silence_phone],
                         0, -math.log(cfg.silence_prob))

    return DecodingGraph(arcs, finals, words, num_pdfs)
