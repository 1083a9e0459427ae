"""Native WFST decoding: Python driver over native/fst_decode.cpp.

Port of speech_recognition_tools_tpu/decode/wfst.py: the counterpart of
the reference's external Kaldi decode (`latgen-faster-mapped` over HCLG +
log-likelihood arks, decode_dnn.sh:128-143). The acoustic model runs
batched on the device and dumps log-likelihoods; this host-side C++
decoder consumes them against a decoding graph built by decode/graph.py
(or any OpenFst-text-format WFST with pdf+1 input labels). One-best with
beam + max-active pruning; a pure-Python reference decoder is provided
for testing/verification.

The decoder, decode_py and rescore_nbest are the JAX package's host code
over the port's own native library (io/native.py, which raises where the
JAX loader returns None). The two RNNLM scorers run the port's RNNLM
(models/rnnlm.py) on its own device, in place of the flax model.
"""

import ctypes
import math

import numpy as np

from speech_recognition_tools_tpu_torch.io.native import load as load_native


class WfstDecoder:
    """Loads a text-format WFST and decodes log-likelihood matrices."""

    def __init__(self, fst_path):
        lib = load_native()
        self._lib = lib
        self._h = lib.fst_load(str(fst_path).encode())
        if not self._h:
            raise FileNotFoundError(fst_path)

    @property
    def num_states(self):
        return int(self._lib.fst_num_states(self._h))

    @property
    def num_arcs(self):
        return int(self._lib.fst_num_arcs(self._h))

    def decode(self, loglikes, acoustic_scale=0.1, beam=16.0,
               max_active=7000, max_words=4096):
        """One-best decode of (T, P) log-likelihoods.

        Returns (word_ids, total_cost). word_ids index the graph's output
        symbol table (DecodingGraph.words / words.txt).
        """
        ll = np.ascontiguousarray(loglikes, np.float32)
        assert ll.ndim == 2, ll.shape
        out = np.zeros(max_words, np.int32)
        cost = ctypes.c_float()
        n = self._lib.fst_decode(
            self._h,
            ll.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ll.shape[0], ll.shape[1],
            ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
            int(max_active),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(max_words), ctypes.byref(cost),
        )
        if n < 0:
            raise RuntimeError("decoding failed (empty beam or bad pdf id)")
        if n > max_words:
            # The C++ core returns the *required* word count and truncates
            # the write at out_cap — retry once with an exact-size buffer
            # rather than silently dropping the hypothesis tail.
            return self.decode(
                loglikes, acoustic_scale=acoustic_scale, beam=beam,
                max_active=max_active, max_words=int(n),
            )
        return [int(w) for w in out[:n]], float(cost.value)

    def decode_nbest(self, loglikes, nbest=10, acoustic_scale=0.1,
                     beam=16.0, max_active=7000, max_words=16384):
        """N-best decode: tokens stay distinct by word history, so the
        per-state recombination preserves alternative word sequences
        (the native counterpart of the reference's lattice path).

        Returns a list of (word_ids, total_cost), best first.
        """
        ll = np.ascontiguousarray(loglikes, np.float32)
        assert ll.ndim == 2, ll.shape
        out = np.zeros(max_words, np.int32)
        lens = np.zeros(nbest, np.int32)
        costs = np.zeros(nbest, np.float32)
        n = self._lib.fst_decode_nbest(
            self._h,
            ll.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ll.shape[0], ll.shape[1],
            ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
            int(max_active), int(nbest),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(max_words),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < 0:
            raise RuntimeError("decoding failed (empty beam or bad pdf id)")
        hyps = []
        pos = 0
        for i in range(n):
            hyps.append((
                [int(w) for w in out[pos : pos + int(lens[i])]],
                float(costs[i]),
            ))
            pos += int(lens[i])
        return hyps

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.fst_free(self._h)
            self._h = None


def decode_py(fst_path, loglikes, acoustic_scale=0.1):
    """Exhaustive pure-Python Viterbi over the same text FST (no pruning).

    Reference implementation for tests: returns (word_ids, cost) exactly
    like WfstDecoder.decode with an infinite beam.
    """
    arcs_by_src = {}
    finals = {}
    max_state = -1
    with open(fst_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                s, d, il, ol = (int(x) for x in parts[:4])
                w = float(parts[4]) if len(parts) > 4 else 0.0
                arcs_by_src.setdefault(s, []).append((d, il, ol, w))
                max_state = max(max_state, s, d)
            elif parts:
                s = int(parts[0])
                finals[s] = float(parts[1]) if len(parts) > 1 else 0.0
                max_state = max(max_state, s)

    inf = math.inf

    def eps_closure(tokens):
        stack = list(tokens)
        while stack:
            s = stack.pop()
            cost, hist = tokens[s]
            for d, il, ol, w in arcs_by_src.get(s, []):
                if il != 0:
                    continue
                c = cost + w
                if d not in tokens or c < tokens[d][0]:
                    tokens[d] = (c, hist + ((ol,) if ol else ()))
                    stack.append(d)
        return tokens

    tokens = eps_closure({0: (0.0, ())})
    ll = np.asarray(loglikes, np.float64)
    for t in range(ll.shape[0]):
        nxt = {}
        for s, (cost, hist) in tokens.items():
            for d, il, ol, w in arcs_by_src.get(s, []):
                if il == 0:
                    continue
                c = cost + w - acoustic_scale * ll[t, il - 1]
                if d not in nxt or c < nxt[d][0]:
                    nxt[d] = (c, hist + ((ol,) if ol else ()))
        tokens = eps_closure(nxt)
        if not tokens:
            raise RuntimeError("empty beam")
    best = (inf, ())
    for s, (cost, hist) in tokens.items():
        if s in finals and cost + finals[s] < best[0]:
            best = (cost + finals[s], hist)
    if math.isinf(best[0]):
        for s, (cost, hist) in tokens.items():
            if cost < best[0]:
                best = (cost, hist)
    return list(best[1]), best[0]


def rescore_nbest(hyps, id2word, old_lm, new_scorer, lm_scale=1.0,
                  new_weight=1.0):
    """LM-rescore an N-best list (the native counterpart of the
    reference's lattice-rescoring stage).

    The graph's own LM contribution is removed exactly — the decoding
    graph was built from `old_lm` (decode/graph.py), so its per-sequence
    score is recomputable — and replaced by `new_scorer`:

        cost' = cost + lm_scale*ln(10)*lp_old(W) - new_weight*lm_scale
                      *ln(10)*lp_new(W)

    Args:
      hyps: [(word_ids, cost), ...] from WfstDecoder.decode_nbest.
      id2word: graph symbol table (DecodingGraph.id_to_word()).
      old_lm: the NgramLM the graph was built from.
      new_scorer: callable(list[str]) -> log10 sequence probability
        (e.g. lambda ws: old_lm.sentence_logprob(ws)[0], or an RNNLM
        wrapper); None keeps only the old-LM removal.
      lm_scale: scale of LM cost in the graph (1.0 when build_decoding
        _graph was used unmodified).
      new_weight: weight of the new LM.

    Returns the re-ranked [(word_ids, cost'), ...].
    """
    ln10 = math.log(10.0)
    out = []
    for ids, cost in hyps:
        words = [id2word[i] for i in ids]
        lp_old, _ = old_lm.sentence_logprob(words)
        c = cost + lm_scale * ln10 * lp_old
        if new_scorer is not None:
            c -= new_weight * lm_scale * ln10 * float(new_scorer(words))
        out.append((ids, c))
    out.sort(key=lambda x: x[1])
    return out


def _rnnlm_log10(model):
    """log10 P(tokens[1:] | tokens[:-1]) of one token list under the port's
    RNNLM, summed, on the model's device."""
    import torch

    dev = next(model.parameters()).device

    @torch.no_grad()
    def score(toks):
        arr = torch.as_tensor([toks], dtype=torch.long, device=dev)
        logp = torch.log_softmax(model(arr[:, :-1]), dim=-1)
        ll = logp.gather(-1, arr[:, 1:, None])[0, :, 0]
        return float(ll.sum()) / math.log(10.0)

    return score


def rnnlm_conditional_scorer(model, vocab):
    """Conditional log10 P(word | history) for lattice rescoring
    (decode.lattice.Lattice.rescore): defined as the prefix-score
    difference of the char RNNLM, so summing over a sentence (+ the
    word=None end-of-sentence call) telescopes to exactly the
    sentence-level rnnlm_sequence_scorer — lattice and N-best rescoring
    stay comparable. Prefix scores are memoized per utterance. `model` is
    the port's RNNLM, in eval mode."""
    from speech_recognition_tools_tpu_torch.io.text import encode_text

    sos = len(vocab) - 1
    log10p = _rnnlm_log10(model)
    cache = {}

    def prefix_logp(words, eos):
        key = (words, eos)
        if key in cache:
            return cache[key]
        ids = encode_text(" ".join(words), vocab)
        toks = [sos] + ids + ([sos] if eos else [])
        cache[key] = 0.0 if len(toks) < 2 else log10p(toks)
        return cache[key]

    def cond(hist, word):
        hist = tuple(hist)
        if word is None:
            return prefix_logp(hist, True) - prefix_logp(hist, False)
        return prefix_logp(hist + (word,), False) - prefix_logp(hist, False)

    return cond


def rnnlm_sequence_scorer(model, vocab):
    """log10 P(word sequence) under a character RNNLM trained by
    cli/train_lm (ESPnet conventions: the ASR char vocab with <space>
    tokens and a shared <sos/eos> as the last id). `model` is the port's
    RNNLM, in eval mode."""
    from speech_recognition_tools_tpu_torch.io.text import encode_text

    sos = len(vocab) - 1
    log10p = _rnnlm_log10(model)

    def score(words):
        return log10p([sos] + encode_text(" ".join(words), vocab) + [sos])

    return score
