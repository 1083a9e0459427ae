"""Look-ahead word-LM fusion for character-level beam search.

Port of speech_recognition_tools_tpu/decode/wordlm.py. The reference's
e2e recipes fuse a WORD RNNLM into the char-level decoder
(`use_wordlm=true`, lm_vocabsize 65000, e2e/wsj/run_fdlp_e1.sh:36-39,
516-519). A word LM cannot score char hypotheses token by token; a
lexical prefix tree bridges the two vocabularies, its subtree masses
giving per-character look-ahead scores:

- every tree node stores the sorted array of word ids under it, so a
  subtree mass is one gather and sum over the word-LM distribution;
- p(.|h) is computed on the device by the port's RNNLM and memoised per
  word history in a bounded LRU; the histories a call is missing run as
  one padded batch (the RNN is causal and masked by length, so each row is
  what the JAX package computes on its own, power-of-two-padded, history);
- the tree walk runs on the host and sums in float64, as in the JAX
  package.

Scoring contract (per char step, given word history h and the partial
word's tree node n; Z(n) = mass of node n under p(.|h)):

  child char c        log Z(n_c) - log Z(n)
  <space>, n terminal log p(w_n) - log Z(n)        (closes word w_n)
  <space>, else       log(p(unk) * oov_penalty)    (closes an OOV word)
  off-tree char       log(p(unk) * oov_penalty)    (enters OOV mode)
  char in OOV mode    log(oov_penalty)
  <space> in OOV mode 0.0                          (unk already charged)
  <sos/eos>           the matching <space> score + log p(<eos> | h, w)

so an OOV word costs log p(unk) + n_chars * log(oov_penalty), and the
end-of-sentence column already includes the word-level <eos> probability.
Blank scores NEG. The rows are raw scores, not normalised:
decode/beam_jit.py adds them to the LM column as they are
(`prefix_scorer`).

`stats` counts the history lookups (hits, misses) and the seconds of the
LM passes on the device (`device_s`, synchronised) and of the rest of each
call, the host tree walk (`host_s`).
"""

import time
from collections import OrderedDict

import numpy as np
import torch

NEG = -1.0e30  # "never pick" score that stays nan-free in arithmetic


def word_vocab_from_dict(path: str, n_vocab: int | None = None) -> dict:
    """Parse an ESPnet-style word dict ('word id' per line, e.g.
    data/local/wordlm_train/wordlist_65000.txt) into {word: id}. '<eos>' is
    appended at max_id+1 when the file omits it (ESPnet's load_labeldict
    convention); '<unk>' must be present. With n_vocab (the LM's embedding
    rows) the ids are validated against it."""
    vocab = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(
                    f"word dict {path}:{lineno}: expected 'word id', got "
                    f"{line.rstrip()!r} (a silently skipped line would "
                    "turn every affected word into an OOV)"
                )
            vocab[parts[0]] = int(parts[1])
    if "<unk>" not in vocab:
        raise ValueError(f"word dict {path} has no <unk> entry")
    if "<eos>" not in vocab:
        vocab["<eos>"] = max(vocab.values()) + 1
    if n_vocab is not None and max(vocab.values()) >= n_vocab:
        raise ValueError(
            f"word dict {path} ids reach {max(vocab.values())} but the "
            f"word LM has only {n_vocab} embedding rows"
        )
    return vocab


class _Node:
    __slots__ = ("children", "wid", "ids", "_idbuf")

    def __init__(self):
        self.children = {}
        self.wid = -1  # word id if a lexicon word ends exactly here
        self.ids = None  # np.ndarray of word ids under this node
        self._idbuf = []


def make_lexical_tree(word_vocab: dict, char_vocab: dict) -> _Node:
    """Prefix tree over the words' char-id spellings. Words containing
    characters outside the ASR char vocabulary and special '<...>' entries
    are skipped (they are unreachable from char hypotheses)."""
    root = _Node()
    for word, wid in word_vocab.items():
        if word.startswith("<") and word.endswith(">"):
            continue
        try:
            cids = [char_vocab[c] for c in word]
        except KeyError:
            continue
        if not cids:
            continue
        node = root
        node._idbuf.append(wid)
        for c in cids:
            node = node.children.setdefault(c, _Node())
            node._idbuf.append(wid)
        node.wid = wid
    stack = [root]
    while stack:
        n = stack.pop()
        n.ids = np.asarray(sorted(n._idbuf), dtype=np.int64)
        n._idbuf = None
        stack.extend(n.children.values())
    return root


def _lg(x) -> float:
    return float(np.log(max(x, 1e-30)))


class LookaheadWordLM:
    """A prefix scorer for decode/beam_jit.py: __call__(prefix_tokens (K, U),
    sos first) -> (K, char_vocab_size) float32 next-char scores. `lm` is the
    port's RNNLM over the word vocabulary, on its device."""

    def __init__(self, lm, word_vocab: dict, char_vocab: dict, oov_penalty: float = 1e-4,
                 cache_size: int = 2048):
        self.lm = lm
        self.word_vocab = word_vocab
        self.unk_w = word_vocab.get("<unk>")
        # tolerate the char-vocab eos spelling ("<sos/eos>") so an imported
        # LM dir's vocab.json works when it is a real word map
        self.eos_w = word_vocab.get("<eos>", word_vocab.get("<sos/eos>"))
        if self.unk_w is None or self.eos_w is None:
            raise ValueError(
                "word vocab lacks <unk> and/or <eos> — an imported LM "
                "dir's vocab.json may be char-convention; pass the LM's "
                "training wordlist via --word_lm_dict instead"
            )
        # a char-convention map also carries <unk>/<sos/eos>, but fusing a
        # 'lexicon' of single characters is silent garbage; <blank>/<space>
        # never appear in a real word list
        if "<blank>" in word_vocab or "<space>" in word_vocab:
            raise ValueError(
                "word vocab contains <blank>/<space> — this is a CHAR-"
                "convention map, not a word lexicon; pass the word LM's "
                "training wordlist via --word_lm_dict instead"
            )
        self.space_c = char_vocab.get("<space>")
        self.eos_c = char_vocab["<sos/eos>"]
        self.blank_c = char_vocab.get("<blank>", 0)
        self.n_char = len(char_vocab)
        self.oov_penalty = float(oov_penalty)
        self.root = make_lexical_tree(word_vocab, char_vocab)
        if self.root.ids.size == 0:
            raise ValueError("no lexicon word is spellable in the char "
                             "vocabulary — check the word dict")
        # word-history tuple -> (Vw,) float32 probs on the host, LRU-bounded:
        # a 65k-word row is ~260 KB and a test set visits unboundedly many
        self._dist = OrderedDict()
        self._cache_size = int(cache_size)
        self.stats = dict(hits=0, misses=0, device_s=0.0, host_s=0.0)

    @torch.no_grad()
    def _run_lm(self, hists: list) -> np.ndarray:
        """p(.|h) for each history, one padded RNNLM pass: rows (N, Vw)
        float32, exp(log_softmax) of the logits after <eos> + h."""
        dev = self.lm.output.weight.device
        lens = np.asarray([len(h) + 1 for h in hists], np.int64)
        toks = np.full((len(hists), int(lens.max())), -1, np.int64)
        for i, h in enumerate(hists):
            toks[i, 0] = self.eos_w
            toks[i, 1 : lens[i]] = h
        lens_t = torch.as_tensor(lens, device=dev)
        logits = self.lm(torch.as_tensor(toks, device=dev), lens_t)
        last = logits[torch.arange(len(hists), device=dev), lens_t - 1]
        return torch.exp(torch.log_softmax(last, dim=-1)).float().cpu().numpy()

    def _dists(self, hists) -> dict:
        """{history: probs} for `hists`: LRU hits as they are, the misses
        computed together and inserted (the oldest entries evicted)."""
        out, missing = {}, []
        for h in hists:
            if h in out or h in missing:
                continue
            p = self._dist.get(h)
            if p is None:
                missing.append(h)
                self.stats["misses"] += 1
            else:
                self._dist.move_to_end(h)
                out[h] = p
                self.stats["hits"] += 1
        if missing:
            t0 = time.perf_counter()
            rows = self._run_lm(missing)  # .cpu() synchronises the device
            self.stats["device_s"] += time.perf_counter() - t0
            for h, p in zip(missing, rows):
                out[h] = p
                self._dist[h] = p
                if len(self._dist) > self._cache_size:
                    self._dist.popitem(last=False)
        return out

    def _parse(self, chars):
        """Char prefix -> (word-history tuple, node-or-None, in_tree). node
        None means the partial word has left the tree (OOV mode); a fresh
        word starts at the root."""
        hist = []
        node, clean = self.root, True
        for c in chars:
            c = int(c)
            if c == self.eos_c:
                break
            if c == self.space_c:
                hist.append(node.wid if (clean and node.wid >= 0) else self.unk_w)
                node, clean = self.root, True
                continue
            if clean and c in node.children:
                node = node.children[c]
            else:
                node, clean = None, False
        return tuple(hist), node, clean

    def __call__(self, prefix_tokens) -> np.ndarray:
        if isinstance(prefix_tokens, torch.Tensor):
            prefix_tokens = prefix_tokens.cpu().numpy()
        t0 = time.perf_counter()
        dev_s = self.stats["device_s"]
        prefix = np.asarray(prefix_tokens)
        parsed = [self._parse(row[1:]) for row in prefix]  # [0] is <sos>
        closing = [node.wid if in_tree and node.wid >= 0 else self.unk_w
                   for _, node, in_tree in parsed]
        dists = self._dists([h for h, _, _ in parsed]
                            + [h + (w,) for (h, _, _), w in zip(parsed, closing)])
        out = np.empty((prefix.shape[0], self.n_char), np.float32)
        for k, ((hist, node, in_tree), w) in enumerate(zip(parsed, closing)):
            out[k] = self._row(dists[hist], node, in_tree, dists[hist + (w,)])
        self.stats["host_s"] += (time.perf_counter() - t0) - (self.stats["device_s"] - dev_s)
        return out

    def _row(self, probs, node, in_tree, probs_next) -> np.ndarray:
        log_oov = _lg(probs[self.unk_w]) + np.log(self.oov_penalty)
        y = np.empty(self.n_char, np.float32)
        if in_tree:
            # entering OOV mode is allowed from any in-tree node
            y[:] = log_oov
            z = max(probs[node.ids].sum(dtype=np.float64), 1e-30)
            for c, child in node.children.items():
                y[c] = np.log(max(probs[child.ids].sum(dtype=np.float64), 1e-30)) - np.log(z)
            end = _lg(probs[node.wid]) - np.log(z) if node.wid >= 0 else log_oov
        else:  # OOV mode: flat per-char penalty, the word closes as <unk>
            y[:] = np.log(self.oov_penalty)
            end = 0.0
        if self.space_c is not None:
            y[self.space_c] = end
        y[self.eos_c] = end + _lg(probs_next[self.eos_w])
        y[self.blank_c] = NEG
        return y
