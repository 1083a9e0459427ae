"""Back-off n-gram language model: interpolated modified Kneser-Ney
training, ARPA export/import, and perplexity evaluation.

Reference behaviour: the hybrid recipes build a 3-gram with the kaldi_lm
toolkit (recipes/timit/local_pyspeech/train_universal_lm.sh: lexicon OOV
mapping -> word counts -> train_lm.sh --arpa --lmtype 3gram-mincount,
scored by perplexity on held-out text). This module is the native
equivalent: same artefacts (ARPA file, perplexity report), standard
interpolated modified-KN estimation in place of kaldi_lm's mincount
variant. Host-side by design — n-gram estimation is dictionary work, not
device compute; the device-side LM is models.rnnlm.

Copy of speech_recognition_tools_tpu/models/ngram_lm.py (host code).
"""

import gzip
import math
from collections import Counter, defaultdict

BOS, EOS, UNK = "<s>", "</s>", "<unk>"


def _open(path, mode="rt"):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def sentences_from_text(texts, lexicon=None):
    """Kaldi-text values -> token lists, OOVs mapped to <unk> when a
    lexicon (set of known words) is given (train_universal_lm.sh's
    text.no_oov step)."""
    out = []
    for t in texts:
        words = t.split()
        if lexicon is not None:
            words = [w if w in lexicon else UNK for w in words]
        out.append(words)
    return out


class NgramLM:
    """Interpolated modified Kneser-Ney back-off model.

    logprob[(w1..wn)] and backoff[(w1..wn-1)] tables in log10 (the ARPA
    convention). Query with score(context_tuple, word).
    """

    def __init__(self, order, logprob, backoff, vocab):
        self.order = order
        self.logprob = logprob
        self.backoff = backoff
        self.vocab = vocab

    def score(self, context, word):
        """log10 P(word | context) with ARPA back-off:
        P(w|c) = logprob[c+w] if stored, else backoff[c] + P(w|c[1:])."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        bo_sum = 0.0
        while True:
            ng = context + (word,)
            if ng in self.logprob:
                return bo_sum + self.logprob[ng]
            if not context:
                # closed-vocab fallback: unseen unigram scores as <unk>
                return bo_sum + self.logprob.get((UNK,), -99.0)
            bo_sum += self.backoff.get(context, 0.0)
            context = context[1:]

    def sentence_logprob(self, words):
        """Sum log10 P over the sentence incl. </s>, BOS-padded."""
        ctx = (BOS,) * (self.order - 1)
        total = 0.0
        n = 0
        for w in list(words) + [EOS]:
            total += self.score(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
            n += 1
        return total, n

    def perplexity(self, sentences):
        total, n = 0.0, 0
        for s in sentences:
            lp, k = self.sentence_logprob(s)
            total += lp
            n += k
        return 10.0 ** (-total / max(n, 1))


def train_ngram_lm(sentences, order: int = 3, add_lexicon=None):
    """Interpolated modified Kneser-Ney estimation.

    sentences: list of token lists (already OOV-mapped). add_lexicon:
    optional iterable of words given one extra unigram count each (the
    train_universal_lm.sh '+1 for each lexicon word' step).

    Returns an NgramLM.
    """
    # --- raw counts per order, with BOS padding
    counts = [Counter() for _ in range(order + 1)]  # counts[n] on n-grams
    for s in sentences:
        padded = [BOS] * (order - 1) + list(s) + [EOS]
        for n in range(1, order + 1):
            start = (order - 1) - (n - 1)
            for i in range(start, len(padded) - n + 1):
                counts[n][tuple(padded[i : i + n])] += 1
    if add_lexicon:
        for w in add_lexicon:
            counts[1][(w,)] += 1
    counts[1][(UNK,)] = counts[1][(UNK,)] or 1  # floor at one, don't double

    vocab = {g[0] for g in counts[1]}
    vocab.discard(BOS)

    # --- Kneser-Ney continuation counts for lower orders: replace c(g) by
    # the number of distinct left extensions N1+(. g) for every order < max
    cont = [Counter() for _ in range(order + 1)]
    for n in range(2, order + 1):
        seen = set(counts[n])
        for g in seen:
            cont[n - 1][g[1:]] += 1
    adjusted = [Counter() for _ in range(order + 1)]
    adjusted[order] = counts[order]
    for n in range(1, order):
        # BOS-headed contexts never appear as continuations; keep raw counts
        for g, c in counts[n].items():
            adjusted[n][g] = cont[n][g] if cont[n][g] > 0 else c

    # --- absolute discount per order (interpolated KN, Chen & Goodman's
    # D = n1/(n1+2 n2) estimate with a 0.75 fallback). The three-discount
    # "modified" variant needs healthy count-of-count statistics; on small
    # corpora its D2/D3 estimates go non-monotone (a twice-seen word can
    # score below a once-seen one), so the single well-behaved discount is
    # the right production default — kaldi_lm's "mincount" flavour equally
    # deviates from textbook mKN.
    def discount(cnts):
        n1 = sum(1 for c in cnts.values() if c == 1)
        n2 = sum(1 for c in cnts.values() if c == 2)
        if n1 == 0 or n2 == 0:
            return 0.75
        d = n1 / (n1 + 2.0 * n2)
        return min(max(d, 0.1), 0.95)

    D = {n: discount(adjusted[n]) for n in range(1, order + 1)}

    def disc(n, c):
        return D[n] if c > 0 else 0.0

    # --- group n-grams by context
    by_ctx = [defaultdict(list) for _ in range(order + 1)]
    for n in range(1, order + 1):
        for g, c in adjusted[n].items():
            by_ctx[n][g[:-1]].append((g[-1], c))

    # --- interpolated probabilities, highest order down to unigrams
    logprob, backoff = {}, {}
    uni_total = sum(adjusted[1].values())
    V = len(vocab | {UNK})

    def p_interp(n, g):
        """interpolated KN probability of g (an n-gram tuple)."""
        if n == 0:
            return 1.0 / V
        ctx = g[:-1]
        items = by_ctx[n].get(ctx)
        if not items:
            return p_interp(n - 1, g[1:])
        total = sum(c for _, c in items)
        c = adjusted[n].get(g, 0)
        d = disc(n, c)
        # back-off mass from the discounts actually removed
        lam = sum(disc(n, ci) for _, ci in items) / total
        p_lower = p_interp(n - 1, g[1:]) if n > 1 else 1.0 / V
        return max(c - d, 0.0) / total + lam * p_lower

    floor = 1e-99
    for n in range(1, order + 1):
        for g in adjusted[n]:
            if g == (BOS,):
                logprob[g] = -99.0  # ARPA convention: <s> not predicted
                continue
            logprob[g] = math.log10(max(p_interp(n, g), floor))
    # back-off weights, ARPA-consistent:
    # bo(c) = log10[(1 - sum_{w seen after c} P(w|c)) /
    #               (1 - sum_{w seen after c} P(w|c[1:]))]
    # computed shortest contexts first so the denominator's backed-off
    # scores only touch already-final weights
    lm = NgramLM(order, logprob, backoff, vocab)  # shares the dicts
    for n in range(1, order):
        for ctx, items in by_ctx[n + 1].items():
            num = 1.0 - sum(
                10.0 ** logprob[ctx + (w,)]
                for w, _ in items
                if ctx + (w,) in logprob
            )
            den = 1.0 - sum(10.0 ** lm.score(ctx[1:], w) for w, _ in items)
            backoff[ctx] = math.log10(max(num, floor)) - math.log10(
                max(den, floor)
            )
    _ = uni_total
    return lm


def write_arpa(lm: NgramLM, path):
    """Write the model in ARPA format (kaldi_lm's lm_unpruned.gz shape).

    Contexts that carry only a back-off weight (no probability of their
    own — e.g. BOS-headed contexts, which are never *predicted*) still
    need an n-gram line to anchor the weight, with the conventional -99
    log-probability; dropping them would change every backed-off score
    after a round-trip and strip the start-state back-off arcs from
    decoding graphs built on the re-read model."""
    by_n = defaultdict(dict)
    for g, lp in lm.logprob.items():
        by_n[len(g)][g] = lp
    for g in lm.backoff:
        by_n[len(g)].setdefault(g, -99.0)
    with _open(path, "wt") as f:
        f.write("\\data\\\n")
        for n in range(1, lm.order + 1):
            f.write(f"ngram {n}={len(by_n[n])}\n")
        for n in range(1, lm.order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for g, lp in sorted(by_n[n].items()):
                bo = lm.backoff.get(g)
                line = f"{lp:.6f}\t{' '.join(g)}"
                if bo is not None and n < lm.order:
                    line += f"\t{bo:.6f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
    return path


def read_arpa(path):
    """Read an ARPA file back into an NgramLM."""
    logprob, backoff = {}, {}
    order = 0
    with _open(path, "rt") as f:
        section = 0
        for line in f:
            line = line.strip()
            if not line or line.startswith("\\data\\"):
                continue
            if line.startswith("\\end\\"):
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                section = int(line[1:].split("-")[0])
                order = max(order, section)
                continue
            if line.startswith("ngram "):
                continue
            if section:
                parts = line.split("\t")
                if len(parts) == 1:
                    parts = line.split()
                    lp, words, bo = parts[0], parts[1:section + 1], (
                        parts[section + 1] if len(parts) > section + 1 else None
                    )
                else:
                    lp, words = parts[0], tuple(parts[1].split())
                    bo = parts[2] if len(parts) > 2 else None
                g = tuple(words)
                logprob[g] = float(lp)
                if bo is not None:
                    backoff[g] = float(bo)
    vocab = {g[0] for g in logprob if len(g) == 1}
    vocab.discard(BOS)
    return NgramLM(order, logprob, backoff, vocab)
