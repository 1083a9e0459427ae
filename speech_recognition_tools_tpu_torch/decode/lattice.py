"""Word lattices from the native decoder: generation, best/N-best paths,
oracle WER, exact LM rescoring, posterior computation and multi-system
combination.

The native counterpart of the reference's Kaldi lattice stack:
  * lattice generation — `latgen-faster-mapped ... "ark:|gzip -c > lat.JOB.gz"`
    (recipes/timit/local_pyspeech/decode_dnn.sh:128-143 of the reference),
    here `decode_lattice` over native/fst_decode.cpp's link-recording
    token passing;
  * lattice rescoring — the reference rescales LM weight inside lattices
    at scoring time (`score.sh` lmwt sweep); here `rescore` replaces the
    graph's n-gram scores *exactly* with any new LM, expanding lattice
    states by LM context (exact for back-off n-grams, beam-pruned
    push-forward for RNNLMs);
  * system fusion — `lattice-combine` posterior-weighted union
    (recipes/timit/local_pyspeech/combine_lattice.sh:23-26 of the reference),
    here `combine` (union) + `posteriors`-based confusion-network voting
    (`cn_combine`).

The native decoder emits a *state-level* lattice (epsilon arcs kept,
graph/acoustic costs separate, one node per surviving (frame, state)
token within `lattice_beam` of the best path). All algorithms here work
directly on that DAG; `Lattice.word_lattice()` compresses epsilons away
when an explicit word graph is wanted.

Copy of speech_recognition_tools_tpu/decode/lattice.py (host code over
the port's own native library, io/native.py).
"""

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Lattice:
    """State-level lattice DAG. Node 0 is the start; `frames[i]` is the
    frame index of node i; links carry (olabel, graph_cost, ac_cost);
    `finals` maps node -> final cost."""

    frames: np.ndarray          # (N,) int32
    link_from: np.ndarray       # (L,) int32
    link_to: np.ndarray         # (L,) int32
    link_olabel: np.ndarray     # (L,) int32 (0 = epsilon)
    link_graph: np.ndarray      # (L,) float32
    link_ac: np.ndarray         # (L,) float32
    finals: dict = field(default_factory=dict)   # node -> final cost
    best_cost: float = 0.0

    @property
    def num_nodes(self):
        return int(self.frames.shape[0])

    @property
    def num_links(self):
        return int(self.link_from.shape[0])

    # -- structural helpers -------------------------------------------------

    def topo_order(self):
        """Topological order of nodes (frames ascend; intra-frame epsilon
        chains resolved by Kahn's algorithm)."""
        n = self.num_nodes
        indeg = np.zeros(n, np.int64)
        np.add.at(indeg, self.link_to, 1)
        out = [[] for _ in range(n)]
        for i in range(self.num_links):
            out[int(self.link_from[i])].append(i)
        order = [i for i in range(n) if indeg[i] == 0]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for li in out[u]:
                v = int(self.link_to[li])
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(order) != n:
            raise ValueError("lattice is not a DAG")
        return order, out

    def link_cost(self, lm_scale=1.0, ac_scale=1.0):
        return lm_scale * self.link_graph.astype(np.float64) + \
            ac_scale * self.link_ac.astype(np.float64)

    # -- best path ----------------------------------------------------------

    def best_path(self, lm_scale=1.0, ac_scale=1.0):
        """Shortest path start -> final. Returns (word_ids, cost); equals
        the one-best decoder output at lm_scale=ac_scale=1."""
        order, out = self.topo_order()
        w = self.link_cost(lm_scale, ac_scale)
        dist = np.full(self.num_nodes, np.inf)
        back = np.full(self.num_nodes, -1, np.int64)
        dist[0] = 0.0
        for u in order:
            if not math.isfinite(dist[u]):
                continue
            for li in out[u]:
                v = int(self.link_to[li])
                c = dist[u] + w[li]
                if c < dist[v]:
                    dist[v] = c
                    back[v] = li
        best, bn = np.inf, -1
        for node, fc in self.finals.items():
            c = dist[node] + fc
            if c < best:
                best, bn = c, node
        if bn < 0:
            raise ValueError("no path to a final node")
        words = []
        v = bn
        while back[v] >= 0:
            li = int(back[v])
            if self.link_olabel[li]:
                words.append(int(self.link_olabel[li]))
            v = int(self.link_from[li])
        return words[::-1], float(best)

    # -- N-best -------------------------------------------------------------

    def nbest(self, n, lm_scale=1.0, ac_scale=1.0, beam=20.0):
        """N best *distinct word sequences* through the lattice.

        A* over (node, word-history) with the exact backward Viterbi cost
        as heuristic; paths merging on the same (node, words-so-far) are
        recombined, so each returned hypothesis is the best-scoring
        alignment of its word sequence (matching decode_nbest semantics).
        `beam` is an ABSOLUTE cost margin over the best path (same units
        as lattice_beam elsewhere): hypotheses costing more than
        best + beam are not expanded.
        Returns [(word_ids, cost)], best first.
        """
        import heapq

        order, out = self.topo_order()
        w = self.link_cost(lm_scale, ac_scale)
        # backward best cost to a final
        bwd = np.full(self.num_nodes, np.inf)
        for node, fc in self.finals.items():
            bwd[node] = fc
        for u in reversed(order):
            for li in out[u]:
                c = w[li] + bwd[int(self.link_to[li])]
                if c < bwd[u]:
                    bwd[u] = c
        if not math.isfinite(bwd[0]):
            raise ValueError("no path to a final node")

        results = []
        emitted = set()
        seen_end = {}
        # heap entries: (est_total, cost_so_far, node, words); node -1 is
        # the virtual end state — stopping at a final is an explicit
        # transition of cost final_cost, NOT an immediate emission.
        # (Emitting on first completion is wrong: at a final node u,
        # est = cost + bwd[u] can be SMALLER than cost + fc_u when the
        # cheapest continuation runs through another final, so a later
        # pop may complete the same word sequence cheaper. End entries
        # have est == true total, so popping one is provably minimal.)
        heap = [(bwd[0], 0.0, 0, ())]
        best_map = {(0, ()): 0.0}
        limit = bwd[0] + beam
        while heap and len(results) < n:
            est, cost, u, words = heapq.heappop(heap)
            if est > limit:
                break
            if u == -1:
                if words not in emitted:
                    emitted.add(words)
                    results.append((list(words), cost))
                continue
            if best_map.get((u, words), np.inf) < cost - 1e-9:
                continue  # superseded
            fc = self.finals.get(u)
            if fc is not None:
                total = cost + fc
                if total < seen_end.get(words, np.inf) - 1e-9:
                    seen_end[words] = total
                    heapq.heappush(heap, (total, total, -1, words))
            for li in out[u]:
                v = int(self.link_to[li])
                nw = words + ((int(self.link_olabel[li]),)
                              if self.link_olabel[li] else ())
                c = cost + w[li]
                key = (v, nw)
                if c < best_map.get(key, np.inf) - 1e-9:
                    best_map[key] = c
                    heapq.heappush(heap, (c + bwd[v], c, v, nw))
        return results

    # -- oracle -------------------------------------------------------------

    def oracle_wer(self, ref_words):
        """Minimum word-error count over every path in the lattice vs a
        reference (list of word ids), i.e. Kaldi lattice-oracle.

        DP over (node, ref position) with Levenshtein moves; epsilon
        links advance the node only. Returns (errors, len(ref), best
        matching hypothesis word ids).
        """
        order, out = self.topo_order()
        R = len(ref_words)
        INF = 10**9
        # cost[node] = array over ref positions 0..R of min edits
        cost = [None] * self.num_nodes
        back = [None] * self.num_nodes
        start = np.arange(R + 1, dtype=np.int64)  # leading deletions
        cost[0] = start.copy()
        back[0] = {}
        for u in order:
            if cost[u] is None:
                continue
            cu = cost[u]
            for li in out[u]:
                v = int(self.link_to[li])
                ol = int(self.link_olabel[li])
                if ol == 0:
                    cand = cu
                else:
                    cand = np.empty(R + 1, np.int64)
                    # insertion (consume hyp word, no ref)
                    cand[0] = cu[0] + 1
                    for j in range(1, R + 1):
                        sub = cu[j - 1] + (ref_words[j - 1] != ol)
                        cand[j] = min(cu[j] + 1, sub)
                    # deletions folded in below
                # allow deletions after the move
                run = cand.copy()
                for j in range(1, R + 1):
                    if run[j - 1] + 1 < run[j]:
                        run[j] = run[j - 1] + 1
                if cost[v] is None:
                    cost[v] = np.full(R + 1, INF, np.int64)
                    back[v] = {}
                improved = run < cost[v]
                if improved.any():
                    for j in np.nonzero(improved)[0]:
                        cost[v][j] = run[j]
                        back[v][int(j)] = (u, li)
        best = (INF, None)
        for node, _fc in self.finals.items():
            if cost[node] is not None and cost[node][R] < best[0]:
                best = (int(cost[node][R]), node)
        if best[1] is None:
            raise ValueError("no path to a final node")
        # reconstruct (approximately — follow backpointers at position R)
        words = []
        node, j = best[1], R
        guard = 0
        while node != 0 and guard < 10**6:
            guard += 1
            bp = back[node].get(j)
            if bp is None:
                # backpointer was stored for a different j; scan any
                found = next(iter(back[node].values()), None)
                if found is None:
                    break
                bp = found
            u, li = bp
            if self.link_olabel[li]:
                words.append(int(self.link_olabel[li]))
            node = u
        return best[0], R, words[::-1]

    # -- posteriors ---------------------------------------------------------

    def posteriors(self, lm_scale=1.0, ac_scale=1.0):
        """Link posteriors by forward-backward over the tropical->log
        semiring (sum-exp of path scores). Returns (L,) float64."""
        order, out = self.topo_order()
        w = self.link_cost(lm_scale, ac_scale)
        NEG = -np.inf
        alpha = np.full(self.num_nodes, NEG)
        alpha[0] = 0.0
        for u in order:
            au = alpha[u]
            if au == NEG:
                continue
            for li in out[u]:
                v = int(self.link_to[li])
                alpha[v] = np.logaddexp(alpha[v], au - w[li])
        beta = np.full(self.num_nodes, NEG)
        for node, fc in self.finals.items():
            beta[node] = -fc
        for u in reversed(order):
            for li in out[u]:
                beta[u] = np.logaddexp(
                    beta[u], -w[li] + beta[int(self.link_to[li])]
                )
        logz = beta[0]
        post = np.zeros(self.num_links)
        for u in order:
            if alpha[u] == NEG:
                continue
            for li in out[u]:
                post[li] = np.exp(
                    alpha[u] - w[li] + beta[int(self.link_to[li])] - logz
                )
        return post

    # -- word lattice / sausage ---------------------------------------------

    def word_lattice(self):
        """Epsilon-free word-level lattice: contract epsilon links (their
        costs pushed onto following word links / final costs). Returns a
        new Lattice whose links all carry words."""
        order, out = self.topo_order()
        n = self.num_nodes
        # eps-closure from each node: node -> {reachable: min eps cost}
        eps_out = [[] for _ in range(n)]
        word_out = [[] for _ in range(n)]
        for i in range(self.num_links):
            (word_out if self.link_olabel[i] else eps_out)[
                int(self.link_from[i])
            ].append(i)
        closure = [None] * n
        for u in reversed(order):
            cl = {u: 0.0}
            for li in eps_out[u]:
                v = int(self.link_to[li])
                c = float(self.link_graph[li] + self.link_ac[li])
                for node, cv in closure[v].items():
                    cc = c + cv
                    if cc < cl.get(node, np.inf):
                        cl[node] = cc
            closure[u] = cl
        # nodes that matter: start + word-link destinations
        keep = {0}
        for i in range(self.num_links):
            if self.link_olabel[i]:
                keep.add(int(self.link_to[i]))
        remap = {u: i for i, u in enumerate(sorted(keep))}
        lf, lt, lo, lg, la = [], [], [], [], []
        finals = {}
        for u in keep:
            for mid, ec in closure[u].items():
                fc = self.finals.get(mid)
                if fc is not None:
                    c = ec + fc
                    if c < finals.get(remap[u], np.inf):
                        finals[remap[u]] = c
                for li in word_out[mid]:
                    lf.append(remap[u])
                    lt.append(remap[int(self.link_to[li])])
                    lo.append(int(self.link_olabel[li]))
                    lg.append(float(self.link_graph[li]) + ec)
                    la.append(float(self.link_ac[li]))
        return Lattice(
            frames=np.asarray(
                [self.frames[u] for u in sorted(keep)], np.int32
            ),
            link_from=np.asarray(lf, np.int32),
            link_to=np.asarray(lt, np.int32),
            link_olabel=np.asarray(lo, np.int32),
            link_graph=np.asarray(lg, np.float32),
            link_ac=np.asarray(la, np.float32),
            finals=finals,
            best_cost=self.best_cost,
        )

    # -- exact LM rescoring --------------------------------------------------

    def rescore(self, id2word, old_lm, new_scorer=None, lm_scale=1.0,
                new_weight=1.0, beam=20.0, history_limit=None,
                max_states=500000):
        """Exact lattice LM rescoring (the lattice analogue of
        wfst.rescore_nbest, beyond it in coverage: *every* lattice path
        is rescored, not an N-best approximation).

        The decoding graph was built from `old_lm` (decode/graph.py), so
        each path's total LM contribution — word arcs + back-off epsilon
        arcs + the </s> arc into the final state — sums to exactly
        -lm_scale*ln10*log10 P_old(sentence). It is removed by adding
        lm_scale*ln10*score_old(w|h) per word link (+ the </s> term at
        finals) along a (node, word-history)-expanded shortest-path
        search, and `new_scorer`'s scores are subtracted in its place.
        Acoustic and non-LM graph costs (HMM topology, silence) pass
        through untouched.

        Args:
          new_scorer: callable(history_word_tuple, word_or_None) ->
            log10 P(word | history) (None = end of sentence). Defaults
            to old_lm's own conditional — then the result provably
            equals best_path() (the exactness check in tests).
          history_limit: words of history kept in the search state; must
            be >= old_lm.order - 1 (the old-LM removal needs that exact
            context; smaller values raise ValueError).
            Default: old_lm.order - 1 when new_scorer is None (exact),
            unbounded otherwise (exact for any scorer; `beam` prunes).
          beam: cost beam over the plain-lattice backward bound.

        Returns (word_ids, cost) of the rescored best path.
        """
        import heapq

        ln10 = math.log(10.0)
        from speech_recognition_tools_tpu_torch.models.ngram_lm import BOS, EOS

        K = old_lm.order - 1
        if history_limit is not None and history_limit < K:
            # old_cond BOS-pads histories shorter than K; a history
            # truncated below K would be scored as sentence-initial,
            # making the old-LM removal systematically wrong (a bias,
            # not a pruning) — so this is an error, not a knob setting
            raise ValueError(
                f"history_limit={history_limit} < old_lm.order-1={K}: "
                "the old-LM score removal needs the exact K-word "
                "context; use history_limit >= K (or None)"
            )

        def old_cond(hist_ids, word):
            ctx = tuple(id2word[h] for h in hist_ids[-K:]) if K else ()
            if len(ctx) < K:
                ctx = (BOS,) * (K - len(ctx)) + ctx
            return old_lm.score(ctx, EOS if word is None else word)

        if new_scorer is None:
            def new_scorer(hist_words, word):
                h = (BOS,) * max(0, K - len(hist_words)) + tuple(
                    hist_words[-K:] if K else ()
                )
                return old_lm.score(h, EOS if word is None else word)

            if history_limit is None:
                history_limit = K

        def trunc(hist):
            # histories are only ever truncated at >= K words (validated
            # above), so old_cond always sees the exact K-word context;
            # truncation only bounds the state space seen by new_scorer
            if history_limit is not None and len(hist) > history_limit:
                return hist[-history_limit:]
            return hist

        order, out = self.topo_order()
        w_ac = self.link_ac.astype(np.float64)
        # backward bound from plain lattice costs, for pruning only
        bwd = np.full(self.num_nodes, np.inf)
        w_all = self.link_cost(1.0, 1.0)
        for node, fc in self.finals.items():
            bwd[node] = fc
        for u in reversed(order):
            for li in out[u]:
                c = w_all[li] + bwd[int(self.link_to[li])]
                if c < bwd[u]:
                    bwd[u] = c

        best = {(0, ()): 0.0}
        back = {}
        heap = [(0.0, 0, ())]
        best_total = np.inf
        best_key = None
        expanded = 0
        while heap:
            cost, u, hist = heapq.heappop(heap)
            if cost > best.get((u, hist), np.inf) + 1e-9:
                continue
            if cost + max(0.0, float(bwd[u])) > best_total + beam:
                continue
            expanded += 1
            if expanded > max_states:
                break
            fc = self.finals.get(u)
            if fc is not None:
                hw = tuple(id2word[h] for h in hist)
                total = (
                    cost + fc
                    + lm_scale * ln10 * old_cond(hist, None)
                    - new_weight * lm_scale * ln10
                    * float(new_scorer(hw, None))
                )
                if total < best_total:
                    best_total = total
                    best_key = (u, hist)
            for li in out[u]:
                v = int(self.link_to[li])
                ol = int(self.link_olabel[li])
                c = cost + w_ac[li] + float(self.link_graph[li])
                if ol == 0:
                    nh = hist
                else:
                    word = id2word[ol]
                    hw = tuple(id2word[h] for h in hist)
                    c += lm_scale * ln10 * old_cond(hist, word)
                    c -= new_weight * lm_scale * ln10 * float(
                        new_scorer(hw, word)
                    )
                    nh = trunc(hist + (ol,))
                key = (v, nh)
                if c < best.get(key, np.inf) - 1e-9:
                    best[key] = c
                    back[key] = ((u, hist), ol)
                    heapq.heappush(heap, (c, v, nh))
        if best_key is None:
            raise ValueError("rescoring pruned away every path")
        words = []
        key = best_key
        while key in back:
            key, ol = back[key]
            if ol:
                words.append(ol)
        return words[::-1], float(best_total)


def write_lattice(lat: Lattice, path):
    """Text serialization (gzip if path ends .gz), Kaldi-text-lattice
    shaped: arc lines 'from to olabel graph_cost,acoustic_cost', final
    lines 'node cost', preceded by one '#frames f0 f1 ...' header."""
    import gzip

    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wt") as f:
        f.write("#frames " + " ".join(str(int(x)) for x in lat.frames)
                + "\n")
        for i in range(lat.num_links):
            f.write(
                f"{int(lat.link_from[i])} {int(lat.link_to[i])} "
                f"{int(lat.link_olabel[i])} "
                f"{float(lat.link_graph[i]):.6f},"
                f"{float(lat.link_ac[i]):.6f}\n"
            )
        for node, fc in sorted(lat.finals.items()):
            f.write(f"{node} {fc:.6f}\n")
    return path


def read_lattice(path) -> Lattice:
    import gzip

    op = gzip.open if str(path).endswith(".gz") else open
    frames = None
    lf, lt, lo, lg, la = [], [], [], [], []
    finals = {}
    with op(path, "rt") as f:
        for line in f:
            if line.startswith("#frames"):
                frames = np.asarray(
                    [int(x) for x in line.split()[1:]], np.int32
                )
                continue
            parts = line.split()
            if len(parts) == 4:
                gw, aw = parts[3].split(",")
                lf.append(int(parts[0]))
                lt.append(int(parts[1]))
                lo.append(int(parts[2]))
                lg.append(float(gw))
                la.append(float(aw))
            elif len(parts) == 2:
                finals[int(parts[0])] = float(parts[1])
    lat = Lattice(
        frames=frames,
        link_from=np.asarray(lf, np.int32),
        link_to=np.asarray(lt, np.int32),
        link_olabel=np.asarray(lo, np.int32),
        link_graph=np.asarray(lg, np.float32),
        link_ac=np.asarray(la, np.float32),
        finals=finals,
    )
    try:
        lat.best_cost = lat.best_path()[1]
    except ValueError:
        pass
    return lat


def decode_lattice(decoder, loglikes, acoustic_scale=0.1, beam=16.0,
                   max_active=7000, lattice_beam=8.0):
    """Lattice-generating decode over a WfstDecoder's graph.

    Args:
      decoder: decode.wfst.WfstDecoder (its loaded graph is reused).
      loglikes: (T, P) log-likelihood matrix.
      lattice_beam: keep paths within this cost of the best path.

    Returns a state-level Lattice.
    """
    lib = decoder._lib
    ll = np.ascontiguousarray(loglikes, np.float32)
    assert ll.ndim == 2, ll.shape
    h = lib.fst_decode_lattice(
        decoder._h,
        ll.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ll.shape[0], ll.shape[1],
        ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
        int(max_active), ctypes.c_float(lattice_beam),
    )
    if not h:
        raise RuntimeError(
            "lattice decoding failed (empty beam or bad pdf id)"
        )
    try:
        n = int(lib.lat_num_nodes(h))
        L = int(lib.lat_num_links(h))
        nf = int(lib.lat_num_finals(h))
        frames = np.zeros(n, np.int32)
        lib.lat_get_node_frames(
            h, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        lf = np.zeros(L, np.int32)
        lt = np.zeros(L, np.int32)
        lo = np.zeros(L, np.int32)
        lg = np.zeros(L, np.float32)
        la = np.zeros(L, np.float32)
        lib.lat_get_links(
            h,
            lf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            la.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        fn = np.zeros(nf, np.int32)
        fcost = np.zeros(nf, np.float32)
        lib.lat_get_finals(
            h,
            fn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fcost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return Lattice(
            frames=frames, link_from=lf, link_to=lt, link_olabel=lo,
            link_graph=lg, link_ac=la,
            finals={int(a): float(b) for a, b in zip(fn, fcost)},
            best_cost=float(lib.lat_best_cost(h)),
        )
    finally:
        lib.lat_free(h)


# -- multi-system combination ------------------------------------------------

def combine(lattices, weights=None):
    """Union of lattices with per-system weights — the lattice-combine
    analogue (combine_lattice.sh:23-26: lattice-combine --lat-weights).
    Weights scale each system's posterior share by adding -ln(w) to its
    paths. Returns one Lattice with a common start node."""
    if weights is None:
        weights = [1.0] * len(lattices)
    frames, lf, lt, lo, lg, la = [0], [], [], [], [], []
    finals = {}
    offset = 1
    for lat, wt in zip(lattices, weights):
        # epsilon link start -> system start carrying the weight
        lf.append(0)
        lt.append(offset)
        lo.append(0)
        lg.append(-math.log(max(wt, 1e-30)))
        la.append(0.0)
        frames.extend(int(f) for f in lat.frames)
        lf.extend(int(x) + offset for x in lat.link_from)
        lt.extend(int(x) + offset for x in lat.link_to)
        lo.extend(int(x) for x in lat.link_olabel)
        lg.extend(float(x) for x in lat.link_graph)
        la.extend(float(x) for x in lat.link_ac)
        for node, fc in lat.finals.items():
            finals[node + offset] = float(fc)
        offset += lat.num_nodes
    return Lattice(
        frames=np.asarray(frames, np.int32),
        link_from=np.asarray(lf, np.int32),
        link_to=np.asarray(lt, np.int32),
        link_olabel=np.asarray(lo, np.int32),
        link_graph=np.asarray(lg, np.float32),
        link_ac=np.asarray(la, np.float32),
        finals=finals,
        best_cost=min(l.best_cost for l in lattices),
    )


def cn_combine(lattices, weights=None, lm_scale=1.0, ac_scale=1.0,
               min_vote_frac=0.5, min_overlap=0.25):
    """Confusion-network (sausage) decoding of combined systems: cluster
    each lattice's word links into time slots by *interval overlap*,
    accumulate posterior votes per (slot, word), and read out the argmax
    of every slot carrying at least `min_vote_frac` of the total system
    weight (lower-vote slots are read as epsilon/skip). This is the
    posterior-fusion step lattices enable beyond N-best (the
    lattice-combine + sausage-decode analogue). Returns the fused
    word-id sequence."""
    if weights is None:
        weights = [1.0] * len(lattices)
    occ = []  # (start_frame, end_frame, word, vote)
    for lat, wt in zip(lattices, weights):
        post = lat.posteriors(lm_scale, ac_scale)
        for li in range(lat.num_links):
            ol = int(lat.link_olabel[li])
            if ol == 0 or post[li] < 1e-6:
                continue
            a = float(lat.frames[int(lat.link_from[li])])
            b = float(lat.frames[int(lat.link_to[li])])
            occ.append((min(a, b), max(a, b + 1e-3), ol, wt * post[li]))
    if not occ:
        return []
    occ.sort()
    # slots: [start, end, {word: vote}] — weighted-interval clustering;
    # an occurrence joins the slot it overlaps most (relative to the
    # shorter of the two intervals), else opens a new slot. Slots are
    # kept sorted by start and only the time-overlapping window
    # [a - max_len, b) is scanned (any slot overlapping (a, b) has
    # start < b and start > a - its_length >= a - max_len), so the
    # clustering is near-linear on long/dense lattices instead of
    # O(occurrences x slots).
    import bisect

    slots = []
    starts = []  # parallel sorted keys: starts[i] == slots[i][0]
    max_len = 0.0
    for a, b, ol, v in occ:
        lo = bisect.bisect_left(starts, a - max_len)
        hi = bisect.bisect_right(starts, b)
        best, best_ov, best_i = None, 0.0, -1
        for i in range(lo, hi):
            sl = slots[i]
            inter = min(b, sl[1]) - max(a, sl[0])
            denom = max(min(b - a, sl[1] - sl[0]), 1e-6)
            ov = inter / denom
            if ov > best_ov:
                best, best_ov, best_i = sl, ov, i
        if best is not None and best_ov >= min_overlap:
            w_old = sum(best[2].values())
            best[2][ol] = best[2].get(ol, 0.0) + v
            # vote-weighted interval update keeps slots tight
            best[0] = (best[0] * w_old + a * v) / (w_old + v)
            best[1] = (best[1] * w_old + b * v) / (w_old + v)
            max_len = max(max_len, best[1] - best[0])
            # the start moved by a bounded amount; restore sortedness
            # locally (neighbour swaps)
            starts[best_i] = best[0]
            i = best_i
            while i > 0 and starts[i - 1] > starts[i]:
                starts[i - 1], starts[i] = starts[i], starts[i - 1]
                slots[i - 1], slots[i] = slots[i], slots[i - 1]
                i -= 1
            while i + 1 < len(starts) and starts[i] > starts[i + 1]:
                starts[i], starts[i + 1] = starts[i + 1], starts[i]
                slots[i], slots[i + 1] = slots[i + 1], slots[i]
                i += 1
        else:
            j = bisect.bisect_left(starts, a)
            slots.insert(j, [a, b, {ol: v}])
            starts.insert(j, a)
            max_len = max(max_len, b - a)
    total_weight = sum(weights)
    out = []
    for _, _, votes in slots:
        if sum(votes.values()) >= min_vote_frac * total_weight:
            out.append(max(votes, key=votes.get))
    return out
