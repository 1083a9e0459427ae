"""Native forced alignment for the hybrid branch: flat start and iterative
Viterbi realignment, the in-framework replacement for the reference's
external Kaldi GMM alignment pipeline (recipes/timit/run_get_hq_ali.sh ->
ali-to-pdf, consumed by src/nnet/data_prep_for_seq.py:66-88).

Port of speech_recognition_tools_tpu/align/forced.py:

  1. `utterance_states`: transcript + lexicon -> the linear HMM state chain
     (pdf = base[phone] + state, HmmTopology's numbering, which the
     decoding graph of decode/graph.py shares), with optional-silence
     blocks between words that Viterbi may skip; `trailing_optional` and
     `min_align_frames` give its final states and its shortest path
     (host code, copies of the JAX functions);
  2. `equal_align`: the flat-start bootstrap (uniform frame split);
  3. `viterbi_align_batch`: exact forced alignment of a padded batch. The
     (B, S) DP row runs on the device as a loop over frames, with the JAX
     scan's arithmetic in float32 and its order of ties (skip >= best -> 2,
     then advance >= best -> 1, else stay 0); its int8 backpointers and the
     last alpha row are all that cross to the host, for the O(T)
     traceback. An infeasible utterance gives (None, -inf);
  4. `realign_corpus`: train the acoustic model (the port's RNNClassifier,
     masked cross-entropy, plain Adam 3e-3) on the current labels, turn its
     posteriors into pseudo log-likelihoods under the label-count prior,
     re-align, until the labels stop moving.

The JAX realign_corpus draws iteration `it`'s initial weights from
jax.random.key(seed + it); the port draws flax's distributions from a
torch.Generator seeded the same way, so the two start from different
weights. `init_weights` (it -> RNNClassifier state_dict) feeds both the
same ones. As in the JAX package, an iteration in which every utterance's
DP saturates changes no frame out of none, reads as 0% changed and stops
the loop as converged (ROADMAP Queue 3).
"""

import time

import numpy as np
import torch


class HmmTopology:
    """Per-phone HMM topology + pdf numbering shared by the aligner and
    the decoding graph (decode/graph.py).

    pdf = base[phone] + hmm_state. With uniform state counts this
    degenerates to the legacy convention pdf = phone * states_per_phone
    + state, so existing alignments/graphs are unchanged unless the new
    knobs are used:

      silence_states: the silence phone gets its own (longer) chain —
        the Kaldi-topology tier where silence is a 5-state HMM while
        speech phones are 3-state (run_get_hq_ali.sh's topology via
        prepare_lang).
      wpd_silence: word-position-dependent silence — utterance-boundary
        silence gets a DISTINCT pdf block (a virtual phone id
        `edge_silence_phone`) from inter-word silence, so the AM can
        model long endpoint silences separately from short pauses.
    """

    def __init__(self, num_phones, states_per_phone=1, silence_phone=None,
                 silence_states=None, wpd_silence=False):
        self.silence_phone = silence_phone
        self.wpd_silence = bool(wpd_silence) and silence_phone is not None
        P = num_phones + (1 if self.wpd_silence else 0)
        self.num_phones = P
        self.edge_silence_phone = (
            num_phones if self.wpd_silence else silence_phone
        )
        st = np.full(P, states_per_phone, np.int32)
        if silence_phone is not None and silence_states:
            st[silence_phone] = silence_states
            if self.wpd_silence:
                st[self.edge_silence_phone] = silence_states
        self._states = st
        self.base = np.concatenate(
            [[0], np.cumsum(st)]
        ).astype(np.int32)
        self.num_pdfs = int(self.base[-1])

    def states(self, p):
        return int(self._states[p])

    def pdf(self, p, k):
        return int(self.base[p]) + k


def read_lexicon(path: str) -> dict:
    """Parse 'word phone-id [phone-id ...]' lines -> {word: [ids]} (the
    one lexicon format every aligner entry point shares)."""
    lexicon = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                lexicon[parts[0]] = [int(x) for x in parts[1:]]
    return lexicon


def utterance_states(words, lexicon, states_per_phone=1,
                     silence_phone=None, topo: "HmmTopology | None" = None):
    """Linear HMM state chain for a transcript.

    Returns (pdfs, skip_to, start_lo):
      pdfs[s]: emitting pdf id of state s (topo.pdf(phone, k); with the
        default uniform topology that is phone * states_per_phone + k)
      skip_to[s]: -1, or the state index an ADVANCE out of state s may
        additionally jump to (the first state after the next optional
        silence block), as graph.py's splice_hmm_chain topology.
      start_lo: the alternative entry state (first state after a leading
        optional silence block; 0 when there is none).

    topo: optional HmmTopology for per-phone state counts and
    word-position-dependent silence; when given it overrides
    states_per_phone/silence_phone.
    """
    if topo is not None:
        silence_phone = topo.silence_phone
    pdfs, optional = [], []

    def emit(phones, opt):
        for p in phones:
            n_st = topo.states(p) if topo is not None else states_per_phone
            for k in range(n_st):
                pdfs.append(topo.pdf(p, k) if topo is not None else p * states_per_phone + k)
                optional.append(opt)

    edge_sil = topo.edge_silence_phone if topo is not None else silence_phone
    emit([edge_sil] if silence_phone is not None else [], True)
    for i, w in enumerate(words):
        if w not in lexicon:
            raise KeyError(f"word not in lexicon: {w!r}")
        emit(lexicon[w], False)
        if silence_phone is not None:
            # the trailing block is utterance-boundary silence, inner
            # blocks inter-word silence
            last = i == len(words) - 1
            emit([edge_sil if last else silence_phone], True)
    pdfs = np.asarray(pdfs, np.int32)
    skip_to = np.full(len(pdfs), -1, np.int32)
    # an advance leaving state s-1 may skip a following optional block
    # [s, s+L): record the jump target s+L on the state BEFORE the block
    i = 0
    while i < len(pdfs):
        if optional[i]:
            j = i
            while j < len(pdfs) and optional[j]:
                j += 1
            if i > 0 and j < len(pdfs):
                skip_to[i - 1] = j
            i = j
        else:
            i += 1
    start_lo = 0
    if optional and optional[0]:
        while start_lo < len(optional) and optional[start_lo]:
            start_lo += 1
    return pdfs, skip_to, np.int32(start_lo)


def trailing_optional(pdfs, skip_to, silence_phone, states_per_phone,
                      topo: "HmmTopology | None" = None):
    """Index of the last NON-optional state +1, for the two-final readout
    (an utterance may end before its trailing silence)."""
    if topo is not None:
        silence_phone = topo.silence_phone
    if silence_phone is None:
        return len(pdfs)
    if topo is not None:
        p = topo.edge_silence_phone
        sil_set = {topo.pdf(p, k) for k in range(topo.states(p))}
    else:
        S = states_per_phone
        sil_set = {silence_phone * S + k for k in range(S)}
    s = len(pdfs)
    while s > 0 and int(pdfs[s - 1]) in sil_set:
        s -= 1
    return s


def min_align_frames(pdfs, skip_to, start_lo, fin_lo):
    """Minimum frame count with a valid alignment path: the fewest states
    on any entry->final walk (each visited state emits >= 1 frame). Moves
    are advance (s -> s+1) and skip (src -> skip_to[src]). Shorter
    utterances are infeasible: viterbi_align_batch returns (None, -inf)
    for them and realign_corpus drops them."""
    S = len(pdfs)
    m = np.full(S + 1, np.iinfo(np.int32).max, np.int64)
    for ent in {0, int(start_lo)}:
        if ent < S:
            m[ent] = 1
    for s in range(S):
        if m[s] == np.iinfo(np.int32).max:
            continue
        if s + 1 <= S:
            m[s + 1] = min(m[s + 1], m[s] + 1)
        dst = int(skip_to[s])
        if dst >= 0:
            m[dst] = min(m[dst], m[s] + 1)
    finals = m[max(fin_lo - 1, 0): S]
    return int(finals.min()) if len(finals) else 1


def equal_align(num_frames, pdfs):
    """Flat start: distribute frames uniformly over the state chain."""
    S = len(pdfs)
    idx = np.minimum((np.arange(num_frames) * S) // max(num_frames, 1), S - 1)
    return np.asarray(pdfs)[idx].astype(np.int32)


NEG = -1e30


@torch.no_grad()
def viterbi_dp(e, lengths, start_lo, skip_to, self_lp, adv_lp):
    """The batched DP on e's device. e (B, Tmax, S) float32 emissions, NEG
    at padded states; lengths, start_lo (B,); skip_to (B, S) (-1 = none);
    self_lp, adv_lp 0-dim float32 tensors. Frames past a row's length are
    frozen (alpha carried, backpointer stay), so the returned alpha is the
    t = length - 1 row. Returns (alpha (B, S), bps (Tmax, B, S) int8 in
    {0 stay, 1 advance, 2 skip-advance})."""
    B, T, S = e.shape
    dev = e.device
    neg = torch.tensor(NEG, dtype=e.dtype, device=dev)
    # state s receives a skip from src iff skip_to[src] == s
    valid = skip_to >= 0
    src = torch.arange(S, device=dev).expand(B, S)
    skip_src = torch.full((B, S + 1), -1, dtype=torch.long, device=dev)
    skip_src.scatter_(1, torch.where(valid, skip_to, S), torch.where(valid, src, -1))
    skip_src = skip_src[:, :S]
    has_skip = skip_src >= 0
    gather_src = skip_src.clamp_min(0)
    sidx = torch.arange(S, device=dev)[None, :]
    alpha = torch.where((sidx == 0) | (sidx == start_lo[:, None]), e[:, 0], neg)
    bps = torch.zeros((T, B, S), dtype=torch.int8, device=dev)
    neg_col = neg.expand(B, 1)
    two, one, zero = (torch.tensor(v, dtype=torch.int8, device=dev) for v in (2, 1, 0))
    for t in range(1, T):
        act = (t < lengths)[:, None]
        stay = alpha + self_lp
        adv = torch.cat([neg_col, alpha[:, :-1] + adv_lp], dim=1)
        skip = torch.where(has_skip, alpha.gather(1, gather_src) + adv_lp, neg)
        best = torch.maximum(stay, torch.maximum(adv, skip))
        bp = torch.where(skip >= best, two, torch.where(adv >= best, one, zero))
        alpha = torch.where(act, best + e[:, t], alpha)
        bps[t] = torch.where(act, bp, zero)
    return alpha, bps


def viterbi_align_batch(loglikes, lengths, chains, self_loop_prob=0.5, *, device=None,
                        timings=None):
    """Exact forced alignment of a padded batch.

    loglikes: (B, Tmax, P) log-likelihoods (or scaled posteriors), a tensor
      (the DP runs on its device) or an array (moved to `device`, default
      "cuda", which raises without a card).
    lengths: (B,) true frame counts.
    chains: per utterance (pdfs, skip_to, start_lo, final_lo), the
      `utterance_states` outputs plus `trailing_optional`; final_lo is the
      earliest permitted final state +1 (ending inside a trailing optional
      silence is also allowed).
    timings: optional dict; "dp" and "traceback" gain their seconds (the
      device synchronised between them).
    Returns [(labels (T_b,), score)] per utterance; one with no valid path
    gives (None, -inf).
    """
    from speech_recognition_tools_tpu_torch.device import resolve_device

    t0 = time.perf_counter()
    if isinstance(loglikes, torch.Tensor):
        dev = loglikes.device if device is None else resolve_device(device)
    else:
        dev = resolve_device("cuda" if device is None else device)
    ll = torch.as_tensor(loglikes).to(device=dev, dtype=torch.float32)
    B, Tmax, _ = ll.shape
    Smax = max(len(c[0]) for c in chains)
    pdfs = np.zeros((B, Smax), np.int64)
    smask = np.zeros((B, Smax), bool)
    skip_to = np.full((B, Smax), -1, np.int64)
    start_lo = np.zeros((B,), np.int64)
    for b, (p, sk, st, _fin) in enumerate(chains):
        pdfs[b, : len(p)] = p
        smask[b, : len(p)] = True
        skip_to[b, : len(sk)] = sk
        start_lo[b] = st
    lengths = np.asarray(lengths)
    pd = torch.as_tensor(pdfs, device=dev)
    e = ll.gather(2, pd[:, None, :].expand(B, Tmax, Smax))
    e = e.masked_fill(~torch.as_tensor(smask, device=dev)[:, None, :], NEG)
    alpha, bps = viterbi_dp(
        e, torch.as_tensor(lengths, dtype=torch.long, device=dev),
        torch.as_tensor(start_lo, device=dev), torch.as_tensor(skip_to, device=dev),
        torch.tensor(np.float32(np.log(self_loop_prob)), device=dev),
        torch.tensor(np.float32(np.log1p(-self_loop_prob)), device=dev))
    # only the backpointer bitplane and the final DP row cross to the host
    alphaT = alpha.cpu().numpy()
    bps = bps.cpu().numpy()
    t1 = time.perf_counter()
    out = []
    for b, (p, sk, st_lo, fin_lo) in enumerate(chains):
        T = int(lengths[b])
        S = len(p)
        # final: last real state, or anywhere in a trailing optional block
        fin_states = np.arange(max(fin_lo - 1, 0), S)
        s = int(fin_states[int(np.argmax(alphaT[b, fin_states]))])
        score = float(alphaT[b, s])
        # infeasible (fewer frames than the shortest chain path, or a DP
        # saturated at the emission floor): no valid traceback exists
        if T < min_align_frames(p, sk, st_lo, fin_lo) or score <= -1e29:
            out.append((None, -np.inf))
            continue
        labels = np.zeros(T, np.int32)
        for t in range(T - 1, -1, -1):
            labels[t] = p[s]
            mv = bps[t, b, s]
            if t > 0:
                if mv == 1:
                    s -= 1
                elif mv == 2:
                    s = int(np.where(sk[:S] == s)[0][0])
        assert s in (0, int(st_lo)), (s, st_lo)
        out.append((labels, score))
    if timings is not None:
        timings["dp"] = timings.get("dp", 0.0) + t1 - t0
        timings["traceback"] = timings.get("traceback", 0.0) + time.perf_counter() - t1
    return out


def realign_corpus(feats, texts, lexicon, *, states_per_phone=1,
                   silence_phone=None, silence_states=None,
                   wpd_silence=False, self_loop_prob=0.5,
                   num_iters=2, am_epochs=5, hidden_dim=96, num_layers=1,
                   batch_size=8, seed=0, converge_tol=0.002,
                   history=None, iter_callback=None, log=print,
                   init_weights=None, timings=None, device="cuda"):
    """Flat start + iterative Viterbi realignment -> frame labels.

    feats: {utt: (T, D)}; texts: {utt: 'word word ...'}. Each iteration
    trains an RNNClassifier (num_layers x hidden_dim GRU, plain Adam 3e-3,
    masked cross-entropy; am_epochs over length-sorted buckets of
    batch_size, padded to multiples of 128 frames, their order shuffled by
    numpy's RandomState(seed + it)) on the current labels, turns its
    posteriors into pseudo log-likelihoods (log p(s|x) - log prior, the
    prior from the label counts, add-one) and re-aligns. Returns
    ({utt: (T,) pdf labels}, num_pdfs).

    silence_states / wpd_silence choose the topology (HmmTopology). Each
    realignment logs the share of frames whose label changed; the loop
    stops once that falls below converge_tol. history=[] receives the
    per-iteration dicts {iter, am_loss, frames_changed_pct};
    iter_callback(it, labels) runs after each iteration.

    init_weights: optional it -> RNNClassifier state_dict, the iteration's
    initial weights (default: flax's distributions drawn from
    torch.Generator().manual_seed(seed + it)). timings: optional dict;
    "am_step" (synchronised, per-step seconds summed), "dp" and "traceback"
    gain their seconds. Runs on `device` ("cuda" unless "cpu" is given).
    """
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
    from speech_recognition_tools_tpu_torch.train.losses import masked_cross_entropy
    from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

    dev = resolve_device(device)
    num_phones = 1 + max(
        max(ph for phs in lexicon.values() for ph in phs),
        silence_phone if silence_phone is not None else 0,
    )
    topo = HmmTopology(num_phones, states_per_phone, silence_phone,
                       silence_states=silence_states, wpd_silence=wpd_silence)
    utts = [u for u in feats if u in texts]
    chains = {}
    for u in list(utts):
        p, sk, st = utterance_states(texts[u].split(), lexicon, topo=topo)
        fin_lo = trailing_optional(p, sk, silence_phone, states_per_phone, topo=topo)
        if feats[u].shape[0] < min_align_frames(p, sk, st, fin_lo):
            log(f"WARNING: {u}: {feats[u].shape[0]} frames < shortest "
                f"chain path — infeasible transcript, dropping")
            utts.remove(u)
            continue
        chains[u] = (p, sk, st, fin_lo)
    if not utts:
        raise ValueError("no alignable utterances (all infeasible)")
    num_pdfs = topo.num_pdfs
    labels = {u: equal_align(feats[u].shape[0], chains[u][0]) for u in utts}

    # the corpus stays ragged on the host and is densified a batch at a
    # time; length-sorted buckets padded to multiples of 128 frames
    n = len(utts)
    lens = np.asarray([feats[u].shape[0] for u in utts], np.int32)
    D = next(iter(feats.values())).shape[1]
    by_len = sorted(range(n), key=lambda i: int(lens[i]))
    buckets = [by_len[k : k + batch_size] for k in range(0, n, batch_size)]
    t_cap = int(lens.max())

    def dense_batch(idx, with_labels):
        tb = min(-(-max(int(lens[i]) for i in idx) // 128) * 128, t_cap)
        f = np.zeros((batch_size, tb, D), np.float32)  # rows padded with empty utts
        y = np.zeros((batch_size, tb), np.int64)
        ls = np.zeros(batch_size, np.int64)
        for r, i in enumerate(idx):
            T = int(lens[i])
            f[r, :T] = feats[utts[i]]
            ls[r] = T
            if with_labels:
                y[r, :T] = labels[utts[i]]
        out = (torch.as_tensor(f, device=dev), torch.as_tensor(ls, device=dev))
        return out + ((torch.as_tensor(y, device=dev),) if with_labels else ())

    model = RNNClassifier(D, num_layers, hidden_dim, num_pdfs, device=dev)
    params = dict(model.named_parameters())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for it in range(num_iters):
        if init_weights is not None:
            model.load_state_dict(init_weights(it))
        else:
            model.reset_parameters(torch.Generator().manual_seed(seed + it))
        opt = ClipAdam(3e-3, None, inject=False)  # optax.adam(3e-3)
        opt_state = opt.init(params)
        rs = np.random.RandomState(seed + it)
        border = np.arange(len(buckets))
        last = None
        model.train()
        for _ in range(am_epochs):
            rs.shuffle(border)
            for bi in border:
                f, ln, y = dense_batch(buckets[bi], with_labels=True)
                t0 = time.perf_counter()
                for p in params.values():
                    p.grad = None
                loss = masked_cross_entropy(model(f, ln), y, ln)
                loss.backward()
                opt_state, _ = opt.apply(params, {k: p.grad for k, p in params.items()},
                                         opt_state)
                last = loss.detach()
                if timings is not None:
                    sync()
                    timings["am_step"] = timings.get("am_step", 0.0) + time.perf_counter() - t0
                    timings["am_steps"] = timings.get("am_steps", 0) + 1
        last = float(last)
        log(f"align iter {it}: AM loss {last:.4f}")

        counts = np.bincount(np.concatenate([labels[u] for u in utts]),
                             minlength=num_pdfs).astype(np.float64)
        prior = np.log((counts + 1.0) / (counts.sum() + num_pdfs)).astype(np.float32)
        prior_t = torch.as_tensor(prior, device=dev)
        model.eval()
        changed = total_frames = 0
        for idx in buckets:
            f, ln = dense_batch(idx, with_labels=False)
            with torch.no_grad():
                pseudo_ll = torch.log_softmax(model(f, ln)[: len(idx)], dim=-1) - prior_t
            aligned = viterbi_align_batch(pseudo_ll, lens[idx], [chains[utts[i]] for i in idx],
                                          self_loop_prob=self_loop_prob, timings=timings)
            # a saturated DP (None labels) keeps the previous labels
            for i, a in zip(idx, aligned):
                if a[0] is None:
                    log(f"WARNING: {utts[i]}: Viterbi found no valid path "
                        f"this iteration — keeping previous labels")
                else:
                    changed += int(np.sum(labels[utts[i]] != a[0]))
                    total_frames += len(a[0])
                    labels[utts[i]] = a[0]
        pct = changed / max(total_frames, 1)
        log(f"align iter {it}: labels changed {100.0 * pct:.2f}% of {total_frames} frames")
        if history is not None:
            history.append({"iter": it, "am_loss": last,
                            "frames_changed_pct": round(100.0 * pct, 3)})
        if iter_callback is not None:
            iter_callback(it, labels)
        # labels that stopped moving end the loop (so does an iteration in
        # which no utterance aligned: 0 of 0 frames, as in the JAX package)
        if pct < converge_tol:
            log(f"align converged at iter {it} "
                f"(changed {100.0 * pct:.2f}% < {100.0 * converge_tol}%)")
            break
    return labels, num_pdfs
