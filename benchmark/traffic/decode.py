"""Offline recognition of a seeded test set (traffic kind "decode").

The window runs `decode/beam_jit.py::beam_search_batched` as
`recog_e2e --jit_decode` runs it: batches of `batch` utterances from
`io/egs.py::iter_egs_batches` (sorted by length, padded to a multiple of
`bucket_frames`), the joint CTC/attention beam search with the GRU RNNLM
fused at the configuration's weights. It runs whole batches until
`seconds` have passed; the rate is all their audio over all the time.

Inputs: `utterances` feature matrices of lengths evenly spread over
[seconds_lo, seconds_hi] (the same set for every seed, so every seed does
the same work), N(0, 1) from the seed as global CMVN leaves features.
The batches run long and short in turn (longest, shortest, second
longest, ...), so a window that stops after any batch has decoded a mix
near the set's mean.

Check: the encoder output and CTC log-probabilities of `check_batches`
batches the window ran (the one with the longest utterance and others
drawn from the seed), and the joint score of every hypothesis they
returned, recomputed by reference/transformer.py from the same features
and weights; the search and the reference have to agree on which
hypotheses are impossible (a blank in them, or a CTC prefix longer than
the frames hold), both ways.
"""

import numpy as np

from benchmark.common import device_generator, draw_weights, lengths_grid, numpy_seed

# a search score at or below this says the CTC prefix is impossible (the
# search's NEG_INF is -1e30, weighted by ctc_weight)
IMPOSSIBLE = -1e29


def asr_config(am: dict):
    from speech_recognition_tools_tpu_torch.models.transformer_asr import TransformerASRConfig

    return TransformerASRConfig(
        vocab_size=am["vocab_size"], adim=am["adim"], aheads=am["aheads"],
        elayers=am["elayers"], eunits=am["eunits"], dlayers=am["dlayers"],
        dunits=am["dunits"], dropout=0.0, mtlalpha=am["mtlalpha"],
        lsm_weight=am["lsm_weight"], attn_chunk=am.get("attn_chunk", 0),
        attn_left_chunks=am.get("attn_left_chunks", -1))


def long_short_order(n: int) -> list:
    """0 .. n-1 (ascending lengths) as n-1, 0, n-2, 1, ..."""
    out, lo, hi = [], 0, n - 1
    while lo <= hi:
        out.append(hi)
        if lo != hi:
            out.append(lo)
        lo, hi = lo + 1, hi - 1
    return out


def setup(ctx):
    import torch

    from speech_recognition_tools_tpu_torch.decode import beam_jit
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
    from speech_recognition_tools_tpu_torch.models.transformer_asr import TransformerASR

    p, c, dev = ctx.params, ctx.config, ctx.device
    am, lmc, dec = c["am"], c["lm"], c["decode"]
    gen = device_generator(ctx.seed, dev)
    idim = c["frontend"]["nfilters"]
    model = TransformerASR(asr_config(am), idim, device=dev).eval()
    am_w = draw_weights(model, gen, dev)
    lm = RNNLM(am["vocab_size"], lmc["embed_dim"], lmc["units"], lmc["layers"],
               lmc.get("cell", "gru"), device=dev).eval()
    lm_w = draw_weights(lm, gen, dev)

    rate = p["frame_rate"]
    lens = lengths_grid(p["utterances"], p["seconds_lo"], p["seconds_hi"], 1.0 / rate,
                        ctx.seed)
    feats = torch.randn(int(lens.sum()), idim, generator=gen, device=dev).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(lens)])
    utts = [(f"utt{i:04d}", feats[offs[i]:offs[i + 1]], None) for i in range(len(lens))]
    batches = list(iter_egs_batches(utts, p["batch"], drop_labels=True,
                                    bucket_multiple=p["bucket_frames"]))
    batches = [batches[i] for i in long_short_order(len(batches))]
    beam = dict(beam_size=dec["beam_size"], ctc_weight=dec["ctc_weight"],
                penalty=dec["penalty"], max_len=p["max_len"])

    captured = []
    encode = model.encode

    def capturing_encode(x, lengths):
        if ctx.trace:
            with ctx.rec.span("decode.encode"):
                out = encode(x, lengths)
        else:
            out = encode(x, lengths)
        captured.append(out)
        return out

    model.encode = capturing_encode
    search = beam_jit.beam_search_encoded
    if ctx.trace:
        def spanned_search(*args, **kw):
            with ctx.rec.span("decode.search"):
                return search(*args, **kw)

        beam_jit.beam_search_encoded = spanned_search

    run = dict(model=model, lm=lm, dev=dev, beam=beam, lm_weight=dec["lm_weight"],
               search=search)
    seen = set()
    for b in batches:  # every padded shape the window meets, two steps each
        if b["feats"].shape in seen:
            continue
        seen.add(b["feats"].shape)
        _search(run, b, max_len=2)
    captured.clear()
    return dict(run, batches=batches, am_w=am_w, lm_w=lm_w, captured=captured,
                results=[], rate=rate)


def _search(run, b, **over):
    from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_batched

    return beam_search_batched(run["model"], b["feats"], b["lengths"], lm=run["lm"],
                               lm_weight=run["lm_weight"], device=run["dev"],
                               **dict(run["beam"], **over))


def window(ctx, state):
    import time

    batches, results = state["batches"], state["results"]
    times = []
    t0 = time.perf_counter()
    i = audio = 0
    while True:
        j = i % len(batches)
        b = batches[j]
        t = time.perf_counter()
        toks, scores = _search(state, b)
        results.append((j, toks, scores))
        times.append(time.perf_counter() - t)
        audio += float(b["lengths"].sum()) / state["rate"]
        i += 1
        if ctx.tracer is not None and ctx.tracer.active:
            ctx.tracer.unit_done()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    steps = [int((toks[:, :, 1:] >= 0).any(0).any(0).sum()) for _, toks, _ in results]
    ctx.facts.update(
        batch_s=times, search_steps=sum(steps), steps=steps, beam=state["beam"]["beam_size"],
        in_lens=[batches[j]["lengths"].tolist() for j, _, _ in results],
        enc_lens=[state["captured"][k][1].tolist() for k in range(len(results))])
    if ctx.trace:
        from speech_recognition_tools_tpu_torch.decode import beam_jit

        beam_jit.beam_search_encoded = state["search"]
    utts = sum(len(batches[j]["keys"]) for j, _, _ in results)
    return {"metrics": {"decode_audio_s_per_s": audio / elapsed},
            "attempted": utts, "failed": 0}


def _picks(ctx, state) -> list:
    """Indices into results: the first run of the batch holding the longest
    utterance (the first batch), and check_batches - 1 others from the seed."""
    n = len(state["results"])
    k = min(ctx.params["check_batches"], n)
    rng = np.random.RandomState(numpy_seed(ctx.seed) ^ 0x5EED)
    return [0] + sorted(rng.choice(np.arange(1, n), k - 1, replace=False).tolist())


def _hyps(tokens, eos):
    """The search's (K, max_len + 1) buffer as token lists without sos, up
    to and with the first eos."""
    out = []
    for row in tokens.tolist():
        seq = []
        for t in row[1:]:
            if t < 0:
                break
            seq.append(t)
            if t == eos:
                break
        out.append(seq)
    return out


def _reference(ctx, state, picks, P):
    import torch

    from benchmark.reference import transformer as ref

    c, dev = ctx.config, state["dev"]
    am = dict(c["am"])
    W_am, W_lm = ref.Weights(state["am_w"], P), ref.Weights(state["lm_w"], P)
    eos = am["vocab_size"] - 1
    out = []
    for r in picks:
        j, toks, _ = state["results"][r]
        b = state["batches"][j]
        with torch.no_grad():
            mem, enc_len, ctc = ref.encode(W_am, torch.as_tensor(b["feats"], device=dev),
                                           torch.as_tensor(b["lengths"], device=dev), am)
            B, K = toks.shape[:2]
            hyps, rows = [], []
            for u in range(B):
                for h in _hyps(toks[u], eos):
                    hyps.append(h if h else [eos])
                    rows.append(u)
            scores = ref.hypothesis_scores(
                W_am, W_lm, mem, enc_len, ctc, torch.tensor(rows, device=dev), hyps, am,
                c["lm"]["layers"], dict(c["decode"])).view(B, K)
            # the joint search never emits a blank: a hypothesis with one is
            # impossible (the CTC lattice above would read it as a label)
            blank = torch.tensor([0 in h for h in hyps], device=dev).view(B, K)
            scores = scores.masked_fill(blank, float("-inf"))
        out.append(dict(mem=mem, enc_len=enc_len, ctc=ctc, scores=scores))
    return out


def _compare(got, want):
    """Readings of `got` (the program's or the control's outputs) against
    the float64 reference `want`, batch by batch."""
    import torch

    enc = ctc = score = 0.0
    unscored = revived = impossible = 0
    for g, w in zip(got, want):
        n = w["enc_len"]
        valid = torch.arange(w["mem"].shape[1], device=n.device)[None, :] < n[:, None]
        wm, gm = w["mem"][valid].double(), g["mem"][valid].double()
        enc = max(enc, float((gm - wm).abs().max() / wm.abs().max()))
        ctc = max(ctc, float((g["ctc"][valid].double() - w["ctc"][valid]).abs().max()))
        gs, ws = g["scores"].double(), w["scores"].double()
        live, possible = gs > IMPOSSIBLE, torch.isfinite(ws)
        both = live & possible
        if both.any():
            score = max(score, float(((gs - ws).abs() / ws.abs())[both].max()))
        # the search and the reference agree on which hypotheses are
        # impossible (a blank in them, or a CTC prefix the frames cannot
        # hold): none that it calls impossible is possible, and the reverse
        unscored += int((~live & possible).sum())
        revived += int((live & ~possible).sum())
        impossible += int((~live).sum())
    return {"enc_rel": enc, "ctc_abs": ctc, "score_rel": score, "unscored": float(unscored),
            "revived": float(revived), "impossible": float(impossible)}


def check(ctx, state):
    import torch

    from benchmark.reference.precision import Precision

    picks = _picks(ctx, state)
    got = []
    for r in picks:
        _, toks, scores = state["results"][r]
        mem, enc_len, ctc_logits = state["captured"][r]
        got.append(dict(mem=mem, enc_len=enc_len,
                        ctc=torch.log_softmax(ctc_logits.double(), -1), scores=scores))
    for k in ("model", "lm"):
        state.pop(k)
    if state["dev"].type == "cuda":
        torch.cuda.empty_cache()
    want = _reference(ctx, state, picks, Precision("f64"))
    readings = _compare(got, want)
    if ctx.facts.get("control"):
        ctl = _reference(ctx, state, picks, Precision("tf32"))
        ctx.facts["control_readings"] = _compare(ctl, want)
    ctx.facts["readings"] = readings
    return [(k, readings[k], lim) for k, lim in ctx.cell["limits"].items()]
