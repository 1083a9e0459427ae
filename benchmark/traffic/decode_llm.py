"""Offline recognition with the speech LLM (traffic kind "decode_llm").

The window runs `decode/beam_jit.py::beam_search_batched` as
`recog_e2e --jit_decode` runs it for a speech-LLM model directory:
batches of `batch` utterances from `io/egs.py::iter_egs_batches` (sorted
by length, padded to a multiple of `bucket_frames`), `SpeechLLM.encode`
(the audio tower and the projector), one prefill of the audio prefixes,
then the beam search through the LLM's latent cache, with the LLM's
scores alone (no CTC head, no RNNLM). It runs whole batches until
`seconds` have passed; the rate is all their audio over all the time.

Inputs: as the `decode` kind's: `utterances` feature matrices of lengths
evenly spread over [seconds_lo, seconds_hi], N(0, 1) from the seed, the
batches long and short in turn. Weights: the audio tower as the `decode`
kind draws it (one float32 draw); the projector and the LLM one bf16 draw
per tensor on the device (benchmark/configs/<config>.json, "weights").

Check, of `check_batches` batches the window ran (the longest and others
from the seed), against reference/moe_lm.py (float32, TF32 off; the audio
tower in float64). The reference runs each returned hypothesis's full
[audio prefix, sos, tokens] with no cache, each position through the
experts the program chose there (the prefill's choices over the prefix,
then those of the step that fed each token, followed back through the
beams' reordering), and forms its own choice beside them:
  - enc_rel: the audio tower's output, max gap over max value, valid frames;
  - logp_abs: the first step's log-probabilities (after [prefix, sos]) over
    the whole vocabulary, each utterance's, max gap;
  - score_rel: every returned hypothesis's summed log-probability against
    the reference's, max relative gap: the prefill and the cached decoding
    against the uncached forward pass;
  - route_diff: the share of (position, expert layer) whose set of experts
    differs from the reference's own choice there.
A near-tie between two experts' scores goes either way in bfloat16, and a
flip would send the two computations down different paths; with the
program's choices the logit gaps measure the arithmetic and route_diff
counts the flips. With ctx.facts["control"] the reference is also computed
with the expert weights rounded to fp8 e4m3 (the control, judged in the
program's place) and with top-(k-1) routing, without the shared experts
and without the correction bias (ctx.facts["fault_readings"]), each
against the reference computed with the control's choices.
"""

import os
import time

import numpy as np

from benchmark.common import device_generator, draw_weights, lengths_grid
from benchmark.harness import load_module

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_decode = load_module("traffic", "decode", _ROOT)

# a CPU run larger than this (the configuration's bf16 weights) is refused:
# the full-size model is run on the card
CPU_BYTES_MAX = 4 << 30


def model_config(c: dict):
    from speech_recognition_tools_tpu_torch.models.moe_lm import MoELMConfig
    from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLMConfig

    return SpeechLLMConfig(
        llm=MoELMConfig.from_dict(dict(c, dtype=c["llm"]["dtype"])),
        encoder=_decode.asr_config(c["am"]), idim=c["frontend"]["nfilters"],
        stack=c["projector"]["stack"], sos_id=c["llm"]["sos_id"], eos_id=c["llm"]["eos_id"])


def draw_llm(model, gen, dev, bias_std: float = 0.1) -> None:
    """Seeded weights for the projector and the LLM, one draw per tensor in
    its own dtype on the device: a matrix N(0, 1 / fan_in), a norm's scale
    1 + 0.02 N(0, 1), a bias 0.02 N(0, 1), a correction bias bias_std
    N(0, 1)."""
    import torch

    from speech_recognition_tools_tpu_torch.models.moe_lm import RMSNorm

    scales = {id(m.weight) for m in model.modules()
              if isinstance(m, (RMSNorm, torch.nn.LayerNorm))}
    named = (list(model.projector.named_parameters(prefix="projector"))
             + list(model.llm.named_parameters(prefix="llm")))
    with torch.no_grad():
        for name, p in named:
            d = torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype)
            if name.endswith("e_score_correction_bias"):
                p.copy_(d.mul_(bias_std))
            elif p.dim() >= 2:
                p.copy_(d.mul_(p.shape[-1] ** -0.5))
            elif id(p) in scales:
                p.copy_(d.mul_(0.02).add_(1.0))
            else:
                p.copy_(d.mul_(0.02))


def setup(ctx):
    # first: a program without the speech LLM fails here, at once
    from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLM

    import torch

    from benchmark import llm_work
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches

    p, c, dev = ctx.params, ctx.config, ctx.device
    nbytes = llm_work.BYTES * llm_work.llm_params(c)
    if dev.type == "cpu" and nbytes > CPU_BYTES_MAX:
        raise RuntimeError(f"{c['name']}: {nbytes / 2**30:.1f} GiB of weights; the "
                           "configuration runs on the card (CPU runs take a cut copy)")
    cfg = model_config(c)
    gen = device_generator(ctx.seed, dev)
    model = SpeechLLM.empty(cfg, dev)
    draw_weights(model.encoder, gen, dev)
    draw_llm(model, gen, dev)
    K = c["decode"]["beam_size"]

    rate = p["frame_rate"]
    lens = lengths_grid(p["utterances"], p["seconds_lo"], p["seconds_hi"], 1.0 / rate,
                        ctx.seed)
    feats = torch.randn(int(lens.sum()), cfg.idim, generator=gen, device=dev).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(lens)])
    utts = [(f"utt{i:04d}", feats[offs[i]:offs[i + 1]], None) for i in range(len(lens))]
    batches = list(iter_egs_batches(utts, p["batch"], drop_labels=True,
                                    bucket_multiple=p["bucket_frames"]))
    batches = [batches[i] for i in _decode.long_short_order(len(batches))]
    beam = dict(beam_size=K, ctc_weight=c["decode"]["ctc_weight"],
                penalty=c["decode"]["penalty"], max_len=p["max_len"])

    # what the check reads, captured as the window runs: the audio tower's
    # output, the experts every expert layer chose (the prefill's, each
    # step's: the cache's "routes"), the beams' reordering, the first step's
    # logits
    captured = dict(enc=[], routes=[], first=[])
    encode_audio, init_cache, incremental, reorder = (
        model.encode_audio, model.decode_init_cache, model.decode_incremental,
        model.reorder_cache)

    def capturing_encode_audio(feats, lengths):
        out = encode_audio(feats, lengths)
        captured["enc"].append(out)
        return out

    def capturing_init_cache(tokens, memory, enc_len):
        with ctx.rec.span("llm.prefill"):
            cache = init_cache(tokens, memory, enc_len)
        captured["routes"].append(dict(prefill=cache["routes"], steps=[], rows=[],
                                       shape=tuple(memory.shape[:2])))
        return cache

    def capturing_incremental(last_tokens, pos, memory, enc_len, cache, **kw):
        logits = incremental(last_tokens, pos, memory, enc_len, cache, **kw)
        # the step's routes are overwritten by the next step's
        captured["routes"][-1]["steps"].append(cache["routes"].clone())
        if pos == 0:
            captured["first"].append(logits[::K, 0].clone())
        return logits

    def capturing_reorder(cache, rows):
        captured["routes"][-1]["rows"].append(rows)
        return reorder(cache, rows)

    model.encode_audio = capturing_encode_audio
    model.decode_init_cache = capturing_init_cache
    model.decode_incremental = capturing_incremental
    model.reorder_cache = capturing_reorder

    run = dict(model=model, dev=dev, beam=beam)
    seen = set()
    for b in batches:  # every padded shape the window meets, two steps each
        if b["feats"].shape in seen:
            continue
        seen.add(b["feats"].shape)
        _search(run, b, max_len=2)
    for v in captured.values():
        v.clear()
    return dict(run, batches=batches, captured=captured, results=[], rate=rate)


def _unhook(model):
    """Take the capturing wrappers off the model: they hold the model's own
    methods, a cycle that would keep its 32 GB alive past the run until
    the garbage collector found it."""
    for name in ("encode_audio", "decode_init_cache", "decode_incremental", "reorder_cache"):
        model.__dict__.pop(name, None)


def _search(run, b, **over):
    from speech_recognition_tools_tpu_torch.decode.beam_jit import beam_search_batched

    return beam_search_batched(run["model"], b["feats"], b["lengths"], device=run["dev"],
                               incremental=True, **dict(run["beam"], **over))


def window(ctx, state):
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
    enc = state["captured"]["enc"]
    stack = state["model"].cfg.stack
    ctx.facts.update(
        batch_s=times, search_steps=sum(steps), steps=steps, beam=state["beam"]["beam_size"],
        in_lens=[batches[j]["lengths"].tolist() for j, _, _ in results],
        enc_lens=[enc[k][1].tolist() for k in range(len(results))],
        prefix_lens=[(enc[k][1] // stack).tolist() for k in range(len(results))])
    utts = sum(len(batches[j]["keys"]) for j, _, _ in results)
    return {"metrics": {"decode_audio_s_per_s": audio / elapsed},
            "attempted": utts, "failed": 0}


def _program_routes(batch, P, hyps, rows, K):
    """The experts the program computed each hypothesis's positions with,
    per expert layer (N, S, k), -1 at padding, S = max(P + len(hyp)): its
    utterance's prefill choices over the prefix, then at sos and each token
    the choices of the step that fed it, followed back through the beams'
    reordering (the search reorders after every step)."""
    import torch

    B, S_pad = batch["shape"]
    dev = P.device
    N = len(hyps)
    L = [len(h) for h in hyps]
    S = max(int(P[r]) + n for r, n in zip(rows, L))
    final = torch.tensor([r * K + i % K for i, r in enumerate(rows)], device=dev)
    steps = len(batch["steps"])
    anc = [None] * steps  # each hypothesis's row at each step
    a = final
    for s in reversed(range(steps)):
        a = batch["rows"][s][a]
        anc[s] = a
    out = []
    for layer in range(len(batch["prefill"])):
        pre = batch["prefill"][layer].view(B, S_pad, -1)
        r = torch.full((N, S, pre.shape[-1]), -1, dtype=pre.dtype, device=dev)
        for i, (u, n) in enumerate(zip(rows, L)):
            p = int(P[u])
            r[i, :p] = pre[u, S_pad - p:]
            for s in range(n):
                r[i, p + s] = batch["steps"][s][layer][anc[s][i]]
        out.append(r)
    return out


def _reference(ctx, state, picks, controls):
    """Per pick: the program's outputs and what reference/moe_lm.py gives
    computed with the program's experts; with `controls`, per control its
    own outputs and the reference computed with its experts."""
    import torch

    from benchmark.reference import moe_lm as ref

    c, dev, cap = ctx.config, state["dev"], state["captured"]
    cfg = state["model"].cfg
    K = state["beam"]["beam_size"]
    weights = state["weights"]
    got, want, ctl = [], [], {name: ([], []) for name in controls}
    for r in picks:
        j, toks, scores = state["results"][r]
        b = state["batches"][j]
        with torch.no_grad():
            mem, enc_len, prefixes = ref.audio_prefix(
                weights, torch.as_tensor(b["feats"], device=dev),
                torch.as_tensor(b["lengths"], device=dev), c["am"], cfg.stack)
            B = toks.shape[0]
            rows, hyps = [], []
            for u in range(B):
                for h in _decode._hyps(toks[u], cfg.eos_id):
                    rows.append(u)
                    hyps.append(h)
            P = enc_len // cfg.stack

            def reading(total, first, routes, mem_=mem):
                """first: each hypothesis's log-probabilities after sos."""
                return dict(mem=mem_, enc_len=enc_len, scores=total.view(B, K),
                            first=first[::K], routes=routes)

            forced = _program_routes(cap["routes"][r], P, hyps, rows, K)
            first = torch.log_softmax(cap["first"][r].float(), -1)  # (B, V)
            got.append(reading(scores, first.repeat_interleave(K, 0), forced, cap["enc"][r][0]))
            want.append(reading(*ref.hypothesis_logp(weights, prefixes, rows, hyps, c,
                                                     cfg.sos_id, forced=forced)))
            for name, o in controls.items():
                x = ref.hypothesis_logp(weights, prefixes, rows, hyps, c, cfg.sos_id, o)
                w = ref.hypothesis_logp(weights, prefixes, rows, hyps, c, cfg.sos_id,
                                        forced=x[2])
                ctl[name][0].append(reading(*x))
                ctl[name][1].append(reading(*w))
    return got, want, ctl


def _compare(got, want):
    """Readings of `got` (the program's outputs or a control's) against the
    reference `want` computed with the same experts, batch by batch:
    route_diff is the share of (position, expert layer) where the
    reference's own choice differs from the experts `got` used."""
    import torch

    enc = logp = score = 0.0
    differ = sets = 0
    for g, w in zip(got, want):
        n = w["enc_len"]
        valid = torch.arange(w["mem"].shape[1], device=n.device)[None, :] < n[:, None]
        wm, gm = w["mem"][valid].double(), g["mem"][valid].double()
        enc = max(enc, float((gm - wm).abs().max() / wm.abs().max()))
        logp = max(logp, float((g["first"].double() - w["first"].double()).abs().max()))
        gs, ws = g["scores"].double(), w["scores"].double()
        score = max(score, float(((gs - ws).abs() / ws.abs()).max()))
        for gl, wl in zip(g["routes"], w["routes"]):
            pos = wl[..., 0] >= 0
            sets += int(pos.sum())
            if gl.shape[-1] != wl.shape[-1]:
                differ += int(pos.sum())
            else:
                same = (gl.sort(-1).values == wl.sort(-1).values).all(-1)
                differ += int((pos & ~same).sum())
    return {"enc_rel": enc, "logp_abs": logp, "score_rel": score,
            "route_diff": differ / max(sets, 1)}


def check(ctx, state):
    import torch

    from benchmark.reference.moe_lm import Options, no_tf32

    no_tf32()
    picks = _decode._picks(ctx, state)
    state["weights"] = dict(state["model"].state_dict())
    if state["dev"].type == "cuda":
        torch.cuda.empty_cache()
    k = ctx.config["num_experts_per_tok"]
    controls = {}
    if ctx.facts.get("control"):
        controls = {"fp8_experts": Options(fp8_experts=True),
                    f"top{k - 1}": Options(top_k=k - 1), "no_shared": Options(shared=False),
                    "no_bias": Options(bias=False)}
    got, want, ctl = _reference(ctx, state, picks, controls)
    _unhook(state["model"])
    readings = _compare(got, want)
    if controls:
        faults = {name: _compare(*ctl[name]) for name in controls}
        ctx.facts["control_readings"] = faults.pop("fp8_experts")
        ctx.facts["fault_readings"] = faults
    ctx.facts["readings"] = readings
    return [(k, readings[k], lim) for k, lim in ctx.cell["limits"].items()]
