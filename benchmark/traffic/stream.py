"""Live streams (traffic kind "stream").

Set-up writes a model directory from the seed (the configuration's
transformer with its streaming chunk mask, vocab.json, serving.json and
global CMVN, as train_e2e and run_corpus write them) and serves it with
`cli/serve.py::make_server` on 127.0.0.1 and an ephemeral port, with the
serve CLI's defaults (`max_streams` 8, `defer_ms` 30), in this process.
`streams` clients run from one separate process (stream_client.py): each
sends seeded utterances of seconds_lo-seconds_hi s, one connection each,
in 0.25 s messages in an open loop at real time (message k due at
t_u + 0.25 k whether or not earlier replies came), eof when the audio
ends, the next utterance then. The streams start at times drawn from the
seed in the `ramp_s` before the window, so that the window finds them in
steady state, each at its own point of its utterance. Every stream has
the same set of utterance lengths, in an order drawn from the seed.

stream_reply_p95_ms: the 95th percentile, over every message due in the
window across all streams, of the time from when it was due to when its
reply arrived; a message without a reply is failed and counts as later
than every reply.

Check: the finals of `check_utterances` utterances (the longest and
others drawn from the seed) and the partials before them, against
reference/transformer.py's offline chunk-masked forward of
reference/fdlp.py's features of the same samples, through the same CMVN:
the served frame count, the widest gap by which the served frame
decisions lie below the reference's best CTC log-probability (at an
emitting frame the served token; elsewhere blank or the last token,
whichever the reference scores higher), each served confidence against
the reference's posterior, and every partial a prefix of its final.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from benchmark.common import (
    device_generator,
    draw_weights,
    lengths_grid,
    numpy_seed,
    speechlike_signals,
)

LETTERS = "abcdefghijklmnopqrstuvwxyz'.-0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "stream_client.py")


def _model_dir(ctx, work, gen):
    from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_to_jax
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab, save_vocab
    from speech_recognition_tools_tpu_torch.models.transformer_asr import TransformerASR
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    from benchmark.traffic.decode import asr_config

    c = ctx.config
    am = dict(c["am"], attn_chunk=c["streaming"]["attn_chunk"],
              attn_left_chunks=c["streaming"]["attn_left_chunks"])
    fe = c["frontend"]
    model = TransformerASR(asr_config(am), fe["nfilters"], device=ctx.device)
    weights = draw_weights(model, gen, ctx.device)
    # a trained CTC head calls most frames blank, so pauses endpoint and
    # hypotheses stay short
    weights["ctc_head.bias"][0] += ctx.params["blank_bias"]
    tree = transformer_asr_to_jax({k: v.cpu() for k, v in weights.items()}, am["aheads"])
    del model
    hyper = dict(model_class="TransformerASR", encoder_type="transformer", conv_kernel=15,
                 feature_dim=fe["nfilters"],
                 **{k: am[k] for k in ("vocab_size", "adim", "aheads", "elayers", "eunits",
                                       "dlayers", "dunits", "mtlalpha", "lsm_weight",
                                       "attn_chunk", "attn_left_chunks")})
    path = os.path.join(work, "model")
    save_checkpoint(path, "final_avg", tree, hyper)
    vocab = build_char_vocab([LETTERS[: am["vocab_size"] - 4]])
    if len(vocab) != am["vocab_size"]:
        raise ValueError(f"{len(vocab)} units, not am.vocab_size")
    save_vocab(vocab, os.path.join(path, "vocab.json"))
    frontend = {k: fe[k] for k in ("srate", "nfilters", "coeff_num", "coeff_range", "order",
                                   "fduration", "overlap_fraction", "fbank_type", "frate")}
    with open(os.path.join(path, "serving.json"), "w") as f:
        json.dump({"frontend": {"type": "fdlp", **frontend}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "global"}, f)
    return path, am, weights


def setup(ctx):
    import torch

    from speech_recognition_tools_tpu_torch.cli import serve

    from benchmark.reference.fdlp import features
    from benchmark.reference.precision import Precision

    p, fe, dev = ctx.params, ctx.config["frontend"], ctx.device
    S, srate = p["streams"], fe["srate"]
    work = tempfile.mkdtemp(prefix="bench_stream_")  # under TMPDIR
    gen = device_generator(ctx.seed, dev)
    model_dir, am, weights = _model_dir(ctx, work, gen)

    rng = np.random.RandomState(numpy_seed(ctx.seed))
    n = p["utterances_per_stream"]
    sigs, blob = [], {}
    for i in range(S):
        lens = lengths_grid(n, p["seconds_lo"], p["seconds_hi"], 1.0 / srate,
                            numpy_seed(ctx.seed) + i)
        sigs.append(speechlike_signals(rng, lens, srate))
        for j, s in enumerate(sigs[-1]):
            blob[f"s{i}_u{j}"] = s.astype(np.int16)
    np.savez(os.path.join(work, "signals.npz"), **blob)
    # global CMVN of the model directory: the reference front-end's
    # statistics of two utterances
    ref = torch.cat([features(sigs[0][j], fe, Precision("f64"), dev) for j in range(2)])
    mean, std = ref.mean(0).cpu().numpy(), ref.std(0).cpu().numpy()
    np.savez(os.path.join(model_dir, "cmvn.npz"), mean=mean.astype(np.float32),
             std=std.astype(np.float32))

    server, port = serve.make_server(model_dir, host="127.0.0.1", port=0,
                                     max_streams=p["max_streams"],
                                     defer_s=p["defer_ms"] / 1000.0, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    svc = server.service
    if ctx.trace:
        _instrument(ctx, svc)
    _warm_up(port, sigs[0][0], srate, p["chunk_s"])
    plan = dict(port=port, signals=os.path.join(work, "signals.npz"), streams=S,
                utterances=n, chunk_s=p["chunk_s"], srate=srate, seconds=ctx.seconds,
                drain_s=p["drain_s"],
                offsets=rng.uniform(-p["ramp_s"], 0.0, S).tolist())
    client = subprocess.Popen([sys.executable, CLIENT], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
    client.stdin.write(json.dumps(plan) + "\n")
    client.stdin.flush()
    if client.stdout.readline().strip() != "ready":
        raise RuntimeError("the stream client did not start")
    return dict(server=server, thread=thread, client=client, work=work, sigs=sigs,
                weights=weights, am=am, cmvn=(mean, std), svc=svc)


def _instrument(ctx, svc):
    """Spans around the batcher's push under the service lock and around
    each connection's featgen call (traced runs only)."""
    batcher = svc.batcher
    push = batcher.push

    def spanned_push(*a, **kw):
        with ctx.rec.span("stream.push"):
            return push(*a, **kw)

    batcher.push = spanned_push
    make = svc._mk_featgen

    def spanned_featgen():
        fg = make()
        process = fg.process

        def spanned_process(samples):
            with ctx.rec.span("stream.featgen"):
                return process(samples)

        fg.process = spanned_process
        return fg

    svc._mk_featgen = spanned_featgen


def _warm_up(port, sig, srate, chunk_s):
    """One unpaced utterance through the socket: every kernel of a round,
    of the streaming featgen and of the final is built and run once."""
    import socket

    chunk = int(round(chunk_s * srate))
    with socket.create_connection(("127.0.0.1", port)) as sock:
        f = sock.makefile("rw")
        for k in range(0, len(sig), chunk):
            f.write(json.dumps({"pcm": sig[k:k + chunk].astype(np.int64).tolist()}) + "\n")
            f.flush()
            json.loads(f.readline())
        f.write('{"eof": true}\n')
        f.flush()
        json.loads(f.readline())


def window(ctx, state):
    svc = state["svc"]
    rounds0 = svc.batcher.rounds
    t0 = time.time() + ctx.params["ramp_s"] + 0.5
    client = state["client"]
    client.stdin.write(json.dumps({"t0": t0}) + "\n")
    client.stdin.flush()
    client.stdin.close()
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(client.stdout), daemon=True)
    reader.start()
    # the trace covers the window's first trace_units seconds
    trace_end = t0 + ctx.cell.get("trace_units", 1)
    deadline = time.time() + ctx.seconds + ctx.params["drain_s"] + 60
    while client.poll() is None and time.time() < deadline:
        if ctx.tracer is not None and ctx.tracer.active and time.time() >= trace_end:
            ctx.tracer.stop()
            ctx.facts["rounds_traced"] = svc.batcher.rounds - rounds0
        time.sleep(0.05)
    if client.poll() is None:
        client.kill()
    client.wait()
    reader.join(timeout=10)
    out = "".join(lines)
    if client.returncode != 0:
        raise RuntimeError(f"the stream client exited with {client.returncode}")
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    end = t0 + ctx.seconds
    lat, lag, failed, halves = [], [], 0, ([], [])
    for r in recs:
        for due, sent, arr in zip(r["due"], r["sent"], r["arrival"]):
            if not t0 <= due < end:
                continue
            if arr is None:
                failed += 1
                continue
            lat.append(arr - due)
            lag.append(sent - due)
            halves[int(due >= t0 + ctx.seconds / 2)].append(arr - due)
    attempted = len(lat) + failed
    if attempted == 0:
        raise RuntimeError("no message was due in the window")
    # a failed message counts as later than every reply
    ranked = np.sort(np.concatenate([np.asarray(lat), np.full(failed, np.inf)]))
    p95 = float(np.percentile(ranked, 95, method="linear")) if failed == 0 else \
        float(ranked[min(len(ranked) - 1, int(np.ceil(0.95 * len(ranked))) - 1)])
    state["recs"] = recs
    ctx.facts.update(rounds=svc.batcher.rounds - rounds0, messages=attempted,
                     send_lag_p95_ms=1e3 * float(np.percentile(lag, 95)) if lag else None,
                     reply_p50_ms=1e3 * float(np.percentile(lat, 50)) if lat else None,
                     # a growing backlog shows as a later second half
                     reply_p95_halves_ms=[1e3 * float(np.percentile(h, 95)) if h else None
                                          for h in halves],
                     utterances=len(recs))
    return {"metrics": {"stream_reply_p95_ms": 1e3 * p95},
            "attempted": attempted, "failed": failed}


def _picks(ctx, state):
    done = [r for r in state["recs"] if r["final"] is not None and "tokens" in r["final"]]
    if not done:
        return []
    sigs = state["sigs"]
    lens = [len(sigs[r["stream"]][r["utt"]]) for r in done]
    first = int(np.argmax(lens))
    rest = [r for k, r in enumerate(done) if k != first]
    rng = np.random.RandomState(numpy_seed(ctx.seed) ^ 0x57EA)
    k = min(ctx.params["check_utterances"] - 1, len(rest))
    return [done[first]] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]


def _reference_logp(ctx, state, sig, P):
    import torch

    from benchmark.reference import transformer as ref
    from benchmark.reference.fdlp import features

    dev = ctx.device
    feats = features(sig, ctx.config["frontend"], P, dev)
    mean, std = (torch.as_tensor(v, device=dev).to(P.dtype) for v in state["cmvn"])
    feats = (feats.to(P.dtype) - mean) / std
    W = ref.Weights(state["weights"], P)
    with torch.no_grad():
        _, enc_len, ctc = ref.encode(W, feats[None], torch.tensor([feats.shape[0]], device=dev),
                                     state["am"])
    return ctc[0, : int(enc_len[0])].double()


def _served(final, sub_dt):
    """The served frame decisions: {emit frame: token} from the final."""
    return {int(round(t / sub_dt)): tok for t, tok in zip(final["times"], final["tokens"])}


def _greedy(lp):
    """Greedy CTC of (T, V) log-probabilities as a served final would say
    it: tokens, emit frames, posteriors."""
    ids = lp.argmax(-1).tolist()
    toks, frames, confs, prev = [], [], [], 0
    for t, i in enumerate(ids):
        if i != 0 and i != prev:
            toks.append(i)
            frames.append(t)
            confs.append(float(lp[t, i].exp()))
        prev = i
    return toks, frames, confs


def _gap(lp, emits):
    """Widest gap below the reference's best of the frame decisions that
    `emits` ({frame: token}) implies: the token at an emitting frame,
    elsewhere blank or the last emitted token, whichever scores higher."""
    best = lp.max(-1).values
    worst, last = 0.0, None
    for t in range(lp.shape[0]):
        if t in emits:
            last = emits[t]
            got = lp[t, last]
        else:
            got = lp[t, 0] if last is None else max(lp[t, 0], lp[t, last])
        worst = max(worst, float(best[t] - got))
    return worst


def check(ctx, state):
    import torch

    from benchmark.reference.precision import Precision

    _shutdown(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    sub_dt = 4.0 / ctx.config["frontend"]["frate"]
    gap = conf = 0.0
    frames_off = partial_bad = 0
    c_gap = c_conf = 0.0
    picks = _picks(ctx, state)
    for r in picks:
        sig = state["sigs"][r["stream"]][r["utt"]]
        lp = _reference_logp(ctx, state, sig, Precision("f64"))
        final = r["final"]
        frames_off += int(final["frames"] != lp.shape[0])
        emits = _served(final, sub_dt)
        if max(emits, default=-1) >= lp.shape[0]:
            frames_off += 1
            continue
        gap = max(gap, _gap(lp, emits))
        for t, c in zip(final["times"], final["confs"]):
            f = int(round(t / sub_dt))
            conf = max(conf, abs(c - float(lp[f, emits[f]].exp())))
        text = final["final"]
        partial_bad += sum(1 for s in r["partials"] if s is None or not text.startswith(s))
        if ctx.facts.get("control"):
            lp_c = _reference_logp(ctx, state, sig, Precision("tf32"))
            toks, fr, cf = _greedy(lp_c)
            c_gap = max(c_gap, _gap(lp, dict(zip(fr, toks))))
            c_conf = max([c_conf] + [abs(round(c, 4) - float(lp[f, k].exp()))
                                     for f, k, c in zip(fr, toks, cf)])
    readings = {"token_gap": gap, "conf_abs": conf, "frames_off": float(frames_off),
                "partial_bad": float(partial_bad),
                "checked": float(len(picks))}
    if ctx.facts.get("control"):
        ctx.facts["control_readings"] = {"token_gap": c_gap, "conf_abs": c_conf}
    ctx.facts["readings"] = readings
    out = [(k, readings[k], lim) for k, lim in ctx.cell["limits"].items()]
    # a check that compared nothing is no check
    out.append(("unchecked", float(len(picks) < min(ctx.params["check_utterances"], 1)), 0.0))
    return out


def _shutdown(state):
    server = state.pop("server", None)
    if server is not None:
        server.shutdown()
        server.server_close()
        state.pop("thread").join(timeout=30)
    client = state.pop("client", None)
    if client is not None and client.poll() is None:
        client.kill()
        client.wait()
    state.pop("svc", None)
    shutil.rmtree(state.pop("work"), ignore_errors=True)
