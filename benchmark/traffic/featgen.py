"""Corpus feature extraction (traffic kind "featgen").

The window runs `cli/common.py::run_batched` with
`dsp/fdlp.py::fdlp_spectrogram_batch` as the `compute_fdlp_spectrogram`
CLI runs it: utterances sorted by length, batches of `batch` padded to a
multiple of `bucket_seconds`, the features copied to host memory (no ark
written). It passes over the shard again and again until `seconds` have
passed; the rate is all the audio whose features reached the host over
all the time.

Inputs: a shard of `utterances` speech-like utterances (common.py) with
lengths evenly spread over [seconds_lo, seconds_hi], the same set every
seed, held in host memory.

Check: the features of `check_utterances` utterances of the last pass
(the longest and others drawn from the seed) against reference/fdlp.py
on the same samples, over every valid frame: the largest absolute gap of
the log features and its 99.9th percentile.
"""

import time

import numpy as np

from benchmark.common import lengths_grid, numpy_seed, speechlike_signals


def fdlp_config(fe: dict):
    from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig

    return FdlpConfig(srate=fe["srate"], nfilters=fe["nfilters"], coeff_num=fe["coeff_num"],
                      coeff_range=fe["coeff_range"], order=fe["order"],
                      fduration=fe["fduration"], frate=fe["frate"],
                      overlap_fraction=fe["overlap_fraction"], fbank_type=fe["fbank_type"],
                      precision=fe["precision"])


def setup(ctx):
    from speech_recognition_tools_tpu_torch.cli.common import run_batched
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_spectrogram_batch
    from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra
    from speech_recognition_tools_tpu_torch.utils.profiling import ThroughputMeter

    p, fe, dev = ctx.params, ctx.config["frontend"], ctx.device
    cfg = fdlp_config(fe)
    srate = fe["srate"]
    lens = lengths_grid(p["utterances"], p["seconds_lo"], p["seconds_hi"], 1.0 / srate,
                        ctx.seed)
    rng = np.random.RandomState(numpy_seed(ctx.seed))
    signals = [(f"utt{i:04d}", s) for i, s in enumerate(speechlike_signals(rng, lens, srate))]

    def batch_fn(batch, nsamp):
        return fdlp_spectrogram_batch(batch, nsamp, cfg, device=dev)

    def one_pass():
        return run_batched(signals, batch_fn, batch_size=p["batch"],
                           bucket_multiple=int(p["bucket_seconds"] * srate),
                           meter=ThroughputMeter(), srate=srate, device=dev)

    one_pass()  # every bucket shape; builds K1 on a checkout's first run
    return dict(one_pass=one_pass, signals=signals, audio=float(lens.sum()) / srate,
                lens=lens, k1=lpc_cepstra)


def window(ctx, state):
    from speech_recognition_tools_tpu_torch.ops.framing import frame_count, frame_params

    fe = ctx.config["frontend"]
    passes = audio = 0
    pass_s = []
    k1_before = state["k1"].launches
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        feats = state["one_pass"]()
        pass_s.append(time.perf_counter() - t)
        passes += 1
        audio += state["audio"]
        if ctx.tracer is not None and ctx.tracer.active:
            ctx.tracer.unit_done()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    state["feats"] = feats
    fp = frame_params(fe["srate"], 1.0 / ((1 - fe["overlap_fraction"]) * fe["fduration"]),
                      fe["fduration"])
    ctx.facts.update(passes=passes, pass_s=pass_s,
                     pass_windows=[frame_count(int(n), fp) for n in state["lens"]],
                     pass_frames=[int(-(-int(n) * fe["frate"] // fe["srate"]))
                                  for n in state["lens"]],
                     k1_launches=state["k1"].launches - k1_before)
    n = len(state["signals"])
    return {"metrics": {"featgen_audio_s_per_s": audio / elapsed},
            "attempted": passes * n, "failed": 0}


def _readings(ctx, state, keys, P, got):
    import torch

    from benchmark.reference.fdlp import features

    fe = ctx.config["frontend"]
    signals = dict(state["signals"])
    gaps = []
    for k in keys:
        want = features(signals[k], fe, P, ctx.device).double()
        have = torch.as_tensor(got[k], device=ctx.device).double()
        if have.shape != want.shape:
            return {"feat_max": float("inf"), "feat_p999": float("inf")}
        gaps.append((have - want).abs().flatten())
    gaps = torch.cat(gaps)
    return {"feat_max": float(gaps.max()), "feat_p999": float(torch.quantile(
        gaps.float(), 0.999))}


def check(ctx, state):
    import torch

    from benchmark.reference.precision import Precision

    feats = state.pop("feats")
    state.pop("one_pass")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    order = np.argsort(state["lens"])
    keys = [state["signals"][int(order[-1])][0]]
    rng = np.random.RandomState(numpy_seed(ctx.seed) ^ 0xFEA7)
    rest = [state["signals"][int(i)][0] for i in order[:-1]]
    keys += [rest[i] for i in rng.choice(len(rest), ctx.params["check_utterances"] - 1,
                                         replace=False)]
    readings = _readings(ctx, state, keys, Precision("f64"), feats)
    if ctx.facts.get("control"):
        ctl = {}
        for k in keys:
            from benchmark.reference.fdlp import features

            ctl[k] = features(dict(state["signals"])[k], ctx.config["frontend"],
                              Precision("tf32"), ctx.device)
        ctx.facts["control_readings"] = _readings(ctx, state, keys, Precision("f64"), ctl)
    ctx.facts["readings"] = readings
    return [(k, readings[k], lim) for k, lim in ctx.cell["limits"].items()]
