"""Share of the H100's dense bf16 peak (989 TFLOP/s) that the speech LLM's
decode reaches: the operations of the window's batches after the profiled
ones (the audio tower, as `decode.mfu` counts it; the projector and the
prefill; every search step of every beam: `llm_work.py`) over their wall
time. None for a cell without the speech LLM."""

import os

from benchmark import llm_work
from benchmark.harness import load_module

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read(run):
    f = run.facts
    if "prefix_lens" not in f:
        return None
    skip = run.traced_units
    seconds = sum(f["batch_s"][skip:])
    if not seconds:
        return None
    encoder_flops = load_module("metrics", "decode.mfu", _ROOT).encoder_flops
    c, K = run.config, f["beam"]
    idim = c["frontend"]["nfilters"]
    stack_in = c["projector"]["stack"] * c["am"]["adim"]
    total = 0
    for ins, lens, P, steps in zip(f["in_lens"][skip:], f["enc_lens"][skip:],
                                   f["prefix_lens"][skip:], f["steps"][skip:]):
        total += sum(encoder_flops(c["am"], idim, t_in, t2) for t_in, t2 in zip(ins, lens))
        total += llm_work.prefill_flops(c, P, stack_in)
        for s in range(steps):
            total += llm_work.step_flops(c, K * len(P), K * sum(p + s + 1 for p in P))
    return 100.0 * total / seconds / llm_work.H100_BF16_FLOPS
