"""Share of the H100's memory bandwidth (3.35 TB/s) that the LLM's decode
steps reach: the bytes the profiled batches' steps must read
(`llm_work.step_bytes`: the distinct experts each expert layer used in the
step, from the counts of its `llm.moe` spans, the shared experts, the
routers, attention, the dense layer, the head and the latent cache of
each row's real positions) over the steps' time (each `search` span less
its `search.init`, which holds the prefill; the step's wait on the device
included).

None where the port recorded no `llm.moe` span."""

from benchmark import llm_spans, llm_work
from benchmark.common import H100_BYTES_PER_S


def read(run):
    steps = llm_spans.decode_steps(run)
    if not steps:
        return None
    f, K = run.facts, run.facts["beam"]
    total = seconds = 0.0
    for u, (ns, active) in enumerate(steps):
        P = f["prefix_lens"][u]
        rows = K * len(P)
        for s, act in enumerate(active):
            attended = K * sum(p + s + 1 for p in P)
            total += llm_work.step_bytes(run.config, rows, attended, act)
        seconds += ns / 1e9
    return 100.0 * total / seconds / H100_BYTES_PER_S
