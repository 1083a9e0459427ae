"""The speech LLM's port spans, as the `llm.*` per-layer metrics read
them: the profiled batches' `search` roots (`utils/profiling.py::
last_units`) and, in each, the spans directly under its steps'
`search.decoder` spans (the prefill's, under `search.init`, are left out).
"""


def _units(run):
    from speech_recognition_tools_tpu_torch.utils import profiling

    last_units = getattr(profiling, "last_units", None)  # None before the port had spans
    return last_units("search", run.traced_units) if last_units else []


def _in_steps(below, name):
    decoders = {r.id for r in below if r.name == "search.decoder"}
    return [r for r in below if r.name == name and r.parent in decoders]


def ms_per_step(run, name):
    """Milliseconds of the `name` spans under the steps, a step; None where
    there are none."""
    units = _units(run)
    steps = sum(root.n or 0 for root, _ in units)
    spans = [r for _, below in units for r in _in_steps(below, name)]
    if not steps or not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / steps


def decode_steps(run):
    """Per profiled batch: (nanoseconds of its steps: the `search` span less
    its `search.init`, a list per step of the counts of its `llm.moe`
    spans, the distinct experts each expert layer used). [] where the port
    recorded no `llm.moe` span under a step."""
    out = []
    for root, below in _units(run):
        moe = _in_steps(below, "llm.moe")
        if not moe:
            return []
        init = sum(r.end_ns - r.start_ns for r in below if r.name == "search.init")
        by_step = {}
        for r in moe:
            by_step.setdefault(r.parent, []).append(int(r.n))
        active = [by_step[k] for k in sorted(by_step)]
        out.append((root.end_ns - root.start_ns - init, active))
    return out
