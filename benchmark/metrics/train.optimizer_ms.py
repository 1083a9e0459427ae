"""Host milliseconds of a training step's update outside its wait on the
device: the mean (`train.optimizer` - its `optim.wait`, the clip's read of
the global norm) a profiled `train.step` span (`train/optim.py`).

Read from the port's own spans (`utils/profiling.py::span`), which record
only while the profiler runs: the window's first `run.traced_units` units,
the same units and clock as the idle share. Profiled units run slower than
plain ones (~2x, PERF.md §3): compare this metric PR to PR, not with the
benchmark's own span metrics, which read the units after the profiled ones.
None where the port recorded no span.
"""


def read(run):
    from speech_recognition_tools_tpu_torch.utils import profiling

    last_units = getattr(profiling, "last_units", None)  # None before the port had spans
    if last_units is None:
        return None
    units = last_units("train.step", run.traced_units)
    if not units:
        return None
    ns = 0
    for _, below in units:
        for r in below:
            if r.name == "train.optimizer":
                ns += r.end_ns - r.start_ns
            elif r.name == "optim.wait":
                ns -= r.end_ns - r.start_ns
    return ns / 1e6 / len(units)
