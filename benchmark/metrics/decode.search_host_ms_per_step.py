"""Host milliseconds a beam-search step takes outside its wait on the device:
(the `search` spans - their `search.wait` spans) over the steps they ran
(each `search` span's count), over the profiled batches. The wait is the
step's one host sync, `bool(finished.all())`; the rest is the host
launching the step's work, which the device trails.

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
    units = last_units("search", run.traced_units)
    steps = sum(root.n or 0 for root, _ in units)
    if not steps:
        return None
    ns = sum(root.end_ns - root.start_ns for root, _ in units)
    ns -= sum(r.end_ns - r.start_ns for _, below in units for r in below
              if r.name == "search.wait")
    return ns / 1e6 / steps
