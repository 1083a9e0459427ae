"""Host milliseconds the loader spends building a batch between steps
(`io/egs.py::iter_egs_batches`: the padding of the utterances into one
array): the mean of the last `run.traced_units` `egs.batch` spans, one a
profiled step.

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
    units = last_units("egs.batch", run.traced_units)
    if not units:
        return None
    return sum(root.end_ns - root.start_ns for root, _ in units) / 1e6 / len(units)
