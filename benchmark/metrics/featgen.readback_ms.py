"""Host milliseconds a featgen batch waits for the device and copies its
features back (`cli/common.py::run_batched`'s two `.cpu().numpy()`): the
mean `featgen.readback` span a batch, over the profiled passes'
`featgen.pass` spans.

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
    units = last_units("featgen.pass", run.traced_units)
    reads = [r.end_ns - r.start_ns for _, below in units for r in below
             if r.name == "featgen.readback"]
    return sum(reads) / 1e6 / len(reads) if reads else None
