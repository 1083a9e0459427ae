"""Host milliseconds of a training step's forward pass (the loss, through
the GRU's time loop): the mean `train.forward` span a profiled
`train.step` span (`train/trainer.py::Trainer.train_step`).

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
    return sum(r.end_ns - r.start_ns for _, below in units for r in below
               if r.name == "train.forward") / 1e6 / len(units)
