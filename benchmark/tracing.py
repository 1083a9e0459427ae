"""The device trace of a `--trace 1` run.

torch.profiler records the device only (kernels, copies, memsets): host
ops of a window with 10^5-10^6 launches took tens of seconds to parse
(chip_smoke.py::device_breakdown learnt this). The trace covers the
window's first `trace_units` units of work (batches or steps, as the
cell's file sets them); the driver calls `unit_done()` after each unit.
The summary gives the device's busy seconds (the union of the recorded
activities' intervals), the traced window's wall seconds, the ten
activities that took most device time, and the ten longest idle gaps
between activities, each named by the activity that ended it.
"""

from __future__ import annotations

import time


class Tracer:
    def __init__(self, device, units: int):
        self.device = device
        self.units = max(1, int(units))
        self.done = 0
        self.prof = None
        self.t0 = None
        self.window_s = None
        self._summary = None

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                      else [ProfilerActivity.CPU])
        self.prof = profile(activities=activities)
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def unit_done(self):
        self.done += 1
        if self.done == self.units:
            self.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.window_s is None

    def stop(self):
        if not self.active:
            return
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        if self._summary is None:
            self._summary = self._summarise()
        return self._summary

    def _summarise(self) -> dict:
        """Read the raw Kineto activities (building the profiler's Python
        event tree takes minutes for a window of 10^5-10^6 launches)."""
        import torch

        want = (torch.autograd.DeviceType.CUDA if self.device.type == "cuda"
                else torch.autograd.DeviceType.CPU)
        spans, by_name = [], {}
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != want or name == "Activity Buffer Request":
                continue
            start, dur = e.start_ns(), e.duration_ns()
            if dur <= 0:
                continue
            spans.append((start, start + dur, name))
            by_name[name] = by_name.get(name, 0.0) + dur / 1e9
        spans.sort()
        busy_ns, gaps = 0, []
        cur_start = cur_end = None
        for start, end, name in spans:
            if cur_end is None:
                cur_start, cur_end = start, end
            elif start > cur_end:
                busy_ns += cur_end - cur_start
                gaps.append(((start - cur_end) / 1e9, "before " + name[:80]))
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        if cur_end is not None:
            busy_ns += cur_end - cur_start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps.sort(key=lambda g: -g[0])
        return {"busy_s": busy_ns / 1e9, "window_s": self.window_s,
                "device_ops": [[name[:120], s] for name, s in top],
                "idle_gaps": [[name, s] for s, name in gaps[:10]],
                "by_name": by_name}


def idle_pct(trace: dict | None) -> float | None:
    """Share of the traced window in which no device activity ran, or
    None where the trace saw no device time."""
    if not trace or not trace["window_s"] or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
