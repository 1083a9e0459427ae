"""Tracing and throughput counters.

Port of speech_recognition_tools_tpu/utils/profiling.py: `trace` captures
a torch.profiler trace (the JAX package's captures a jax.profiler one),
`annotate` names a region inside it, and `ThroughputMeter` counts
utterances and audio seconds per wall second for the CLIs. The caller
synchronises the device before reading a rate: the meter reads the host
clock.
"""

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Capture a torch.profiler trace of the block into `log_dir` as a
    Chrome trace JSON (`<host>_<pid>.<ms>.pt.trace.json`, which
    chrome://tracing, Perfetto and TensorBoard read). CPU activities are
    traced always, CUDA activities when `device` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Accumulates items (utterances / frames / audio seconds) per second."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._items = 0.0
        self._audio_seconds = 0.0

    def update(self, items: float = 0.0, audio_seconds: float = 0.0):
        self._items += items
        self._audio_seconds += audio_seconds

    @property
    def elapsed(self):
        return time.time() - self._t0

    def rate(self):
        dt = max(self.elapsed, 1e-9)
        return {
            "items_per_sec": self._items / dt,
            "realtime_factor": self._audio_seconds / dt,
        }

    def summary(self):
        r = self.rate()
        return (
            f"{self._items:.0f} items in {self.elapsed:.1f}s "
            f"({r['items_per_sec']:.1f}/s, {r['realtime_factor']:.0f}x RT)"
        )
