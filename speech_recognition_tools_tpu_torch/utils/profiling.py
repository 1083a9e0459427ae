"""Throughput counters for the training CLIs.

Port of speech_recognition_tools_tpu/utils/profiling.py::ThroughputMeter
(the JAX module's trace helpers wrap jax.profiler; the port's profiles are
torch.profiler windows in chip_smoke.py). The caller synchronises the
device before reading a rate: the meter reads the host clock.
"""

import time


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
