"""Tracing, spans and throughput counters.

Port of speech_recognition_tools_tpu/utils/profiling.py: `trace` captures
a torch.profiler trace (the JAX package's captures a jax.profiler one),
and `ThroughputMeter` counts utterances and audio seconds per wall second
for the CLIs. The caller synchronises the device before reading a rate:
the meter reads the host clock.

`span(name, n=None)` marks a region of the port's host work. It records
only while a torch.profiler session is active in the calling thread, and
then also opens `torch.profiler.record_function(name)`, so a Chrome trace
shows the same names beside the kernels. With no session it returns one
shared context that does nothing. A span never synchronises the device:
one around a call that waits for the device (`.item()`, `.cpu()`,
`bool(tensor)`) is named `*.wait` or `*.readback`, and its time is the
host's wait. Each record holds the name, start and end in Unix-epoch
nanoseconds (`time.time_ns()`, the clock of the profiler's Kineto events,
so a span can be laid over the device trace), its id, its parent's id
(0 for a root) from the thread's stack of open spans, and an optional
count `n` of the work it carried (bytes, steps, frames). `span_records`
and `last_units` read them back.
"""

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

MAX_RECORDS = 1_000_000

# the profiler's own look for a session in this thread (~0.1 us a call)
_enabled = torch._C._autograd._profiler_enabled
_records = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0: a root
    n: int | None


class _Off:
    """What `span` returns with no profiler session: enters, exits and
    takes a count without doing anything."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    @property
    def n(self):
        return None

    @n.setter
    def n(self, value):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "id", "parent", "start", "_rf")

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        # the clock is read inside the range, so that neither end counts the
        # range's own cost (~15 us under the profiler)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        _records.append(SpanRecord(self.name, self.start, end, self.id, self.parent, self.n))
        return False

    def __bool__(self):
        return True


def span(name: str, n=None):
    """A context for a region named `name`, carrying the count `n`; truthy
    only while it records. The count may also be set inside the block
    (`sp.n = steps`), and may be a 0-dim tensor, read when the records are
    read, so that the span never waits for the device."""
    if not _enabled():
        return _OFF
    return _Span(name, n)


def recording() -> bool:
    """Whether spans record in this thread now (a profiler session runs)."""
    return _enabled()


def span_records() -> list:
    """Every recorded span, in the order they ended (a child before its
    parent), their counts as Python numbers."""
    return [r._replace(n=r.n.item()) if isinstance(r.n, torch.Tensor) else r
            for r in list(_records)]


def last_units(root: str, units: int) -> list:
    """The last `units` root spans named `root`, each as (root record,
    [its descendants' records]), oldest first."""
    if units <= 0:
        return []
    records = span_records()
    roots = [r for r in records if r.name == root and r.parent == 0][-units:]
    children = collections.defaultdict(list)
    for r in records:
        children[r.parent].append(r)
    out = []
    for r in roots:
        below, todo = [], [r.id]
        while todo:
            kids = children.get(todo.pop(), [])
            below += kids
            todo += [k.id for k in kids]
        out.append((r, below))
    return out


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
