"""The port's span recorder (utils/profiling.py::span): nothing recorded
and one shared no-op without a profiler; under one, nested spans with their
parents and counts, a stack per thread, the profiler's own clock, a bounded
buffer; and on the card (skipped without one) a span that contains the
device interval of the kernel it enqueued and waited for."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speech_recognition_tools_tpu_torch.utils import profiling
from speech_recognition_tools_tpu_torch.utils.profiling import last_units, span, span_records


def _since(first_id):
    return [r for r in span_records() if r.id > first_id]


def _last_id():
    return max((r.id for r in span_records()), default=0)


def test_without_a_profiler_a_span_is_the_shared_no_op():
    before = len(span_records())
    a, b = span("x"), span("y", n=3)
    assert a is b and not a
    with a as sp:
        sp.n = 5
        assert sp.n is None
    assert len(span_records()) == before


def test_nested_spans_record_parents_counts_and_names_under_a_profiler():
    first = _last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", n=2) as outer:
            assert outer
            with span("outer.a", n=7):
                pass
            with span("outer.b") as b:
                with span("outer.b.c"):
                    pass
                b.n = torch.tensor(11)
            outer.n = 3
    recs = {r.name: r for r in _since(first)}
    assert set(recs) == {"outer", "outer.a", "outer.b", "outer.b.c"}
    assert recs["outer"].parent == 0 and recs["outer"].n == 3
    assert recs["outer.a"].parent == recs["outer"].id and recs["outer.a"].n == 7
    assert recs["outer.b"].parent == recs["outer"].id and recs["outer.b"].n == 11
    assert recs["outer.b.c"].parent == recs["outer.b"].id and recs["outer.b.c"].n is None
    for r in recs.values():
        assert 0 < r.end_ns - r.start_ns
    (root, below), = last_units("outer", 1)
    assert root == recs["outer"] and sorted(r.name for r in below) == [
        "outer.a", "outer.b", "outer.b.c"]
    # the spans are record_function ranges of the profiler's trace too
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"outer", "outer.a", "outer.b", "outer.b.c"} <= names


def test_a_span_contains_the_profilers_interval_of_an_op_inside_it():
    """The spans' clock is that of the profiler's events (Unix-epoch ns)."""
    first = _last_id()
    x = torch.randn(300, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("clock"):
            x @ x
    rec, = [r for r in _since(first) if r.name == "clock"]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert rec.start_ns <= start <= end <= rec.end_ns
    assert end - start > 0 and rec.end_ns - rec.start_ns < 10 * (end - start) + 10_000_000


def test_two_threads_keep_their_own_stacks(monkeypatch):
    """Each thread nests its spans under its own open span, however the two
    interleave (the profiler's session is per thread; both record here)."""
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    first = _last_id()
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with span(f"{tag}.root"):
            barrier.wait()
            for _ in range(20):
                with span(f"{tag}.child"):
                    time.sleep(0.0005)
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    recs = _since(first)
    roots = {r.name: r.id for r in recs if r.parent == 0}
    assert set(roots) == {"a.root", "b.root"}
    for tag in ("a", "b"):
        kids = [r for r in recs if r.name == f"{tag}.child"]
        assert len(kids) == 20 and all(r.parent == roots[f"{tag}.root"] for r in kids)


def test_the_buffer_stays_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_records", profiling.collections.deque(maxlen=5))
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    for i in range(12):
        with span("bounded", n=i):
            pass
    recs = span_records()
    assert len(recs) == 5 and [r.n for r in recs] == [7, 8, 9, 10, 11]
    assert profiling.MAX_RECORDS == 1_000_000


def test_on_the_card_a_span_contains_its_kernels_device_interval():
    """Under a device-only profiler (as the benchmark's tracer runs it), the
    profiler reads as on, and a span around a ~1 ms kernel and the wait for
    it contains the kernel's device interval, each end within 50 us: the
    spans and the device trace share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    first = _last_id()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch._C._autograd._profiler_enabled()
        # the session's first launches set up its activity buffers: not timed
        for _ in range(3):
            with span("card.warm"):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        with span("card.sleep"):
            torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's ~2 GHz
            torch.cuda.synchronize()
        torch.cuda.synchronize()
    rec, = [r for r in _since(first) if r.name == "card.sleep"]
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
              and e.name() != "Activity Buffer Request"]
    longest = max(device, key=lambda e: e.duration_ns())
    start, end = longest.start_ns(), longest.start_ns() + longest.duration_ns()
    lead, tail = start - rec.start_ns, rec.end_ns - end
    print(f"span {rec.start_ns}..{rec.end_ns}, kernel {start}..{end}: lead {lead / 1e3:.1f} us, "
          f"tail {tail / 1e3:.1f} us, kernel {(end - start) / 1e3:.1f} us; device events "
          f"{[(e.name()[:40], e.duration_ns()) for e in device]}")
    assert end - start > 200_000
    assert 0 <= lead <= 50_000 and 0 <= tail <= 50_000, (lead, tail)
