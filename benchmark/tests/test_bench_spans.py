"""The per-layer metrics that read the port's own spans
(`utils/profiling.py::span`): each cell, run tiny with `--trace 1`, reports
every one of them, finite and positive; the spans of its profiled units
nest as the readers expect, the children of `search` and of
`featgen.pass` covering at least 90% of their root; and a reader with no
span to read returns None."""

import collections
import json
import math
import os

import pytest

from benchmark import harness
from conftest import ROOT, run_tiny

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
# the per-layer metrics that read the port's spans, by cell
PORT_SPAN_METRICS = {
    "wsj_fdlp_e2e.decode": ["decode.search_host_ms_per_step", "decode.ctc_prefix_ms_per_step",
                            "decode.decoder_ms_per_step"],
    "timit_hybrid.train": ["train.forward_ms", "train.backward_ms", "train.optimizer_ms",
                           "train.egs_ms"],
    "wsj_fdlp_e2e.featgen": ["featgen.pad_ms", "featgen.h2d_gb_per_s", "featgen.readback_ms"],
}
ROOTS = {"wsj_fdlp_e2e.decode": "search", "timit_hybrid.train": "train.step",
         "wsj_fdlp_e2e.featgen": "featgen.pass"}


def _children_share(root, below):
    kids = [r for r in below if r.parent == root.id]
    return sum(r.end_ns - r.start_ns for r in kids) / (root.end_ns - root.start_ns)


def test_the_metrics_are_listed_for_their_cells():
    listed = {m["name"]: m for m in SPEC["per_layer"]}
    for cell, names in PORT_SPAN_METRICS.items():
        for name in names:
            assert listed[name]["workloads"] == [cell]
            assert listed[name]["source"] == "program_span"


@pytest.mark.parametrize("cell", sorted(PORT_SPAN_METRICS))
def test_a_traced_run_reads_the_ports_spans(tiny_root, cell):
    from speech_recognition_tools_tpu_torch.utils.profiling import last_units

    result, ctx = run_tiny(tiny_root, cell, trace=True, seconds=1.0)
    assert result["correct"], result["checks"]
    for name in PORT_SPAN_METRICS[cell]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    units = ctx.tracer.done
    roots = last_units(ROOTS[cell], units)
    assert units >= 1 and len(roots) == units
    for root, below in roots:
        names = collections.Counter(r.name for r in below)
        if cell == "wsj_fdlp_e2e.decode":
            assert root.n >= 1
            for part in ("search.decoder", "search.lm", "search.ctc_prefix", "search.topk",
                         "search.update", "search.wait"):
                assert names[part] == root.n, part
            assert _children_share(root, below) >= 0.9
        elif cell == "wsj_fdlp_e2e.featgen":
            assert root.n == ctx.params["utterances"]
            batches = names["featgen.pad"]
            assert batches >= 1 and names["fdlp.h2d"] == batches
            for part in ("featgen.batch_fn", "featgen.readback", "featgen.split"):
                assert names[part] == batches, part
            assert all(r.n > 0 for r in below if r.name == "fdlp.h2d")
            assert _children_share(root, below) >= 0.9
        else:
            assert root.n > 0  # the batch's valid frames
            for part in ("train.forward", "train.backward", "train.optimizer", "optim.wait"):
                assert names[part] == 1, part
    if cell == "timit_hybrid.train":
        egs = last_units("egs.batch", units)
        assert len(egs) == units and all(r.n > 0 for r, _ in egs)


def test_a_reader_without_spans_returns_none(monkeypatch):
    from speech_recognition_tools_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    for cell, names in PORT_SPAN_METRICS.items():
        run = harness.Run(cell={"name": cell}, config={}, spans={}, facts={}, trace=None,
                          window_s=1.0, traced_units=2)
        for name in names:
            assert harness.load_module("metrics", name).read(run) is None, name
