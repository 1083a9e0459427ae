"""Every cell and every traffic kind runs end to end on the CPU at a tiny
size against its plain reference (the look for a card skipped), with its
end-to-end metrics plain and its per-layer metrics traced; a new
configuration, cell and per-layer metric come as new files and entries
alone."""

import json
import os

import pytest

from conftest import ROOT, add_e2e_train_cell, add_stream_cell, run_tiny

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
CELLS = [w["name"] for w in SPEC["workloads"]]


def _expected(spec, cell, group):
    return {m["name"] for m in spec[group] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, cell, trace):
    result, _ = run_tiny(tiny_root, cell, trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    if trace:
        assert "breakdown" in result and result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == _expected(SPEC, cell, "end_to_end")
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_a_cell_added_as_data(tiny_root):
    """The transformer_asr family of the train driver, as a configuration,
    a cell and a per-layer metric added without editing a file there."""
    before = {os.path.join(b, f): os.path.getmtime(os.path.join(b, f))
              for b, _, fs in os.walk(os.path.join(tiny_root, "benchmark")) for f in fs}
    name = add_e2e_train_cell(tiny_root)
    for path, mtime in before.items():
        assert os.path.getmtime(path) == mtime, path
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    plain, _ = run_tiny(tiny_root, name)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    # The span reader leaves out the two profiled steps: the window has to
    # outlast them, also on a host that other tests keep busy.
    traced, _ = run_tiny(tiny_root, name, trace=True, seconds=5.0)
    assert traced["correct"]
    assert set(traced["metrics"]) == _expected(spec, name, "per_layer")


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_the_stream_cell_added_as_entries(tiny_root, trace):
    """The stream cell's files are there; entries alone make it a cell."""
    name = add_stream_cell(tiny_root)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    result, ctx = run_tiny(tiny_root, name, trace, seconds=2.0)
    assert result["correct"], result["checks"]
    assert ctx.facts["readings"]["checked"] > 0
    group = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) <= _expected(spec, name, group)
    if not trace:
        assert set(result["metrics"]) == _expected(spec, name, group)


@pytest.mark.parametrize("cell", ["wsj_fdlp_e2e.decode", "timit_hybrid.train"])
def test_spans_are_the_windows_own(tiny_root, cell):
    """Spans are recorded in the window only, not in set-up's warm-up or
    first steps; those of the profiled units are kept apart."""
    _, ctx = run_tiny(tiny_root, cell, trace=True, seconds=2.0)
    units = ctx.cell["trace_units"]
    done = ctx.facts["steps"]
    done = len(done) if isinstance(done, list) else done
    assert done > units
    for name in ctx.rec.spans:
        assert len(ctx.rec.traced[name]) == units
        assert len(ctx.rec.spans[name]) == done - units
