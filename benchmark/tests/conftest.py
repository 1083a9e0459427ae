"""Shared fixtures of the benchmark's tests.

`card` skips a test when no CUDA card is present; the look is made inside
the fixture, never while a module is imported. `tiny_root` is a copy of
the benchmark (BENCHMARK.json and benchmark/) whose configurations and
cells are cut to a size the CPU runs in seconds: the same files under the
same names, the widths and counts small.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "wsj_fdlp_e2e": {
        "frontend": {"nfilters": 20, "order": 20, "coeff_num": 20, "coeff_range": "1,20",
                     "fduration": 0.25},
        "am": {"vocab_size": 12, "adim": 16, "aheads": 2, "elayers": 2, "eunits": 32,
               "dlayers": 1, "dunits": 32, "dropout": 0.0, "batch_size": 4},
        "lm": {"units": 24, "embed_dim": 8},
        "streaming": {"attn_chunk": 3, "attn_left_chunks": 2},
    },
    "timit_hybrid": {
        "frontend": {"nfilters": 8, "order": 10, "coeff_num": 10, "coeff_range": "1,8",
                     "fduration": 0.25},
        "am": {"num_layers": 2, "hidden_dim": 16, "num_classes": 12, "batch_size": 4},
    },
}
TINY_CELLS = {
    "wsj_fdlp_e2e.stream": {"streams": 2, "seconds_lo": 0.8, "seconds_hi": 1.2,
                            "utterances_per_stream": 3, "max_streams": 2, "drain_s": 30.0, "ramp_s": 0.5,
                            "check_utterances": 2},
    "wsj_fdlp_e2e.featgen": {"utterances": 12, "seconds_lo": 0.6, "seconds_hi": 1.2,
                             "batch": 4, "bucket_seconds": 0.25, "check_utterances": 3},
    "timit_hybrid.train": {"utterances": 8, "seconds_lo": 0.2, "seconds_hi": 0.4},
    "wsj_fdlp_e2e.decode": {"batch": 2, "utterances": 6, "seconds_lo": 0.3,
                            "seconds_hi": 0.6, "bucket_frames": 8, "max_len": 6},
}


# at the configurations' own widths: three batches of 32 distinct rows and
# frames enough for every one of timit_hybrid's 3,376 classes
REAL_WIDTH_CELLS = {
    "timit_hybrid.train": {"utterances": 96, "seconds_lo": 0.4, "seconds_hi": 0.6},
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and k in base else v
    return out


# every cell that has its files, in BENCHMARK.json or not (the stream cell
# is not: PERF.md §7)
CELL_FILES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "workloads"))
                    if f.endswith(".json"))


def make_tiny_root(dest: str, real_widths: bool = False) -> str:
    """A tiny copy of the benchmark under `dest`; with `real_widths` the
    configurations keep their own widths and only the cells' traffic is
    cut."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in ({} if real_widths else TINY_CONFIGS).items():
        path = os.path.join(dest, "benchmark", "configs", name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                cfg = json.load(f)
            with open(path, "w") as f:
                json.dump(_merge(cfg, over), f, indent=1)
    for name, over in TINY_CELLS.items():
        if real_widths:
            over = dict(over, **REAL_WIDTH_CELLS.get(name, {}))
        path = os.path.join(dest, "benchmark", "workloads", name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                cell = json.load(f)
            cell["params"] = dict(cell["params"], **over)
            with open(path, "w") as f:
                json.dump(cell, f, indent=1)
    return dest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


def add_e2e_train_cell(root: str) -> str:
    """Add, as new files and new entries only, a configuration, a training
    cell of the "transformer_asr" family and a per-layer metric of its own
    to a tiny benchmark copy; returns the cell's name."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "wsj_fdlp_e2e.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_e2e"
    cfg["am"]["dropout"] = 0.0
    cfg["am"]["warmup_steps"] = 4
    with open(os.path.join(bench, "configs", "tiny_e2e.json"), "w") as f:
        json.dump(cfg, f)
    cell = {"name": "tiny_e2e.train", "config": "tiny_e2e", "traffic": "train",
            "why": "a dummy cell: e2e joint CTC/attention training steps",
            "trace_units": 2,
            "params": {"utterances": 8, "seconds_lo": 0.4, "seconds_hi": 0.8,
                       "frame_rate": 100},
            "limits": {"loss_rel": 1e-5, "grad_leaf": 1e-5, "change_leaf": 1e-5}}
    with open(os.path.join(bench, "workloads", "tiny_e2e.train.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(bench, "metrics", "train.step_ms_e2e.py"), "w") as f:
        f.write('def read(run):\n    s = run.spans.get("train.step")\n'
                '    return 1e3 * sum(s) / len(s) if s else None\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_e2e", "source": cfg["source"],
                            "file": "benchmark/configs/tiny_e2e.json", "reduced": [],
                            "why": cfg["why"]})
    spec["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "why")}
                             | {"chips": 1})
    for m in spec["end_to_end"]:
        if m["name"] == "train_audio_s_per_s":
            m["workloads"].append(cell["name"])
    spec["per_layer"].append({"name": "train.step_ms_e2e", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "whole train step",
                              "moves": "train_audio_s_per_s", "workloads": [cell["name"]]})
    with open(path, "w") as f:
        json.dump(spec, f)
    return cell["name"]


def add_stream_cell(root: str) -> str:
    """Add the stream cell, whose files are there, to a tiny copy's
    BENCHMARK.json as entries alone: the cell, its end-to-end metric and
    its per-layer metrics."""
    name = "wsj_fdlp_e2e.stream"
    with open(os.path.join(root, "benchmark", "workloads", name + ".json")) as f:
        cell = json.load(f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "why")}
                             | {"chips": 1})
    spec["end_to_end"].append({"name": "stream_reply_p95_ms", "unit": "ms", "better": "lower",
                               "bound": 0.25, "source": "host_clock", "workloads": [name]})
    for metric, layer, unit, source in (
            ("stream.round_ms", "stream scheduler", "ms", "program_span"),
            ("stream.featgen_ms", "streaming front-end", "ms", "program_span"),
            ("stream.device_idle_pct", "device", "%", "device_trace")):
        spec["per_layer"].append({"name": metric, "unit": unit, "better": "lower",
                                  "source": source, "layer": layer,
                                  "moves": "stream_reply_p95_ms", "workloads": [name]})
    with open(path, "w") as f:
        json.dump(spec, f)
    return name


def run_tiny(root, workload, trace=False, prepare=None, seed=123456789012, seconds=0.3):
    """One CPU run of a cell of the tiny copy; returns (result, context)."""
    import time

    import torch

    from benchmark import harness

    box = {}

    def prep(ctx):
        box["ctx"] = ctx
        if prepare is not None:
            prepare(ctx)

    result = harness.run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                              time.perf_counter(), root=root, prepare=prep)
    return result, box["ctx"]
