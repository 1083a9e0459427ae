"""The benchmark's core: one cell, one run.

`run_cell` finds everything by name: the cell's file
`workloads/<cell>.json`, its configuration `configs/<config>.json`, its
traffic driver `traffic/<kind>.py` and the per-layer readers
`metrics/<metric>.py` that BENCHMARK.json lists for the cell. A driver
module has three functions:

    setup(ctx) -> state        build the program's objects and inputs from
                               the seed, warm up every shape the window uses
    window(ctx, state) -> dict run for ctx.seconds; returns the cell's
                               end-to-end values under "metrics" and the
                               counts "attempted" and "failed"
    check(ctx, state) -> list  free the program's state, run the plain
                               reference, return [(name, value, limit)]

A reader module has `read(run) -> float | None`, where `run` is the
`Run` below: spans, the facts the driver recorded (counts the program
keeps among them), the trace summary. A reader that finds nothing to read returns None and the metric
is left out of the line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# compared with each loaded module's top-level name, whole: the port's
# package name begins with the JAX package's and must not match it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "speech_recognition_tools_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(kind: str, name: str, root: str = ROOT):
    """benchmark/<kind>/<name>.py of the checkout at `root` as a module
    (names may hold dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    mod_name = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    mod_name += "_" + str(abs(hash(path)))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[mod_name] = module
    module_spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict]:
    """(cell, configuration) of the workload `name`."""
    bench = os.path.join(root, "benchmark")
    cell = load_json(os.path.join(bench, "workloads", name + ".json"))
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {cell.get('name')!r}")
    config = load_json(os.path.join(bench, "configs", cell["config"] + ".json"))
    return cell, config


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Recorder:
    """Spans (seconds, by name) recorded from the benchmark's own files
    around calls into the program, in the measured window only: set-up's
    warm-up calls and the check are not recorded. A span that ends while
    the profiler traces the window's first units goes to `traced`, the
    others to `spans`, so that a reader can leave out the profiler's cost.
    With `sync` every span synchronises the device at both ends (the
    traced run only), so that a span is the device work it enqueued and
    not only its launch."""

    def __init__(self, sync: bool = False, device=None):
        self.sync = sync and device is not None and device.type == "cuda"
        self.spans: dict[str, list[float]] = {}
        self.traced: dict[str, list[float]] = {}
        self.recording = False
        self.tracer = None

    def open(self, tracer=None):
        self.recording, self.tracer = True, tracer

    def close(self):
        self.recording = False

    def _synchronize(self):
        if self.sync:
            import torch

            torch.cuda.synchronize()

    @contextmanager
    def span(self, name: str):
        if not self.recording:
            yield
            return
        self._synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._synchronize()
            traced = self.tracer is not None and self.tracer.active
            into = self.traced if traced else self.spans
            into.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Run:
    """What a per-layer reader reads: `spans` of the window's units after
    the first `traced_units`, which the profiler traced (see Recorder)."""

    cell: dict
    config: dict
    spans: dict
    facts: dict
    trace: dict | None
    window_s: float
    traced_units: int = 0


@dataclass
class Context:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    rec: Recorder
    tracer: object
    facts: dict = field(default_factory=dict)

    @property
    def params(self) -> dict:
        return self.cell["params"]


def cuda_sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: str = ROOT, prepare=None) -> dict:
    """One run of one cell: set-up, window, isolation check, reference
    check. Returns the result line's object; raises on a fault of the
    run (an isolation breach included)."""
    import torch

    from benchmark.tracing import Tracer

    bench = spec(root)
    cell, config = load_cell(workload, root)
    traffic = load_module("traffic", cell["traffic"], root)
    rec = Recorder(sync=trace, device=device)
    tracer = Tracer(device, cell.get("trace_units", 1)) if trace else None
    ctx = Context(cell=cell, config=config, seed=seed, seconds=seconds, trace=trace,
                  device=device, rec=rec, tracer=tracer)
    # tests plant faults here, or ask for the control (ctx.facts["control"]):
    # the plain reference computed in the precision below the
    # configuration's, whose readings then stand in for the program's
    if prepare is not None:
        prepare(ctx)
    state = traffic.setup(ctx)
    cuda_sync(device)
    setup_s = time.perf_counter() - t_start
    if tracer is not None:
        tracer.start()
    rec.open(tracer)
    t0 = time.perf_counter()
    out = traffic.window(ctx, state)
    cuda_sync(device)
    window_s = time.perf_counter() - t0
    rec.close()
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise IsolationError(found)
    t_check = time.perf_counter()
    checks = traffic.check(ctx, state)
    del state
    if ctx.facts.get("control"):  # the control's outputs judged in the program's place
        control = ctx.facts["control_readings"]
        checks = [(name, control.get(name, v), lim) for name, v, lim in checks]
    print(f"benchmark: set-up {setup_s:.3f} s, window {window_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s; facts "
          + json.dumps({k: v for k, v in ctx.facts.items()
                      if k.endswith("_s") or k in ("steps", "passes")}),
          file=sys.stderr)

    metrics = {}
    if trace:
        run = Run(cell=cell, config=config, spans=rec.spans, facts=ctx.facts,
                  trace=tracer.summary() if tracer else None,
                  window_s=window_s, traced_units=tracer.done if tracer else 0)
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            value = load_module("metrics", m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if not applies(m, workload):
                continue
            if m["name"] not in values:
                raise KeyError(f"traffic {cell['traffic']!r} reports no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device_info}
    if trace and tracer is not None:
        summary = tracer.summary()
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": float(v), "limit": float(lim)}
                        for name, v, lim in checks}
    return result


class IsolationError(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded modules outside the port: " + ", ".join(found))
        self.found = found
