"""Isolation: no module of JAX or of the JAX package is loaded by the
benchmark, compared by whole top-level names; the run refuses to print a
result without a card or without the program."""

import os
import re
import shutil
import subprocess
import sys
import types

from benchmark import harness
from conftest import ROOT

# every module of the benchmark and the port modules its drivers import
IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import benchmark.harness, benchmark.tracing, benchmark.common, benchmark.calibrate
import benchmark.sweep, benchmark.run
import benchmark.reference.fdlp, benchmark.reference.training
import benchmark.reference.transformer, benchmark.reference.precision
for kind in ("traffic", "metrics"):
    d = __import__("os").path.join({root!r}, "benchmark", kind)
    for f in sorted(__import__("os").listdir(d)):
        if f.endswith(".py"):
            benchmark.harness.load_module(kind, f[:-3])
import speech_recognition_tools_tpu_torch.cli.serve
import speech_recognition_tools_tpu_torch.cli.train_am
import speech_recognition_tools_tpu_torch.cli.train_e2e
import speech_recognition_tools_tpu_torch.cli.common
import speech_recognition_tools_tpu_torch.decode.beam_jit
import speech_recognition_tools_tpu_torch.dsp.fdlp
import speech_recognition_tools_tpu_torch.dsp.streaming
print("forbidden:" + ",".join(benchmark.harness.forbidden_modules()))
"""


def test_whole_top_level_names(monkeypatch):
    for name in ("speech_recognition_tools_tpu_torch.x", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "speech_recognition_tools_tpu.ops",
                        types.ModuleType("speech_recognition_tools_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "speech_recognition_tools_tpu"]


def test_nothing_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(root=ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_no_source_reads_the_jax_side_or_the_smoke_script():
    imports = re.compile(r"^\s*(import|from)\s+(chip_smoke|jax|jaxlib|flax|"
                         r"speech_recognition_tools_tpu)(\s|\.|$)")
    files = ("bench_captures", "BENCH_r0", "__graft_entry__", "bench.py")
    for base, _, names in os.walk(os.path.join(ROOT, "benchmark")):
        for f in names:
            if f.endswith(".py") and f != os.path.basename(__file__):
                with open(os.path.join(base, f)) as fh:
                    for line in fh:
                        assert not imports.match(line), (f, line)
                        assert not any(w in line for w in files), (f, line)


def test_no_result_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # the look for a card is what this checks; on the chip it passes
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wsj_fdlp_e2e.decode", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, BENCH_RUN="x"))
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    fails before any result (the look for a card skipped)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.'); from benchmark import harness; "
            "print(harness.run_cell('wsj_fdlp_e2e.featgen', 1, 0.1, False, "
            "torch.device('cpu'), time.perf_counter()))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and "ModuleNotFoundError" in out.stderr
    assert out.stdout.strip() == ""
