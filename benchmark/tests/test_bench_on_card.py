"""On the card (marked `card`; skipped without one): each cell's run as the
checks run it, briefly, prints a correct result; and the control, the
plain reference in TF32 judged in the program's place, makes the run not
correct at each cell's own size.

    python3 -m pytest benchmark/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "20260101", "--seconds", "10", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell,
                          "--seconds", "15", "--seeds", "20260102"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "benchmark", "workloads", cell + ".json")) as f:
        limits = json.load(f)["limits"]
    assert line["program_correct"] and not line["correct"]
    assert any(v > limits[k] for k, v in line["control"].items() if k in limits)
