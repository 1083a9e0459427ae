"""The correctness control at a size a test run holds: the plain reference
computed in TF32 (the precision below the configurations' float32 with
TF32 off) put in the program's place makes the run's own check come out
not correct, at the configurations' own widths (only the traffic is cut);
for training, so does half of each batch left out. The program's own
readings of the same runs pass."""

import pytest

from conftest import CELL_FILES, make_tiny_root, run_tiny


@pytest.fixture(scope="module")
def real_widths_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("control")), real_widths=True)


@pytest.mark.parametrize("cell", CELL_FILES)
def test_control_fails_a_limit(real_widths_root, cell):
    result, ctx = run_tiny(real_widths_root, cell,
                           prepare=lambda c: c.facts.update(control=True), seconds=1.0)
    limits = ctx.cell["limits"]
    assert not result["correct"], result["checks"]
    control = ctx.facts["control_readings"]
    assert all(result["checks"][k]["value"] == v for k, v in control.items() if k in limits)
    program = ctx.facts["readings"]
    assert all(program[k] <= lim for k, lim in limits.items() if k in program), program
    for fault in ctx.facts.get("fault_readings", {}).values():
        assert any(fault[k] > limits[k] for k in fault if k in limits), (fault, limits)
