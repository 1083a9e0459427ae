"""K1's launch plan (ops/lpc_cepstra.py::launch_plan) on the CPU.

The plan picks the kernel instantiation (lanes per row L, register chunk
C, rows per block) for a shape; the kernel itself runs only on the card
(chip_smoke.py holds it against its plain version there). These tests
hold the plan to the instantiations the CUDA source lists, for every
shape the recipes use and every order the instantiations reach.
"""

import glob
import json
import math
import os

import pytest

from speech_recognition_tools_tpu_torch import kernels
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
    MAX_SMEM_PER_BLOCK,
    launch_plan,
    smem_stride,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_shapes():
    shapes = set()
    for path in sorted(glob.glob(os.path.join(REPO, "recipes", "configs", "*.json"))):
        with open(path) as f:
            fe = json.load(f).get("frontend", {})
        if "order" in fe and "coeff_num" in fe:
            shapes.add((fe["order"], fe["coeff_num"]))
    return sorted(shapes)


# (order, lim) of the AR cases chip_smoke.py runs, the configs' chunk
# boundaries included
SMOKE_SHAPES = [(150, 100), (50, 50), (30, 40), (20, 1), (20, 2), (150, 450),
                (20, 60), (3, 10), (160, 60), (161, 60), (64, 60), (65, 60)]


def _check(order, lim, plan):
    lanes, chunks = kernels.instantiations()
    L, C, rows = plan
    assert L in lanes and C in chunks, plan
    assert L * C >= order and C >= math.ceil(order / L), plan
    assert (rows * L) % 32 == 0 and 32 <= rows * L <= 1024, plan
    assert rows * smem_stride(order, lim) * 4 <= MAX_SMEM_PER_BLOCK, plan


def test_source_lists_the_instantiations():
    lanes, chunks = kernels.instantiations()
    assert lanes == (1, 2, 4, 8, 16)
    assert chunks == tuple(sorted(chunks)) and len(chunks) >= 2


def test_config_shapes_are_found():
    shapes = _config_shapes()
    assert (150, 100) in shapes and (50, 50) in shapes and (150, 450) in shapes


@pytest.mark.parametrize("order,lim", sorted(set(_config_shapes()) | set(SMOKE_SHAPES)))
def test_plan_covers_config_and_smoke_shapes(order, lim):
    _check(order, lim, launch_plan(order, lim))


def test_plan_picks_the_measured_choice_at_the_config_shapes():
    """The choice the H100 sweep of chip_smoke.py fixed (PERF.md): 8 lanes
    at order 150, 4 at order 50, 128 threads a block."""
    assert launch_plan(150, 100) == (8, 20, 16)
    assert launch_plan(150, 450) == (8, 20, 16)
    assert launch_plan(50, 50) == (4, 16, 32)


@pytest.mark.parametrize("lim", [1, 2, 50, 100, 450])
def test_plan_covers_every_order_it_reaches(lim):
    """Every order up to the widest group's reach, with the smallest
    instantiated chunk that covers it."""
    lanes, chunks = kernels.instantiations()
    for order in range(1, lanes[-1] * chunks[-1] + 1):
        plan = launch_plan(order, lim)
        _check(order, lim, plan)
        L, C, _ = plan
        assert all(c >= C or L * c < order for c in chunks), (order, plan)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_plan_with_given_lanes(lanes):
    for order in (1, 20, 50, 150):
        _, chunks = kernels.instantiations()
        if lanes * chunks[-1] < order:
            with pytest.raises(ValueError):
                launch_plan(order, 100, lanes=lanes)
            continue
        for threads in (64, 128, 256):
            plan = launch_plan(order, 100, lanes=lanes, threads=threads)
            _check(order, 100, plan)
            assert plan[0] == lanes


def test_plan_raises_beyond_its_instantiations():
    lanes, chunks = kernels.instantiations()
    reach = lanes[-1] * chunks[-1]
    launch_plan(reach, 10)
    with pytest.raises(ValueError, match="exceeds"):
        launch_plan(reach + 1, 10)
    with pytest.raises(ValueError):
        launch_plan(150, 100, lanes=3)  # not instantiated
    with pytest.raises(ValueError):
        launch_plan(150, 100, lanes=8, threads=100)  # not whole warps
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(150, 100_000)  # one warp's row buffers do not fit
    with pytest.raises(ValueError):
        launch_plan(0, 10)
