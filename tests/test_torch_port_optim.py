"""The port's adadelta, sgd, adagrad and rmsprop (train/optim.py::ClipRule)
held against optax as the JAX trainer builds them: optax.inject_hyperparams
around make_optimizer(name, lr, clip), with and without the global-norm
clip.

Parameters and gradients are float64 on both sides (the conftest's x64),
so the comparison is of the arithmetic, not of float32 rounding. Limits:
parameters after 5 steps within 1e-6 relative of optax's (the injected rate
is float32 in the port and float64 under x64 in JAX: ~1e-8 apart), the
state tree in optax's layout leaf for leaf within 1e-6 relative, and a
state restored from optax's tree continuing as optax does.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tools_tpu.train.optim import make_optimizer as jmake
from speech_recognition_tools_tpu_torch.io.jax_params import (
    optim_state_from_jax,
    optim_state_to_jax,
)
from speech_recognition_tools_tpu_torch.train.optim import ClipRule, make_optimizer

NAMES = ["adadelta", "sgd", "adagrad", "rmsprop"]
LR = 0.05
REL = 1e-6
SHAPES = {"a": (4, 3), "b": (5,)}


def _grads(rs, scale):
    return {k: rs.randn(*s) * scale for k, s in SHAPES.items()}


def _np_tree(d):
    return {k: v.numpy() for k, v in d.items()}


def _t_tree(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _close(got, want):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.abs(g - w).max() <= REL * max(np.abs(w).max(), 1e-12), k


def _run(name, clip, steps, seed=0, scale=3.0):
    """(optax params, optax state, port params, port state, optimizer)
    after `steps` updates from the same start and gradients; scale 3
    puts the global norm above a clip of 1."""
    rs = np.random.RandomState(seed)
    start = {k: rs.randn(*s) for k, s in SHAPES.items()}
    tx = optax.inject_hyperparams(lambda learning_rate: jmake(name, learning_rate, clip))(
        learning_rate=LR)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jst = tx.init(jp)
    opt = make_optimizer(name, LR, clip)
    tp = _t_tree(start)
    tst = opt.init(tp)
    for _ in range(steps):
        g = _grads(rs, scale)
        u, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, u)
        tst, _ = opt.apply(tp, _t_tree(g), tst)
    return tx, jp, jst, tp, tst, opt


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", NAMES)
def test_five_steps_match_optax(name, clip):
    _, jp, jst, tp, tst, opt = _run(name, clip, 5)
    assert isinstance(opt, ClipRule) and tst["count"] == 5
    _close(_np_tree(tp), jp)
    tree = optim_state_to_jax(tst, _np_tree, name=name, clip=clip is not None)
    want = flax.serialization.to_state_dict(jst)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= REL * max(
            np.abs(np.asarray(w)).max(), 1e-12)


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", NAMES)
def test_state_resumes_from_optax_layout(name, clip):
    """Two steps in optax, its state written as flax writes it, read by
    optim_state_from_jax, then three more steps on both sides."""
    tx, jp, jst, _, _, opt = _run(name, clip, 2)
    tree = flax.serialization.to_state_dict(jst)
    tst = optim_state_from_jax(tree, _t_tree, name=name, clip=clip is not None)
    assert tst["count"] == 2 and tst["learning_rate"] == np.float32(LR)
    tp = _t_tree({k: np.asarray(v) for k, v in jp.items()})
    rs = np.random.RandomState(1)
    for _ in range(3):
        g = _grads(rs, 0.5)
        u, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, u)
        tst, _ = opt.apply(tp, _t_tree(g), tst)
    _close(_np_tree(tp), jp)
    back = optim_state_from_jax(optim_state_to_jax(tst, _np_tree, name=name,
                                                   clip=clip is not None),
                                _t_tree, name=name, clip=clip is not None)
    assert back["count"] == tst["count"] and back["learning_rate"] == tst["learning_rate"]
    for slot in (k for k, v in tst.items() if isinstance(v, dict)):
        assert all(torch.equal(back[slot][k], tst[slot][k]) for k in SHAPES)


def test_defaults_are_optax_not_torch():
    """Adagrad's accumulator starts at optax's 0.1 (torch: 0); the first
    rmsprop step divides by sqrt(0.1 g^2 + 1e-8) (torch: 0.01 g^2 and eps
    outside the root); an unknown name raises ValueError."""
    p = {"x": torch.tensor([2.0], dtype=torch.float64)}
    opt = make_optimizer("adagrad", 1.0, None)
    st = opt.init(p)
    assert st["sum_of_squares"]["x"].item() == pytest.approx(0.1)
    opt.apply(p, {"x": torch.tensor([1.0], dtype=torch.float64)}, st)
    assert p["x"].item() == pytest.approx(2.0 - np.float32(1.0) / np.sqrt(1.1 + 1e-7))
    p = {"x": torch.tensor([0.0], dtype=torch.float64)}
    opt = make_optimizer("rmsprop", 1.0, None)
    opt.apply(p, {"x": torch.tensor([1.0], dtype=torch.float64)}, opt.init(p))
    assert p["x"].item() == pytest.approx(-1.0 / np.sqrt(0.1 + 1e-8))
    with pytest.raises(ValueError):
        make_optimizer("lamb", 1e-3)
