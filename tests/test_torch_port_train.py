"""The port's training half of the hybrid slice held against the JAX
package: masked losses, the optax-arithmetic Adam with global-norm
clipping, the flax msgpack codec, checkpoints both ways, egs directories
both ways, the LR-halve-and-revert trainer, flax-distribution
initialisation, and the train_am CLI.

Both sides get the same numpy inputs and, where a model is involved, the
same weights (carried over by io/jax_params.py). The JAX side runs on the
CPU with the conftest's x64; the port runs on the CPU.
"""

import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tools_tpu import models as jmodels
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu.train import losses as jlosses
from speech_recognition_tools_tpu.train import trainer as jtrainer
from speech_recognition_tools_tpu_torch.cli import train_am
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io import flax_msgpack
from speech_recognition_tools_tpu_torch.io.jax_params import (
    adam_state_from_jax,
    adam_state_to_jax,
    rnn_classifier_from_jax,
    rnn_classifier_to_jax,
)
from speech_recognition_tools_tpu_torch.models.recurrent import RNNClassifier
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt
from speech_recognition_tools_tpu_torch.train import losses as tlosses
from speech_recognition_tools_tpu_torch.train.optim import ClipAdam, make_optimizer
from speech_recognition_tools_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

D, LAYERS, HIDDEN, CLASSES = 6, 2, 32, 10
LENGTHS = np.array([13, 7, 10], np.int32)


def _jax_rnn(seed=0, dropout=0.0):
    model = jmodels.RNNClassifier(num_layers=LAYERS, hidden_size=HIDDEN, out_size=CLASSES,
                                  dropout=dropout)
    params = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, 4, D), jnp.float32),
                        jnp.asarray([4]))
    return model, jax.tree.map(np.asarray, params)


def _port_rnn(params, dropout=0.0):
    m = RNNClassifier(D, LAYERS, HIDDEN, CLASSES, dropout, device="cpu")
    m.load_state_dict(rnn_classifier_from_jax(params))
    return m


def _tree_close(got, want, rtol=0.0, atol=0.0, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, (path, k, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{path}/{k}")


def _batch(seed=0, B=3, T=13):
    rs = np.random.RandomState(seed)
    return {"feats": rs.randn(B, T, D).astype(np.float32),
            "lengths": LENGTHS[:B].copy(),
            "labels": rs.randint(0, CLASSES, (B, T)).astype(np.int32)}


# ------------------------------------------------------------------ msgpack


def test_msgpack_codec_matches_flax_bytes():
    """packb writes the bytes flax.serialization.to_bytes writes (same key
    order); each side decodes the other's bytes to the same tree."""
    rs = np.random.RandomState(0)
    tree = {
        "params": {"a": {"kernel": rs.randn(3, 4).astype(np.float32),
                         "bias": np.zeros(4, np.float32)},
                   "b" * 40: {"big": rs.randn(70000).astype(np.float32)}},
        "opt_state": {"0": {}, "1": {"0": {"count": np.asarray(3, np.int32),
                                           "mu": {"z": np.arange(300, dtype=np.int64)}},
                                     "1": {"count": np.asarray(-5, np.int32)}}},
        "lr": np.asarray(1e-3, np.float32), "h": np.ones((2, 1), np.float16),
    }
    flax_bytes = flax.serialization.to_bytes(tree)
    assert flax_msgpack.packb(tree) == flax_bytes
    _tree_close(flax_msgpack.unpackb(flax_bytes), tree)
    _tree_close(flax.serialization.msgpack_restore(flax_msgpack.packb(tree)), tree)
    for bad in (flax_bytes[:-1], flax_bytes + b"\x00"):
        with pytest.raises(ValueError):
            flax_msgpack.unpackb(bad)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("name", ["masked_cross_entropy", "masked_frame_error",
                                  "masked_mse", "masked_l1"])
def test_losses_match_jax(name):
    """f64 values at rtol 1e-12; the CE's gradient too."""
    rs = np.random.RandomState(1)
    B, T = 3, 13
    if name in ("masked_cross_entropy", "masked_frame_error"):
        a, b = rs.randn(B, T, CLASSES), rs.randint(0, CLASSES, (B, T)).astype(np.int32)
    else:
        a, b = rs.randn(B, T, 5), rs.randn(B, T, 5)
    jf, tf = getattr(jlosses, name), getattr(tlosses, name)
    want = float(jf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(LENGTHS)))
    ta = torch.tensor(a, requires_grad=True)
    got = tf(ta, torch.as_tensor(b), torch.as_tensor(LENGTHS))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-12)
    if name == "masked_cross_entropy":
        got.backward()
        jg = jax.grad(lambda x: jf(x, jnp.asarray(b), jnp.asarray(LENGTHS)))(jnp.asarray(a))
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-14)


# ------------------------------------------------------------------ optimizer


def _grads(rs, shapes, scale=1.0):
    return {k: (scale * rs.randn(*s)).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (4, 3), "b": (3,)}


def _optax_run(tx, params, grads_seq):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    for g in grads_seq:
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, u)
    return jax.tree.map(np.asarray, p), st


def _port_run(opt, params, grads_seq):
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init(p)
    for g in grads_seq:
        st, _ = opt.apply(p, {k: torch.tensor(v) for k, v in g.items()}, st)
    return {k: v.numpy() for k, v in p.items()}, st


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("schedule", [False, True])
def test_adam_updates_match_optax(steps, schedule):
    """chain(clip_by_global_norm(1), adam) after 1 and 3 updates, float32,
    with a fixed rate (the trainer's inject_hyperparams form) and with a
    short-warmup Noam schedule whose rates differ every step; params at
    rtol 1e-6, and the state in optax's layout."""
    from speech_recognition_tools_tpu.models.transformer_asr import noam_schedule as jnoam
    from speech_recognition_tools_tpu_torch.models.transformer_asr import noam_schedule

    rs = np.random.RandomState(2)
    params = _grads(rs, SHAPES)
    grads = [_grads(rs, SHAPES, scale=0.4) for _ in range(steps)]
    if schedule:
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adam(jnoam(32, warmup=3, factor=1.0), b2=0.98))
        opt = ClipAdam(noam_schedule(32, warmup=3, factor=1.0), 1.0, b2=0.98)
    else:
        tx = optax.inject_hyperparams(
            lambda learning_rate: jtrainer.make_optimizer("adam", learning_rate, 1.0)
        )(learning_rate=1e-2)
        opt = make_optimizer("adam", 1e-2, 1.0)
    want_p, want_st = _optax_run(tx, params, grads)
    got_p, got_st = _port_run(opt, params, grads)
    _tree_close(got_p, want_p, rtol=1e-6, atol=1e-7)
    got_tree = adam_state_to_jax(got_st, lambda d: {k: v.numpy() for k, v in d.items()},
                                 clip=True)
    _tree_close(got_tree, flax.serialization.to_state_dict(want_st), rtol=1e-6, atol=1e-9)
    back = adam_state_from_jax(got_tree, lambda d: {k: torch.tensor(v) for k, v in d.items()},
                               clip=True)
    assert back["count"] == steps and ("learning_rate" in back) == (not schedule)


@pytest.mark.parametrize("ratio", [1 - 1e-3, 1 + 1e-3, 10.0])
def test_clip_boundary_matches_optax(ratio):
    """Just below the threshold the gradients pass unchanged; at and above
    it they become (g / |g|) * clip, as optax clips (not torch's
    clip / (|g| + 1e-6))."""
    rs = np.random.RandomState(3)
    g = _grads(rs, SHAPES)
    n = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
    g = {k: (v / n * ratio).astype(np.float32) for k, v in g.items()}
    params = {k: np.zeros_like(v) for k, v in g.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(1.0))
    want, _ = _optax_run(tx, params, [g])
    opt = ClipAdam(1.0, 1.0)
    tg = [torch.tensor(v) for v in g.values()]
    norm = opt.global_norm(tg).item()
    clipped = (tg if norm < 1.0 else
               torch._foreach_mul(torch._foreach_div(tg, norm), 1.0))
    for k, c in zip(g, clipped):
        np.testing.assert_allclose(c.numpy(), -want[k], rtol=1e-6, atol=0)
    if ratio < 1:
        assert all(np.array_equal(c.numpy(), v) for c, v in zip(clipped, g.values()))


def test_schedule_first_three_rates_lag_one_step():
    """The k-th update uses noam(max(k - 1, 1)): with a constant gradient
    of 1, Adam's update is 1 / (1 + eps) every step, so each step moves a
    parameter by exactly the rate it used. Same moves as optax."""
    from speech_recognition_tools_tpu.models.transformer_asr import noam_schedule as jnoam
    from speech_recognition_tools_tpu_torch.models.transformer_asr import noam_schedule

    sched = noam_schedule(16, warmup=3, factor=2.0)
    for s in range(5):
        np.testing.assert_allclose(sched(s), float(jnoam(16, 3, 2.0)(s)), rtol=1e-12)
    one = {"x": np.ones(1, np.float32)}
    opt = ClipAdam(sched, None, b2=0.98)
    p = {"x": torch.zeros(1)}
    st = opt.init(p)
    tx = optax.adam(jnoam(16, 3, 2.0), b2=0.98)
    jp = {"x": jnp.zeros(1, jnp.float32)}
    jst = tx.init(jp)
    for k in (1, 2, 3):
        before = p["x"].item()
        st, _ = opt.apply(p, {"x": torch.ones(1)}, st)
        moved = before - p["x"].item()
        np.testing.assert_allclose(moved, sched(max(k - 1, 1)) / (1 + 1e-8), rtol=2e-7)
        u, jst = tx.update({"x": jnp.asarray(one["x"])}, jst, jp)
        jp = optax.apply_updates(jp, u)
        np.testing.assert_allclose(p["x"].numpy(), np.asarray(jp["x"]), rtol=1e-6)


def test_other_optimizers_raise():
    """The JAX package's other four optimizers are ported
    (tests/test_torch_port_optim.py holds them to optax); a name neither
    package knows raises ValueError."""
    for name in ("adadelta", "sgd", "adagrad", "rmsprop"):
        assert make_optimizer(name, 1e-3).name == name
    with pytest.raises(ValueError):
        make_optimizer("lamb", 1e-3)


# ------------------------------------------------------------------ weights


def test_rnn_converters_are_exact_inverses():
    _, params = _jax_rnn()
    tree = rnn_classifier_to_jax(rnn_classifier_from_jax(params))
    _tree_close(tree, params)
    sd = _port_rnn(params).state_dict()
    back = rnn_classifier_from_jax(rnn_classifier_to_jax(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_rnn_init_std_matches_flax():
    """Each leaf's standard deviation within 10% of flax's init (zero
    leaves zero); D = 40, H = 64, 100 classes."""
    model = jmodels.RNNClassifier(num_layers=2, hidden_size=64, out_size=100)
    fl = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 4, 40), jnp.float32),
                    jnp.asarray([4]))
    m = RNNClassifier(40, 2, 64, 100, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    got = rnn_classifier_to_jax(m.state_dict())
    flat_w = {"/".join(k): v for k, v in _flat(jax.tree.map(np.asarray, fl)).items()}
    flat_g = {"/".join(k): v for k, v in _flat(got).items()}
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        sw, sg = float(np.std(w)), float(np.std(flat_g[k]))
        if sw == 0:
            assert sg == 0, k
        else:
            assert abs(sg / sw - 1) < 0.1, (k, sg, sw)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_gru_train_mode_at_dropout_zero_equals_eval():
    _, params = _jax_rnn()
    b = _batch()
    x, n = torch.as_tensor(b["feats"]), torch.as_tensor(b["lengths"])
    m = _port_rnn(params, dropout=0.0)
    with torch.no_grad():
        assert torch.equal(m.train()(x, n), m.eval()(x, n))
        drop = _port_rnn(params, dropout=0.5)
        assert not torch.equal(drop.train()(x, n), drop.eval()(x, n))
        assert torch.equal(drop.eval()(x, n), m.eval()(x, n))


# ------------------------------------------------------------------ checkpoints


def _jax_trainer_state(params, batches, lr=1e-2):
    model = jmodels.RNNClassifier(num_layers=LAYERS, hidden_size=HIDDEN, out_size=CLASSES)

    def loss_fn(p, batch, rng, train):
        logits = model.apply(p, batch["feats"], batch["lengths"])
        return jlosses.masked_cross_entropy(logits, batch["labels"], batch["lengths"]), {}

    tr = jtrainer.Trainer(loss_fn, jtrainer.TrainConfig(learning_rate=lr))
    st = tr.init_state(jax.tree.map(jnp.asarray, params))
    for b in batches:
        st.params, st.opt_state, _, _ = tr._train_step(
            st.params, st.opt_state, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.key(0))
    return tr, st


def _port_trainer_state(params, batches, lr=1e-2):
    m = _port_rnn(params)
    tr = Trainer(m, train_am.make_loss(train_am.get_parser().parse_args(["e", "s"])),
                 TrainConfig(learning_rate=lr))
    st = tr.init_state()
    for b in batches:
        tr.train_step(st, {k: torch.as_tensor(v) for k, v in b.items()})
    return m, tr, st


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Two trainer steps on both sides; the port saves params + opt_state
    and the JAX load_checkpoint(template=...) restores them: every leaf
    equal to the port's, close to JAX's own (rtol 1e-5), and the JAX
    model applies the restored params to the port's logits (atol 1e-5)."""
    _, params = _jax_rnn()
    batches = [_batch(s) for s in (10, 11)]
    _, st_j = _jax_trainer_state(params, batches)
    m, tr, st = _port_trainer_state(params, batches)
    p_tree = rnn_classifier_to_jax(st.params)
    o_tree = adam_state_to_jax(st.opt_state, rnn_classifier_to_jax, clip=True)
    path = tckpt.save_checkpoint(str(tmp_path), "epoch_2", p_tree, {"model_class": "RNNClassifier"},
                                 opt_state=o_tree, extra={"epoch": 2})
    payload, cfg = jckpt.load_checkpoint(path, template={"params": st_j.params,
                                                         "opt_state": st_j.opt_state})
    assert cfg["extra"]["epoch"] == 2
    _tree_close(jax.tree.map(np.asarray, payload["params"]), p_tree)
    restored_opt = flax.serialization.to_state_dict(payload["opt_state"])
    _tree_close(restored_opt, o_tree)
    _tree_close(restored_opt, flax.serialization.to_state_dict(st_j.opt_state),
                rtol=1e-5, atol=1e-8)
    _tree_close(p_tree, jax.tree.map(np.asarray, st_j.params), rtol=1e-5, atol=1e-6)
    b = _batch(12)
    jmodel = jmodels.RNNClassifier(num_layers=LAYERS, hidden_size=HIDDEN, out_size=CLASSES)
    want = np.asarray(jmodel.apply(payload["params"], b["feats"], b["lengths"]))
    with torch.no_grad():
        got = m.eval()(torch.as_tensor(b["feats"]), torch.as_tensor(b["lengths"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A checkpoint the JAX trainer state writes loads through the port's
    load_checkpoint and converters: params and moments bit for bit, count
    and learning rate; load_checkpoint refuses a mismatched template."""
    _, params = _jax_rnn()
    _, st_j = _jax_trainer_state(params, [_batch(10)])
    path = jckpt.save_checkpoint(str(tmp_path), "epoch_1", st_j.params, {"a": 1},
                                 opt_state=st_j.opt_state, extra={"epoch": 1})
    m, tr, st = _port_trainer_state(params, [])
    template = {"params": rnn_classifier_to_jax(st.params),
                "opt_state": adam_state_to_jax(st.opt_state, rnn_classifier_to_jax, clip=True)}
    payload, cfg = tckpt.load_checkpoint(path, template=template)
    assert cfg == {"a": 1, "extra": {"epoch": 1}}
    sd = rnn_classifier_from_jax(payload["params"])
    _tree_close({k: v.numpy() for k, v in sd.items()},
                {k: v.numpy() for k, v in rnn_classifier_from_jax(
                    jax.tree.map(np.asarray, st_j.params)).items()})
    opt = adam_state_from_jax(payload["opt_state"], rnn_classifier_from_jax, clip=True)
    assert opt["count"] == 1 and opt["learning_rate"] == np.float32(1e-2)
    mu_j = rnn_classifier_from_jax(jax.tree.map(
        np.asarray, st_j.opt_state.inner_state[1][0].mu))
    assert all(torch.equal(opt["mu"][k], mu_j[k]) for k in mu_j)
    assert tckpt.load_checkpoint(path)[0].keys() == {"params", "opt_state"}
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, template={"other": {}})
    bad = {"params": rnn_classifier_to_jax(RNNClassifier(D, LAYERS, HIDDEN + 1, CLASSES,
                                                          device="cpu").state_dict())}
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, template=bad)


# ------------------------------------------------------------------ egs


def _utts(seed=4, n=7):
    rs = np.random.RandomState(seed)
    lens = rs.randint(5, 40, n)
    return [(f"u{i}", rs.randn(t, D).astype(np.float32), rs.randint(0, CLASSES, t))
            for i, t in enumerate(lens)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_egs_round_trip(tmp_path, writer):
    """An egs dir built by either package loads in the other: the same
    config, utterances and bucketed batches (stable sort, shuffled batch
    order, padded to multiples of 8)."""
    utts = _utts()
    feats = [(k, f) for k, f, _ in utts]
    labels = {k: lab for k, _, lab in utts if k != "u3"}
    mean, std = np.zeros(D), np.ones(D) * 2
    build = jegs.build_egs if writer == "jax" else tegs.build_egs
    build(iter(feats), str(tmp_path), labels, cmvn=(mean, std), shard_size=3,
          num_targets=CLASSES)
    jcfg, jutts = jegs.load_egs(str(tmp_path))
    tcfg, tutts = tegs.load_egs(str(tmp_path))
    assert jcfg.__dict__ == tcfg.__dict__ and tcfg.extra == {"num_utts": 6}
    assert [u[0] for u in jutts] == [u[0] for u in tutts]
    for (_, jf, jl), (_, tf, tl) in zip(jutts, tutts):
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tl, jl)
    jb = list(jegs.iter_egs_batches(str(tmp_path), 2, bucket_multiple=8, shuffle_seed=1))
    tb = list(tegs.iter_egs_batches(str(tmp_path), 2, bucket_multiple=8, shuffle_seed=1))
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys() and a["keys"] == b["keys"]
        for k in ("feats", "lengths", "labels"):
            np.testing.assert_array_equal(b[k], a[k])


# ------------------------------------------------------------------ trainer


def test_trainer_revert_keeps_moments_like_jax():
    """Three epochs with a dev set labelled with the one class the training
    set never has, so the dev loss regresses: each side reverts the weights to the best
    epoch and halves the rate at the same epochs, the moments are not
    reverted, and losses, weights and moments agree to rtol 1e-6. The model
    is a per-frame Dense classifier in float64 on both sides (the JAX GRU
    keeps a float32 carry): in float32, Adam's first updates of near-zero
    gradient entries amplify rounding (lr * err / eps) past any useful
    bound."""
    from flax import linen as fnn

    rs = np.random.RandomState(20)
    train = {"feats": rs.randn(3, 13, D), "lengths": LENGTHS.copy(),
             "labels": rs.randint(1, CLASSES, (3, 13)).astype(np.int32)}
    dev = dict(train, labels=np.zeros_like(train["labels"]))
    cfg = dict(learning_rate=0.05, epochs=3, lrr=0.5)
    jmodel = fnn.Dense(CLASSES, param_dtype=jnp.float64)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jnp.zeros((1, D))))

    def jloss(p, batch, rng, train_):
        return jlosses.masked_cross_entropy(jmodel.apply(p, batch["feats"]), batch["labels"],
                                            batch["lengths"]), {}

    jtr = jtrainer.Trainer(jloss, jtrainer.TrainConfig(**cfg))
    jst = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jlog = []
    as_j = [{k: jnp.asarray(v) for k, v in b.items()} for b in (train, dev)]
    jtr.fit(jst, lambda: iter(as_j[:1]), lambda: iter(as_j[1:]), log_fn=jlog.append)

    def to_jax(sd):
        return {"params": {"kernel": _np(sd["weight"]).T, "bias": _np(sd["bias"])}}

    m = torch.nn.Linear(D, CLASSES, dtype=torch.float64)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(params["params"]["kernel"].T))
        m.bias.copy_(torch.tensor(params["params"]["bias"]))

    def tloss(model, batch, train_):
        return tlosses.masked_cross_entropy(model(batch["feats"]), batch["labels"],
                                            batch["lengths"]), {}

    tr = Trainer(m, tloss, TrainConfig(**cfg))
    st = tr.init_state()
    tlog = []
    as_t = [{k: torch.as_tensor(v) for k, v in b.items()} for b in (train, dev)]
    tr.fit(st, lambda: iter(as_t[:1]), lambda: iter(as_t[1:]), log_fn=tlog.append)

    assert [("regressed" in s) for s in tlog] == [("regressed" in s) for s in jlog]
    assert any("regressed" in s for s in tlog), tlog
    assert st.lr == jst.lr < cfg["learning_rate"]
    for a, b in zip(st.history, jst.history):
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["dev_loss"], b["dev_loss"], rtol=1e-6)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-6)
    _tree_close(to_jax(st.params), jax.tree.map(np.asarray, jst.params), rtol=1e-6, atol=1e-12)
    # the live weights are the best snapshot; the moments moved on
    assert all(torch.equal(p.detach(), st.best_params[k]) for k, p in st.params.items())
    assert st.opt_state["count"] == 3 and st.opt_state["learning_rate"] == np.float32(st.lr)
    _tree_close(adam_state_to_jax(st.opt_state, to_jax, clip=True),
                jax.tree.map(np.asarray, flax.serialization.to_state_dict(jst.opt_state)),
                rtol=1e-6, atol=1e-15)


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------ CLI


def test_train_am_main_on_a_tiny_egs_dir(tmp_path):
    """train_am.main --arch rnn on the CPU: per-epoch and final checkpoints
    the JAX load_checkpoint restores, finite losses, resume from the newest
    epoch; the unported flags raise (every arch is ported: the conv half's
    in tests/test_torch_port_conv_zoo.py)."""
    utts = _utts(n=9)
    egs = str(tmp_path / "egs")
    tegs.build_egs(iter((k, f) for k, f, _ in utts), egs, {k: lab for k, _, lab in utts},
                   num_targets=CLASSES)
    store = str(tmp_path / "am")
    argv = [egs, store, "--arch", "rnn", "--num_layers", "2", "--hidden_dim", "16",
            "--batch_size", "4", "--device", "cpu"]
    st = train_am.main(argv + ["--epochs", "2"])
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "final"]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["dev_loss"])
               for h in st.history)
    jmodel = jmodels.RNNClassifier(num_layers=2, hidden_size=16, out_size=CLASSES)
    template = jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 4, D), jnp.float32),
                           jnp.asarray([4]))
    payload, cfg = jckpt.load_checkpoint(os.path.join(store, "final"),
                                         template={"params": template})
    assert cfg["model_class"] == "RNNClassifier" and cfg["num_classes"] == CLASSES
    assert cfg["feature_dim"] == D and len(cfg["extra"]["history"]) == 2
    shutil.rmtree(os.path.join(store, "final"))  # as after an interrupted run
    st3 = train_am.main(argv + ["--epochs", "3"])
    assert st3.epoch == 3 and len(st3.history) == 1
    assert os.path.isdir(os.path.join(store, "epoch_3"))
    for bad in (["--data_parallel"], ["--expert_parallel", "2"]):
        with pytest.raises(NotImplementedError):
            train_am.main(argv + ["--epochs", "4"] + bad)
