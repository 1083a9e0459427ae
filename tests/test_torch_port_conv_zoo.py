"""The conv half of the port's model zoo held against the JAX package:
models/cnn.py and models/modnet.py class by class, the argmax pool and
its unpool, train_am's patch extraction, train_am.main and dump_outputs
for the seven conv archs, and dump_outputs on the conv families the
checkpoint importer writes.

Modules get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise so that every bias is nonzero, carried over by
io/jax_params.py::zoo_from_jax) and, where they sample, the same noise:
the JAX module is called with `rng=key`, the port with the normals (VAE
latents) or uniforms (gumbel heads, one split per head) that jax.random
draws from that key. Every module runs at a square kernel of 3 and an even
one ((2, 4), or 2 for the square-kernel modnets and patch classifier;
(3, 4) where a rate-scale conv synthesises the kernel, since a Hann window
of length 2 is all zero). Limits: forward outputs within 1e-5 of their
scale (max |want|), gradient trees within 1e-4 of theirs.

train_am.main: the port writes the initial checkpoint (--epochs 0, then
that init as epoch_0 with sgd's state), both CLIs resume from it for one
epoch of 2 batches with the same fed noise (a fixed function of the
latent's or the uniforms' shape, monkeypatched over both packages'
draws), and their losses (1e-5 relative) and final weights (1e-5 of the
tree's scale) are compared; then the port's dump_outputs of the port's
checkpoint is held to the JAX package's model on the same batches (1e-5
of the scale). The JAX dump_outputs runs vae_cnn_pool only (ROADMAP
Queue 3), so for the other six the JAX side is its model applied as the
port's dump defines the output. Widths: 2 LSTM layers, hidden 16, bn 4,
6-dim features, 5 classes, patches of 7 frames. Everything runs on the
CPU; the JAX side with the conftest's x64.
"""

import argparse
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_import import _build

from speech_recognition_tools_tpu.cli import dump_outputs as jdump
from speech_recognition_tools_tpu.cli import import_torch_ckpt as jimport
from speech_recognition_tools_tpu.cli import train_am as jtrain
from speech_recognition_tools_tpu.io import iter_egs_batches as jiter
from speech_recognition_tools_tpu.models import cnn as jcnn
from speech_recognition_tools_tpu.models import modnet as jmodnet
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import dump_outputs as tdump
from speech_recognition_tools_tpu_torch.cli import import_torch_ckpt as timport
from speech_recognition_tools_tpu_torch.cli import train_am as ttrain
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io.jax_params import (
    optim_state_to_jax,
    zoo_from_jax,
    zoo_to_jax,
)
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
from speech_recognition_tools_tpu_torch.models import cnn as tcnn
from speech_recognition_tools_tpu_torch.models import modnet as tmodnet
from speech_recognition_tools_tpu_torch.models import vae as tvae
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

B, H, W, BN, C = 3, 8, 12, 4, 5
LENS = np.array([12, 9, 5])
FWD_REL, GRAD_REL = 1e-5, 1e-4
KEY = jax.random.key(5)


def _x(seed=0, shape=(B, 1, H, W)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _case(name, k):
    """(JAX module, port module, inputs, noise) of module `name` at kernel
    size class k ("odd" or "even"); noise: None, ("normal", shape) or
    ("uniform", heads, shape)."""
    sq = 3 if k == "odd" else 2
    kern = (3, 3) if k == "odd" else (2, 4)
    rs_kern = (3, 3) if k == "odd" else (3, 4)
    x, lens = _x(), LENS
    x5 = _x(1, (B, 1, 2, H, W))
    pw = 11
    xp = _x(2, (B, 1, H, pw))
    cases = {
        "cnn_classifier": (jcnn.CnnClassifier((1, 4), (4, 6), sq, 2, 16, C),
                           tcnn.CnnClassifier((H, W), (1, 4), (4, 6), sq, 2, 16, C), (x,), None),
        "cnn_frame": (jcnn.CNNFrameClassifier((4, 5), kern, C),
                      tcnn.CNNFrameClassifier(H, (4, 5), kern, C), (x,), None),
        "cldnn": (jcnn.CLDNN((4, 3), kern, 16, 2, 2, C),
                  tcnn.CLDNN(H, (4, 3), kern, 16, 2, 2, C), (x, lens), None),
        "cldnn3d": (jcnn.CLDNN3D(2, (3,), kern, 16, 2, 2, C),
                    tcnn.CLDNN3D(H, 2, (3,), kern, 16, 2, 2, C), (x5, lens), None),
        "vae_cnn_pool": (jcnn.VAECNN((1, 3), (3, 5), kern, BN),
                         tcnn.VAECNN((H, W), (1, 3), (3, 5), kern, BN), (x,),
                         ("normal", (B, BN))),
        "vae_cnn_nopool": (jcnn.VAECNNNopool((1, 3), (3, 5), kern, BN),
                           tcnn.VAECNNNopool(H, (1, 3), (3, 5), kern, BN), (x,),
                           ("normal", (B, W, BN))),
        "cnn_ae": (jcnn.CNNAE((1, 3), (3, 5), kern, BN), tcnn.CNNAE(H, (1, 3), (3, 5), kern, BN),
                   (x,), None),
        "rs_vae": (jcnn.VaeRsModulation((1, 3), (3, 5), rs_kern, BN),
                   tcnn.VaeRsModulation(H, (1, 3), (3, 5), rs_kern, BN), (x,),
                   ("normal", (B, W, BN))),
        "modnet_classifier": (jmodnet.ModnetClassifier(2, 16, C),
                              tmodnet.ModnetClassifier(H * 3, 2, 16, C),
                              (_x(3, (B, H * 3)),), None),
        "modnet_encoder": (jmodnet.ModnetEncoder((1,), (4, 3), sq, 5, pw / 100, 3),
                           tmodnet.ModnetEncoder((H, pw), (1,), (4, 3), sq, 5, pw / 100, 3),
                           (xp,), ("uniform", 3, (B, 5))),
        "modnet": (jmodnet.ModulationNet(H, (1,), (4, 3), sq, 5, pw / 100, 3, 2, 16, C),
                   tmodnet.ModulationNet(H, pw, (1,), (4, 3), sq, 5, pw / 100, 3, 2, 16, C),
                   (xp,), ("uniform", 3, (B, 5))),
        "modnet_sigmoid_encoder": (jmodnet.ModnetSigmoidEncoder((1,), (4,), sq, 5, 5, pw / 100),
                                   tmodnet.ModnetSigmoidEncoder((H, pw), (1,), (4,), sq, 5, 5,
                                                                pw / 100), (xp,), None),
        "modnet_sigmoid": (jmodnet.ModulationSigmoidNet((1,), (4,), sq, 5, 5, pw / 100, 2, 16, C),
                           tmodnet.ModulationSigmoidNet(H, pw, (1,), (4,), sq, 5, 5, pw / 100, 2,
                                                        16, C), (xp,), None),
    }
    return cases[name]


NAMES = ["cnn_classifier", "cnn_frame", "cldnn", "cldnn3d", "vae_cnn_pool", "vae_cnn_nopool",
         "cnn_ae", "rs_vae", "modnet_classifier", "modnet_encoder", "modnet",
         "modnet_sigmoid_encoder", "modnet_sigmoid"]
CASES = [(n, k) for n in NAMES for k in ("odd", "even")]


@functools.lru_cache(maxsize=None)
def _params(name, k):
    """The flax init of a case, each leaf perturbed by 0.1 x N(0, 1)."""
    jm, _, inputs, noise = _case(name, k)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1),
            "gumbel": jax.random.key(2)}
    params = jax.jit(jm.init)(rngs, *map(jnp.asarray, inputs))
    rs = np.random.RandomState(7)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(np.float32), params)


def _noise_kwargs(noise):
    """(JAX call kwargs, port call kwargs): the draws the JAX module makes
    from KEY, handed to the port."""
    if noise is None:
        return {}, {}
    if noise[0] == "normal":
        return {"rng": KEY}, {"eps": torch.tensor(np.asarray(
            jax.random.normal(KEY, noise[1], jnp.float32)))}
    rng, us = KEY, []
    for _ in range(noise[1]):  # ModnetEncoder splits its key once per head
        rng, sub = jax.random.split(rng)
        us.append(torch.tensor(np.asarray(jax.random.uniform(sub, noise[2], jnp.float32))))
    return {"rng": KEY}, {"uniforms": us}


def _setup(name, k):
    jm, tm, inputs, noise = _case(name, k)
    params = jax.tree.map(np.copy, _params(name, k))
    tm.load_state_dict(zoo_from_jax(tm, params))
    jkw, tkw = _noise_kwargs(noise)
    return jm, params, tm, [jnp.asarray(a) for a in inputs], [torch.tensor(a) for a in inputs], \
        jkw, tkw


def _leaves(out):
    return [np.asarray(a) for a in jax.tree.leaves(out)]


def _tleaves(out):
    return [t.detach().numpy() for t in jax.tree.leaves(
        out, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,k", CASES)
def test_forward_and_gradients_match_jax(name, k):
    """The outputs, and d/dparams of sum_i <output_i, r_i> for fixed random
    r_i (one jitted JAX program computes both)."""
    jm, params, tm, ji, ti, jkw, tkw = _setup(name, k)
    shapes = [w.shape for w in jax.tree.leaves(
        jax.eval_shape(lambda p, *a: jm.apply(p, *a, **jkw), params, *ji))]
    rs = np.random.RandomState(3)
    rs_ = [np.asarray(rs.randn(*s), np.float32) for s in shapes]

    def objective(p):
        outs = jax.tree.leaves(jm.apply(p, *ji, **jkw))
        return sum(jnp.sum(o * r) for o, r in zip(outs, rs_))

    out, grads = jax.jit(lambda p: (jm.apply(p, *ji, **jkw), jax.grad(objective)(p)))(params)
    want = _leaves(out)
    got_out = tm(*ti, **tkw)
    got = _tleaves(got_out)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= FWD_REL, (name, k, _rel(g, w))
    outs = jax.tree.leaves(got_out, is_leaf=lambda a: isinstance(a, torch.Tensor))
    sum((o * torch.tensor(r)).sum() for o, r in zip(outs, rs_)).backward()
    got_g = zoo_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    want_l = dict(jax.tree_util.tree_leaves_with_path(grads))
    got_l = dict(jax.tree_util.tree_leaves_with_path(got_g))
    assert set(got_l) == set(want_l)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want_l.values())
    err = max(float(np.abs(np.asarray(got_l[p]) - np.asarray(v)).max())
              for p, v in want_l.items())
    assert err <= GRAD_REL * scale, (name, k, err, scale)


@pytest.mark.parametrize("name", NAMES)
def test_converters_round_trip(name):
    """to_jax(from_jax(p)) == p leaf by leaf, the paths included."""
    _, params, tm, *_ = _setup(name, "even")
    back = zoo_to_jax(tm, zoo_from_jax(tm, params))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for p, v in want.items():
        np.testing.assert_array_equal(got[p], v)


@pytest.mark.parametrize("k", [(3, 3), (3, 4)])
def test_rate_scale_convs_match_jax(k):
    """RateScaleConv and RateScaleConvTranspose alone (NHWC on the JAX
    side): forward and the gradient of rates and scales."""
    x = _x(4, (B, 3, H, W))
    rs = np.random.RandomState(8)
    for jcls, tcls in ((jcnn.RateScaleConv, tcnn.RateScaleConv),
                       (jcnn.RateScaleConvTranspose, tcnn.RateScaleConvTranspose)):
        jm, tm = jcls(3, 2, k), tcls(3, 2, k)
        xj = jnp.asarray(x.transpose(0, 2, 3, 1))
        params = jm.init({"params": jax.random.key(0)}, xj)
        params = jax.tree.map(lambda a: (np.asarray(a) + rs.randn(*np.shape(a))).astype(
            np.float32), params)
        tm.load_state_dict(zoo_from_jax(tm, params))
        want = np.asarray(jm.apply(params, xj)).transpose(0, 3, 1, 2)
        r = rs.randn(*want.shape).astype(np.float32)
        got = tm(torch.tensor(x))
        assert _rel(got.detach(), want) <= FWD_REL
        gw = jax.grad(lambda p: jnp.sum(jm.apply(p, xj) * r.transpose(0, 2, 3, 1)))(params)
        (got * torch.tensor(r)).sum().backward()
        for leaf in ("rates", "scales"):
            assert _rel(getattr(tm, leaf).grad, gw["params"][leaf]) <= GRAD_REL, leaf


def test_argmax_pool_and_unpool_match_jax_on_ties():
    """2 x 2 argmax pooling of a (B, 7, 9, C) map (an odd row and column to
    crop) full of ties (ReLU'd, rounded): values and slots identical, the
    unpool identical with its zero pad back to 7 x 9, and the gradients
    through both (amax splits a tie's gradient evenly) within 1e-6."""
    rs = np.random.RandomState(9)
    x = np.maximum(np.round(rs.randn(2, 7, 9, 3), 0), 0).astype(np.float32)
    x[0, :2, :2] = 1.0  # a window of four equal maxima
    jp, ji = jcnn._maxpool_with_indices(jnp.asarray(x))
    tp, ti = tcnn._maxpool_with_indices(torch.tensor(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ju = jcnn._maxunpool(jp, ji, (7, 9))
    tu = tcnn._maxunpool(tp, ti, (7, 9))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    r1 = rs.randn(*np.shape(jp)).astype(np.float32)
    r2 = rs.randn(2, 7, 9, 3).astype(np.float32)

    def objective(a):
        p, i = jcnn._maxpool_with_indices(a)
        return jnp.sum(p * r1) + jnp.sum(jcnn._maxunpool(p, i, (7, 9)) * r2)

    want = np.asarray(jax.grad(objective)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    p, i = tcnn._maxpool_with_indices(xt)
    ((p * torch.tensor(r1)).sum() + (tcnn._maxunpool(p, i, (7, 9)) * torch.tensor(r2)).sum()
     ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6)
    assert np.any((want != 0) & (np.abs(want) < np.abs(r1).max()))  # a split tie


@pytest.mark.parametrize("width", [7, 8])
def test_extract_patches_matches_jax(width):
    rs = np.random.RandomState(10)
    feats = rs.randn(3, 20, 6).astype(np.float32)
    labels = rs.randint(0, 5, (3, 20)).astype(np.int32)
    lens = np.array([20, 13, 6], np.int32)
    jp, jl, jv = jtrain._extract_patches(jnp.asarray(feats), jnp.asarray(labels),
                                         jnp.asarray(lens), width)
    tp, tl, tv = ttrain.extract_patches(torch.tensor(feats), torch.tensor(labels),
                                        torch.tensor(lens), width)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gumbel_softmax_matches_jax():
    """The straight-through sample on the same uniforms: the one-hot
    forward and the soft gradient."""
    rs = np.random.RandomState(11)
    logits = rs.randn(4, 6).astype(np.float32)
    r = rs.randn(4, 6).astype(np.float32)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (4, 6), jnp.float32))
    jf = lambda lg: jnp.sum(jmodnet.gumbel_softmax(key, lg, 0.8) * r)  # noqa: E731
    lt = torch.tensor(logits, requires_grad=True)
    out = tmodnet.gumbel_softmax(lt, 0.8, torch.tensor(u))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jmodnet.gumbel_softmax(key, jnp.asarray(logits), 0.8)))
    (out * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(logits))),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- the CLIs

D, N_UTTS, LR, PW = 6, 9, 0.1, 7
TINY = ["--num_layers", "2", "--hidden_dim", "16", "--bn_dim", "4", "--batch_size", "4",
        "--optimizer", "sgd", "--learning_rate", str(LR), "--patch_width", str(PW),
        "--freq_num", "4", "--head_num", "2"]
CONV_ARCHS = ["cnn", "cldnn", "vae_cnn", "vae_cnn_pool", "rs_vae", "modnet", "modnet_sigmoid"]
ARCH_FLAGS = {"cnn": ["--num_layers_dec", "2"]}
LOSS_REL, WEIGHT_REL, DUMP_REL = 1e-5, 1e-5, 1e-5


def _fed(shape, lo=0.0):
    """A fixed function of the shape: normals-like for latents, in (0, 1)
    for uniforms."""
    n = int(np.prod(shape))
    if lo:
        return ((np.arange(n) * 0.6180339887 + 0.1) % 1.0 * 0.98 + 0.01).reshape(shape).astype(
            np.float32)
    return (1.3 * np.sin(0.7 * np.arange(n) + 0.3)).reshape(shape).astype(np.float32)


@pytest.fixture
def fed_noise(monkeypatch):
    """Both packages' latent normals and gumbel uniforms replaced by _fed."""
    def jsample(key, means, logvars):
        return means + jnp.exp(logvars) * jnp.asarray(_fed(means.shape), means.dtype)

    def jgumbel(key, logits, temperature):
        u = jnp.asarray(_fed(logits.shape, lo=1), logits.dtype)
        g = -jnp.log(-jnp.log(u + 1e-20) + 1e-20)
        y = jax.nn.softmax((logits + g) / temperature, axis=-1)
        hard = jax.nn.one_hot(jnp.argmax(y, axis=-1), y.shape[-1], dtype=y.dtype)
        return jax.lax.stop_gradient(hard - y) + y

    monkeypatch.setattr(jcnn, "sample_latent", jsample)
    monkeypatch.setattr(jmodnet, "gumbel_softmax", jgumbel)
    monkeypatch.setattr(tvae, "draw_eps", lambda like, eps=None, generator=None: torch.tensor(
        _fed(tuple(like.shape)), dtype=like.dtype))
    monkeypatch.setattr(tmodnet, "draw_uniform", lambda like, generator=None: torch.tensor(
        _fed(tuple(like.shape), lo=1), dtype=like.dtype))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Egs dirs built by the port: 9 utterances of 14-24 frames and, for
    modnet_sigmoid, 8 of 32 (the loader's bucket: no all-zero patch, see
    test_modnet_sigmoid_goes_nan_on_padding_in_both), 6-dim, 5 classes."""
    root = tmp_path_factory.mktemp("conv")
    rs = np.random.RandomState(0)
    utts = [(f"u{i}", rs.randn(n, D).astype(np.float32))
            for i, n in enumerate(rs.randint(14, 25, N_UTTS))]
    full = [(f"f{i}", rs.randn(32, D).astype(np.float32)) for i in range(8)]
    out = {"root": root}
    for name, us in (("egs", utts), ("egs32", full)):
        labels = {k: rs.randint(0, C, len(f)) for k, f in us}
        out[name] = tegs.build_egs(iter(us), str(root / name), labels, num_targets=C)
    return out


def _initial(argv, egs, dest, tmp):
    """The port's init (train_am.main --epochs 0) saved as epoch_0 of
    `dest` with its optimizer's initial state (sgd's empty one, or adam's
    zero moments) in optax's layout."""
    init = str(tmp / (os.path.basename(dest) + "_init"))
    ttrain.main([egs, init, *argv, "--epochs", "0", "--device", "cpu"])
    payload, cfg = tckpt.load_checkpoint(os.path.join(init, "final"))
    cfg.pop("extra", None)
    args = ttrain.get_parser().parse_args([egs, init, *argv])
    zeros = {s: jax.tree.map(np.zeros_like, payload["params"])
             for s in (("mu", "nu") if args.optimizer == "adam" else ())}
    opt = optim_state_to_jax(dict(zeros, count=0, learning_rate=args.learning_rate),
                             lambda tree: tree, name=args.optimizer, clip=True)
    tckpt.save_checkpoint(dest, "epoch_0", payload["params"], cfg, opt_state=opt,
                          extra={"epoch": 0, "lr": args.learning_rate})
    return dest


def _tree_rel(got, want):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_g) == set(flat_w)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in flat_w.values())
    return max(float(np.abs(np.asarray(flat_g[p]) - np.asarray(v)).max())
               for p, v in flat_w.items()) / scale


def jax_conv_dump(store, egs, batch_size=32):
    """{utt: rows} that the port's dump_outputs writes for a conv-half
    checkpoint, computed with the JAX package's model on its loader's
    batches: the logits (cnn, cldnn) or the latent means (vae_cnn, rs_vae)
    of each utterance's image; the pooled VAE's means or the modnets'
    logits on the centre-aligned patches, edge-padded (the JAX
    dump_outputs' vae_cnn_pool windowing)."""
    path = jckpt.latest_checkpoint(store) or store
    payload, cfg = jckpt.load_checkpoint(path)
    model = jtrain.build_model(argparse.Namespace(**cfg), cfg["feature_dim"],
                               cfg.get("num_classes"))
    arch, variables, out = cfg["arch"], payload["params"], {}
    rngs = {"sample": jax.random.key(2), "gumbel": jax.random.key(2)}
    apply = jax.jit(lambda v, *a: model.apply(v, *a, rngs=rngs))
    for b in jiter(egs, batch_size):
        feats, lengths = jnp.asarray(b["feats"]), jnp.asarray(b["lengths"])
        x = jnp.swapaxes(feats, 1, 2)[:, None]
        if arch in ("cnn", "cldnn"):
            rows = apply(variables, x, *([lengths] if arch == "cldnn" else []))
        elif arch in ("vae_cnn", "rs_vae"):
            rows = apply(variables, x)[1][0]
        else:
            Wp = int(cfg.get("num_frames") or cfg.get("patch_width") or 21)
            Bn, T, _ = feats.shape
            patches, _, _ = jtrain._extract_patches(feats, None, jnp.full((Bn,), T), Wp)
            res = apply(variables, patches)
            rows = (res[1][0] if arch == "vae_cnn_pool" else res[0]).reshape(Bn, T - Wp + 1, -1)
            rows = jnp.pad(rows, ((0, 0), (Wp // 2, Wp - 1 - Wp // 2), (0, 0)), mode="edge")
        rows = np.asarray(rows)
        for i, key in enumerate(b["keys"]):
            out[key] = rows[i, : int(b["lengths"][i])]
    return out


def _dict_rel(got, want):
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / scale


@pytest.mark.parametrize("arch", CONV_ARCHS)
def test_train_am_and_dump_outputs_match_jax(arch, data, fed_noise, tmp_path):
    egs = data["egs32" if arch == "modnet_sigmoid" else "egs"]
    argv = TINY + ["--arch", arch] + ARCH_FLAGS.get(arch, [])
    store_j = _initial(argv, egs, str(tmp_path / "jax"), tmp_path)
    store_p = str(tmp_path / "port")
    shutil.copytree(store_j, store_p)
    jtrain.main([egs, store_j, *argv, "--epochs", "1"])
    st = ttrain.main([egs, store_p, *argv, "--epochs", "1", "--device", "cpu"])
    pay_j, cfg_j = jckpt.load_checkpoint(os.path.join(store_j, "final"))
    pay_p, cfg_p = jckpt.load_checkpoint(os.path.join(store_p, "final"))
    hist_j = cfg_j["extra"]["history"]
    assert len(hist_j) == len(st.history) == 1
    for key in ("train_loss", "dev_loss"):
        assert np.isfinite(hist_j[0][key])
        np.testing.assert_allclose(st.history[0][key], hist_j[0][key], rtol=LOSS_REL)
    assert _tree_rel(pay_p["params"], pay_j["params"]) <= WEIGHT_REL
    for k in ("arch", "model_class", "feature_dim", "num_classes"):
        assert cfg_p[k] == cfg_j[k], k
    opt_j = jckpt.load_checkpoint(os.path.join(store_j, "epoch_1"))[0]["opt_state"]
    opt_p = jckpt.load_checkpoint(os.path.join(store_p, "epoch_1"))[0]["opt_state"]
    assert jax.tree.structure(opt_p) == jax.tree.structure(opt_j)
    got = tdump.main([store_p, egs, str(tmp_path / "p"), "--device", "cpu"])
    assert _dict_rel(got, jax_conv_dump(store_p, egs)) <= DUMP_REL
    if arch == "vae_cnn_pool":  # the one conv arch the JAX CLI dumps
        jdump.main([store_p, egs, str(tmp_path / "j")])
        assert _dict_rel(got, dict(read_ark(str(tmp_path / "j.ark")))) <= DUMP_REL


@pytest.mark.parametrize("family", ["vae_cnn", "vae_cnn_pool", "rs_vae", "modnet",
                                    "modnet_sigmoid"])
def test_imported_conv_family_dumps_as_jax(family, fed_noise, tmp_path):
    """A reference .model dict of the family, imported by both packages'
    CLIs (the same bytes), then dumped by the port and by the JAX model
    (cnn and cldnn: tests/test_torch_port_import.py)."""
    sd, hyper, flags = _build(family, seed=3)
    src = str(tmp_path / "ref.model")
    torch.save({"model_state_dict": sd, **hyper}, src)
    timport.main([src, str(tmp_path / "p"), *flags])
    jimport.main([src, str(tmp_path / "j"), *flags])
    cfg = tckpt.load_checkpoint(tckpt.latest_checkpoint(str(tmp_path / "p")))[1]
    rs = np.random.RandomState(4)
    utts = [(f"u{i}", rs.randn(n, cfg["feature_dim"]).astype(np.float32))
            for i, n in enumerate((17, 9, 12))]
    egs = tegs.build_egs(iter(utts), str(tmp_path / "egs"))
    got = tdump.main([str(tmp_path / "p"), egs, str(tmp_path / "o"), "--device", "cpu"])
    assert _dict_rel(got, jax_conv_dump(str(tmp_path / "j"), egs)) <= DUMP_REL


@pytest.mark.parametrize("arch", ["cnn", "cldnn", "vae_cnn", "vae_cnn_pool", "rs_vae"])
def test_even_kernel_checkpoint_dumps_as_jax(arch, data, fed_noise, tmp_path):
    """train_am's flags give 3 x 3 kernels; an importer's config gives any
    (cnn_kernel). A checkpoint written by the JAX package with cnn_kernel
    (2, 4) ((3, 4) for rs_vae: a Hann window of 2 is zero), its flax init
    perturbed, is dumped by the port as the JAX model computes it."""
    args = jtrain.get_parser().parse_args([data["egs"], "x", *TINY, "--arch", arch])
    args.cnn_kernel = [3, 4] if arch == "rs_vae" else [2, 4]
    if arch == "vae_cnn_pool":
        args.num_frames = PW
    model = jtrain.build_model(args, D, C)
    x = jnp.zeros((2, 1, D, PW if arch == "vae_cnn_pool" else 16), jnp.float32)
    init = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    params = model.init(init, x, *([jnp.array([16, 9])] if arch == "cldnn" else []))
    rs = np.random.RandomState(12)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(
        np.float32), params)
    cfg = dict(vars(args), feature_dim=D, num_classes=C, model_class=jtrain.ARCHS[arch])
    store = str(tmp_path / "j")
    jckpt.save_checkpoint(store, "final", params, cfg)
    got = tdump.main([store, data["egs"], str(tmp_path / "p"), "--device", "cpu"])
    assert _dict_rel(got, jax_conv_dump(store, data["egs"])) <= DUMP_REL


def test_modnet_sigmoid_goes_nan_on_padding_in_both(data, tmp_path):
    """A JAX fault the port reproduces (ROADMAP Queue 3): a patch past an
    utterance's end is all zero, its sin/cos magnitude sqrt(0), whose
    gradient is 0 / 0; the loss masks the patch out, not its NaN gradient.
    One epoch on padded batches ends in NaN in both packages, and the first
    step's loss (on the initial weights) is finite in both."""
    argv = TINY + ["--arch", "modnet_sigmoid"]
    store_j = _initial(argv, data["egs"], str(tmp_path / "jax"), tmp_path)
    store_p = str(tmp_path / "port")
    shutil.copytree(store_j, store_p)
    jtrain.main([data["egs"], store_j, *argv, "--epochs", "1"])
    st = ttrain.main([data["egs"], store_p, *argv, "--epochs", "1", "--device", "cpu"])
    hist_j = jckpt.load_checkpoint(os.path.join(store_j, "final"))[1]["extra"]["history"]
    assert np.isnan(hist_j[0]["train_loss"]) and np.isnan(st.history[0]["train_loss"])
    model, _, _ = tdump.load_model_from_checkpoint(str(tmp_path / "jax_init"), "cpu")
    args = ttrain.get_parser().parse_args([data["egs"], store_p, *argv])
    batch = next(tegs.iter_egs_batches(data["egs"], 4))
    loss, _ = ttrain.make_loss(args)(model, ttrain.batch_on_device(batch, "cpu"), True)
    assert torch.isfinite(loss)
    loss.backward()
    assert any(torch.isnan(p.grad).any() for p in model.parameters())


def test_rs_vae_is_badly_scaled_at_train_am_defaults_in_both(data, tmp_path):
    """A fault of the JAX package the port reproduces (ROADMAP Queue 3): at
    train_am's defaults (hidden 512: 32 / 64 channels, bn 64) the
    rate-scale VAE's loss is above 1e6 from its first step; its KL holds
    exp(logvar) ** 2, and the log-std head sums 384 unnormalised ReLU
    outputs of the rate-scale conv. One epoch of two Adam steps from the
    same initial checkpoint stays above 1e6 (or turns NaN) in both
    packages, and so does the JAX package from its own init."""
    argv = ["--arch", "rs_vae", "--batch_size", "4"]
    egs = data["egs32"]
    store_j = _initial(argv, egs, str(tmp_path / "jax"), tmp_path)
    store_p = str(tmp_path / "port")
    shutil.copytree(store_j, store_p)
    jtrain.main([egs, store_j, *argv, "--epochs", "1"])
    st = ttrain.main([egs, store_p, *argv, "--epochs", "1", "--device", "cpu"])
    jtrain.main([egs, str(tmp_path / "jax_own"), *argv, "--epochs", "1"])
    hists = [jckpt.load_checkpoint(os.path.join(d, "final"))[1]["extra"]["history"][0]
             for d in (store_j, str(tmp_path / "jax_own"))] + [st.history[0]]
    for h in hists:
        assert not h["train_loss"] < 1e6, h  # above 1e6, or NaN
    model, _, _ = tdump.load_model_from_checkpoint(str(tmp_path / "jax_init"), "cpu")
    batch = next(tegs.iter_egs_batches(egs, 4))
    args = ttrain.get_parser().parse_args([egs, store_p, *argv])
    with torch.no_grad():
        loss, _ = ttrain.make_loss(args, None, torch.Generator().manual_seed(0))(
            model, ttrain.batch_on_device(batch, "cpu"), True)
    assert torch.isfinite(loss) and loss > 1e6


@pytest.mark.parametrize("arch", ["cnn", "cldnn", "vae_cnn", "rs_vae", "modnet",
                                  "modnet_sigmoid"])
def test_jax_dump_outputs_fails_on_six_conv_archs(arch, data, tmp_path):
    """The JAX dump_outputs' generic branch calls model.apply(params, feats,
    lengths): the image and modnet archs take one (B, 1, D, T) input and
    raise (ROADMAP Queue 3); the port dumps them (above)."""
    store = str(tmp_path / arch)
    ttrain.main([data["egs"], store, *TINY, "--arch", arch, "--epochs", "0", "--device",
                 "cpu"])
    with pytest.raises((TypeError, ValueError)):
        jdump.main([store, data["egs"], str(tmp_path / "j")])
