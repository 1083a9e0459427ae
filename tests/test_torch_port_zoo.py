"""The recurrent half of the port's model zoo held against the JAX package:
models/recurrent.py (FeedforwardClassifier .. AutoencoderRNN), models/apc.py,
models/vae.py and models/curl.py, their losses, and the flax-tree
converters io/jax_params.py::zoo_from_jax / zoo_to_jax.

Both sides get the same numpy inputs, the same weights (a flax init
perturbed with seeded noise so that every bias is nonzero, carried over by
zoo_from_jax) and, where a model samples, the same noise: the JAX module is
called with `rng=key` and the port with eps = jax.random.normal(key, ...),
the draw the JAX sampler makes from that key. Widths are small (2 layers,
hidden 16, bn 4, 2 components, 6-dim features, 5 classes; the transformer
VAE 16-dim features, bn 8, 2 heads). Limits: every forward output and
loss within 1e-5 of its scale (max |want|), every gradient tree within
1e-4 of its scale (float32 on both sides; the JAX GRU keeps a float32
carry). The JAX side runs on the CPU with the conftest's x64; the port
runs on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu import models as J
from speech_recognition_tools_tpu.models import apc as japc
from speech_recognition_tools_tpu.models import curl as jcurl
from speech_recognition_tools_tpu.models import vae as jvae
from speech_recognition_tools_tpu_torch.io.jax_params import zoo_from_jax, zoo_to_jax
from speech_recognition_tools_tpu_torch.models import apc as tapc
from speech_recognition_tools_tpu_torch.models import curl as tcurl
from speech_recognition_tools_tpu_torch.models import recurrent as R
from speech_recognition_tools_tpu_torch.models import vae as tvae

torch.set_num_threads(1)

B, T, D, H, BN, K, C = 3, 9, 6, 16, 4, 2, 5
LENS = np.array([9, 5, 7])
FWD_REL, GRAD_REL = 1e-5, 1e-4


def _x(seed=0, d=D, shape=None):
    return np.random.RandomState(seed).randn(*(shape or (B, T, d))).astype(np.float32)


def _streams(x):
    return [x[..., :3], x[..., 3:]]


# name -> (JAX module, port module, inputs (numpy), noise shape or None)
def _cases():
    x, x16, z = _x(), _x(d=16), _x(1, d=BN)
    zk = _x(2, shape=(K, B, T, BN))
    return {
        "feedforward": (J.FeedforwardClassifier(2, H, C), R.FeedforwardClassifier(D, 2, H, C),
                        (x,), None),
        "linear": (J.LinearConvStack(2, H, C), R.LinearConvStack(D, 2, H, C), (x, LENS), None),
        "rnn_subnet": (J.RNNSubnet(2, H), R.RNNSubnet(D, 2, H), (x, LENS), None),
        "multistream": (J.MultistreamRNN(2, 2, 8, 1, C), R.MultistreamRNN([3, 3], 2, 8, 1, C),
                        ("streams", LENS), None),
        "encoder_rnn": (J.EncoderRNN(2, H, BN), R.EncoderRNN(D, 2, H, BN), (x, LENS), None),
        "decoder_rnn": (J.DecoderRNN(2, H, C), R.DecoderRNN(BN, 2, H, C), (z, LENS), None),
        "multitask_ae": (J.AEClassifierMultitask(C, 2, 1, 1, H, BN),
                         R.AEClassifierMultitask(D, C, 2, 1, 1, H, BN), (x, LENS), None),
        "multitask_aear": (J.AEClassifierMultitaskAEAR(C, 2, 1, 1, H, BN, 2),
                           R.AEClassifierMultitaskAEAR(D, C, 2, 1, 1, H, BN, 2), (x, LENS), None),
        "pm_ae": (J.AutoencoderRNN(2, 2, H, BN), R.AutoencoderRNN(D, 2, 2, H, BN), (x, LENS),
                  None),
        "apc": (japc.APC(2, H), tapc.APC(D, 2, H), (x, LENS), None),
        "vae_encoder": (J.VAEEncoder(2, H, BN), tvae.VAEEncoder(D, 2, H, BN), (x, LENS), None),
        "vae_decoder": (J.VAEDecoder(2, H, D), tvae.VAEDecoder(BN, 2, H, D), (z, LENS), None),
        "vae": (J.VAE(2, 1, H, BN), tvae.VAE(D, 2, 1, H, BN), (x, LENS), (B, T, BN)),
        "vae_only_ae": (J.VAE(2, 1, H, BN, only_ae=True),
                        tvae.VAE(D, 2, 1, H, BN, only_ae=True), (x, LENS), None),
        "vae_transformer": (J.VAE(2, 1, H, 8, use_transformer=True, nhead=2),
                            tvae.VAE(16, 2, 1, H, 8, use_transformer=True, nhead=2),
                            (x16, LENS), (B, T, 8)),
        "vae_classifier": (J.VAEClassifier(C, 2, 1, 1, H, BN),
                           tvae.VAEClassifier(D, C, 2, 1, 1, H, BN), (x, LENS), (B, T, BN)),
        "arvae": (J.ARVAE(2, 1, H, BN, 2), tvae.ARVAE(D, 2, 1, H, BN, 2), (x, LENS), (B, T, BN)),
        "vae_encoded": (J.VAEEncodedClassifier(2, H, C), tvae.VAEEncodedClassifier(BN, 2, H, C),
                        (z,), None),
        "curl_encoder": (J.CurlEncoder(2, H, BN, K), tcurl.CurlEncoder(D, 2, H, BN, K),
                         (x, LENS), None),
        "curl_decoder": (J.CurlDecoder(1, H, D), tcurl.CurlDecoder(BN, 1, H, D), (zk, LENS),
                         None),
        "curl_decoder_multistream": (J.CurlDecoderMultistream(K, 1, H, D),
                                     tcurl.CurlDecoderMultistream(K, BN, 1, H, D), (zk, LENS),
                                     None),
        "curl_unsup": (J.CurlSupervised(2, 1, H, BN, K), tcurl.CurlSupervised(D, 2, 1, H, BN, K),
                       (x, LENS), (K, B, T, BN)),
        "curl": (J.CurlMultistreamClassifier(C, 2, 1, 1, H, H, BN, K),
                 tcurl.CurlMultistreamClassifier(D, C, 2, 1, 1, H, H, BN, K), (x, LENS),
                 (K, B, T, BN)),
        "curl_encoded": (J.CurlEncodedClassifier(2, H, C),
                         tcurl.CurlEncodedClassifier(BN, 2, H, C), (z,), None),
    }


CASES = sorted(_cases())
KEY = jax.random.key(5)


def _jax_inputs(inputs, x_np):
    return tuple([jnp.asarray(s) for s in _streams(x_np)] if isinstance(a, str)
                 else jnp.asarray(a) for a in inputs)


def _port_inputs(inputs, x_np):
    return tuple([torch.tensor(s) for s in _streams(x_np)] if isinstance(a, str)
                 else torch.tensor(a) for a in inputs)


@functools.lru_cache(maxsize=None)
def _params(name):
    """The flax init of case `name`, each leaf perturbed by 0.1 x N(0, 1)."""
    jm, _, inputs, _ = _cases()[name]
    params = jax.jit(jm.init)({"params": jax.random.key(0), "sample": jax.random.key(1)},
                              *_jax_inputs(inputs, _x()))
    rs = np.random.RandomState(7)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(np.float32), params)


def _setup(name):
    """(JAX module, perturbed params, port module with them loaded, JAX
    inputs, port inputs, JAX call kwargs, port call kwargs)."""
    jm, tm, inputs, noise = _cases()[name]
    x = _x()
    ji, ti = _jax_inputs(inputs, x), _port_inputs(inputs, x)
    params = jax.tree.map(np.copy, _params(name))
    tm.load_state_dict(zoo_from_jax(tm, params))
    jkw, tkw = {}, {}
    if noise is not None:
        jkw = {"rng": KEY}
        tkw = {"eps": torch.tensor(np.asarray(jax.random.normal(KEY, noise, jnp.float32)))}
    return jm, params, tm.eval(), ji, ti, jkw, tkw


def _leaves(out):
    return [np.asarray(a) for a in jax.tree.leaves(out)]


def _tleaves(out):
    return [t.detach().numpy() for t in jax.tree.leaves(
        out, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax(name):
    jm, params, tm, ji, ti, jkw, tkw = _setup(name)
    want = _leaves(jax.jit(lambda p, *a: jm.apply(p, *a, **jkw))(params, *ji))
    with torch.no_grad():
        got = _tleaves(tm(*ti, **tkw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= FWD_REL, (name, _rel_err(g, w))


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax(name):
    """d/dparams of sum_i <output_i, r_i> for fixed random r_i."""
    jm, params, tm, ji, ti, jkw, tkw = _setup(name)
    shapes = [w.shape for w in _leaves(jax.jit(lambda p, *a: jm.apply(p, *a, **jkw))(params,
                                                                                       *ji))]
    rs = np.random.RandomState(3)
    rs_ = [rs.randn(*s).astype(np.float32) for s in shapes]

    def objective(p):
        outs = jax.tree.leaves(jm.apply(p, *ji, **jkw))
        return sum(jnp.sum(o * r) for o, r in zip(outs, rs_))

    want = jax.jit(jax.grad(objective))(params)
    outs = jax.tree.leaves(tm(*ti, **tkw), is_leaf=lambda a: isinstance(a, torch.Tensor))
    sum((o * torch.tensor(r)).sum() for o, r in zip(outs, rs_)).backward()
    got = zoo_to_jax(tm, {k: p.grad for k, p in tm.named_parameters()})
    want_l = dict(jax.tree_util.tree_leaves_with_path(want))
    got_l = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got_l) == set(want_l)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want_l.values())
    err = max(float(np.abs(np.asarray(got_l[k]) - np.asarray(v)).max())
              for k, v in want_l.items())
    assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("name", CASES)
def test_converters_round_trip(name):
    """to_jax(from_jax(p)) == p leaf by leaf, the paths included, and the
    port's state_dict survives the other way round bit for bit."""
    _, params, tm, *_ = _setup(name)
    back = zoo_to_jax(tm, zoo_from_jax(tm, params))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    sd = tm.state_dict()
    again = zoo_from_jax(tm, zoo_to_jax(tm, sd))
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)
    extra = jax.tree.map(lambda a: a, params)
    extra["params"]["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        zoo_from_jax(tm, extra)


def test_flax_reset_draws_flax_distributions():
    """flax_reset_ gives every leaf of a zoo model flax init's distribution:
    zero biases, unit LayerNorm scales, and the kernels' standard deviations
    within 20% of flax's draw (leaves of 256 entries or more)."""
    jm, tm, inputs, _ = _cases()["vae_transformer"]
    ji = _jax_inputs(inputs, _x())
    params = jax.jit(jm.init)({"params": jax.random.key(0), "sample": jax.random.key(1)}, *ji)
    R.flax_reset_(tm, torch.Generator().manual_seed(0))
    got = dict(jax.tree_util.tree_leaves_with_path(zoo_to_jax(tm, tm.state_dict())))
    for k, w in jax.tree_util.tree_leaves_with_path(params):
        g, w = np.asarray(got[k]), np.asarray(w)
        if not w.any() or np.all(w == 1):
            assert np.array_equal(g, w), k
        elif w.size >= 256:
            assert abs(g.std() / w.std() - 1) < 0.2, (k, g.std(), w.std())


def test_scale_gradient_backward_matches_jax():
    x = _x()
    w = _x(4)
    want = jax.grad(lambda a: jnp.sum(jcurl.scale_gradient(a, 0.2) * w))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    y = tcurl.scale_gradient(t, 0.2)
    assert torch.equal(y, t)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-7)


# ------------------------------------------------------------------ losses


def _mask():
    return np.arange(T)[None, :] < LENS[:, None]


@pytest.mark.parametrize("dist", ["gauss", "laplace"])
@pytest.mark.parametrize("masked", [False, True])
def test_vae_loss_matches_jax(dist, masked):
    x, y, m, lv = _x(0), _x(1), _x(2, d=BN), 0.3 * _x(3, d=BN)
    mask = _mask() if masked else None
    want = jvae.vae_loss(jnp.asarray(x), jnp.asarray(y), (jnp.asarray(m), jnp.asarray(lv)), dist,
                         None if mask is None else jnp.asarray(mask))
    got = tvae.vae_loss(torch.tensor(x), torch.tensor(y), (torch.tensor(m), torch.tensor(lv)),
                        dist, None if mask is None else torch.tensor(mask))
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), np.asarray(w)) <= FWD_REL


def _curl_latent():
    rs = np.random.RandomState(11)
    logits = rs.randn(B, T, K)
    cat = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return (cat, _x(12, shape=(K, B, T, BN)), 0.3 * _x(13, shape=(K, B, T, BN)))


@pytest.mark.parametrize("loss", ["supervised_0", "supervised_1", "unsupervised"])
@pytest.mark.parametrize("masked", [False, True])
def test_curl_losses_match_jax(loss, masked):
    x, recon = _x(), _x(14, shape=(K, B, T, D))
    latent = _curl_latent()
    mean_p = _x(15, shape=(K, BN))
    mask = _mask() if masked else None
    jl = tuple(jnp.asarray(a) for a in latent)
    tl = tuple(torch.tensor(a) for a in latent)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.tensor(mask)
    if loss == "unsupervised":
        want = jcurl.curl_loss_unsupervised(jnp.asarray(x), jnp.asarray(recon), jl,
                                            jnp.asarray(mean_p), jmask)
        got = tcurl.curl_loss_unsupervised(torch.tensor(x), torch.tensor(recon), tl,
                                           torch.tensor(mean_p), tmask)
    else:
        k = int(loss[-1])
        want = jcurl.curl_loss_supervised(jnp.asarray(x), jnp.asarray(recon), jl,
                                          jnp.asarray(mean_p), k, jmask)
        got = tcurl.curl_loss_supervised(torch.tensor(x), torch.tensor(recon), tl,
                                         torch.tensor(mean_p), k, tmask)
    assert _rel_err(got.numpy(), np.asarray(want)) <= FWD_REL


def test_apc_loss_and_latent_features_match_jax():
    pred, feats = _x(0), _x(1)
    want = japc.apc_loss(jnp.asarray(pred), jnp.asarray(feats), jnp.asarray(LENS), 2)
    got = tapc.apc_loss(torch.tensor(pred), torch.tensor(feats), torch.tensor(LENS), 2)
    assert _rel_err(got.numpy(), np.asarray(want)) <= FWD_REL
    latent = _curl_latent()
    want = jcurl.compute_latent_features(tuple(jnp.asarray(a) for a in latent))
    got = tcurl.compute_latent_features(tuple(torch.tensor(a) for a in latent))
    assert _rel_err(got.numpy(), np.asarray(want)) <= FWD_REL


def test_random_mixture_means_draws_a_scaled_normal():
    g = torch.Generator().manual_seed(0)
    m = tcurl.random_mixture_means(4, 5000, g, scale=2.0)
    assert m.shape == (4, 5000)
    assert abs(m.std().item() / 2.0 - 1) < 0.05 and abs(m.mean().item()) < 0.05
    again = tcurl.random_mixture_means(4, 5000, torch.Generator().manual_seed(0), scale=2.0)
    assert torch.equal(m, again)


def test_vae_generate_and_llhood_match_jax(monkeypatch):
    """vae_generate on the prior draw jax.random.normal(key, (batch, size,
    bn)) makes; vae_llhood on the draws the JAX sampler makes from the
    keys its loop splits (recorded from the JAX run and fed to the port)."""
    jm, params, tm, ji, ti, _, _ = _setup("vae")
    key = jax.random.key(9)
    want = jvae.vae_generate(jm, params, key, size=7, batch=2)
    z = torch.tensor(np.asarray(jax.random.normal(key, (2, 7, BN), jnp.float32)))
    with torch.no_grad():
        got = tvae.vae_generate(tm, size=7, batch=2, z=z)
    assert _rel_err(got.numpy(), np.asarray(want)) <= FWD_REL
    draws = []
    real = jvae.sample_latent

    def recording(k, means, logvars):
        draws.append(np.asarray(jax.random.normal(k, means.shape, means.dtype)))
        return real(k, means, logvars)

    monkeypatch.setattr(jvae, "sample_latent", recording)
    want = jvae.vae_llhood(jm, params, key, *ji, sample_num=3)
    assert len(draws) == 3
    with torch.no_grad():
        got = tvae.vae_llhood(tm, *ti, sample_num=3, eps=[torch.tensor(d) for d in draws])
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), np.asarray(w)) <= FWD_REL
    with pytest.raises(tvae.MissingNoiseError):
        tm(*ti)


def test_expand_component_copies_the_old_component():
    """The port's expand_component and the JAX one copy the same leaves:
    the GRU trunk, the first K * bn columns of the mean and var heads, the
    first K categorical logits, every stream and classifier; the port's
    grown model with the JAX grown tree loaded matches the JAX grown
    model's forward."""
    jm, params, tm, ji, ti, jkw, _ = _setup("curl")
    new_tm = tcurl.expand_component(tm, torch.Generator().manual_seed(3))
    assert new_tm.comp_num == K + 1 and new_tm.config == dict(tm.config, comp_num=K + 1)
    old, new = tm.state_dict(), new_tm.state_dict()
    for k, v in old.items():
        if k.startswith(("curl_encoder.means", "curl_encoder.vars")):
            assert torch.equal(new[k][: K * BN], v), k
        elif k.startswith("curl_encoder.categorical"):
            assert torch.equal(new[k][:K], v), k
        else:
            assert torch.equal(new[k], v), k
    assert new["curl_encoder.means.bias"][K * BN:].abs().sum() == 0  # flax's zero bias
    new_jm, new_params = jcurl.expand_component(jm, params, jax.random.key(4), ji)
    want_tree = zoo_to_jax(new_tm, new)
    jax_tree = jax.tree.map(np.asarray, new_params)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    for k, v in jax.tree_util.tree_leaves_with_path(want_tree):
        assert flat_j[k].shape == v.shape, k
    grown = tcurl.CurlMultistreamClassifier(D, C, 2, 1, 1, H, H, BN, K + 1).eval()
    grown.load_state_dict(zoo_from_jax(grown, jax_tree))
    for k, v in old.items():
        g = grown.state_dict()[k]
        n = K * BN if k.startswith(("curl_encoder.means", "curl_encoder.vars")) else (
            K if k.startswith("curl_encoder.categorical") else None)
        assert torch.equal(g[:n] if n else g, v), k
    noise = jax.random.normal(KEY, (K + 1, B, T, BN), jnp.float32)
    want = _leaves(new_jm.apply(new_params, *ji, rng=KEY))
    with torch.no_grad():
        got = _tleaves(grown(*ti, eps=torch.tensor(np.asarray(noise))))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= FWD_REL



# ------------------------------------------------------------------ imports


@pytest.mark.parametrize("family", ["feedforward", "linear", "multitask_ae", "multitask_aear",
                                    "vae", "vae_classifier", "curl", "vae_encoded",
                                    "curl_encoded"])
def test_imported_recurrent_family_dumps_as_in_jax(family, tmp_path, monkeypatch):
    """A reference checkpoint of a recurrent family, imported by the port's
    import_torch_ckpt, loads in the port's dump_outputs and gives the JAX
    dump_outputs' ark (1e-5 of its scale; a sampling family gets the same
    fed noise on both sides: the mean itself)."""
    from test_torch_port_import import D as ID
    from test_torch_port_import import _build

    from speech_recognition_tools_tpu.cli import dump_outputs as jdump
    from speech_recognition_tools_tpu_torch.cli import dump_outputs as tdump
    from speech_recognition_tools_tpu_torch.cli import import_torch_ckpt as timport
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark

    monkeypatch.setattr(jvae, "sample_latent", lambda key, m, lv: m)
    monkeypatch.setattr(jcurl, "sample_curl_latent", lambda key, m, lv: m)
    monkeypatch.setattr(tvae, "draw_eps", lambda like, eps=None, generator=None:
                        torch.zeros_like(like))
    monkeypatch.setattr(tcurl, "draw_eps", lambda like, eps=None, generator=None:
                        torch.zeros_like(like))
    sd, hyper, _ = _build(family)
    src = str(tmp_path / "ref.model")
    torch.save({"model_state_dict": sd, **hyper}, src)
    dest = str(tmp_path / "imported")
    timport.main([src, dest])
    rs = np.random.RandomState(4)
    egs = build_egs(iter([(f"u{i}", rs.randn(n, ID).astype(np.float32))
                          for i, n in enumerate((11, 7, 9))]), str(tmp_path / "egs"))
    jdump.main([dest, egs, str(tmp_path / "j")])
    tdump.main([dest, egs, str(tmp_path / "p"), "--device", "cpu"])
    got, want = dict(read_ark(str(tmp_path / "p.ark"))), dict(read_ark(str(tmp_path / "j.ark")))
    assert list(got) == list(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= FWD_REL * scale
