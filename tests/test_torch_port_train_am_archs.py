"""train_am, dump_outputs and tandem_feats of the port held against the JAX
package's CLIs for the recurrent half of the zoo: the 14 archs and their
flags (--loss, --only_ae, --use_transformer, --time_shift, --frame_egs,
--multi_egs_dirs, --base_model, --expand_from).

For each case the port writes the initial checkpoint (train_am.main
--epochs 0, then its init saved as epoch_0 with Adam's initial state in
optax's layout), both CLIs resume from it for one epoch of 2 batches (so
the JAX CLI reads the port's checkpoint), and their histories, final
weights and optimizer-state trees are compared; then the JAX
dump_outputs reads the port's checkpoint and gives the port's ark, and
the port's dump_outputs reads the JAX CLI's. Where an arch samples, both
packages get the same fed noise (a fixed function of the latent's shape,
monkeypatched over jax.random's and the port's draws), and curl_unsup the
same prior means. The runs train with sgd at lr 0.1, two
cases with adadelta and adagrad: Adam's first update lr * g / (|g| + eps)
(and rmsprop's, g / sqrt(0.1 g^2 + 1e-8)) turns float32 rounding of
gradients near eps into weight differences up to lr, which would hide
everything else (tests/test_torch_port_optim.py holds every optimizer to
optax in float64). Limits: losses within 1e-5 relative, final weights
within 1e-5 of the tree's scale (its max |value|), arks within 1e-5 of
their scale on the same checkpoint and 1e-4 across the two packages'
checkpoints. Widths: 2 layers, hidden 16,
bn 4, 2 components, 6-dim features, 5 classes (the transformer VAE:
16-dim features and bn 16, for flax's 16 heads). Everything runs on the
CPU; the JAX side with the conftest's x64.
"""

import argparse
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.cli import dump_outputs as jdump
from speech_recognition_tools_tpu.cli import tandem_feats as jtandem
from speech_recognition_tools_tpu.cli import train_am as jtrain
from speech_recognition_tools_tpu.models import curl as jcurl
from speech_recognition_tools_tpu.models import vae as jvae
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import dump_outputs as tdump
from speech_recognition_tools_tpu_torch.cli import tandem_feats as ttandem
from speech_recognition_tools_tpu_torch.cli import train_am as ttrain
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io.jax_params import optim_state_to_jax
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark
from speech_recognition_tools_tpu_torch.models import curl as tcurl
from speech_recognition_tools_tpu_torch.models import vae as tvae
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt
from speech_recognition_tools_tpu_torch.train.optim import RULES

torch.set_num_threads(1)

D, C, N_UTTS, BATCH, LR = 6, 5, 9, 4, 0.1
LOSS_REL, WEIGHT_REL, ARK_REL, ARK_CROSS_REL = 1e-5, 1e-5, 1e-5, 1e-4
TINY = ["--num_layers", "2", "--hidden_dim", "16", "--bn_dim", "4", "--batch_size", str(BATCH),
        "--optimizer", "sgd", "--learning_rate", str(LR)]
# case -> (train_am flags, egs dir name, dump_outputs flags or None: no dump)
CASES = {
    "linear": (["--arch", "linear"], "egs", []),
    "feedforward": (["--arch", "feedforward"], "egs", ["--layer", "1"]),
    "feedforward_frame_egs": (["--arch", "feedforward", "--frame_egs", "--batch_size", "48"],
                              "frame_egs", None),
    "multitask_ae": (["--arch", "multitask_ae", "--optimizer", "adadelta"], "egs", []),
    "multitask_aear": (["--arch", "multitask_aear", "--time_shift", "2"], "egs", []),
    "multimod": (["--arch", "multimod"], "egs", []),
    "multimod_multi_egs_dirs": (["--arch", "multimod", "--multi_egs_dirs", "<egs4>"], "egs",
                                ["--multi_egs_dirs", "<egs4>"]),
    "vae": (["--arch", "vae"], "egs", []),
    "vae_only_ae_laplace": (["--arch", "vae", "--only_ae", "--loss", "vae_laplace"], "egs", []),
    "vae_transformer": (["--arch", "vae", "--use_transformer", "--bn_dim", "16"], "egs16", []),
    "vae_classifier": (["--arch", "vae_classifier"], "egs", []),
    "arvae": (["--arch", "arvae", "--time_shift", "3"], "egs", None),
    "vae_encoded": (["--arch", "vae_encoded", "--base_model", "<vae>"], "egs", []),
    "pm_ae": (["--arch", "pm_ae", "--num_layers_dec", "2", "--loss", "mse", "--optimizer",
               "adagrad"], "egs", []),
    "pm_ae_time_shift": (["--arch", "pm_ae", "--time_shift", "2"], "egs", []),
    "apc": (["--arch", "apc", "--time_shift", "2"], "egs", []),
    "curl": (["--arch", "curl"], "egs", []),
    "curl_expand_from": (["--arch", "curl", "--expand_from", "<curl>"], "egs", []),
    "curl_unsup": (["--arch", "curl_unsup"], "egs", None),
    "curl_encoded": (["--arch", "curl_encoded", "--base_model", "<curl>"], "egs", []),
}
CONV_ARCHS = ["cnn", "cldnn", "vae_cnn", "vae_cnn_pool", "rs_vae", "modnet", "modnet_sigmoid"]


def _noise(shape):
    """The fed noise: a fixed function of the latent's shape."""
    n = int(np.prod(shape))
    return (1.3 * np.sin(0.7 * np.arange(n) + 0.3)).reshape(shape).astype(np.float32)


MEAN_P = np.random.RandomState(5).randn(8, 16).astype(np.float32)


@pytest.fixture
def fed_noise(monkeypatch):
    """Both packages' latent draws replaced by _noise, curl_unsup's prior
    means by MEAN_P."""
    def jsample(key, means, logvars):
        return means + jnp.exp(logvars) * jnp.asarray(_noise(means.shape), means.dtype)

    def tdraw(like, eps=None, generator=None):
        return torch.tensor(_noise(tuple(like.shape)), dtype=like.dtype, device=like.device)

    monkeypatch.setattr(jvae, "sample_latent", jsample)
    monkeypatch.setattr(jcurl, "sample_curl_latent", jsample)
    monkeypatch.setattr(jcurl, "random_mixture_means",
                        lambda key, k, bn, scale=1.0: jnp.asarray(MEAN_P[:k, :bn]))
    monkeypatch.setattr(tvae, "draw_eps", tdraw)
    monkeypatch.setattr(tcurl, "draw_eps", tdraw)
    monkeypatch.setattr(tcurl, "random_mixture_means",
                        lambda k, bn, generator, scale=1.0: torch.tensor(MEAN_P[:k, :bn]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Egs dirs built by the port (the JAX format): 9 utterances of 8-20
    frames (6-dim; a parallel 4-dim stream; 16-dim), frame-level egs with
    context 1, labels over 5 classes."""
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    lens = rs.randint(8, 21, N_UTTS)
    utts = [(f"u{i}", rs.randn(n, D).astype(np.float32)) for i, n in enumerate(lens)]
    labels = {k: rs.randint(0, C, len(f)) for k, f in utts}
    out = {"root": root}
    out["egs"] = tegs.build_egs(iter(utts), str(root / "egs"), labels, num_targets=C)
    out["egs4"] = tegs.build_egs(((k, rs.randn(len(f), 4).astype(np.float32)) for k, f in utts),
                                 str(root / "egs4"), labels, num_targets=C)
    out["egs16"] = tegs.build_egs(((k, rs.randn(len(f), 16).astype(np.float32))
                                   for k, f in utts), str(root / "egs16"), labels,
                                  num_targets=C)
    out["frame_egs"] = tegs.build_frame_egs(iter(utts), str(root / "frame_egs"), labels,
                                            context=1, num_targets=C)
    assert sum(lens) // 48 == 2  # --batch_size 48: two frame batches
    return out


def _fill(argv, data, bases):
    return [data[a[1:-1]] if a.startswith("<") and a[1:-1] in data
            else bases[a[1:-1]] if a.startswith("<") else a for a in argv]


def _initial(argv, egs, dest, tmp):
    """The initial checkpoint, written by the port: its init (train_am.main
    --epochs 0) saved in `dest` as epoch_0 with the optimizer's initial
    state in optax's layout (io/jax_params.py), as an interrupted run
    leaves it. The JAX CLI resumes from it, so it reads the port's
    checkpoint."""
    init = str(tmp / (os.path.basename(dest) + "_init"))
    ttrain.main([egs, init, *argv, "--epochs", "0", "--device", "cpu"])
    payload, cfg = tckpt.load_checkpoint(os.path.join(init, "final"))
    cfg.pop("extra", None)
    params = payload["params"]
    name = ttrain.get_parser().parse_args([egs, init, *argv]).optimizer
    fill = 0.1 if name == "adagrad" else 0.0  # optax's initial accumulator
    slots = ("mu", "nu") if name == "adam" else RULES[name]
    state = {s: jax.tree.map(lambda a: np.full_like(a, fill), params) for s in slots}
    opt = optim_state_to_jax(dict(state, count=0, learning_rate=LR), lambda tree: tree,
                             name=name, clip=True)
    tckpt.save_checkpoint(dest, "epoch_0", params, cfg, opt_state=opt,
                          extra={"epoch": 0, "lr": LR})
    return dest


def _base(name, data, tmp):
    """A frozen base (vae, curl) for --base_model / --expand_from: the
    port's init of that arch, which both packages read."""
    store = str(tmp / f"base_{name}")
    ttrain.main([data["egs"], store, "--arch", name, *TINY, "--epochs", "0", "--device", "cpu"])
    return store


def _tree_rel(got, want):
    """max |got - want| over the tree's scale (its max |value|): a leaf
    whose gradient vanishes (the attention's key bias) is rounding noise in
    both packages and has no scale of its own."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_g) == set(flat_w)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in flat_w.values())
    return max(float(np.abs(np.asarray(flat_g[k]) - np.asarray(v)).max())
               for k, v in flat_w.items()) / scale


def _arks_rel(a, b):
    ga, gb = dict(read_ark(a)), dict(read_ark(b))
    assert list(ga) == list(gb)
    scale = max(float(np.abs(v).max()) for v in gb.values())
    return max(float(np.abs(ga[k] - gb[k]).max()) for k in gb) / scale


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_am_and_dump_outputs_match_jax(case, data, fed_noise, tmp_path):
    flags, egs_name, dump_flags = CASES[case]
    bases = {}
    if "<vae>" in flags:
        bases["vae"] = _base("vae", data, tmp_path)
    if "<curl>" in flags:
        bases["curl"] = _base("curl", data, tmp_path)
    argv = _fill(TINY + flags, data, bases)
    egs = data[egs_name]
    store_j = _initial(argv, egs, str(tmp_path / "jax"), tmp_path)
    store_p = str(tmp_path / "port")
    shutil.copytree(store_j, store_p)

    jtrain.main([egs, store_j, *argv, "--epochs", "1"])
    st = ttrain.main([egs, store_p, *argv, "--epochs", "1", "--device", "cpu"])
    pay_j, cfg_j = jckpt.load_checkpoint(os.path.join(store_j, "final"))
    pay_p, cfg_p = jckpt.load_checkpoint(os.path.join(store_p, "final"))
    hist_j = cfg_j["extra"]["history"]
    assert len(hist_j) == len(st.history) == 1 and st.epoch == 1
    for key in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(st.history[0][key], hist_j[0][key], rtol=LOSS_REL)
    assert _tree_rel(pay_p["params"], pay_j["params"]) <= WEIGHT_REL
    for k in ("arch", "model_class", "feature_dim", "num_classes", "comp_num"):
        assert cfg_p[k] == cfg_j[k], k
    # the epoch checkpoint's optimizer state, in optax's layout
    opt_j = jckpt.load_checkpoint(os.path.join(store_j, "epoch_1"))[0]["opt_state"]
    opt_p = jckpt.load_checkpoint(os.path.join(store_p, "epoch_1"))[0]["opt_state"]
    assert jax.tree.structure(opt_p) == jax.tree.structure(opt_j)
    if dump_flags is None:
        return
    # the JAX dump_outputs reads the port's checkpoint and gives the port's
    # ark; the port reads the JAX CLI's (weights within WEIGHT_REL of it)
    dump = _fill(dump_flags, data, bases)
    o = {n: str(tmp_path / n) for n in ("Jp", "Pp", "Pj")}
    jdump.main([store_p, egs, o["Jp"], *dump])
    tdump.main([store_p, egs, o["Pp"], *dump, "--device", "cpu"])
    tdump.main([store_j, egs, o["Pj"], *dump, "--device", "cpu"])
    assert _arks_rel(o["Pp"] + ".ark", o["Jp"] + ".ark") <= ARK_REL
    assert _arks_rel(o["Pj"] + ".ark", o["Jp"] + ".ark") <= ARK_CROSS_REL


@pytest.mark.parametrize("arch", ["arvae", "curl_unsup"])
def test_stacked_generative_outputs_fail_in_both_dumps(arch, data, tmp_path):
    """arvae and curl_unsup put their decoders' axis first, and the JAX
    dump_outputs indexes that axis by utterance: with more utterances in a
    batch than decoders both packages raise IndexError (ROADMAP Queue 3)."""
    store = str(tmp_path / arch)
    jtrain.main([data["egs"], store, "--arch", arch, *TINY, "--epochs", "0"])
    with pytest.raises(IndexError):
        jdump.main([store, data["egs"], str(tmp_path / "j")])
    with pytest.raises(IndexError):
        tdump.main([store, data["egs"], str(tmp_path / "p"), "--device", "cpu"])


@pytest.mark.parametrize("layer", [1, 2])
def test_feedforward_layer_taps_match_jax(layer, data, tmp_path):
    """--layer k writes the k-th pre-ReLU embedding from the end."""
    store = str(tmp_path / "ff")
    jtrain.main([data["egs"], store, "--arch", "feedforward", *TINY, "--epochs", "0"])
    jdump.main([store, data["egs"], str(tmp_path / "j"), "--layer", str(layer)])
    tdump.main([store, data["egs"], str(tmp_path / "p"), "--layer", str(layer),
                "--device", "cpu"])
    assert _arks_rel(str(tmp_path / "p.ark"), str(tmp_path / "j.ark")) <= ARK_REL
    with pytest.raises(IndexError):
        tdump.main([store, data["egs"], str(tmp_path / "p"), "--layer", "3", "--device", "cpu"])


@pytest.mark.parametrize("tandem_type", ["softmax", "presoftmax"])
def test_tandem_feats_match_jax(tandem_type, data, tmp_path):
    """tandem_feats --get_pca: the posterior ark, the PCA pickle and the
    projected ark agree (1e-5 of their scale; the PCA transform up to each
    row's sign, which eigh leaves free)."""
    store = str(tmp_path / "am")
    jtrain.main([data["egs"], store, "--arch", "multitask_ae", *TINY, "--epochs", "0"])
    flags = ["--tandem_type", tandem_type, "--get_pca", "--pca_dim", "3"]
    jtandem.main([store, data["egs"], str(tmp_path / "j"), *flags])
    ttandem.main([store, data["egs"], str(tmp_path / "p"), *flags, "--device", "cpu"])
    assert _arks_rel(str(tmp_path / "p.ark"), str(tmp_path / "j.ark")) <= ARK_REL
    with open(tmp_path / "p_pca.pkl", "rb") as f:
        pca_p = pickle.load(f)
    with open(tmp_path / "j_pca.pkl", "rb") as f:
        pca_j = pickle.load(f)
    sign = np.sign(np.sum(pca_p["transform"] * pca_j["transform"], axis=1, keepdims=True))
    np.testing.assert_allclose(pca_p["transform"] * sign, pca_j["transform"], atol=1e-4)
    np.testing.assert_allclose(pca_p["mean"], pca_j["mean"], rtol=1e-5, atol=1e-6)
    proj_p, proj_j = dict(read_ark(str(tmp_path / "p_pca.ark"))), dict(
        read_ark(str(tmp_path / "j_pca.ark")))
    for k in proj_j:
        np.testing.assert_allclose(proj_p[k] * sign[:, 0], proj_j[k], atol=1e-4)


@pytest.mark.parametrize("arch", CONV_ARCHS)
def test_conv_half_still_raises(arch, data, tmp_path):
    """Named for the refusal it held until the conv half was ported. Each
    conv arch now trains for one epoch in the port (--patch_width 5: these
    utterances are 8-20 frames) into a checkpoint that the JAX package
    restores into its own model's template, and dump_outputs writes one
    row per frame of every utterance (tests/test_torch_port_conv_zoo.py
    holds both to the JAX package). --data_parallel and --expert_parallel
    still raise NotImplementedError naming item 5."""
    store = str(tmp_path / arch)
    st = ttrain.main([data["egs"], store, "--arch", arch, *TINY, "--patch_width", "5",
                      "--epochs", "1", "--device", "cpu"])
    assert len(st.history) == 1
    payload, cfg = jckpt.load_checkpoint(os.path.join(store, "final"))
    model = jtrain.build_model(argparse.Namespace(**cfg), D, C)
    x = jnp.zeros((2, 1, D, 5 if arch in ttrain.PATCH_ARCHS else 12), jnp.float32)
    extra = (jnp.array([12, 7]),) if arch == "cldnn" else ()
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1),
            "gumbel": jax.random.key(2)}
    template = model.init(rngs, x, *extra)
    restored, _ = jckpt.load_checkpoint(os.path.join(store, "final"),
                                        template={"params": template})
    assert jax.tree.structure(restored["params"]) == jax.tree.structure(template)
    assert jax.tree.map(np.shape, restored["params"]) == jax.tree.map(np.shape, template)
    got = tdump.main([store, data["egs"], str(tmp_path / "o"), "--device", "cpu"])
    _, utts = tegs.load_egs(data["egs"])
    width = 4 if arch in ("vae_cnn", "vae_cnn_pool", "rs_vae") else C
    assert {k: v.shape for k, v in got.items()} == {k: (len(f), width) for k, f, _ in utts}
    for bad in (["--data_parallel"], ["--expert_parallel", "2"]):
        with pytest.raises(NotImplementedError, match="item 5"):
            ttrain.main([data["egs"], str(tmp_path / "y"), *TINY, *bad, "--device", "cpu"])
