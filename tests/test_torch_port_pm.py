"""The hybrid recipes' PM stage (recipes/run_corpus.py stage 6) in the port,
held against the JAX package: infer/pm_score.py, infer/mmeasure.py and
cli/pm_score_cli.py (`pm` and `mmeasure`).

The stage-6 chain runs in the port at small width: an AM (train_am --arch
rnn, 2 x 16 GRU, 5 classes, one epoch over 6-dim egs) -> dump_outputs
log-likelihoods -> build_egs -> train_am --arch pm_ae --loss mse (2 + 2
layers, hidden 16, bn 4) -> pm_score_cli pm; the JAX pm_score_cli then
scores with the port's checkpoints and both pickles are compared. Limits:
scores within 1e-5 relative (float32 GRUs on both sides), m-measures
within 1e-10 relative (float64 numpy on both sides). The JAX side runs on
the CPU with the conftest's x64; the port runs on the CPU.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu import models as J
from speech_recognition_tools_tpu.cli import pm_score_cli as jcli
from speech_recognition_tools_tpu.infer import mmeasure as jmm
from speech_recognition_tools_tpu.infer import pm_score as jpm
from speech_recognition_tools_tpu_torch.cli import dump_outputs, pm_score_cli, train_am
from speech_recognition_tools_tpu_torch.infer import mmeasure as tmm
from speech_recognition_tools_tpu_torch.infer import pm_score as tpm
from speech_recognition_tools_tpu_torch.io.egs import build_egs
from speech_recognition_tools_tpu_torch.io.jax_params import zoo_from_jax
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
from speech_recognition_tools_tpu_torch.models import recurrent as R
from speech_recognition_tools_tpu_torch.models.vae import MissingNoiseError

torch.set_num_threads(1)

D, C, REL = 6, 5, 1e-5
TINY = ["--num_layers", "2", "--hidden_dim", "16", "--bn_dim", "4", "--batch_size", "4",
        "--device", "cpu"]
B, T, LENS = 3, 30, np.array([30, 20, 25])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pm_model():
    """A JAX AutoencoderRNN (2 + 2 x 16, bn 4) over C-dim inputs, its init
    perturbed so that every bias is nonzero, and the port's with it."""
    jm = J.AutoencoderRNN(2, 2, 16, 4)
    x = jnp.zeros((1, 8, C), jnp.float32)
    params = jax.jit(jm.init)({"params": jax.random.key(0)}, x, jnp.asarray([8]))
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
    tm = R.AutoencoderRNN(C, 2, 2, 16, 4)
    tm.load_state_dict(zoo_from_jax(tm, params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("score,loss", [("reconstruction", "mse"), ("reconstruction", "l1"),
                                        ("contrastive", "l1"), ("contrastive", "mse")])
def test_pm_scores_match_jax(pm_model, score, loss):
    """Reconstruction scores, and contrastive ones with their trimming by
    max(time_shifts) and their valid mask at lengths - max_ts - 1."""
    jm, params, tm = pm_model
    seq = np.random.RandomState(2).randn(B, T, C).astype(np.float32)
    js, jl = jnp.asarray(seq), jnp.asarray(LENS)
    ts, tl = torch.tensor(seq), torch.tensor(LENS)
    with torch.no_grad():
        if score == "reconstruction":
            want = jpm.pm_score_reconstruction(jm.apply, params, js, jl, loss)
            got = tpm.pm_score_reconstruction(tm, ts, tl, loss)
        else:
            want = jpm.pm_score_contrastive(jm.apply, params, js, jl, (2, 4), loss)
            got = tpm.pm_score_contrastive(tm, ts, tl, (2, 4), loss)
    assert got.shape == (B,) and _rel(got.numpy(), want) <= REL


def test_mmeasure_matches_jax():
    rs = np.random.RandomState(3)
    mats = [(f"u{i}", rs.randn(n, C) * 2) for i, n in enumerate((100, 40, 7))]
    want = jmm.mmeasure_scores(iter(mats))
    got = tmm.mmeasure_scores(iter(mats))
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-10 * abs(want[k]), k
    probs = [(k, np.exp(m) / np.exp(m).sum(1, keepdims=True)) for k, m in mats]
    got = tmm.mmeasure_scores(iter(probs), (3, 9), add_softmax=False)
    want = jmm.mmeasure_scores(iter(probs), (3, 9), add_softmax=False)
    assert all(abs(got[k] - want[k]) <= 1e-10 * abs(want[k]) for k in want)


@pytest.fixture(scope="module")
def stage6(tmp_path_factory):
    """The stage-6 chain in the port: AM -> loglikes -> PM egs -> pm_ae."""
    root = tmp_path_factory.mktemp("stage6")
    rs = np.random.RandomState(0)
    utts = [(f"u{i}", rs.randn(n, D).astype(np.float32))
            for i, n in enumerate(rs.randint(24, 40, 8))]
    labels = {k: rs.randint(0, C, len(f)) for k, f in utts}
    j = {n: str(root / n) for n in ("egs", "am", "ll", "pm_egs", "pm", "post")}
    build_egs(iter(utts), j["egs"], labels, num_targets=C)
    train_am.main([j["egs"], j["am"], "--arch", "rnn", *TINY, "--epochs", "1"])
    with open(root / "prior.pkl", "wb") as f:
        pickle.dump(np.log(np.full(C, 1.0 / C)), f)
    dump_outputs.main([j["am"], j["egs"], j["ll"], "--prior", str(root / "prior.pkl"),
                       "--device", "cpu"])
    build_egs(read_mat_scp(j["ll"] + ".scp"), j["pm_egs"])
    train_am.main([j["pm_egs"], j["pm"], "--arch", "pm_ae", "--num_layers_dec", "2",
                   "--loss", "mse", *TINY, "--epochs", "1"])
    dump_outputs.main([j["am"], j["egs"], j["post"], "--add_softmax", "--device", "cpu"])
    with open(root / "mean.pkl", "wb") as f:
        pickle.dump(rs.randn(C).astype(np.float32) * 0.1, f)
    j["mean"] = str(root / "mean.pkl")
    j["root"] = root
    return j


def _scores(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("flags", [[], ["--loss", "mse"], ["--contrastive"],
                                   ["--contrastive", "--loss", "mse", "--time_shifts", "2,4"],
                                   ["--cmvn_mean", "<mean>"]],
                         ids=["recon_l1", "recon_mse", "contrastive_l1",
                              "contrastive_mse_shifts", "cmvn_mean"])
def test_pm_score_cli_matches_jax(stage6, flags, tmp_path):
    """pm_score_cli pm over the stage-6 checkpoints: the port's pickle and
    the JAX CLI's hold the same utterances and scores."""
    flags = [stage6["mean"] if f == "<mean>" else f for f in flags]
    args = [stage6["am"], stage6["pm"], stage6["egs"]]
    jcli.main(["pm", *args, str(tmp_path / "j.pkl"), *flags])
    got = pm_score_cli.main(["pm", *args, str(tmp_path / "p.pkl"), *flags, "--device", "cpu"])
    want = _scores(tmp_path / "j.pkl")
    assert _scores(tmp_path / "p.pkl") == got and sorted(got) == sorted(want)
    assert _rel([got[k] for k in want], list(want.values())) <= REL


def test_mmeasure_cli_matches_jax(stage6, tmp_path):
    scp = stage6["post"] + ".scp"
    jcli.main(["mmeasure", scp, str(tmp_path / "j.pkl"), "--delta_list", "3,5,9"])
    pm_score_cli.main(["mmeasure", scp, str(tmp_path / "p.pkl"), "--delta_list", "3,5,9"])
    got, want = _scores(tmp_path / "p.pkl"), _scores(tmp_path / "j.pkl")
    assert list(got) == list(want)
    assert all(abs(got[k] - want[k]) <= 1e-10 * abs(want[k]) for k in want)


@pytest.mark.parametrize("only_ae", [False, True], ids=["sampling", "only_ae"])
def test_vae_pm_raises_in_both_packages_unless_only_ae(stage6, only_ae, tmp_path):
    """chime4_hybrid's PM is a vae: scored without a 'sample' rng, the JAX
    package raises (flax) and so does the port (MissingNoiseError); with
    --only_ae both score, and agree."""
    pm = str(tmp_path / "vae_pm")
    train_am.main([stage6["pm_egs"], pm, "--arch", "vae", *TINY, "--epochs", "0",
                   *(["--only_ae"] if only_ae else [])])
    args = [stage6["am"], pm, stage6["egs"]]
    if not only_ae:
        with pytest.raises(Exception) as err:
            jcli.main(["pm", *args, str(tmp_path / "j.pkl")])
        assert "rng" in str(err.value).lower() or "sample" in str(err.value).lower()
        with pytest.raises(MissingNoiseError):
            pm_score_cli.main(["pm", *args, str(tmp_path / "p.pkl"), "--device", "cpu"])
        return
    jcli.main(["pm", *args, str(tmp_path / "j.pkl")])
    got = pm_score_cli.main(["pm", *args, str(tmp_path / "p.pkl"), "--device", "cpu"])
    want = _scores(tmp_path / "j.pkl")
    assert _rel([got[k] for k in want], list(want.values())) <= REL


def test_stage6_chain_is_whole(stage6):
    """The chain's artefacts: loglike egs of the AM's output width, a PM
    checkpoint of arch pm_ae over it, finite scores for every utterance."""
    from speech_recognition_tools_tpu_torch.io.egs import load_egs
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint

    cfg, utts = load_egs(stage6["pm_egs"])
    assert cfg.feat_dim == C and len(utts) == 8
    _, pm_cfg = load_checkpoint(os.path.join(stage6["pm"], "final"))
    assert pm_cfg["arch"] == "pm_ae" and pm_cfg["feature_dim"] == C
    scores = pm_score_cli.main(["pm", stage6["am"], stage6["pm"], stage6["egs"],
                                str(stage6["root"] / "s.pkl"), "--device", "cpu"])
    assert len(scores) == 8 and all(np.isfinite(v) for v in scores.values())
