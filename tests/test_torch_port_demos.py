"""The port's two demo recipes held against the JAX package's
(recipes/demo/run.py and recipes/reverb_demo/run.py, run in-process through
sys.argv), stage by stage, at small sizes.

Stages that train or simulate draw from torch generators in the port and
from jax.random in JAX (ROADMAP Queue 3, "Randomness in training", "The
simulation's and augmentation's randomness"), so they are held by a stage
handoff: the JAX recipe runs up to stage N, its expdir is copied, and the
port's recipe runs stage N+1 on the copy. Tolerances:
  - demo stages 0 and 2: the wavs, text, ali.pkl, lexicon.txt and the
    clipped labels identical (numpy's RandomState in both);
  - featgen (demo stage 1, reverb_demo stage 4): rtol 1e-3, atol 2e-3 on
    every frame (the FDLP parity bound of tests/test_torch_port_fdlp.py);
    the egs' raw features and CMVN statistics, computed from them, within
    the same bound;
  - demo stage 4 (a handoff after JAX's stage 3): the printed Viterbi and
    argmax FER lines identical;
  - reverb_demo stage 1 (a handoff after JAX's stage 0): the WPE wavs and
    arrays within 1e-6 of their peak (float64 numpy in both, then float32);
  - reverb_demo stage 3 (a handoff after JAX's stage 2): every SE score
    within 1e-9 (float64 host code in both).
"""

import filecmp
import importlib.util
import io
import json
import os
import pickle
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from scipy.io.wavfile import read as wav_read

from speech_recognition_tools_tpu_torch.io.egs import load_egs
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
from speech_recognition_tools_tpu_torch.recipes import demo as pdemo
from speech_recognition_tools_tpu_torch.recipes import reverb_demo as preverb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=1e-3, atol=2e-3)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdemo = _load("jax_demo_run", "recipes/demo/run.py")
jreverb = _load("jax_reverb_demo_run", "recipes/reverb_demo/run.py")


def _run_jax(mod, argv, monkeypatch):
    """The JAX recipe's main() reads sys.argv; returns its stdout."""
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _run_port(mod, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(argv + ["--device", "cpu"])
    return buf.getvalue()


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _feats_close(got_scp, want_scp):
    got, want = dict(read_mat_scp(got_scp)), dict(read_mat_scp(want_scp))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **FEAT_TOL)


def _fer_lines(out):
    return [line for line in out.splitlines() if "FER" in line]


# ------------------------------------------------------------------- demo


DEMO = ["--num_utts", "3"]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The JAX demo's stages 0-4 (copies after stage 2 and after stage 3)
    and the port's stages 0-2 in a directory of their own."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("demo")
    jexp, pexp = str(root / "jax"), str(root / "port")
    try:
        _run_jax(jdemo, ["--expdir", jexp, "--stage", "0", "--stop_stage", "2"] + DEMO, mp)
        _run_jax(jdemo, ["--expdir", jexp, "--stage", "3", "--stop_stage", "3"] + DEMO, mp)
        after3 = _copy(jexp, str(root / "after3"))
        out4 = _run_jax(jdemo, ["--expdir", jexp, "--stage", "4", "--stop_stage", "4"]
                        + DEMO, mp)
    finally:
        mp.undo()
    _run_port(pdemo, ["--expdir", pexp, "--stage", "0", "--stop_stage", "2"] + DEMO)
    return dict(root=root, jax=jexp, port=pexp, after3=after3, out4=out4)


def test_demo_stage0_data_is_identical(demo):
    names = sorted(os.listdir(demo["jax"]))
    for f in ("utt0.wav", "utt1.wav", "utt2.wav", "text", "lexicon.txt"):
        assert f in names
        assert filecmp.cmp(os.path.join(demo["port"], f), os.path.join(demo["jax"], f),
                           shallow=False), f
    for f in ("ali.pkl", "labels.pkl"):
        with open(os.path.join(demo["port"], f), "rb") as a, \
                open(os.path.join(demo["jax"], f), "rb") as b:
            got, want = pickle.load(a), pickle.load(b)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with open(os.path.join(demo["port"], "wav.scp")) as a, \
            open(os.path.join(demo["jax"], "wav.scp")) as b:
        assert a.read().replace(demo["port"], "") == b.read().replace(demo["jax"], "")


def test_demo_stages1_2_features_and_egs_match_jax(demo):
    _feats_close(os.path.join(demo["port"], "fdlp.scp"), os.path.join(demo["jax"], "fdlp.scp"))
    gcfg, gutts = load_egs(os.path.join(demo["port"], "egs"))
    wcfg, wutts = load_egs(os.path.join(demo["jax"], "egs"))
    assert gcfg.num_targets == wcfg.num_targets and gcfg.feat_dim == wcfg.feat_dim
    np.testing.assert_allclose(gcfg.cmvn_mean, wcfg.cmvn_mean, **FEAT_TOL)
    np.testing.assert_allclose(gcfg.cmvn_std, wcfg.cmvn_std, **FEAT_TOL)
    assert [u[0] for u in gutts] == [u[0] for u in wutts]
    for (_, gf, gl), (_, wf, wl) in zip(gutts, wutts):
        np.testing.assert_allclose(gf, wf, **FEAT_TOL)
        np.testing.assert_array_equal(gl, wl)


def test_demo_stage4_fer_by_handoff_matches_jax(demo):
    exp = _copy(demo["after3"], str(demo["root"] / "p4"))
    out = _run_port(pdemo, ["--expdir", exp, "--stage", "4", "--stop_stage", "4"] + DEMO)
    got, want = _fer_lines(out), _fer_lines(demo["out4"])
    assert len(want) == 2 and got == want, (got, want)


def test_demo_port_stages_3_to_6_run(demo):
    """The port's own stages 3-6 on its stage-2 output: AM, FER, PM and
    adaptation, then the WFST decode."""
    exp = _copy(demo["port"], str(demo["root"] / "p36"))
    out = _run_port(pdemo, ["--expdir", exp, "--stage", "3"] + DEMO)
    assert len(_fer_lines(out)) == 2 and "PM scores for 3 utts" in out
    for f in ("am/final", "prior.pkl", "loglikes.ark", "pm/final", "adapted",
              "pm.score", "graph/HCLG.txt", "hyp.txt"):
        assert os.path.exists(os.path.join(exp, f)), f
    assert out.rstrip().endswith("demo recipe done")


# ------------------------------------------------------------ reverb demo


REVERB = ["--num_utts", "3", "--num_channels", "2", "--srate", "8000",
          "--stft_size", "256", "--stft_shift", "64", "--words_per_utt", "2",
          "--masknet_epochs", "4", "--e2e_epochs", "1"]


@pytest.fixture(scope="module")
def reverb(tmp_path_factory):
    """The JAX reverb demo's stages 0-4, with copies after stages 0, 2
    and 3."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("reverb")
    jexp = str(root / "jax")
    copies = {}
    try:
        for stage in range(5):
            _run_jax(jreverb, ["--expdir", jexp, "--stage", str(stage), "--stop_stage",
                               str(stage)] + REVERB, mp)
            if stage in (0, 2, 3):
                copies[stage] = _copy(jexp, str(root / f"after{stage}"))
    finally:
        mp.undo()
    return dict(root=root, jax=jexp, after=copies)


def test_reverb_stage1_wpe_by_handoff_matches_jax(reverb):
    exp = _copy(reverb["after"][0], str(reverb["root"] / "p1"))
    _run_port(preverb, ["--expdir", exp, "--stage", "1", "--stop_stage", "1"] + REVERB)
    with open(os.path.join(exp, "wpe.scp")) as f:
        utts = [line.split()[0] for line in f if line.strip()]
    assert utts == ["utt0", "utt1", "utt2"]
    for u in utts:
        got = np.load(os.path.join(exp, "wpe", f"{u}.wav.npy"))
        want = np.load(os.path.join(reverb["jax"], "wpe", f"{u}.wav.npy"))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        sr, gw = wav_read(os.path.join(exp, "wpe", f"{u}.wav"))
        _, ww = wav_read(os.path.join(reverb["jax"], "wpe", f"{u}.wav"))
        assert sr == 8000 and gw.dtype == ww.dtype
        assert np.abs(gw - ww).max() <= 1e-6 * np.abs(ww).max()


def test_reverb_stage3_metrics_by_handoff_match_jax(reverb):
    exp = _copy(reverb["after"][2], str(reverb["root"] / "p3"))
    _run_port(preverb, ["--expdir", exp, "--stage", "3", "--stop_stage", "3"] + REVERB)
    with open(os.path.join(exp, "se_scores.json")) as f:
        got = json.load(f)
    with open(os.path.join(reverb["jax"], "se_scores.json")) as f:
        want = json.load(f)
    assert list(got) == list(want) == ["noisy", "enhanced"]
    for label in want:
        assert list(got[label]) == list(want[label])
        for k, v in want[label].items():
            if v is None:
                assert got[label][k] is None, (label, k)
            else:
                assert abs(got[label][k] - v) <= 1e-9, (label, k, got[label][k], v)


def test_reverb_stage4_features_by_handoff_match_jax(reverb):
    exp = _copy(reverb["after"][3], str(reverb["root"] / "p4"))
    _run_port(preverb, ["--expdir", exp, "--stage", "4", "--stop_stage", "4"] + REVERB)
    _feats_close(os.path.join(exp, "fdlp.scp"), os.path.join(reverb["jax"], "fdlp.scp"))


def test_reverb_port_stages_run_with_the_jax_layout(reverb):
    """The port's own stages 0-5 (its simulation draws from torch
    generators): the JAX recipe's files and scps, finite SE scores, a
    hypothesis file."""
    exp = str(reverb["root"] / "port")
    out = _run_port(preverb, ["--expdir", exp] + REVERB)
    assert sorted(os.listdir(os.path.join(exp, "wav"))) == sorted(
        os.listdir(os.path.join(reverb["jax"], "wav")))
    for f in ("wpe.scp", "enhanced.scp", "se_scores.json", "fdlp.scp", "hyp.text"):
        assert os.path.exists(os.path.join(exp, f)), f
    with open(os.path.join(exp, "se_scores.json")) as f:
        scores = json.load(f)
    assert all(np.isfinite(scores[lab][k]) for lab in scores for k in scores[lab]
               if scores[lab][k] is not None)
    assert out.rstrip().endswith("reverb_demo recipe done")
