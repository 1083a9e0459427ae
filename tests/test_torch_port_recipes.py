"""The port's corpus driver (recipes/run_corpus.py), its synthetic corpus
generator, the babysitter and the device prefetch held against the JAX
package's, stage by stage, on the synthetic corpus of
tests/test_run_corpus.py (8 kHz, a 1 x 48 GRU, a tiny transformer).

Every stage that trains starts from weights drawn by torch generators in
the port and by jax.random in JAX (ROADMAP Queue 3, "Randomness in
training"), so a whole run cannot agree after the first stage that
trains. The later stages are held by the drivers' own --stage resume
contract ("stage handoff"): the JAX driver runs up to stage N, its expdir
is copied, and the port driver runs stage N+1 on the copy, to be compared
with what the JAX driver's own stage N+1 wrote. Each JAX driver runs once
per module (module-scoped fixtures). Tolerances:
  - stage 1 features: rtol 1e-3, atol 2e-3 on every frame (the FDLP parity
    bound of tests/test_torch_port_fdlp.py: float32 in another order);
  - stage 2 (a handoff after JAX's stage 1): egs labels and keys
    identical, CMVN statistics within 1e-6 relative, the e2e dict
    identical;
  - stage 3: the ARPA file identical once gunzipped;
  - stage 5 (a handoff after JAX's stage 4): the log-likelihood arks
    within 1e-5 of their scale (max |value|), hypotheses, RESULTS and
    hyp_*.txt identical;
  - stage 6 (a handoff after JAX's stage 6 without its final PM
    checkpoint and scores: train_am resumes at the last epoch's
    checkpoint and trains no further): PM scores within 1e-5 relative;
  - stage 4's serving.json identical and cmvn.npz's arrays identical;
  - the synthetic corpus: byte-identical files.
"""

import filecmp
import glob
import gzip
import importlib.util
import io
import json
import os
import pickle
import shutil
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import test_run_corpus as trc
from speech_recognition_tools_tpu_torch.cli import babysit as pbabysit
from speech_recognition_tools_tpu_torch.io.egs import load_egs
from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_mat_scp
from speech_recognition_tools_tpu_torch.io.prefetch import prefetch_to_device
from speech_recognition_tools_tpu_torch.recipes import make_synth_corpus as pmsc
from speech_recognition_tools_tpu_torch.recipes import run_corpus as prc

torch.set_num_threads(1)

REPO = trc.REPO
jrc = trc.run_corpus  # the JAX driver, recipes/run_corpus.py
CONFIGS = sorted(glob.glob(os.path.join(REPO, "recipes", "configs", "*.json")))
HYB = os.path.join(REPO, "recipes/configs/timit_hybrid.json")
E2E = os.path.join(REPO, "recipes/configs/wsj_fdlp_e2e.json")
FEAT_TOL = dict(rtol=1e-3, atol=2e-3)
LL_REL = 1e-5

HYB_SET = [
    "--set", "frontend.srate=8000",
    "--set", "am.num_layers=1", "--set", "am.hidden_dim=48",
    "--set", "am.epochs=2", "--set", "am.batch_size=4",
    "--set", "decode.acoustic_scale=0.5", "--set", "decode.beam=24",
    "--set", "pm.hidden_dim=16", "--set", "pm.bn_dim=8",
    "--set", "pm.num_layers_enc=1", "--set", "pm.num_layers_dec=1",
    "--set", "pm.epochs=1",
]
E2E_SET = [
    "--set", "frontend.srate=8000", "--set", "frontend.nfilters=20",
    "--set", "frontend.fduration=0.5", "--set", "frontend.order=50",
    "--set", "frontend.coeff_num=50", "--set", "frontend.coeff_range=1,20",
    "--set", "am.adim=32", "--set", "am.aheads=2",
    "--set", "am.elayers=1", "--set", "am.eunits=32",
    "--set", "am.dlayers=1", "--set", "am.dunits=32",
    "--set", "am.epochs=1", "--set", "am.batch_size=4",
    "--set", "am.warmup_steps=50", "--set", "am.average_last=1",
    "--set", "lm.units=16", "--set", "lm.epochs=1",
    "--set", "decode.beam_size=2", "--set", "decode.max_len=12",
]


def _args(config, data, exp, sets, *stage):
    argv = ["--config", config, "--data", data, "--expdir", exp] + sets
    if stage:
        argv += ["--stage", str(stage[0]), "--stop_stage", str(stage[-1])]
    return argv


def _port(config, data, exp, sets, *stage):
    return prc.main(_args(config, data, exp, sets, *stage) + ["--device", "cpu"])


def _copy(src, dst):
    shutil.copytree(src, dst)  # copy2: file and dir mtimes kept
    return dst


def _ark(exp, stem):
    return dict(read_mat_scp(os.path.join(exp, stem + ".scp")))


def _same_text(a, b):
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read(), (a, b)


def _egs(path):
    """{utt: (feats, labels or None)} and the egs.config dict."""
    _, utts = load_egs(path)
    with open(os.path.join(path, "egs.config")) as f:
        return {k: (f_, lab) for k, f_, lab in utts}, json.load(f)


def _assert_egs_match(got_dir, want_dir):
    got, gcfg = _egs(got_dir)
    want, wcfg = _egs(want_dir)
    assert {k for k in gcfg if k not in ("cmvn_mean", "cmvn_std")} == \
        {k for k in wcfg if k not in ("cmvn_mean", "cmvn_std")}
    for k, v in wcfg.items():
        if k in ("cmvn_mean", "cmvn_std") and v is not None:
            np.testing.assert_allclose(gcfg[k], v, rtol=1e-6, atol=0)
        else:
            assert gcfg[k] == v, k
    return got, want


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("s", ["am.epochs=3", "a.b=0.5", "a.b=true", "a.b=false",
                               "a.b=null", "a.b=None", "a.b=mel,1", "a.b=", "a.b.c=-2",
                               "x=1e-3", "enhancement.se_metrics=stoi,srmr"])
def test_parse_and_apply_override_match_jax(s):
    assert prc.parse_override(s) == jrc.parse_override(s)
    cfg_p, cfg_j = {"am": {"epochs": 50}}, {"am": {"epochs": 50}}
    prc.apply_override(cfg_p, *prc.parse_override(s))
    jrc.apply_override(cfg_j, *jrc.parse_override(s))
    assert cfg_p == cfg_j


@pytest.mark.parametrize("config", CONFIGS, ids=os.path.basename)
def test_frontend_argv_matches_jax(config, tmp_path):
    with open(config) as f:
        fe = json.load(f)["frontend"]
    d = str(tmp_path)
    assert prc.frontend_argv(fe, "a/wav.scp", "o/feats", d) == \
        jrc.frontend_argv(fe, "a/wav.scp", "o/feats", d)
    open(os.path.join(d, "segments"), "w").close()
    got = prc.frontend_argv(fe, "a/wav.scp", "o/feats", d)
    assert got == jrc.frontend_argv(fe, "a/wav.scp", "o/feats", d)
    assert got[1][:1] == [os.path.join(d, "segments")]


@pytest.mark.parametrize("cli", ["compute_fdlp_spectrogram", "compute_mel_spectrum",
                                 "compute_mfcc", "compute_modulation_spectrum", "train_lm",
                                 "train_ngram", "train_e2e", "train_am", "recog_e2e",
                                 "compute_prior", "decode_wfst", "dump_outputs",
                                 "pm_score_cli", "adapt_am"])
def test_port_clis_accept_every_jax_flag(cli):
    """Every flag of the JAX CLIs the drivers call (and so every flag the
    JAX drivers pass) is one the port's CLI accepts."""
    import importlib

    def opts(parser):
        out = set()
        for a in parser._actions:
            out.update(a.option_strings)
            if isinstance(getattr(a, "choices", None), dict):
                for name, sub in a.choices.items():
                    out.update(f"{name}:{o}" for o in opts(sub))
        return out

    j = importlib.import_module("speech_recognition_tools_tpu.cli." + cli)
    t = importlib.import_module("speech_recognition_tools_tpu_torch.cli." + cli)
    assert opts(j.get_parser()) <= opts(t.get_parser())


def test_check_data_matches_jax(tmp_path, capsys):
    """--check_data prints the same READY / NOTE / PROBLEM lines and exits
    with the same code, on the corpus variants of
    test_run_corpus.py::test_check_data_preflight."""
    data = str(tmp_path / "data")
    trc._make_corpus(data)
    common = ["--config", HYB, "--data", data, "--expdir", str(tmp_path / "exp")]

    def both(argv):
        outs = []
        for mod in (jrc, prc):
            try:
                rc = mod.main(argv)
            except SystemExit as e:
                rc = ("exit", e.code)
            outs.append((rc, capsys.readouterr().out))
        assert outs[0] == outs[1], outs
        return outs[0]

    good = common + ["--check_data", "--set", "frontend.srate=8000"]
    rc, out = both(good)
    assert rc == [] and "READY" in out
    assert not os.path.exists(str(tmp_path / "exp"))
    rc, out = both(common + ["--check_data"])
    assert rc == ("exit", 1) and "sample rate" in out
    os.remove(os.path.join(data, "dev", "ali.pkl"))
    rc, out = both(good)
    assert "dev egs would be built without labels" in out
    os.remove(os.path.join(data, "test", "text"))
    os.remove(os.path.join(data, "train", "ali.pkl"))
    os.remove(os.path.join(data, "lexicon.txt"))
    rc, out = both(good)
    assert "missing text" in out and "forced alignment" in out
    rc, out = both(["--config", os.path.join(REPO, "recipes/configs/reverb_fdlp_e2e.json"),
                    "--data", data, "--expdir", str(tmp_path / "exp"), "--check_data",
                    "--stage", "2"])
    assert rc == ("exit", 1)


# ---------------------------------------------------------- hybrid branch


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """The JAX driver's hybrid branch, stages 1-6; copies of its expdir
    after stage 1 and after stage 4, and the port's own stages 1 and 3."""
    root = tmp_path_factory.mktemp("hybrid")
    data = str(root / "data")
    trc._make_corpus(data)
    jexp = str(root / "jax")
    jrc.main(_args(HYB, data, jexp, HYB_SET, 1, 1))
    after1 = _copy(jexp, str(root / "after1"))
    jrc.main(_args(HYB, data, jexp, HYB_SET, 2, 4))
    after4 = _copy(jexp, str(root / "after4"))
    jrc.main(_args(HYB, data, jexp, HYB_SET, 5, 6))
    pexp = str(root / "port")
    _port(HYB, data, pexp, HYB_SET, 1, 1)
    _port(HYB, data, pexp, HYB_SET, 3, 3)
    return dict(root=root, data=data, jax=jexp, after1=after1, after4=after4, port=pexp)


def test_hybrid_stage1_features_match_jax(hybrid):
    for name in ("train", "dev", "test"):
        got = _ark(hybrid["port"], f"feats_{name}")
        want = _ark(hybrid["jax"], f"feats_{name}")
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], **FEAT_TOL)


def test_hybrid_stage2_by_handoff_matches_jax(hybrid):
    exp = _copy(hybrid["after1"], str(hybrid["root"] / "p2"))
    _port(HYB, hybrid["data"], exp, HYB_SET, 2, 2)
    for name in ("train", "dev", "test"):
        got, want = _assert_egs_match(os.path.join(exp, f"egs_{name}"),
                                      os.path.join(hybrid["jax"], f"egs_{name}"))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-6, atol=1e-6)
            assert got[k][1].dtype == want[k][1].dtype
            np.testing.assert_array_equal(got[k][1], want[k][1])


def test_hybrid_stage3_arpa_matches_jax(hybrid):
    (got,) = glob.glob(os.path.join(hybrid["port"], "ngram", "*.arpa*"))
    (want,) = glob.glob(os.path.join(hybrid["jax"], "ngram", "*.arpa*"))
    assert os.path.basename(got) == os.path.basename(want)
    with gzip.open(got) as g, gzip.open(want) as w:
        assert g.read() == w.read()


@pytest.fixture(scope="module")
def hybrid5(hybrid):
    exp = _copy(hybrid["after4"], str(hybrid["root"] / "p5"))
    results = _port(HYB, hybrid["data"], exp, HYB_SET, 5, 5)
    return exp, results


def test_hybrid_stage5_by_handoff_matches_jax(hybrid, hybrid5):
    exp, results = hybrid5
    jexp = hybrid["jax"]
    got, want = _ark(exp, "loglikes_test"), _ark(jexp, "loglikes_test")
    assert list(got) == list(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert np.abs(got[k] - want[k]).max() <= LL_REL * scale, k
    for f in ("hyp_test.txt", "RESULTS"):
        _same_text(os.path.join(exp, f), os.path.join(jexp, f))
    with open(os.path.join(exp, "prior.pkl"), "rb") as f, \
            open(os.path.join(jexp, "prior.pkl"), "rb") as g:
        np.testing.assert_allclose(np.asarray(pickle.load(f)), np.asarray(pickle.load(g)),
                                   rtol=1e-12)
    assert results and results[0][0] == "test" and np.isfinite(results[0][1])
    assert filecmp.cmp(os.path.join(exp, "graph", "HCLG.txt"),
                       os.path.join(jexp, "graph", "HCLG.txt"), shallow=False)


def test_hybrid_stage6_pm_by_handoff_matches_jax(hybrid):
    """The JAX expdir after stage 6 without pm/final and pm.score: the
    port's train_am resumes from pm/epoch_1, the last epoch, so it trains
    no further and the PM is JAX's; its scores match JAX's."""
    jexp = hybrid["jax"]
    exp = _copy(jexp, str(hybrid["root"] / "p6"))
    shutil.rmtree(os.path.join(exp, "pm", "final"))
    os.remove(os.path.join(exp, "pm.score"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        _port(HYB, hybrid["data"], exp, HYB_SET, 6, 6)
    assert "resumed from" in buf.getvalue() and "epoch 1:" not in buf.getvalue()
    with open(os.path.join(exp, "pm.score"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(jexp, "pm.score"), "rb") as f:
        want = pickle.load(f)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7)


def test_rerun_of_a_finished_am_stage_raises_in_both_packages(hybrid):
    """Stage 4 again on a finished expdir: the newest checkpoint is
    `final`, which has no optimizer state, and both drivers raise
    KeyError (a fault of the JAX package that the port keeps: ROADMAP
    Queue 3)."""
    for mod, tag, extra in ((jrc, "j4", []), (prc, "p4", ["--device", "cpu"])):
        exp = _copy(hybrid["after4"], str(hybrid["root"] / f"rerun_{tag}"))
        with pytest.raises(KeyError, match="opt_state"):
            mod.main(_args(HYB, hybrid["data"], exp, HYB_SET, 4, 4) + extra)


def test_hybrid_stage_resume(hybrid):
    """--stage/--stop_stage contract: each stage runs standalone and
    rewrites nothing of an earlier stage."""
    data = hybrid["data"]
    exp = str(hybrid["root"] / "resume")
    _port(HYB, data, exp, HYB_SET, 1, 1)
    assert os.path.exists(os.path.join(exp, "feats_test.scp"))
    assert not os.path.exists(os.path.join(exp, "egs_train"))
    stamp = {f: os.path.getmtime(f) for f in glob.glob(os.path.join(exp, "feats_*"))}
    time.sleep(0.01)
    _port(HYB, data, exp, HYB_SET, 2, 2)
    assert os.path.exists(os.path.join(exp, "egs_test/egs.config"))
    assert not os.path.exists(os.path.join(exp, "am"))
    assert {f: os.path.getmtime(f) for f in stamp} == stamp


def test_hybrid_realign_layout_matches_jax(tmp_path):
    """Stage 2 without ali.pkl (native realignment), as a handoff after
    JAX's stage 1: the same files, utterances, label shapes and dtypes,
    history keys and target count. The labels themselves differ: the
    aligner's initial weights are drawn by each package's generator
    (ROADMAP Queue 3, "realign_corpus's initial weights")."""
    data = str(tmp_path / "data")
    trc._make_corpus(data, sets=(("train", 4), ("dev", 2), ("test", 2)), with_ali=False)
    sets = HYB_SET + ["--set", "align.iters=1", "--set", "align.epochs=2",
                      "--set", "align.hidden_dim=16"]
    jexp = str(tmp_path / "jax")
    jrc.main(_args(HYB, data, jexp, sets, 1, 1))
    exp = _copy(jexp, str(tmp_path / "port"))
    jrc.main(_args(HYB, data, jexp, sets, 2, 2))
    _port(HYB, data, exp, sets, 2, 2)
    assert sorted(os.listdir(exp)) == sorted(os.listdir(jexp))
    for name in ("train", "dev"):
        with open(os.path.join(exp, f"ali_{name}.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(jexp, f"ali_{name}.pkl"), "rb") as f:
            want = pickle.load(f)
        assert list(got) == list(want)
        for k in want:
            assert type(got[k]) is type(want[k]) and got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
    with open(os.path.join(exp, "align_history.json")) as f:
        gh = json.load(f)
    with open(os.path.join(jexp, "align_history.json")) as f:
        jh = json.load(f)
    assert [sorted(h) for h in gh] == [sorted(h) for h in jh]
    for name in ("train", "dev", "test"):
        g, w = _egs(os.path.join(exp, f"egs_{name}"))[1], \
            _egs(os.path.join(jexp, f"egs_{name}"))[1]
        assert g["num_targets"] == w["num_targets"]


# ------------------------------------------------------------- e2e branch


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX driver's e2e branch, stages 1-5, with copies of its expdir
    after stage 1, stage 3 and stage 4."""
    root = tmp_path_factory.mktemp("e2e")
    data = str(root / "data")
    trc._make_corpus(data, with_ali=False)
    jexp = str(root / "jax")
    jrc.main(_args(E2E, data, jexp, E2E_SET, 1, 1))
    after1 = _copy(jexp, str(root / "after1"))
    jrc.main(_args(E2E, data, jexp, E2E_SET, 2, 3))
    after3 = _copy(jexp, str(root / "after3"))
    jrc.main(_args(E2E, data, jexp, E2E_SET, 4, 4))
    after4 = _copy(jexp, str(root / "after4"))
    jrc.main(_args(E2E, data, jexp, E2E_SET, 5, 5))
    return dict(root=root, data=data, jax=jexp, after1=after1, after3=after3,
                after4=after4)


def test_e2e_stage2_by_handoff_matches_jax(e2e):
    exp = _copy(e2e["after1"], str(e2e["root"] / "p2"))
    _port(E2E, e2e["data"], exp, E2E_SET, 2, 2)
    _same_text(os.path.join(exp, "vocab.json"), os.path.join(e2e["jax"], "vocab.json"))
    for name in ("train", "dev", "test"):
        got, want = _assert_egs_match(os.path.join(exp, f"egs_{name}"),
                                      os.path.join(e2e["jax"], f"egs_{name}"))
        assert list(got) == list(want)


def test_e2e_stage4_serving_manifest_matches_jax(e2e):
    """Stage 4 on a copy of JAX's stage-3 expdir: serving.json identical
    and cmvn.npz's arrays identical (the zip's timestamps differ)."""
    exp = _copy(e2e["after3"], str(e2e["root"] / "p4"))
    _port(E2E, e2e["data"], exp, E2E_SET, 4, 4)
    _same_text(os.path.join(exp, "am", "serving.json"),
               os.path.join(e2e["jax"], "am", "serving.json"))
    got = np.load(os.path.join(exp, "am", "cmvn.npz"))
    want = np.load(os.path.join(e2e["jax"], "am", "cmvn.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert os.path.exists(os.path.join(exp, "am", "final_avg", "state.msgpack"))


def test_e2e_stage5_by_handoff_matches_jax(e2e):
    exp = _copy(e2e["after4"], str(e2e["root"] / "p5"))
    results = _port(E2E, e2e["data"], exp, E2E_SET, 5, 5)
    for f in ("hyp_test.txt", "RESULTS"):
        _same_text(os.path.join(exp, f), os.path.join(e2e["jax"], f))
    assert results and results[0][0] == "test" and np.isfinite(results[0][1])


def test_stage_profile_keys_match_jax(e2e):
    """--profile_stages writes the JAX driver's stage_profile.json keys;
    on the CPU no device memory is recorded."""
    exp = _copy(e2e["after1"], str(e2e["root"] / "prof"))
    prc.main(_args(E2E, e2e["data"], exp, E2E_SET, 2, 2)
             + ["--device", "cpu", "--profile_stages"])
    with open(os.path.join(exp, "stage_profile.json")) as f:
        prof = json.load(f)
    assert sorted(prof) == ["artifact_bytes", "stages"]
    (st,) = prof["stages"]
    assert sorted(st) == ["device_memory", "seconds", "stage"]
    assert st["stage"] == "2 data prep" and st["device_memory"] == {}
    assert "egs_train/" in prof["artifact_bytes"]


def test_driver_default_device_raises_without_a_card(tmp_path, monkeypatch):
    """--device cuda (the default) raises at once without a card; it does
    not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = str(tmp_path / "data")
    trc._make_corpus(data, sets=(("train", 1), ("dev", 1), ("test", 1)))
    with pytest.raises(RuntimeError, match="is_available"):
        prc.main(_args(HYB, data, str(tmp_path / "exp"), HYB_SET))
    assert not os.path.exists(str(tmp_path / "exp"))


def test_parallel_knobs_are_passed_to_train_am(tmp_path, monkeypatch):
    """am.data_parallel / am.expert_parallel reach train_am, which refuses
    them until the parallel layer is ported (ROADMAP Queue 1 item 5)."""
    data = str(tmp_path / "data")
    trc._make_corpus(data, sets=(("train", 2), ("dev", 1), ("test", 1)))
    exp = str(tmp_path / "exp")
    _port(HYB, data, exp, HYB_SET, 1, 2)
    for knob in ("am.data_parallel=true", "am.expert_parallel=2"):
        with pytest.raises(NotImplementedError, match="item 5"):
            _port(HYB, data, exp, HYB_SET + ["--set", knob], 4, 4)


# ------------------------------------------------- corpus, babysit, prefetch


def test_make_synth_corpus_is_byte_identical(tmp_path):
    jspec = importlib.util.spec_from_file_location(
        "jax_make_synth_corpus", os.path.join(REPO, "recipes", "make_synth_corpus.py"))
    jmsc = importlib.util.module_from_spec(jspec)
    jspec.loader.exec_module(jmsc)
    flags = ["--train_hours", "0.004", "--dev_minutes", "0.1", "--test_minutes", "0.1",
             "--n_words", "12", "--srate", "8000", "--seed", "3"]
    for mod, d in ((jmsc, "jax"), (pmsc, "port")):
        with redirect_stdout(io.StringIO()):
            mod.main(["--out", str(tmp_path / d)] + flags)
    for root, _, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(root, tmp_path / "jax")
        assert sorted(os.listdir(tmp_path / "port" / rel)) == sorted(
            os.listdir(root))
        for f in files:
            a, b = os.path.join(root, f), str(tmp_path / "port" / rel / f)
            if f.endswith(".scp"):  # the paths name each corpus's own root
                with open(a) as fa, open(b) as fb:
                    assert fa.read().replace(str(tmp_path / "jax"), "") == \
                        fb.read().replace(str(tmp_path / "port"), "")
            else:
                assert filecmp.cmp(a, b, shallow=False), f


class _Rc:
    def __init__(self, rc):
        self.returncode = rc


def test_babysit_restarts_until_success(monkeypatch):
    calls, rcs, clock = [], iter([1, 1, 0]), [0.0]
    monkeypatch.setattr(pbabysit.time, "time",
                        lambda: clock.__setitem__(0, clock[0] + 100) or clock[0])

    def fake_run(cmd):
        calls.append(list(cmd))
        return _Rc(next(rcs))

    rc = pbabysit.babysit(["train"], max_restarts=5, min_uptime=30, backoff=0,
                          _run=fake_run, _sleep=lambda s: None)
    assert rc == 0 and len(calls) == 3


def test_babysit_fast_crash_is_fatal_and_restarts_are_bounded(monkeypatch):
    assert pbabysit.babysit(["boom"], max_restarts=5, min_uptime=30, backoff=0,
                            _run=lambda c: _Rc(2), _sleep=lambda s: None) == 2
    clock, sleeps = [0.0], []
    monkeypatch.setattr(pbabysit.time, "time",
                        lambda: clock.__setitem__(0, clock[0] + 100) or clock[0])
    assert pbabysit.babysit(["boom"], max_restarts=2, min_uptime=30, backoff=7,
                            _run=lambda c: _Rc(5), _sleep=sleeps.append) == 5
    assert sleeps == [7, 7]


def test_babysit_end_to_end(tmp_path):
    """A real subprocess that crashes once (a flag file), then succeeds,
    through the module's command line."""
    flag = tmp_path / "crashed_once"
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(3)\n"
        "print('done')\n"
    )
    argv = ["--max_restarts", "3", "--min_uptime", "0", "--backoff", "0", "--",
            sys.executable, str(script)]
    assert pbabysit.main(argv) == 0 and flag.exists()
    with pytest.raises(SystemExit):
        pbabysit.main(["--max_restarts", "1"])


def test_prefetch_to_device_cpu():
    """Batches arrive in order, equal to the host batches, as tensors; the
    producer's exception is raised on the consumer's side; sharding waits
    for the parallel layer."""
    rng = np.random.RandomState(0)
    host = [{"x": rng.randn(3, 4).astype(np.float32), "y": (np.arange(i), i)}
            for i in range(5)]
    got = list(prefetch_to_device(iter(host), size=2, device="cpu"))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), h["x"])
        np.testing.assert_array_equal(g["y"][0].numpy(), h["y"][0])
        assert g["y"][1] == h["y"][1]

    def broken():
        yield {"x": np.zeros(2)}
        raise ValueError("producer failed")

    it = prefetch_to_device(broken(), device="cpu")
    np.testing.assert_array_equal(next(it)["x"].numpy(), np.zeros(2))
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
    with pytest.raises(NotImplementedError, match="item 5"):
        next(prefetch_to_device(iter(host), device="cpu", sharding=object()))
