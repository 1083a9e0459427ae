"""The port's speech-enhancement metrics held against the JAX package:
eval/enhancement_metrics.py (cepsdist, lpcllr, fwsegsnr, stoi / estoi,
sdr), eval/srmr.py, eval/info_theory.py, PESQ through the port's own build
of native/pesq.cpp, and enhance/pipeline.py::se_scores over scps.

The metric modules are host copies (numpy / scipy), so every value is held
within 1e-12 relative; PESQ is the same C++ and must be identical.
"""

import importlib

import numpy as np
import pytest
from scipy.io.wavfile import write as wav_write

from speech_recognition_tools_tpu.enhance import pipeline as jpipe
from speech_recognition_tools_tpu.eval import enhancement_metrics as jem
from speech_recognition_tools_tpu.eval import info_theory as jit
from speech_recognition_tools_tpu.io import native as jnative
from speech_recognition_tools_tpu_torch import eval as teval
from speech_recognition_tools_tpu_torch.enhance import pipeline as tpipe
from speech_recognition_tools_tpu_torch.eval import enhancement_metrics as tem
from speech_recognition_tools_tpu_torch.eval import info_theory as tit
from speech_recognition_tools_tpu_torch.io import native as tnative

# the module, not the function the package re-exports under the same name
jsrmr = importlib.import_module("speech_recognition_tools_tpu.eval.srmr")
tsrmr = importlib.import_module("speech_recognition_tools_tpu_torch.eval.srmr")

REL = 1e-12
METRICS = ["cepsdist", "lpcllr", "fwsegsnr", "stoi", "estoi", "sdr", "srmr", "pesq"]


def _speech(n, rs, sr):
    x = rs.randn(n)
    for a in (0.85, 0.6):
        x[1:] += a * x[:-1]
    t = np.arange(n) / sr
    return x * (0.25 + 0.75 * np.sin(2 * np.pi * 2.0 * t) ** 2)


@pytest.fixture(scope="module", params=[8000, 16000], ids=["8k", "16k"])
def pair(request):
    """(clean, degraded, srate): 1 s of speech-like audio, the degraded copy
    reverberated, delayed and noisy."""
    sr = request.param
    rs = np.random.RandomState(sr)
    clean = _speech(sr, rs, sr) * 3000.0
    rir = np.exp(-np.arange(sr // 10) / (sr / 60.0)) * rs.randn(sr // 10) * 0.2
    rir[0] = 1.0
    deg = np.convolve(clean, rir)[:sr] + 300.0 * rs.randn(sr)
    return clean, deg, sr


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= REL * np.maximum(np.abs(b), 1e-300)), (a, b)


@pytest.mark.parametrize("name", ["cepsdist", "lpcllr", "fwsegsnr"])
def test_reverb_suite_metrics_match_jax(pair, name):
    clean, deg, sr = pair
    _close(getattr(tem, name)(deg, clean, sr), getattr(jem, name)(deg, clean, sr))


@pytest.mark.parametrize("extended", [False, True], ids=["stoi", "estoi"])
def test_stoi_matches_jax(pair, extended):
    clean, deg, sr = pair
    _close(tem.stoi(clean, deg, sr, extended=extended),
           jem.stoi(clean, deg, sr, extended=extended))


def test_sdr_and_srmr_match_jax(pair):
    clean, deg, sr = pair
    _close(tem.sdr(clean, deg), jem.sdr(clean, deg))
    _close(tsrmr.srmr(deg, sr), jsrmr.srmr(deg, sr))
    assert teval.srmr is tsrmr.srmr and teval.stoi is tem.stoi


def test_pesq_is_identical_to_jax(pair):
    """The port builds native/pesq.cpp into its own library; the MOS is the
    JAX package's bit for bit; short signals raise ValueError in both."""
    clean, deg, sr = pair
    assert tnative.pesq(clean, deg, sr) == jnative.pesq(clean, deg, sr)
    assert tnative.pesq(clean, clean, sr) == jnative.pesq(clean, clean, sr)
    with pytest.raises(ValueError, match="too short"):
        tnative.pesq(clean[:100], deg[:100], sr)
    with pytest.raises(ValueError, match="too short"):
        jnative.pesq(clean[:100], deg[:100], sr)


def test_info_theory_matches_jax():
    rs = np.random.RandomState(4)
    feats = {f"u{i}": rs.randn(40 + 7 * i, 6) for i in range(3)}
    alis = {k: rs.randint(1, 5, len(v)) for k, v in feats.items()}
    assert tit.feats_minmax(feats) == jit.feats_minmax(feats)
    rng = tit.feats_minmax(feats)
    for kw in ({}, {"feat_dim": 4, "num_bins": 10}, {"labels_one_based": False}):
        labels = 5 if kw.get("labels_one_based", True) else 6
        a = tit.signal_label_histogram(alis, feats, rng, labels, **kw)
        b = jit.signal_label_histogram(alis, feats, rng, labels, **kw)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tit.mark_transitions(alis["u1"]),
                                  jit.mark_transitions(alis["u1"]))
    hists = [jit.signal_label_histogram(alis, feats, rng, 5) for _ in range(2)]
    comb = tit.combine_histograms(hists)
    np.testing.assert_array_equal(comb, jit.combine_histograms(hists))
    _close(tit.mutual_information(comb), jit.mutual_information(comb))


def test_se_scores_match_jax(tmp_path):
    """Two enhanced / clean utterance pairs through scps (int16 wavs): all
    eight metrics of both packages within 1e-12, each a number; an unknown
    metric is ignored by both."""
    sr = 16000
    rs = np.random.RandomState(1)
    enh, cl = [], []
    for u in range(2):
        c = _speech(sr, rs, sr) * 3000.0
        d = np.convolve(c, [1.0, 0.0, 0.3, 0.1])[:sr] + 200.0 * rs.randn(sr)
        cp, dp = str(tmp_path / f"c{u}.wav"), str(tmp_path / f"d{u}.wav")
        wav_write(cp, sr, c.astype(np.int16))
        wav_write(dp, sr, d.astype(np.int16))
        enh.append(f"u{u} {dp}")
        cl.append(f"u{u} {cp}")
    (tmp_path / "enh.scp").write_text("\n".join(enh) + "\n")
    (tmp_path / "clean.scp").write_text("\n".join(cl) + "\n")
    args = (str(tmp_path / "enh.scp"), str(tmp_path / "clean.scp"), METRICS + ["nope"], sr)
    got = tpipe.se_scores(*args, log=lambda s: None)
    want = jpipe.se_scores(*args, log=lambda s: None)
    assert set(got) == set(want) == set(METRICS + ["nope"]) and got["nope"] is None
    for m in METRICS:
        assert isinstance(got[m], float), (m, got[m])
        _close(got[m], want[m])
