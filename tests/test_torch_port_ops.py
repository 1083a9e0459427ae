"""The PyTorch port's FDLP ops held against the JAX package.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU with x64 (tests/conftest.py) and Pallas in interpret mode.
f64 comparisons hold both sides to rtol 1e-10 with atol 1e-10 times the
output's largest magnitude (the same algebra in f64); each f32 comparison
states its own tolerance. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against its plain version there).
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp import filterbanks as jfb
from speech_recognition_tools_tpu.ops import autocorr as jac
from speech_recognition_tools_tpu.ops import cepstrum as jcep
from speech_recognition_tools_tpu.ops import dct as jdct
from speech_recognition_tools_tpu.ops import framing as jfr
from speech_recognition_tools_tpu.ops import levinson as jlev
from speech_recognition_tools_tpu.ops import ola as jola
from speech_recognition_tools_tpu.ops import windows as jwin
from speech_recognition_tools_tpu.ops.pallas_lpc import lpc_cepstra_pallas
from speech_recognition_tools_tpu_torch.dsp import filterbanks as tfb
from speech_recognition_tools_tpu_torch.ops import autocorr as tac
from speech_recognition_tools_tpu_torch.ops import cepstrum as tcep
from speech_recognition_tools_tpu_torch.ops import dct as tdct
from speech_recognition_tools_tpu_torch.ops import framing as tfr
from speech_recognition_tools_tpu_torch.ops import levinson as tlev
from speech_recognition_tools_tpu_torch.ops import ola as tola
from speech_recognition_tools_tpu_torch.ops import windows as twin
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import (
    lpc_cepstra,
    lpc_cepstra_reference,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "speech_recognition_tools_tpu_torch")


def _f64_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    atol = 1e-10 * max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=atol)


def _port_modules():
    mods = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


# ---------------------------------------------------------------- isolation


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax, flax, optax,
    msgpack or JAX package module (a subprocess, since conftest has already imported
    jax; modules loaded before the imports, e.g. by site hooks, are not
    the port's doing)."""
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'speech_recognition_tools_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


def test_import_checks_cover_the_serving_modules():
    """The two isolation tests above and below walk the whole package; the
    serving path's modules, the LM-training stage's, the hybrid decode
    end's, the MFCC / mel front-ends', the modulation spectrum's and the
    high-precision FDLP and incremental decoder's, and the checkpoint
    importer's are among what they walk."""
    mods = set(_port_modules())
    for m in ("dsp.streaming", "infer.streaming_asr", "eval.wer", "cli.recog_e2e",
              "cli.serve", "cli.serve_client", "cli.transcribe",
              "cli.train_lm", "models.rnnlm", "cli.compute_prior", "cli.dump_outputs",
              "cli.train_ngram", "cli.decode_wfst", "decode.export", "decode.viterbi",
              "decode.graph", "decode.wfst", "decode.lattice", "models.ngram_lm",
              "align.forced", "io.kaldi_ark", "io.scp", "io.native",
              "dsp.mfcc", "dsp.melspec", "utils.splice", "utils.transforms",
              "utils.profiling", "cli.compute_mfcc", "cli.compute_mel_spectrum",
              "dsp.modspec", "cli.compute_modulation_spectrum", "ops.autocorr",
              "ops.levinson", "ops.cepstrum", "ops.dct", "dsp.fdlp",
              "cli.compute_fdlp_spectrogram", "models.transformer_asr",
              "decode.beam_jit", "io.torch_import", "cli.import_torch_ckpt"):
        assert f"speech_recognition_tools_tpu_torch.{m}" in mods, m


def test_native_library_builds_only_into_the_port(monkeypatch, tmp_path):
    """io/native.py compiles native/ark_io.cpp and native/fst_decode.cpp
    into the port's _build/ (the JAX loader's native/build/ is not
    touched), and a failed build raises instead of falling back."""
    from speech_recognition_tools_tpu_torch.io import native

    assert os.path.dirname(native.library_path()) == os.path.join(PORT, "_build")
    assert [os.path.relpath(s, REPO) for s in native.SOURCES] == [
        os.path.join("native", "ark_io.cpp"), os.path.join("native", "fst_decode.cpp")]
    assert os.path.exists(native.build()) and native.load() is native.load()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (str(bad),))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_port_sources_import_nothing_of_jax():
    files = [os.path.join(r, f) for r, _, fs in os.walk(PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    banned = ("jax", "jaxlib", "flax", "optax", "msgpack")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, (path, name)
                assert name != "speech_recognition_tools_tpu" and not name.startswith(
                    "speech_recognition_tools_tpu."), (path, name)


# ------------------------------------------------- host constants: bit-exact


@pytest.mark.parametrize("name", ["hamming", "hanning", "square"])
def test_windows_bit_exact(name):
    for n in (1, 7, 400, 24000):
        np.testing.assert_array_equal(twin.WINDOWS[name](n), jwin.WINDOWS[name](n))


@pytest.mark.parametrize(
    "spec,nf,nfft,sr",
    [("mel,1", 20, 16000, 16000), ("mel,1", 80, 48000, 16000),
     ("mel,0.9", 24, 8000, 8000), ("cochlear,0.2,2.5,1,2.5,1", 20, 16000, 16000),
     ("cochlear,0.2,2.5,0,2.5,1.1", 15, 8000, 8000)],
)
def test_filterbanks_bit_exact(spec, nf, nfft, sr):
    np.testing.assert_array_equal(
        tfb.parse_fbank_type(spec, nf, nfft, sr),
        jfb.parse_fbank_type(spec, nf, nfft, sr),
    )


# ------------------------------------------------------------------ framing


def _ragged(seed=0):
    """Three utterances; the last is shorter than the reflect pad."""
    rng = np.random.RandomState(seed)
    params = jfr.frame_params(8000, 1.0 / (0.75 * 0.5), 0.5)  # FDLP geometry
    lens = np.array([12000, 9001, params.extend - 100], np.int32)
    sig = np.zeros((3, 12000))
    for b, n in enumerate(lens):
        sig[b, :n] = rng.randn(n) * 1000
    return sig, lens, params


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_frame_signal_matches_jax(dtype):
    sig, lens, jp = _ragged()
    tp = tfr.frame_params(8000, 1.0 / (0.75 * 0.5), 0.5)
    assert tp.__dict__ == jp.__dict__
    F = jfr.frame_count(sig.shape[1], jp)
    assert tfr.frame_count(sig.shape[1], tp) == F
    win = np.hamming(jp.flength_samples)
    jf, jn = jfr.frame_signal(jnp.asarray(sig, dtype), jnp.asarray(lens), jp,
                              jnp.asarray(win, dtype), F)
    tf, tn = tfr.frame_signal(torch.as_tensor(sig).to(getattr(torch, dtype)),
                              torch.as_tensor(lens), tp,
                              torch.as_tensor(win).to(getattr(torch, dtype)), F)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for b in range(3):  # frames past an utterance's count are garbage
        nf = int(jn[b])
        if dtype == "float64":
            _f64_close(tf[b, :nf].numpy(), np.asarray(jf[b, :nf]))
        else:  # one f32 product of the same two f32 operands
            np.testing.assert_array_equal(tf[b, :nf].numpy(), np.asarray(jf[b, :nf]))


# ---------------------------------------------------------------------- dct


@pytest.mark.parametrize("n", [64, 400, 4001, 8000])
def test_dct2_matches_jax_f64(n):
    x = np.random.RandomState(n).randn(3, n)
    _f64_close(tdct.dct2(torch.as_tensor(x)).numpy(),
               np.asarray(jdct.dct2(jnp.asarray(x))))


def test_dct2_matches_jax_f32():
    """f32: both sides are O(N log N) FFT forms with errors ~eps*||x||;
    held at 2e-5 of the output scale."""
    x = np.random.RandomState(1).randn(4, 8000).astype(np.float32)
    got = tdct.dct2(torch.as_tensor(x)).numpy()
    ref = np.asarray(jdct.dct2(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


# ----------------------------------------------------------------- autocorr


def _fbank(nf=6, sr=8000, fdur=0.5):
    fb = jfb.parse_fbank_type("mel,1", nf, int(2 * fdur * sr), sr)[:, :-1]
    return fb


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_banded_autocorr_matches_jax(dtype):
    fb = _fbank()
    x = np.random.RandomState(2).randn(5, fb.shape[1])
    nlags = 22
    assert tac.banded_supports_separable(fb, nlags) == jac.banded_supports_separable(fb, nlags)
    tt = getattr(torch, dtype)
    got = tac.banded_autocorr(torch.as_tensor(x).to(tt), torch.as_tensor(fb).to(tt), nlags)
    ref = np.asarray(jac.banded_autocorr(jnp.asarray(x, dtype), jnp.asarray(fb, dtype), nlags))
    if dtype == "float64":
        _f64_close(got.numpy(), ref)
    else:  # f32 dot products of length 4000, different summation order
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_banded_supports_separable_detects_wrap():
    fb = np.zeros((2, 100))
    fb[0, 10:20] = 1
    fb[1, :3] = fb[1, -3:] = 1
    assert tac.banded_supports_separable(fb[:1], 5)
    assert not tac.banded_supports_separable(fb, 5)
    assert not jac.banded_supports_separable(fb, 5)


# ---------------------------------------------------- levinson + cepstrum


def _ar_lags(P, order, n=300, seed=0):
    """AR(2)-coloured noise lags (tests/test_pallas_ops.py::_ar_lags)."""
    rng = np.random.RandomState(seed)
    sigs = rng.randn(P, n)
    for a in (0.9, -0.5):
        sigs[:, 1:] += a * sigs[:, :-1]
    return np.stack([np.correlate(s, s, "full")[len(s) - 1 : len(s) + order + 2]
                     for s in sigs])


@pytest.mark.parametrize("order,lim", [(12, 20), (30, 40), (50, 50)])
def test_lpc_and_cepstrum_match_jax_f64(order, lim):
    r = _ar_lags(16, order)
    jx, jg = jlev.lpc_from_autocorr(jnp.asarray(r), order)
    tx, tg = tlev.lpc_from_autocorr(torch.as_tensor(r), order)
    _f64_close(tx.numpy(), np.asarray(jx))
    _f64_close(tg.numpy(), np.asarray(jg))
    _f64_close(tcep.lpc_to_cepstrum(tx, tg, lim).numpy(),
               np.asarray(jcep.lpc_to_cepstrum(jx, jg, lim)))


def test_lpc_and_cepstrum_match_jax_f32():
    """f32 on well-conditioned AR lags: 2e-5 (the bound the JAX package
    holds its fused kernel to against the scans)."""
    order, lim = 30, 40
    r = _ar_lags(32, order).astype(np.float32)
    jx, jg = jlev.lpc_from_autocorr(jnp.asarray(r), order)
    tx, tg = tlev.lpc_from_autocorr(torch.as_tensor(r), order)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-5)
    np.testing.assert_allclose(tcep.lpc_to_cepstrum(tx, tg, lim).numpy(),
                               np.asarray(jcep.lpc_to_cepstrum(jx, jg, lim)),
                               rtol=2e-5, atol=2e-5)


def test_gain_fallback_and_degenerate_rows_match_jax():
    """A silent row takes the gain fallback on both sides. A pure tone
    (singular Toeplitz) drives the error to its floor, where both sides
    divide rounding noise and their predictors decohere: there the test
    asks only for a finite predictor and a positive gain."""
    r = np.zeros((3, 12))
    r[1] = np.cos(0.3 * np.arange(12))
    r[2] = _ar_lags(1, 10)[0, :12]
    jx, jg = jlev.lpc_from_autocorr(jnp.asarray(r), 10)
    tx, tg = tlev.lpc_from_autocorr(torch.as_tensor(r), 10)
    assert np.all(tg.numpy() > 0) and np.all(np.asarray(jg) > 0)
    assert np.isfinite(tx.numpy()).all()
    assert tg[0].item() == float(jg[0]) == np.finfo(np.float64).tiny
    for row in (0, 2):
        _f64_close(tx[row].numpy(), np.asarray(jx[row]))
        _f64_close(tg[row].numpy(), np.asarray(jg[row]))


# ------------------------------------------- K1's plain version vs Pallas


@pytest.mark.parametrize(
    "P,order,lim", [(64, 30, 40), (48, 50, 50), (16, 150, 100), (8, 20, 2),
                    (8, 150, 450)]
)
def test_k1_plain_matches_pallas_and_scans(P, order, lim):
    """lpc_cepstra_reference (what the CUDA kernel is held to on the card)
    against the Pallas kernel in interpret mode and against the JAX scans,
    at rtol = atol = 2e-5 (tests/test_pallas_ops.py's bound)."""
    r = _ar_lags(P, order).astype(np.float32)
    got = lpc_cepstra_reference(torch.as_tensor(r), order, lim).numpy()
    pallas = np.asarray(lpc_cepstra_pallas(jnp.asarray(r), order, lim, block=16,
                                           interpret=True))
    jx, jg = jlev.lpc_from_autocorr(jnp.asarray(r), order)
    scans = np.asarray(jcep.lpc_to_cepstrum(jx, jg, lim))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, scans, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("unity_gain,lim", [(True, 25), (False, 1)])
def test_k1_plain_unity_gain_and_single_coefficient(unity_gain, lim):
    r = _ar_lags(24, 16).astype(np.float32)
    got = lpc_cepstra_reference(torch.as_tensor(r), 16, lim, unity_gain=unity_gain)
    ref = np.asarray(lpc_cepstra_pallas(jnp.asarray(r), 16, lim, block=8,
                                        interpret=True, unity_gain=unity_gain))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    if unity_gain:
        assert np.all(got[:, 0].numpy() == 0)


def test_k1_wrapper_on_cpu_runs_plain_version_without_launching():
    r = torch.as_tensor(_ar_lags(10, 12).astype(np.float32))
    before = lpc_cepstra.launches
    got = lpc_cepstra(r, 12, 20)
    assert lpc_cepstra.launches == before
    torch.testing.assert_close(got, lpc_cepstra_reference(r, 12, 20), rtol=0, atol=0)
    with pytest.raises(ValueError):
        lpc_cepstra(r[:, :5], 12, 20)  # too few lags
    with pytest.raises(ValueError):
        lpc_cepstra(r.to("meta"), 12, 20)


# ---------------------------------------------------------------------- ola


def _ola_case(seed=3):
    rng = np.random.RandomState(seed)
    B, F, NB, kk, hop, kkb2 = 2, 6, 3, 50, 37, 25
    env = rng.rand(B, F, NB, kk)
    nfr = np.array([6, 4], np.int32)
    out_len = np.array([230, 150], np.int32)
    jitter = rng.randint(0, 2, (B, F)).astype(np.int32)
    return env, nfr, out_len, jitter, (F, hop, kk, kkb2), 240


def test_overlap_add_strided_matches_jax_f64():
    env, nfr, out_len, _, (F, hop, kk, kkb2), T = _ola_case()
    jpos, jvalid = jola.ola_positions(F, hop, kk, kkb2)
    tpos, tvalid = tola.ola_positions(F, hop, kk, kkb2)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    ref = jola.overlap_add(jnp.asarray(env), jpos, jvalid, jnp.asarray(nfr),
                           jnp.asarray(out_len), T, hop=hop, kkb2=kkb2)
    got = tola.overlap_add(torch.as_tensor(env), tpos, tvalid, torch.as_tensor(nfr),
                           torch.as_tensor(out_len), T, hop=hop, kkb2=kkb2)
    _f64_close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_overlap_add_jittered_matches_jax(dtype):
    import jax

    env, nfr, out_len, jitter, (F, hop, kk, kkb2), T = _ola_case()
    jpos, jvalid = jax.vmap(lambda j: jola.ola_positions(F, hop, kk, kkb2, j))(
        jnp.asarray(jitter))
    tpos, tvalid = tola.ola_positions(F, hop, kk, kkb2, torch.as_tensor(jitter))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    ref = jola.overlap_add(jnp.asarray(env, dtype), jpos, jvalid[0], jnp.asarray(nfr),
                           jnp.asarray(out_len), T)
    got = tola.overlap_add(torch.as_tensor(env).to(getattr(torch, dtype)), tpos, tvalid,
                           torch.as_tensor(nfr), torch.as_tensor(out_len), T)
    if dtype == "float64":
        _f64_close(got.numpy(), np.asarray(ref))
    else:  # sums of at most ceil(kk/hop)+1 f32 terms in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
