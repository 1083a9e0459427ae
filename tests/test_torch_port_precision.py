"""The port's FDLP precision="high" path held against the JAX package: the
float64 DCT, the support-compacted lags (banded_support_plan,
banded_autocorr_compact), the blocked Schur/Szego Levinson, the whole
high-precision front-end at float32 and float64 I/O for every LPC backend,
and the featgen CLI's --precision high.

The JAX side runs on the CPU with the conftest's x64. Each test states its
tolerance: the float64 ops agree to about 1e-12 of their scale (the same
algebra in another summation order); the high-precision log features to
1e-6 (float64 work, float32 or float64 output).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp import FdlpConfig as JaxFdlpConfig
from speech_recognition_tools_tpu.dsp import fdlp as jfdlp
from speech_recognition_tools_tpu.dsp import filterbanks as jfb
from speech_recognition_tools_tpu.ops import autocorr as jac
from speech_recognition_tools_tpu.ops import dct as jdct
from speech_recognition_tools_tpu.ops import levinson as jlev
from speech_recognition_tools_tpu_torch.dsp.fdlp import (
    FdlpConfig,
    fdlp_lags,
    fdlp_spectrogram_batch,
)
from speech_recognition_tools_tpu_torch.ops import autocorr as tac
from speech_recognition_tools_tpu_torch.ops import dct as tdct
from speech_recognition_tools_tpu_torch.ops import levinson as tlev
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

torch.set_num_threads(1)

FEAT_TOL = 1e-6  # log features, high precision, either I/O dtype


def _rel_close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _ar_lags(P, p, n=512, seed=11):
    """Healthy lags: AR(2)-coloured noise, its linear autocorrelation."""
    rs = np.random.RandomState(seed)
    sigs = rs.randn(P, n)
    for a in (0.9, -0.5):
        sigs[:, 1:] += a * sigs[:, :-1]
    return np.stack([np.correlate(s, s, "full")[len(s) - 1 : len(s) + p + 1] for s in sigs])


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("n", [8000, 24000])
def test_dct2_f64_matches_jax_at_fdlp_lengths(n):
    """torch.fft's Makhoul DCT in float64 against the JAX f64 DCT (its
    Stockham FFT) at the timit (0.5 s) and wsj (1.5 s) window lengths:
    1e-12 of the output scale."""
    x = np.random.RandomState(n).randn(3, n)
    got = tdct.dct2(torch.as_tensor(x))
    assert got.dtype == torch.float64
    _rel_close(got.numpy(), jdct.dct2(jnp.asarray(x), dtype=jnp.float64))


@pytest.mark.parametrize("nf,fdur,sr", [(80, 1.5, 16000), (20, 0.5, 16000), (8, 0.5, 8000)])
def test_banded_support_plan_equals_jax(nf, fdur, sr):
    """The host plan, entry for entry, at the wsj_fdlp_e2e and timit_hybrid
    filterbanks and a small one."""
    fb = jfb.parse_fbank_type("mel,1", nf, int(2 * fdur * sr), sr)[:, :-1]
    assert tac.banded_support_plan(fb, 52) == jac.banded_support_plan(fb, 52)


def test_banded_autocorr_compact_matches_jax_and_the_dense_form():
    """float64, 20 bands of 8000 bins, 52 lags: the compacted sums against
    the JAX compacted sums and the port's dense banded_autocorr, 1e-12 of
    the lags' scale."""
    fb = jfb.parse_fbank_type("mel,1", 20, 16000, 16000)[:, :-1]
    x = np.random.RandomState(3).randn(4, fb.shape[1])
    plan = tac.banded_support_plan(fb, 52)
    got = tac.banded_autocorr_compact(torch.as_tensor(x), torch.as_tensor(fb), 52, plan)
    ref = jax.jit(partial(jac.banded_autocorr_compact, nlags=52, plan=plan))(
        jnp.asarray(x), jnp.asarray(fb))
    assert got.shape == (4, 20, 52)
    _rel_close(got.numpy(), ref)
    _rel_close(got.numpy(), tac.banded_autocorr(torch.as_tensor(x), torch.as_tensor(fb), 52))


@pytest.mark.parametrize("block", [15, 7])
def test_levinson_blocked_matches_jax(block):
    """Order 40 on healthy AR lags, blocks of 15 (the default) and of 7
    (which does not divide 40): predictor and error against the JAX
    blocked solver and against the port's step loop, 1e-12 of their
    scale."""
    p = 40
    r = _ar_lags(6, p)
    a, e = tlev.levinson_durbin_blocked(torch.as_tensor(r), p, block=block)
    ja, je = jax.jit(partial(jlev.levinson_durbin_blocked, order=p, block=block,
                             return_error=True))(jnp.asarray(r))
    assert a.shape == (6, p) and e.shape == (6,)
    _rel_close(a.numpy(), ja)
    _rel_close(e.numpy(), je)
    sa, se = tlev.levinson_durbin(torch.as_tensor(r), p)
    _rel_close(a.numpy(), sa.numpy())
    _rel_close(e.numpy(), se.numpy())


def test_lpc_from_autocorr_block_matches_jax():
    p = 24
    r = _ar_lags(5, p, seed=4)
    tx, tg = tlev.lpc_from_autocorr(torch.as_tensor(r), p, block=15)
    jx, jg = jax.jit(partial(jlev.lpc_from_autocorr, order=p, block=15))(jnp.asarray(r))
    _rel_close(tx.numpy(), jx)
    _rel_close(tg.numpy(), jg)
    with pytest.raises(NotImplementedError):
        tlev.levinson_durbin_blocked(torch.as_tensor(r + 0j), p)


# -------------------------------------------------------------- front-end


def _ragged_batch(n=8000, short=6000, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, n) * 1000).astype(np.float32)
    x[1, short:] = 0
    return x, np.array([n, short], np.int32)


def _check_valid(got, ngot, ref, nref, tol=FEAT_TOL):
    nref = np.asarray(nref)
    np.testing.assert_array_equal(ngot.numpy(), nref)
    assert got.shape == ref.shape
    for b in range(len(nref)):
        T = int(nref[b])
        np.testing.assert_allclose(got[b, :T].numpy(), np.asarray(ref[b, :T]),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,precision", [("float32", "high"), ("float64", "high"),
                                             ("float32", "mixed")])
def test_fdlp_high_matches_jax_with_jitter(dtype, precision):
    """precision high (and its alias mixed) at float32 and float64 I/O on a
    ragged batch with an explicit OLA jitter array: log features within
    1e-6 on valid frames, the output of the I/O dtype."""
    x, lens = _ragged_batch(n=16000, short=12000, seed=5)
    cfg = dict(nfilters=8, precision=precision)
    jcfg = JaxFdlpConfig(**cfg)
    jitter = np.random.RandomState(0).randint(0, 2, (2, 3)).astype(np.int32)
    fbank = np.asarray(jfdlp._host_constants(jcfg)["fbank"])
    ref, nref = jfdlp._fdlp_impl(
        jnp.asarray(x, dtype), jnp.asarray(lens), jnp.asarray(fbank, jnp.float64), jcfg,
        x.shape[1], jnp.asarray(jitter))
    got, ngot = fdlp_spectrogram_batch(x, lens, FdlpConfig(**cfg), jitter=jitter,
                                       dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    _check_valid(got, ngot, ref, nref)


@pytest.fixture(scope="module")
def jax_high():
    x, lens = _ragged_batch()
    ref, nref = jfdlp.fdlp_spectrogram_batch(x, lens, JaxFdlpConfig(nfilters=8, precision="high"))
    return x, lens, np.asarray(ref), np.asarray(nref)


@pytest.mark.parametrize("backend", ["auto", "scan", "scan:unroll=4", "blocked", "blocked:7"])
def test_fdlp_high_every_lpc_backend_matches_jax(jax_high, backend):
    """Every backend the high path takes, at float32 I/O, against the JAX
    high path's default (blocked:15; its backends agree to ~1e-15): 1e-6 on
    valid frames. K1 is never launched (float64 lags)."""
    x, lens, ref, nref = jax_high
    before = lpc_cepstra.launches
    got, ngot = fdlp_spectrogram_batch(
        x, lens, FdlpConfig(nfilters=8, precision="high", lpc_backend=backend), device="cpu")
    assert lpc_cepstra.launches == before
    _check_valid(got, ngot, ref, nref)


def test_fdlp_high_scan_matches_jax_scan(jax_high):
    x, lens, _, _ = jax_high
    ref, nref = jfdlp.fdlp_spectrogram_batch(
        x, lens, JaxFdlpConfig(nfilters=8, precision="high", lpc_backend="scan"))
    got, ngot = fdlp_spectrogram_batch(
        x, lens, FdlpConfig(nfilters=8, precision="high", lpc_backend="scan"), device="cpu")
    _check_valid(got, ngot, ref, nref)


def test_fdlp_high_lags_are_float64_compacted(jax_high):
    """fdlp_lags at high precision: float64, no ridge, equal to the dense
    banded form of the same float64 DCT (1e-12 of the scale)."""
    x, lens, _, _ = jax_high
    cfg = FdlpConfig(nfilters=8, precision="high")
    r, _ = fdlp_lags(x, lens, cfg, device="cpu")
    assert r.dtype == torch.float64 and r.shape[1:] == (8, cfg.order + 2)
    dense, _ = fdlp_lags(x, lens, FdlpConfig(nfilters=8), dtype=torch.float64, device="cpu")
    _rel_close(r.numpy(), dense.numpy())


def test_fdlp_fast_blocked_backend_matches_jax():
    """An explicit lpc_backend='blocked' in fast (float32) mode runs the
    blocked solver in float32 on both sides: rtol 1e-3, atol 2e-3 (the
    fast path's bound)."""
    x, lens = _ragged_batch(seed=2)
    ref, nref = jfdlp.fdlp_spectrogram_batch(
        x, lens, JaxFdlpConfig(nfilters=8, lpc_backend="blocked"))
    got, ngot = fdlp_spectrogram_batch(x, lens, FdlpConfig(nfilters=8, lpc_backend="blocked"),
                                       device="cpu")
    _check_valid(got, ngot, ref, nref, tol=2e-3)


def test_fdlp_rejects_unknown_precision_and_backend():
    x, lens = _ragged_batch()
    with pytest.raises(ValueError, match="precision"):
        fdlp_spectrogram_batch(x, lens, FdlpConfig(precision="double"), device="cpu")
    with pytest.raises(ValueError, match="lpc_backend"):
        fdlp_spectrogram_batch(x, lens, FdlpConfig(lpc_backend="blocked:x"), device="cpu")


# ------------------------------------------------------------------- CLI


def test_cli_precision_high_matches_jax_cli(tmp_path):
    from scipy.io.wavfile import write as wav_write

    from speech_recognition_tools_tpu.cli import compute_fdlp_spectrogram as jcli
    from speech_recognition_tools_tpu.io import read_ark
    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram as tcli

    rng = np.random.RandomState(7)
    lines = []
    for i, n in enumerate((16000, 11000)):
        path = tmp_path / f"utt{i}.wav"
        wav_write(str(path), 16000, np.clip(rng.randn(n) * 2000, -32768, 32767).astype(np.int16))
        lines.append(f"utt{i} {path}\n")
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(lines))
    flags = ["--nfilters", "8", "--precision", "high", "--write_utt2num_frames"]
    jcli.main([str(scp), str(tmp_path / "jax"), *flags])
    tcli.main([str(scp), str(tmp_path / "port"), *flags, "--device", "cpu"])
    ref = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], ref[key], rtol=FEAT_TOL, atol=FEAT_TOL)
    assert (tmp_path / "port.len").read_text() == (tmp_path / "jax.len").read_text()
