"""The port's modulation spectrum (dsp/modspec.py, the
compute_modulation_spectrum CLI) and its complex ops held against the JAX
package: complex banded autocorrelation, circular autocorrelation (real and
complex, keepreal), the complex Hermitian Levinson and the complex cepstrum,
and modulation_spectrum_batch over its options.

The JAX side runs on the CPU with the conftest's x64. Each case runs in
float64 on both sides, held tight (1e-9 of the output's scale; the same
algebra in another order), and in float32 (complex64), held loose: the two
packages' float32 FFTs differ in form (torch.fft against the JAX package's
Bluestein and XLA FFTs), and the Levinson recursion amplifies that
rounding, so features agree to 2e-3 of their scale. Features are compared
on valid frames only: under complex_modulation in float32 the JAX
package's frames past an utterance's end can be NaN.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp import filterbanks as jfb
from speech_recognition_tools_tpu.dsp.modspec import ModSpecConfig as JaxModSpecConfig
from speech_recognition_tools_tpu.dsp.modspec import modulation_spectrum_batch as jax_modspec
from speech_recognition_tools_tpu.ops import autocorr as jac
from speech_recognition_tools_tpu.ops import cepstrum as jcep
from speech_recognition_tools_tpu.ops import levinson as jlev
from speech_recognition_tools_tpu_torch.dsp import modspec as tmodspec
from speech_recognition_tools_tpu_torch.dsp.modspec import (
    ModSpecConfig,
    modulation_spectrum_batch,
)
from speech_recognition_tools_tpu_torch.ops import autocorr as tac
from speech_recognition_tools_tpu_torch.ops import cepstrum as tcep
from speech_recognition_tools_tpu_torch.ops import levinson as tlev
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import launch_plan, lpc_cepstra

torch.set_num_threads(1)

TIGHT = 1e-9  # float64 / complex128, relative to the output's scale
LOOSE = 2e-3  # float32 / complex64 features, relative to their scale
# complex64 features at the CLI's order 50: each package's float32 chain
# is ~1-2.5% of the scale from its float64 result on these wavs (the JAX
# package's 7.8e-3, the port's 1.7e-2 at scale 0.68), so the two float32
# arks are held to 4% of the scale; their float64 forms agree to 1e-10
CLI_COMPLEX_LOOSE = 4e-2


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max())


def _complex_noise(P, n, seed):
    """AR(2)-coloured complex noise (healthy Hermitian lags)."""
    rs = np.random.RandomState(seed)
    s = rs.randn(P, n) + 1j * rs.randn(P, n)
    for a in (0.8 + 0.3j, -0.4):
        s[:, 1:] += a * s[:, :-1]
    return s


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("dtype,rel", [("complex128", TIGHT), ("complex64", 1e-4)])
def test_complex_banded_autocorr_matches_jax(dtype, rel):
    fb = jfb.parse_fbank_type("mel,1", 6, 800, 8000)[:, :-1]
    x = _complex_noise(5, fb.shape[1], 1).astype(dtype)
    rdt = "float64" if dtype == "complex128" else "float32"
    got = tac.banded_autocorr(torch.as_tensor(x), torch.as_tensor(fb.astype(rdt)), 22)
    ref = jac.banded_autocorr(jnp.asarray(x), jnp.asarray(fb, rdt), 22)
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, 6, 22)
    _close(got.numpy(), ref, rel)


@pytest.mark.parametrize("keepreal", [True, False])
@pytest.mark.parametrize("kind,rel", [("float64", TIGHT), ("complex128", TIGHT),
                                      ("float32", 1e-5), ("complex64", 1e-5)])
def test_circular_autocorr_matches_jax(kind, rel, keepreal):
    """Real and complex signals of odd length, keepreal either way."""
    x = _complex_noise(4, 301, 2)
    x = (x.real if kind.startswith("float") else x).astype(kind)
    got = tac.circular_autocorr(torch.as_tensor(x), 12, keepreal=keepreal)
    ref = jac.circular_autocorr(jnp.asarray(x), 12, keepreal=keepreal)
    assert got.is_complex() == (kind.startswith("complex") and not keepreal)
    _close(got.numpy(), ref, rel)


def test_circular_autocorr_direct_and_f64_match_jax():
    x = np.random.RandomState(3).randn(3, 257)
    _close(tac.circular_autocorr_direct(torch.as_tensor(x), 20).numpy(),
           jac.circular_autocorr_direct(jnp.asarray(x), 20), TIGHT)
    got = tac.circular_autocorr_f64(torch.as_tensor(x.astype(np.float32)), 20)
    assert got.dtype == torch.float64
    _close(got.numpy(), jac.circular_autocorr_f64(jnp.asarray(x.astype(np.float32)), 20),
           TIGHT)
    # the direct form is the FFT form's circular autocorrelation
    x32 = torch.as_tensor(x.astype(np.float32)).double()
    _close(got.numpy(), tac.circular_autocorr(x32, 20).numpy(), TIGHT)


@pytest.mark.parametrize("unity", [False, True])
@pytest.mark.parametrize("dtype,rel", [("complex128", TIGHT), ("complex64", 5e-4)])
def test_complex_levinson_and_cepstrum_match_jax(dtype, rel, unity):
    """The Hermitian Levinson (predictor, error, complex gain) and the
    complex cepstrum, order 20, 30 coefficients."""
    p = 20
    r = jac.circular_autocorr(jnp.asarray(_complex_noise(8, 400, 4)), p + 2, keepreal=False)
    r = np.asarray(r).astype(dtype)
    tr = torch.as_tensor(r)
    a, e = tlev.levinson_durbin(tr, p)
    ja, je = jax.jit(partial(jlev.levinson_durbin, order=p, return_error=True))(jnp.asarray(r))
    assert a.dtype == getattr(torch, dtype) and e.is_complex()
    _close(a.numpy(), ja, rel)
    _close(e.numpy(), je, rel)
    tx, tg = tlev.lpc_from_autocorr(tr, p)
    jx, jg = jlev.lpc_from_autocorr(jnp.asarray(r), p)
    _close(tg.numpy(), jg, rel)
    if unity:
        tg, jg = torch.ones_like(tg), jnp.ones_like(jg)
    _close(tcep.lpc_to_cepstrum(tx, tg, 30).numpy(), jcep.lpc_to_cepstrum(jx, jg, 30), rel)


def test_complex_levinson_stays_finite_where_the_clamp_overflows():
    """Near-tone complex64 lags (singular Hermitian Toeplitz matrices plus
    up to 1e-5 noise) collapse the error to its floor, after which
    -num / e can overflow: the JAX formula k * (kmax / |k|) then gives
    inf * 0 = NaN (it does on some of these rows). The port keeps k on the
    clamp's circle in the direction of -num / e, so every predictor stays
    finite; healthy rows in the same batch still match JAX (5e-4 of their
    scale)."""
    p = 50
    lags = np.arange(p + 2)
    noise = np.random.RandomState(0).randn(p + 2)
    tones = []
    for w in (0.3, 1.1, 2.0):
        for a in (1e-7, 1e-6, 1e-5, 0.0):
            t = np.exp(1j * w * lags) * (1 + a * noise)
            t[0] = 1
            tones.append(t)
    healthy = np.asarray(jac.circular_autocorr(jnp.asarray(_complex_noise(3, 400, 5)), p + 2,
                                               keepreal=False))
    r = np.concatenate([healthy, np.stack(tones)]).astype(np.complex64)
    ja, _ = jlev.levinson_durbin(jnp.asarray(r), p, return_error=True)
    assert not np.isfinite(np.asarray(ja)[3:]).all()
    a, e = tlev.levinson_durbin(torch.as_tensor(r), p)
    assert torch.isfinite(a).all() and torch.isfinite(e).all()
    _close(a[:3].numpy(), np.asarray(ja)[:3], 5e-4)


# ------------------------------------------------------------- front-end

BASE = dict(srate=8000, nfilters=5, fduration=0.2, order=12, coeff_0=3, coeff_n=10)
# the cochlear bank's exponential skirts reach both spectrum ends, so
# banded_supports_separable is false and the per-problem circular path runs
WRAP = "cochlear,4,7,1,0.2,1"
CASES = {
    "default": {},
    "unity_gain": dict(set_unity_gain=True, coeff_0=1),
    "complex": dict(complex_modulation=True),
    "complex_abs": dict(complex_modulation=True, absolute_value=True),
    "complex_unity_noise": dict(complex_modulation=True, set_unity_gain=True, coeff_0=1,
                                compensate_noise=True),
    "abs": dict(absolute_value=True),
    "keep_even_odd_c0": dict(keep_even=True, coeff_0=3),
    "keep_even_even_c0": dict(keep_even=True, coeff_0=4),
    "compensate_noise": dict(compensate_noise=True),
    "no_window": dict(no_window=True),
    "wrap": dict(fbank_type=WRAP),
    "wrap_complex": dict(fbank_type=WRAP, complex_modulation=True),
}


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 8000) * 1000).astype(np.float32)
    x[1, 6000:] = 0
    return x, np.array([8000, 6000], np.int32)


def _valid_close(got, ngot, ref, nref, rel):
    nref = np.asarray(nref)
    np.testing.assert_array_equal(ngot.numpy(), nref)
    assert got.shape == ref.shape
    g = np.concatenate([got[b, : int(n)].numpy() for b, n in enumerate(nref)])
    r = np.concatenate([np.asarray(ref)[b, : int(n)] for b, n in enumerate(nref)])
    assert np.isfinite(g).all() and np.isfinite(r).all()
    _close(g, r, rel)


def test_the_wrap_case_takes_the_circular_path():
    fb = jfb.parse_fbank_type(WRAP, 5, 3200, 8000)[:, :-1]
    assert not tac.banded_supports_separable(fb, 14)
    assert not jac.banded_supports_separable(fb, 14)
    fb = jfb.parse_fbank_type("mel,1", 5, 3200, 8000)[:, :-1]
    assert tac.banded_supports_separable(fb, 14)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_modulation_spectrum_matches_jax(case, dtype):
    x, lens = _batch()
    kw = {**BASE, **CASES[case]}
    ref, nref = jax_modspec(x, lens, JaxModSpecConfig(**kw), dtype=getattr(jnp, dtype))
    before = lpc_cepstra.launches
    got, ngot = modulation_spectrum_batch(x, lens, ModSpecConfig(**kw),
                                          dtype=getattr(torch, dtype), device="cpu")
    assert lpc_cepstra.launches == before  # no kernel on the CPU
    cfg = ModSpecConfig(**kw)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape[2] == cfg.nfilters * cfg.feat_len
    _valid_close(got, ngot, ref, nref, TIGHT if dtype == "float64" else LOOSE)


def test_real_f32_lags_go_through_the_kernel_wrapper_with_unity_gain(monkeypatch):
    """Real float32 lags reach ops/lpc_cepstra.py::lpc_cepstra (the kernel
    on a CUDA tensor) with unity_gain=set_unity_gain, on the shared-lag and
    the wrap path alike; complex and float64 lags take the plain loops."""
    calls = []

    def spy(r, order, lim, unity_gain=False):
        calls.append((r.dtype, r.shape[1], order, lim, unity_gain))
        return lpc_cepstra(r, order, lim, unity_gain=unity_gain)

    monkeypatch.setattr(tmodspec, "lpc_cepstra", spy)
    x, lens = _batch()
    for extra in ({}, dict(fbank_type=WRAP)):
        for unity in (False, True):
            calls.clear()
            modulation_spectrum_batch(x, lens, ModSpecConfig(**BASE, **extra,
                                                             set_unity_gain=unity),
                                      device="cpu")
            assert calls and all(c == (torch.float32, 14, 12, 10, unity) for c in calls)
    calls.clear()
    modulation_spectrum_batch(x, lens, ModSpecConfig(**BASE, complex_modulation=True),
                              device="cpu")
    modulation_spectrum_batch(x, lens, ModSpecConfig(**BASE), dtype=torch.float64,
                              device="cpu")
    assert not calls


def test_modulation_spectrum_lags_are_what_the_batch_solves():
    """modulation_spectrum_lags (the shared-lag path's K1 input, ridge
    applied) through K1's plain version give the batch's features."""
    x, lens = _batch()
    cfg = ModSpecConfig(**BASE)
    r, n = tmodspec.modulation_spectrum_lags(x, lens, cfg, device="cpu")
    feats, nf = modulation_spectrum_batch(x, lens, cfg, device="cpu")
    B, F, _ = feats.shape
    assert r.shape == (B * F * cfg.nfilters, cfg.order + 2) and r.dtype == torch.float32
    assert torch.equal(n, nf)
    cep = lpc_cepstra(r, cfg.order, cfg.coeff_n).reshape(B, F, cfg.nfilters, -1)
    torch.testing.assert_close(cep[..., cfg.coeff_0 - 1 :].reshape(B, F, -1), feats,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="wraps"):
        tmodspec.modulation_spectrum_lags(x, lens, ModSpecConfig(**BASE, fbank_type=WRAP),
                                          device="cpu")


def test_k1_plan_covers_the_modspec_shape():
    """(order 50, lim 30): the CLI defaults' LPC problems."""
    lanes, chunk, rows = launch_plan(50, 30)
    assert lanes * chunk >= 50 and rows >= 1


def test_modulation_spectrum_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x, lens = _batch()
    with pytest.raises(RuntimeError, match="cuda"):
        modulation_spectrum_batch(x, lens, ModSpecConfig(**BASE))


# ------------------------------------------------------------------- CLI


def _write_wavs(tmp_path):
    from scipy.io.wavfile import write as wav_write

    rng = np.random.RandomState(7)
    lines = []
    for i, n in enumerate((16000, 11000)):
        path = tmp_path / f"utt{i}.wav"
        wav_write(str(path), 16000, np.clip(rng.randn(n) * 2000, -32768, 32767).astype(np.int16))
        lines.append(f"utt{i} {path}\n")
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(lines))
    return scp


@pytest.mark.parametrize("flags", [[], ["--set_unity_gain", "--coeff_0", "1"],
                                   ["--complex_modulation", "--absolute_value"]])
def test_cli_matches_jax_cli(tmp_path, flags):
    """The CLI's defaults (15 bands, order 50, coefficients 5-30, 0.5 s at
    16 kHz) on two wavs: arks at the float32 tolerance (CLI_COMPLEX_LOOSE
    under --complex_modulation)."""
    from speech_recognition_tools_tpu.cli import compute_modulation_spectrum as jcli
    from speech_recognition_tools_tpu.io import read_ark
    from speech_recognition_tools_tpu_torch.cli import compute_modulation_spectrum as tcli

    scp = _write_wavs(tmp_path)
    flags = [*flags, "--write_utt2num_frames"]
    jcli.main([str(scp), str(tmp_path / "jax"), *flags])
    tcli.main([str(scp), str(tmp_path / "port"), *flags, "--device", "cpu"])
    ref = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        _close(got[key], ref[key],
               CLI_COMPLEX_LOOSE if "--complex_modulation" in flags else LOOSE)
    assert (tmp_path / "port.len").read_text() == (tmp_path / "jax.len").read_text()


def test_cli_rejects_unported_flags(tmp_path, monkeypatch):
    """--data_parallel is not ported and raises, naming item 5, before
    anything is written. --add_reverb is: from a directory holding seeded
    RIR/ wavs, the ark matches the JAX CLI's at LOOSE."""
    from test_torch_port_augment import write_augmentation_files

    from speech_recognition_tools_tpu.cli import compute_modulation_spectrum as jcli
    from speech_recognition_tools_tpu.io import read_ark
    from speech_recognition_tools_tpu_torch.cli import compute_modulation_spectrum as tcli

    scp = _write_wavs(tmp_path)
    with pytest.raises(NotImplementedError, match="item 5"):
        tcli.main([str(scp), str(tmp_path / "x"), "--device", "cpu", "--data_parallel"])
    assert not (tmp_path / "x.ark").exists()
    write_augmentation_files(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    jcli.main([str(scp), str(tmp_path / "jax"), "--add_reverb", "small_room"])
    tcli.main([str(scp), str(tmp_path / "port"), "--add_reverb", "small_room", "--device", "cpu"])
    ref = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        _close(got[key], ref[key], LOOSE)
