"""The port's FDLP front-end and featgen CLI held against the JAX package.

Both sides run fast (float32) mode on the same numpy waveforms; the JAX
side uses its 'scan' LPC backend (what 'auto' picks on the CPU). Frame
counts must be equal and valid frames agree to rtol 1e-3, atol 2e-3: the
bound the JAX package holds its fused kernel to against the scans
(tests/test_pallas_ops.py:82-84), since f32 rounding in the Levinson
recursion is amplified on narrowband mel channels.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp import FdlpConfig as JaxFdlpConfig
from speech_recognition_tools_tpu.dsp import fdlp_spectrogram_batch as jax_fdlp
from speech_recognition_tools_tpu_torch.dsp.fdlp import (
    FdlpConfig,
    fdlp_spectrogram_batch,
)
from speech_recognition_tools_tpu_torch.ops.lpc_cepstra import lpc_cepstra

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 2e-3


def _ragged_batch(n=8000, short=6000, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, n) * 1000).astype(np.float32)
    x[1, short:] = 0
    return x, np.array([n, short], np.int32)


def _compare(x, lens, **kw):
    ref, nref = jax_fdlp(x, lens, JaxFdlpConfig(lpc_backend="scan", **kw))
    got, ngot = fdlp_spectrogram_batch(x, lens, FdlpConfig(**kw), device="cpu")
    nref = np.asarray(nref)
    np.testing.assert_array_equal(ngot.numpy(), nref)
    assert got.shape == ref.shape
    for b in range(len(lens)):
        T = int(nref[b])
        np.testing.assert_allclose(got[b, :T].numpy(), np.asarray(ref[b, :T]),
                                   rtol=RTOL, atol=ATOL)
    return got, ngot


@pytest.mark.parametrize("kw", [dict(nfilters=6), dict(nfilters=20, order=50)])
def test_fdlp_matches_jax_scan_backend(kw):
    x, lens = _ragged_batch()
    before = lpc_cepstra.launches
    _compare(x, lens, **kw)
    assert lpc_cepstra.launches == before  # no kernel on the CPU


def test_fdlp_cepstral_weights_match_jax():
    """Warped mel bank, odd-modulation zeroing and a lifter."""
    x, lens = _ragged_batch(n=12000, short=9000, seed=4)
    _compare(x, lens, nfilters=8, fbank_type="mel,0.9", odd_mod_zero=True,
             coeff_range="1,30", lifter_config=tuple(np.linspace(1, 2, 50)))


def test_fdlp_rejects_a_wrapping_filterbank_like_jax():
    """Cochlear bands are nonzero at both spectrum ends, so the banded
    autocorrelation would drop their wrap terms: both sides refuse."""
    x, lens = _ragged_batch()
    kw = dict(nfilters=8, fbank_type="cochlear,0.2,2.5,1,2.5,1")
    with pytest.raises(AssertionError):
        jax_fdlp(x, lens, JaxFdlpConfig(lpc_backend="scan", **kw))
    with pytest.raises(ValueError, match="wraps"):
        fdlp_spectrogram_batch(x, lens, FdlpConfig(**kw), device="cpu")


def test_fdlp_f64_matches_jax_f64():
    """The same fast-mode algebra in float64 on both sides (no ridge)."""
    x, lens = _ragged_batch(seed=2)
    ref, nref = jax_fdlp(x, lens, JaxFdlpConfig(nfilters=6, lpc_backend="scan"),
                         dtype=jnp.float64)
    got, _ = fdlp_spectrogram_batch(x, lens, FdlpConfig(nfilters=6),
                                    dtype=torch.float64, device="cpu")
    for b in range(2):
        T = int(nref[b])
        np.testing.assert_allclose(got[b, :T].numpy(), np.asarray(ref[b, :T]),
                                   rtol=1e-8, atol=1e-8)


def test_fdlp_jittered_ola_matches_jax():
    """The reference's +-1 frame OLA jitter, fed to both sides as the same
    explicit (B, F) array."""
    import jax

    from speech_recognition_tools_tpu.dsp import fdlp as jfdlp

    x, lens = _ragged_batch(n=16000, short=12000, seed=5)
    cfg = dict(nfilters=6)
    jcfg = JaxFdlpConfig(lpc_backend="scan", **cfg)
    F = 3
    jitter = np.random.RandomState(0).randint(0, 2, (2, F)).astype(np.int32)
    fbank = np.asarray(jfdlp._host_constants(jcfg)["fbank"])
    ref, nref = jfdlp._fdlp_impl(
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(fbank, jnp.float32), jcfg,
        x.shape[1], jnp.asarray(jitter))
    jax.block_until_ready(ref)
    got, ngot = fdlp_spectrogram_batch(x, lens, FdlpConfig(**cfg), jitter=jitter,
                                       device="cpu")
    np.testing.assert_array_equal(ngot.numpy(), np.asarray(nref))
    for b in range(2):
        T = int(nref[b])
        np.testing.assert_allclose(got[b, :T].numpy(), np.asarray(ref[b, :T]),
                                   rtol=RTOL, atol=ATOL)


def test_fdlp_finite_on_near_periodic_audio():
    """The near-periodic int16-scale input of
    tests/test_dsp_parity.py::test_fast_f32_finite_on_near_periodic_audio
    at the e2e front-end (80 bands, order 150, 1.5 s): the f32 ridge and
    the exponent cap keep every cell finite."""
    rs = np.random.RandomState(0)
    srate = 16000
    t = np.arange(4 * srate) / srate
    sig = np.zeros_like(t)
    for k in range(1, 12):
        sig += np.sin(2 * np.pi * 220.0 * k * t + rs.uniform(0, 6))
    sig = sig / np.abs(sig).max() * 18000 + rs.randn(len(t)) * 10
    cfg = FdlpConfig(nfilters=80, order=150, fduration=1.5, coeff_num=100,
                     coeff_range="1,100")
    feats, nout = fdlp_spectrogram_batch(sig[None], np.asarray([len(sig)]), cfg,
                                         device="cpu")
    out = feats[0, : int(nout[0])].numpy()
    assert out.shape == (400, 80)
    assert np.isfinite(out).all(), (~np.isfinite(out)).sum()


def test_fdlp_rejects_unported_modes():
    """precision='high' and lpc_backend='blocked' are ported (held to JAX
    in tests/test_torch_port_precision.py); what is still refused is what
    the JAX package refuses: StreamingFdlp takes the fast path only, with
    the JAX package's ValueError. The batch high path agrees with JAX's
    on this input within 1e-6."""
    from speech_recognition_tools_tpu.dsp.streaming import StreamingFdlp as JaxStreamingFdlp
    from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp

    for prec in ("high", "mixed"):
        with pytest.raises(ValueError, match="fast") as want:
            JaxStreamingFdlp(JaxFdlpConfig(nfilters=6, precision=prec))
        with pytest.raises(ValueError, match="fast") as got:
            StreamingFdlp(FdlpConfig(nfilters=6, precision=prec), device="cpu")
        assert str(got.value) == str(want.value)
    x, lens = _ragged_batch()
    ref, nref = jax_fdlp(x, lens, JaxFdlpConfig(nfilters=6, precision="high"))
    got, ngot = fdlp_spectrogram_batch(x, lens, FdlpConfig(nfilters=6, precision="high"),
                                       device="cpu")
    np.testing.assert_array_equal(ngot.numpy(), np.asarray(nref))
    for b in range(2):
        T = int(nref[b])
        np.testing.assert_allclose(got[b, :T].numpy(), np.asarray(ref[b, :T]),
                                   rtol=1e-6, atol=1e-6)


def test_fdlp_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x, lens = _ragged_batch()
    with pytest.raises(RuntimeError, match="cuda"):
        fdlp_spectrogram_batch(x, lens, FdlpConfig(nfilters=6))


# ---------------------------------------------------------------------- CLI


def _write_wavs(tmp_path):
    from scipy.io.wavfile import write as wav_write

    rng = np.random.RandomState(7)
    scp = tmp_path / "wav.scp"
    lines = []
    for i, n in enumerate((16000, 11000)):
        sig = np.clip(rng.randn(n) * 2000, -32768, 32767).astype(np.int16)
        path = tmp_path / f"utt{i}.wav"
        wav_write(str(path), 16000, sig)
        lines.append(f"utt{i} {path}\n")
    scp.write_text("".join(lines))
    return scp


def test_cli_matches_jax_cli(tmp_path):
    from speech_recognition_tools_tpu.cli import compute_fdlp_spectrogram as jcli
    from speech_recognition_tools_tpu.io import read_ark
    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram as tcli

    scp = _write_wavs(tmp_path)
    flags = ["--nfilters", "8", "--write_utt2num_frames"]
    jcli.main([str(scp), str(tmp_path / "jax"), *flags])
    tcli.main([str(scp), str(tmp_path / "port"), *flags, "--device", "cpu"])
    ref = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL)
    assert (tmp_path / "port.len").read_text() == (tmp_path / "jax.len").read_text()
    scp_lines = (tmp_path / "port.scp").read_text().splitlines()
    assert [ln.split()[0] for ln in scp_lines] == list(ref)


def test_cli_rejects_unported_flags(tmp_path, monkeypatch):
    """--precision high is ported (tests/test_torch_port_precision.py holds
    its ark to the JAX CLI's), and so is augmentation: --add_noise
    babble,10 with --add_reverb small_room, from a directory holding seeded
    noises/ and RIR/ wavs and with numpy seeded 0 before each CLI, gives the
    JAX CLI's ark (RTOL, ATOL). --data_parallel is not ported and raises
    before anything is written."""
    from test_torch_port_augment import write_augmentation_files

    from speech_recognition_tools_tpu.cli import compute_fdlp_spectrogram as jcli
    from speech_recognition_tools_tpu.io import read_ark
    from speech_recognition_tools_tpu_torch.cli import compute_fdlp_spectrogram as tcli

    scp = _write_wavs(tmp_path)
    with pytest.raises(NotImplementedError, match="item 5"):
        tcli.main([str(scp), str(tmp_path / "x"), "--device", "cpu", "--data_parallel"])
    assert not os.path.exists(str(tmp_path / "x.ark"))
    write_augmentation_files(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    flags = ["--nfilters", "8", "--add_noise", "babble,10", "--add_reverb", "small_room"]
    np.random.seed(0)
    jcli.main([str(scp), str(tmp_path / "jax"), *flags])
    np.random.seed(0)
    tcli.main([str(scp), str(tmp_path / "port"), *flags, "--device", "cpu"])
    ref = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL)
