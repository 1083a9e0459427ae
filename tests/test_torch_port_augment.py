"""The port's augmentation and simulation held against the JAX package:
dsp/augment.py (add_noise_snr on JAX's uniforms, add_awgn, apply_diff_fir,
add_reverb), dsp/simulate.py (synth_rir and simulate_utterance on JAX's
draws, fft_convolve_full, simulate_corpus's layout), the featgen CLIs'
host augmentation (cli/common.py::augment against the JAX CLIs'
load_signals, with numpy's global seed set before each), and the
multichannel reads of io/wav.py.

float64 on both sides (the conftest's x64): values within 1e-12 relative;
the CLI augmentation is the same numpy code and must be identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read as wav_read
from scipy.io.wavfile import write as wav_write

from speech_recognition_tools_tpu.dsp import augment as jaug
from speech_recognition_tools_tpu.dsp import simulate as jsim
from speech_recognition_tools_tpu.io import wav as jwav
from speech_recognition_tools_tpu_torch.dsp import augment as taug
from speech_recognition_tools_tpu_torch.dsp import simulate as tsim
from speech_recognition_tools_tpu_torch.io import wav as twav

torch.set_num_threads(1)

SR = 16000
CPU = "cpu"
NOISE_NAME = "babble"


def write_augmentation_files(directory, seed=0, noise_s=3.0, rir_len=1600,
                             noise_dtype=np.float32):
    """The files the featgen CLIs read for --add_noise <NOISE_NAME>,snr and
    --add_reverb: noises/<NOISE_NAME>.wav (mono, float32 by default; an
    int16 noise wav meets the JAX CLIs' int16 energy overflow, ROADMAP
    Queue 3) and the three rooms' two-channel int16 RIRs under RIR/, made
    from a seed."""
    from speech_recognition_tools_tpu_torch.cli.common import RIR_FILES

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(directory, "noises"), exist_ok=True)
    os.makedirs(os.path.join(directory, "RIR"), exist_ok=True)
    noise = np.clip(rs.randn(int(noise_s * SR)) * 3000, -32768, 32767).astype(noise_dtype)
    wav_write(os.path.join(directory, "noises", f"{NOISE_NAME}.wav"), SR, noise)
    for i, rel in enumerate(RIR_FILES.values()):
        decay = np.exp(-np.arange(rir_len) / (rir_len / (6.0 + 2 * i)))
        rir = rs.randn(rir_len, 2) * decay[:, None] * 0.3
        rir[10 + i, :] = 1.0
        wav_write(os.path.join(directory, rel), SR, (rir * 16000).astype(np.int16))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- augment


@pytest.mark.parametrize("ragged", [False, True])
def test_add_noise_snr_on_jax_uniforms(ragged):
    rs = np.random.RandomState(1)
    sig, noise = rs.randn(3, 4000) * 1000, rs.randn(9000) * 300
    n = np.array([4000, 2500, 3100]) if ragged else None
    key = jax.random.key(5)
    want = np.asarray(jaug.add_noise_snr(key, jnp.asarray(sig), jnp.asarray(noise), 10.0,
                                         None if n is None else jnp.asarray(n)))
    u = np.asarray(jax.random.uniform(key, (3,)))
    got = taug.add_noise_snr(sig, noise, 10.0, n, uniforms=u, device=CPU).numpy()
    assert _rel(got, want) <= 1e-12
    one = taug.add_noise_snr(sig[0], noise, 10.0, uniforms=u[:1], device=CPU)
    assert one.shape == (4000,)
    drawn = taug.add_noise_snr(sig, noise, 10.0, generator=torch.Generator().manual_seed(0),
                               device=CPU)
    assert drawn.shape == sig.shape and torch.isfinite(drawn).all()


def test_add_awgn_and_diff_fir_match_jax():
    rs = np.random.RandomState(2)
    sig, noise = rs.randn(2, 3000), rs.randn(2, 3000)
    assert _rel(taug.add_awgn(sig, noise, 5.0, device=CPU).numpy(),
                np.asarray(jaug.add_awgn(jnp.asarray(sig), jnp.asarray(noise), 5.0))) <= 1e-12
    for x in (sig, sig[0]):
        got = taug.apply_diff_fir(x, device=CPU).numpy()
        assert _rel(got, np.asarray(jaug.apply_diff_fir(jnp.asarray(x)))) <= 1e-12
        assert _rel(got, np.stack([np.convolve(r, taug.DIFF_FIR, "same")
                                   for r in np.atleast_2d(x)]).reshape(x.shape)) <= 1e-12


@pytest.mark.parametrize("m", [400, 1])
def test_add_reverb_matches_jax(m):
    rs = np.random.RandomState(3)
    sig = rs.randn(5000)
    rir = rs.randn(m) * np.exp(-np.arange(m) / 80.0)
    want = np.asarray(jaug.add_reverb(jnp.asarray(sig), jnp.asarray(rir)))
    got = taug.add_reverb(sig, rir, device=CPU).numpy()
    assert _rel(got, want) <= 1e-12


# -------------------------------------------------------------- simulate


def test_synth_rir_on_jax_draws():
    key = jax.random.key(7)
    want = np.asarray(jsim.synth_rir(key, n_channels=3, fs=SR, t60=0.2))
    k_shared, k_diffuse = jax.random.split(key)
    L = want.shape[1]
    draws = (np.asarray(jax.random.normal(k_shared, (L,))),
             np.asarray(jax.random.normal(k_diffuse, (3, L))))
    got = tsim.synth_rir(3, SR, 0.2, draws=draws, dtype=torch.float64, device=CPU).numpy()
    assert _rel(got, want) <= 1e-12
    drawn = tsim.synth_rir(3, SR, 0.2, generator=torch.Generator().manual_seed(0), device=CPU)
    assert drawn.shape == want.shape and drawn.dtype == torch.float32
    for c in range(3):  # the unit direct path at 40 + c * round(2.9e-4 * SR)
        assert drawn[c, 40 + 5 * c] == 1 and (drawn[c, : 40 + 5 * c] == 0).all()


def test_fft_convolve_full_matches_jax():
    rs = np.random.RandomState(4)
    sig, rir = rs.randn(2, 777), rs.randn(2, 123)
    want = np.asarray(jsim.fft_convolve_full(jnp.asarray(sig), jnp.asarray(rir)))
    got = tsim.fft_convolve_full(torch.as_tensor(sig), torch.as_tensor(rir)).numpy()
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("noise_kind", ["white", "mono", "multichannel"])
def test_simulate_utterance_on_jax_draws(noise_kind):
    rs = np.random.RandomState(6)
    clean = rs.randn(4000)
    rirs = np.asarray(jsim.synth_rir(jax.random.key(1), 3, SR, 0.1))
    key = jax.random.key(2)
    noise = {"white": None, "mono": rs.randn(9000), "multichannel": rs.randn(3, 9000)}[noise_kind]
    want = jsim.simulate_utterance(key, jnp.asarray(clean), jnp.asarray(rirs),
                                   None if noise is None else jnp.asarray(noise), 15.0,
                                   return_components=True)
    kw = {}
    if noise is None:
        kw["white"] = np.asarray(jax.random.normal(key, (3, 4000)))
    else:
        kw["offset"] = int(jax.random.randint(key, (), 0, max(noise.shape[-1] - 4000, 1)))
    got = tsim.simulate_utterance(torch.as_tensor(clean), torch.as_tensor(rirs),
                                  None if noise is None else torch.as_tensor(noise), 15.0,
                                  return_components=True, **kw)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-12


def test_simulate_corpus_writes_the_jax_layout(tmp_path):
    """The same files and scp lines (paths under each out_dir), float32 wavs
    of the same shapes, the mixture = wet + noise on channel 0, and the same
    metadata keys; the values differ (torch.Generator draws)."""
    rs = np.random.RandomState(8)
    utts = [(f"u{i}", rs.randn(3000).astype(np.float32)) for i in range(2)]  # one jit shape
    noise = rs.randn(9000).astype(np.float32)
    jm = jsim.simulate_corpus(utts, str(tmp_path / "j"), fs=SR, n_channels=2, snr_db=15.0,
                              noise=noise, seed=3)
    tm = tsim.simulate_corpus(utts, str(tmp_path / "t"), fs=SR, n_channels=2, snr_db=15.0,
                              noise=noise, seed=3, device=CPU)
    assert list(tm) == list(jm)
    for u in tm:
        assert set(tm[u]) == set(jm[u]) and tm[u]["t60"] in (0.25, 0.5, 0.7)
        assert tm[u]["snr_db"] == jm[u]["snr_db"] and tm[u]["n_channels"] == 2
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        if name.endswith(".scp"):
            a = (tmp_path / "t" / name).read_text().replace(str(tmp_path / "t"), "D")
            b = (tmp_path / "j" / name).read_text().replace(str(tmp_path / "j"), "D")
            assert a == b, name
        else:
            (sa, xa), (sb, xb) = wav_read(tmp_path / "t" / name), wav_read(tmp_path / "j" / name)
            assert sa == sb and xa.dtype == xb.dtype == np.float32 and xa.shape == xb.shape
    _, obs = wav_read(tmp_path / "t" / "u1_ch0.wav")
    _, wet = wav_read(tmp_path / "t" / "u1_wet.wav")
    _, ns = wav_read(tmp_path / "t" / "u1_noise.wav")
    np.testing.assert_allclose(obs, wet + ns, atol=1e-4)


# --------------------------------------------------- the CLIs' augmentation


@pytest.mark.parametrize("flags", [dict(add_noise=f"{NOISE_NAME},10"), dict(add_noise="diff"),
                                   dict(add_reverb="small_room"),
                                   dict(add_noise=f"{NOISE_NAME},5", add_reverb="large_room"),
                                   dict(add_noise="clean", add_reverb="clean")],
                         ids=["noise", "diff", "reverb", "noise+reverb", "clean"])
def test_cli_augmentation_is_the_jax_clis(tmp_path, monkeypatch, flags):
    """cli/common.py::load_signals against the JAX CLIs' on the same wavs,
    numpy seeded the same before each: identical samples."""
    import argparse

    from speech_recognition_tools_tpu.cli import common as jcommon
    from speech_recognition_tools_tpu_torch.cli import common as tcommon

    _noisy_scp(tmp_path, np.float32)
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(scp="wav.scp", **{"add_noise": None, "add_reverb": None, **flags})
    np.random.seed(0)
    want = jcommon.load_signals(args, SR)
    np.random.seed(0)
    got = tcommon.load_signals(args, SR)
    assert [k for k, _ in got] == [k for k, _ in want] == ["utt0", "utt1"]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _noisy_scp(tmp_path, noise_dtype):
    write_augmentation_files(str(tmp_path), noise_dtype=noise_dtype)
    rs = np.random.RandomState(9)
    lines = []
    for i, n in enumerate((16000, 7000)):
        p = tmp_path / f"utt{i}.wav"
        wav_write(str(p), SR, (rs.randn(n) * 2000).astype(np.int16))
        lines.append(f"utt{i} {p}\n")
    (tmp_path / "wav.scp").write_text("".join(lines))


@pytest.mark.parametrize("noise_dtype", [np.float32, np.int16], ids=["float32", "int16"])
def test_cli_noise_snr_and_the_int16_energy_overflow_of_both(tmp_path, monkeypatch,
                                                             noise_dtype):
    """A float32 noise wav is mixed at exactly the requested 10 dB. An int16
    one (the reference corpora's noise recordings are int16) is squared in
    int16 by the JAX CLIs' energy (`np.mean(ns**2)`), which wraps: the
    gain is garbage or NaN. The port reproduces it sample for sample
    (ROADMAP Queue 3)."""
    import argparse

    from speech_recognition_tools_tpu.cli import common as jcommon
    from speech_recognition_tools_tpu_torch.cli import common as tcommon

    _noisy_scp(tmp_path, noise_dtype)
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(scp="wav.scp", add_noise=f"{NOISE_NAME},10", add_reverb=None)
    np.random.seed(0)
    clean = [s for _, s in tcommon.load_signals(argparse.Namespace(scp="wav.scp"), SR)]
    np.random.seed(0)
    want = jcommon.load_signals(args, SR)
    np.random.seed(0)
    with np.errstate(invalid="ignore"):
        got = tcommon.load_signals(args, SR)
    snr = []
    for c, (_, a), (_, b) in zip(clean, got, want):
        np.testing.assert_array_equal(a, b)
        snr.append(10 * np.log10(np.mean(c**2) / np.mean((a - c) ** 2)))
    if noise_dtype is np.float32:
        np.testing.assert_allclose(snr, 10.0, atol=1e-9)
    else:
        assert not np.allclose(snr, 10.0, atol=0.5, equal_nan=False), snr


# ------------------------------------------------------- multichannel reads


def test_multichannel_reads_match_jax(tmp_path):
    rs = np.random.RandomState(10)
    mc = (rs.randn(3000, 3) * 1000).astype(np.int16)
    p = str(tmp_path / "mc.wav")
    wav_write(p, SR, mc)
    for keep in (False, True):
        a, b = twav.read_wav_scp_entry(p, SR, keep_channels=keep), jwav.read_wav_scp_entry(
            p, SR, keep_channels=keep)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    pipe = f"cat {p} |"
    np.testing.assert_array_equal(twav.read_wav_scp_entry(pipe, keep_channels=True)[1],
                                  mc.astype(np.float64))
    with pytest.raises(ValueError):
        twav.read_wav_scp_entry(p, 8000)
    mono = str(tmp_path / "mono.wav")
    wav_write(mono, SR, mc[:2000, 0])
    entries = [("a", p), ("missing", str(tmp_path / "nope.wav")), ("b", mono)]
    for kw in ({}, {"max_samples": 2500}):
        got, want = twav.load_wav_batch(entries, SR, **kw), jwav.load_wav_batch(entries, SR, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert twav.load_wav_batch([("x", mono)], 8000)[2] == []
    x = rs.randn(SR * 2)
    np.testing.assert_array_equal(twav.extract_segment(x, SR, 0.25, 1.5),
                                  jwav.extract_segment(x, SR, 0.25, 1.5))
