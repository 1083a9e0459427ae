"""The port's MFCC and mel front-ends held against the JAX package: frame
splicing, CMVN statistics, deltas and PCA, `mfcc_batch`,
`mel_spectrum_batch`, the compute_mfcc / compute_mel_spectrum CLIs and
their arks, and the featgen CLIs' --profile_dir.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU with the conftest's x64, the port on the CPU. float64
comparisons hold the port to 1e-9 (the same algebra, summed in another
order); each float32 comparison states its own tolerance.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp.melspec import MelConfig as JMelConfig
from speech_recognition_tools_tpu.dsp.melspec import mel_spectrum_batch as jmel
from speech_recognition_tools_tpu.dsp.mfcc import MfccConfig as JMfccConfig
from speech_recognition_tools_tpu.dsp.mfcc import mfcc_batch as jmfcc
from speech_recognition_tools_tpu.utils import cmvn as jcmvn
from speech_recognition_tools_tpu.utils import splice as jsplice
from speech_recognition_tools_tpu.utils import transforms as jtr
from speech_recognition_tools_tpu_torch.dsp.melspec import MelConfig, mel_spectrum_batch
from speech_recognition_tools_tpu_torch.dsp.mfcc import MfccConfig, mfcc_batch
from speech_recognition_tools_tpu_torch.utils import cmvn as tcmvn
from speech_recognition_tools_tpu_torch.utils import splice as tsplice
from speech_recognition_tools_tpu_torch.utils import transforms as ttr

torch.set_num_threads(1)

# recipes/configs/wsj_hybrid.json's front-end: MFCC at 16 kHz, 13 cepstra,
# 100 Hz, with the CLI's defaults (30 filters, 0.02 s, nfft 1024)
WSJ_HYBRID = dict(srate=16000, nfilters=30, fduration=0.02, frate=100, nfft=1024, num_ceps=13)


def _batch(lens=(16000, 9000, 4321, 7000), seed=0, scale=3000.0):
    rs = np.random.RandomState(seed)
    x = np.zeros((len(lens), max(lens)))
    for b, n in enumerate(lens):
        x[b, :n] = rs.randn(n) * scale
    return x, np.asarray(lens)


def _valid_close(got, n_got, want, n_want, rtol, atol):
    np.testing.assert_array_equal(np.asarray(n_got), np.asarray(n_want))
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    for b, n in enumerate(np.asarray(n_want)):
        np.testing.assert_allclose(got[b, : int(n)], want[b, : int(n)], rtol=rtol, atol=atol)


# ------------------------------------------------------------------ host transforms


def test_splice_feats_with_lengths_is_the_per_utterance_splice():
    """num_frames ends each utterance at its own length: each row of the
    batch is the JAX splice of that utterance alone (exactly)."""
    x = np.random.RandomState(5).randn(3, 12, 2)
    n = np.array([12, 7, 3])
    got = tsplice.splice_feats(torch.as_tensor(x), 2, torch.as_tensor(n)).numpy()
    for b, k in enumerate(n):
        np.testing.assert_array_equal(
            got[b, :k], np.asarray(jsplice.splice_feats(jnp.asarray(x[b, :k]), 2)))


@pytest.mark.parametrize("T,context", [(20, 4), (9, 1), (3, 4), (5, 0)])
def test_splice_feats_matches_jax(T, context):
    """(T, D) and a (B, T, D) batch, exactly; the last `context` rows are
    zero (all of them when T <= context)."""
    x = np.random.RandomState(T).randn(2, T, 3)
    got = tsplice.splice_feats(torch.as_tensor(x), context).numpy()
    assert got.shape == (2, T, 3 * (2 * context + 1))
    for b in range(2):
        want = np.asarray(jsplice.splice_feats(jnp.asarray(x[b]), context))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(tsplice.splice_feats(torch.as_tensor(x[b]),
                                                           context).numpy(), want)
    if context:
        assert not got[:, max(T - context, 0):].any()


def test_splice_zero_tail_survives_non_finite_rows():
    """The zero tail is a select, as in JAX: a -inf frame (log of a silent
    mel band) does not turn the tail into NaN."""
    x = np.random.RandomState(1).randn(8, 2)
    x[-1, 0] = -np.inf
    got = tsplice.splice_feats(torch.as_tensor(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsplice.splice_feats(jnp.asarray(x), 2)))
    assert not got[-2:].any()


@pytest.mark.parametrize("shape", [(40, 5), (3, 17, 5)])
def test_cmvn_stats_match_jax(shape):
    """Global mean and the population std (ddof 0), float64, rtol 1e-12."""
    x = np.random.RandomState(2).randn(*shape) * 3 + 1
    mean, std = tcmvn.cmvn_stats(torch.as_tensor(x))
    jm, js = jcmvn.cmvn_stats(jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), x.reshape(-1, shape[-1]).std(0), rtol=1e-12)


def test_cmvn_stats_masked_matches_jax():
    x = np.random.RandomState(3).randn(3, 17, 5) * 2 - 1
    n = np.array([17, 9, 4])
    mean, std = tcmvn.cmvn_stats_masked(torch.as_tensor(x), torch.as_tensor(n))
    jm, js = jcmvn.cmvn_stats_masked(jnp.asarray(x), jnp.asarray(n))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), rtol=1e-12)
    valid = np.concatenate([x[b, :k] for b, k in enumerate(n)])
    np.testing.assert_allclose(std.numpy(), valid.std(0), rtol=1e-12)


@pytest.mark.parametrize("order,window,T", [(2, 2, 50), (1, 2, 3), (2, 2, 1), (2, 3, 2),
                                            (3, 1, 7)])
def test_add_deltas_matches_jax(order, window, T):
    """Kaldi deltas with clamped edges, including T below the window,
    float64 rtol 1e-12, on (T, D) and (B, T, D)."""
    x = np.random.RandomState(T).randn(2, T, 4)
    got = ttr.add_deltas(torch.as_tensor(x), order, window).numpy()
    want = np.asarray(jtr.add_deltas(jnp.asarray(x), order, window))
    assert got.shape == want.shape == (2, T, 4 * (order + 1))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ttr.add_deltas(torch.as_tensor(x[0]), order, window).numpy(),
                               want[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dim,normalize", [(None, False), (3, True)])
def test_pca_matches_jax(dim, normalize):
    rs = np.random.RandomState(4)
    x = rs.randn(200, 6) @ rs.randn(6, 6) + 2.0
    T, m = ttr.estimate_pca(x, dim, normalize)
    jT, jm = jtr.estimate_pca(x, dim, normalize)
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_allclose(ttr.apply_pca(x, T, m), np.asarray(jtr.apply_pca(x, jT, jm)),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ front-ends


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mfcc_batch_matches_jax(dtype):
    """wsj_hybrid's MFCC on four uneven utterances: float64 to 1e-9 (the
    DCT and FFT in another order) and float32 at atol 1e-4 (reading
    ~8e-6 on these int16-scale inputs) on valid frames."""
    x, lens = _batch()
    tdt, jdt, tol = ((torch.float64, np.float64, 1e-9) if dtype == "float64"
                     else (torch.float32, np.float32, 1e-4))
    got, n = mfcc_batch(x, lens, MfccConfig(**WSJ_HYBRID), dtype=tdt, device="cpu")
    want, m = jmfcc(x, lens, JMfccConfig(**WSJ_HYBRID), dtype=jdt)
    assert got.dtype == tdt and got.shape[-1] == 13 and torch.isfinite(got).all()
    _valid_close(got.numpy(), n, want, m, rtol=tol if tdt == torch.float64 else 0, atol=tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mfcc_context_splices_each_utterance_as_jax_does_alone(dtype):
    """With context 4 each utterance of the padded batch equals the JAX
    function run on that utterance alone (float64 1e-9, float32 atol
    1e-4), its last 4 rows zero. The JAX batch agrees on every row it
    splices from valid frames only; its last 4 valid rows of a shorter
    utterance take frames past the end (finite garbage or NaN), where the
    port keeps the reference's zeros."""
    x, lens = _batch()
    ctx = 4
    cfg = dict(WSJ_HYBRID, context=ctx)
    tdt, jdt, tol = ((torch.float64, np.float64, 1e-9) if dtype == "float64"
                     else (torch.float32, np.float32, 1e-4))
    got, n = mfcc_batch(x, lens, MfccConfig(**cfg), dtype=tdt, device="cpu")
    assert got.shape[-1] == 13 * 9 and torch.isfinite(got).all()
    got = got.numpy()
    batch, m = jmfcc(x, lens, JMfccConfig(**cfg), dtype=jdt)
    batch = np.asarray(batch)
    np.testing.assert_array_equal(n.numpy(), np.asarray(m))
    rtol = tol if tdt == torch.float64 else 0
    for b, k in enumerate(lens):
        f = int(n[b])
        alone, m1 = jmfcc(x[b : b + 1, :k], lens[b : b + 1], JMfccConfig(**cfg), dtype=jdt)
        assert int(m1[0]) == f
        np.testing.assert_allclose(got[b, :f], np.asarray(alone)[0], rtol=rtol, atol=tol)
        assert not got[b, f - ctx : f].any()
        np.testing.assert_allclose(got[b, : f - ctx], batch[b, : f - ctx], rtol=rtol, atol=tol)
        if f < got.shape[1]:
            assert np.abs(np.nan_to_num(batch[b, f - ctx : f], nan=1.0)).max() > 0


@pytest.mark.parametrize("spectrum_type", ["log", "power"])
@pytest.mark.parametrize("fbank_type", ["mel,1", "mel,0.9", "cochlear,0.2,2.5,1,2.5,1.0"])
def test_mel_spectrum_batch_matches_jax(spectrum_type, fbank_type):
    """The CLI's defaults (23 filters) in float64, rtol 1e-9 with atol 1e-9
    of the largest value; float32 log at atol 1e-4."""
    x, lens = _batch(seed=1)
    cfg = dict(spectrum_type=spectrum_type, fbank_type=fbank_type)
    got, n = mel_spectrum_batch(x, lens, MelConfig(**cfg), dtype=torch.float64, device="cpu")
    want, m = jmel(x, lens, JMelConfig(**cfg), dtype=np.float64)
    _valid_close(got.numpy(), n, want, m, rtol=1e-9,
                 atol=1e-9 * float(np.abs(np.asarray(want)).max()))
    if spectrum_type == "log":
        got, n = mel_spectrum_batch(x, lens, MelConfig(**cfg), device="cpu")
        want, m = jmel(x, lens, JMelConfig(**cfg))
        _valid_close(got.numpy(), n, want, m, rtol=0, atol=1e-4)


def test_front_ends_reject_bad_spectrum_type_and_default_to_the_card():
    x, lens = _batch(lens=(4000,))
    with pytest.raises(ValueError, match="spectrum_type"):
        mel_spectrum_batch(x, lens, MelConfig(spectrum_type="db"), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        mfcc_batch(x, lens)
    with pytest.raises(RuntimeError, match="cuda"):
        mel_spectrum_batch(x, lens)


# ------------------------------------------------------------------ CLIs


def _write_wavs(tmp_path, lengths=(16000, 11000, 5300)):
    from scipy.io.wavfile import write as wav_write

    rng = np.random.RandomState(7)
    lines = []
    for i, n in enumerate(lengths):
        sig = np.clip(rng.randn(n) * 2000, -32768, 32767).astype(np.int16)
        path = tmp_path / f"utt{i}.wav"
        wav_write(str(path), 16000, sig)
        lines.append(f"utt{i} {path}\n")
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(lines))
    return scp


def _write_segments(tmp_path, scp):
    """A Kaldi segments file over the first two recordings."""
    seg = tmp_path / "segments"
    seg.write_text("s0 utt0 0.10 0.55\ns1 utt0 0.50 0.98\ns2 utt1 0.00 0.60\n")
    rec = tmp_path / "rec.scp"
    rec.write_text("".join(scp.read_text().splitlines(keepends=True)[:2]))
    return seg, rec


def _arks_close(tmp_path, atol, tail=0):
    """The two CLIs' arks: same keys in the same order, shapes and float32
    values within atol; with `tail`, the port's last `tail` rows are zero
    and only the rows before them are compared (where the JAX CLI's batch
    splices frames past a shorter utterance's end)."""
    from speech_recognition_tools_tpu.io import read_ark

    want = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32
        n = got[key].shape[0] - tail
        assert not got[key][n:].any()
        np.testing.assert_allclose(got[key][:n], want[key][:n], rtol=0, atol=atol)
    assert [ln.split()[0] for ln in (tmp_path / "port.scp").read_text().splitlines()] == \
        list(want)
    return got


@pytest.mark.parametrize("flags", [["--write_utt2num_frames"],
                                   ["--context", "4", "--nfilters", "23", "--kaldi_cmd", "x"]])
def test_compute_mfcc_cli_matches_jax_cli(tmp_path, flags):
    """compute_mfcc.main against the JAX CLI on a wav scp: the same keys,
    order, shapes and float32 values (atol 1e-4) in the ark, the same
    utt2num_frames file."""
    from speech_recognition_tools_tpu.cli import compute_mfcc as jcli
    from speech_recognition_tools_tpu_torch.cli import compute_mfcc as tcli

    scp = _write_wavs(tmp_path)
    jcli.main([str(scp), str(tmp_path / "jax"), *flags])
    tcli.main([str(scp), str(tmp_path / "port"), *flags, "--device", "cpu"])
    ctx = 4 if "--context" in flags else 0
    got = _arks_close(tmp_path, atol=1e-4, tail=ctx)
    assert got["utt0"].shape == (100, 13 * (2 * ctx + 1))
    if "--write_utt2num_frames" in flags:
        assert (tmp_path / "port.len").read_text() == (tmp_path / "jax.len").read_text()


@pytest.mark.parametrize("mode", ["scp", "segment"])
def test_compute_mel_spectrum_cli_matches_jax_cli(tmp_path, mode):
    """compute_mel_spectrum.main against the JAX CLI, from a wav scp and
    from a segments file (--scp_type segment --wav_scp): ark values at
    atol 1e-4, utt2num_frames identical."""
    from speech_recognition_tools_tpu.cli import compute_mel_spectrum as jcli
    from speech_recognition_tools_tpu_torch.cli import compute_mel_spectrum as tcli

    scp = _write_wavs(tmp_path)
    flags = ["--write_utt2num_frames", "--spectrum_type", "log"]
    src = str(scp)
    if mode == "segment":
        seg, rec = _write_segments(tmp_path, scp)
        src = str(seg)
        flags += ["--scp_type", "segment", "--wav_scp", str(rec)]
    jcli.main([src, str(tmp_path / "jax"), *flags])
    tcli.main([src, str(tmp_path / "port"), *flags, "--device", "cpu"])
    got = _arks_close(tmp_path, atol=1e-4)
    assert sorted(got) == (["s0", "s1", "s2"] if mode == "segment" else ["utt0", "utt1", "utt2"])
    assert (tmp_path / "port.len").read_text() == (tmp_path / "jax.len").read_text()


@pytest.mark.parametrize("cli", ["compute_mfcc", "compute_mel_spectrum",
                                 "compute_fdlp_spectrogram"])
def test_profile_dir_writes_a_trace(tmp_path, cli, capsys):
    """--profile_dir writes a Chrome trace (JSON with traceEvents) of the
    extraction, and the throughput meter's summary is printed."""
    import importlib

    mod = importlib.import_module(f"speech_recognition_tools_tpu_torch.cli.{cli}")
    scp = _write_wavs(tmp_path, lengths=(8000, 6000))
    prof = tmp_path / "prof"
    extra = ["--nfilters", "8"] if cli == "compute_fdlp_spectrogram" else []
    mod.main([str(scp), str(tmp_path / "out"), "--profile_dir", str(prof), *extra,
              "--device", "cpu"])
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1, os.listdir(prof)
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert "2 items in" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out.ark")


@pytest.mark.parametrize("cli", ["compute_mfcc", "compute_mel_spectrum",
                                 "compute_fdlp_spectrogram"])
@pytest.mark.parametrize("extra,match", [(["--add_noise", "babble,10"], None),
                                         (["--add_noise", "diff"], None),
                                         (["--add_reverb", "small_room"], None),
                                         (["--data_parallel"], "item 5")],
                         ids=["extra0-item 9", "extra1-item 9", "extra2-item 9",
                              "extra3-item 10"])
def test_unported_featgen_flags_raise(tmp_path, monkeypatch, cli, extra, match):
    """--data_parallel, not yet ported, raises NotImplementedError naming
    its ROADMAP item before anything is read or written. The augmentation
    flags are ported: from a directory holding seeded noises/babble.wav and
    RIR/ wavs, with numpy seeded 0 before each CLI, the port's ark matches
    the JAX CLI's (MFCC and mel atol 1e-4 as above; FDLP at
    tests/test_torch_port_fdlp.py's rtol 1e-3, atol 2e-3)."""
    import importlib

    mod = importlib.import_module(f"speech_recognition_tools_tpu_torch.cli.{cli}")
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            mod.main([str(tmp_path / "missing.scp"), str(tmp_path / "x"), *extra, "--device",
                      "cpu"])
        assert not os.listdir(tmp_path)
        return
    from test_torch_port_augment import write_augmentation_files

    from speech_recognition_tools_tpu.io import read_ark

    jmod = importlib.import_module(f"speech_recognition_tools_tpu.cli.{cli}")
    scp = _write_wavs(tmp_path)
    write_augmentation_files(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    flags = ["--nfilters", "8"] if cli == "compute_fdlp_spectrogram" else []
    np.random.seed(0)
    jmod.main([str(scp), str(tmp_path / "jax"), *flags, *extra])
    np.random.seed(0)
    mod.main([str(scp), str(tmp_path / "port"), *flags, *extra, "--device", "cpu"])
    if cli != "compute_fdlp_spectrogram":
        _arks_close(tmp_path, atol=1e-4)
        return
    want = dict(read_ark(str(tmp_path / "jax.ark")))
    got = dict(read_ark(str(tmp_path / "port.ark")))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=2e-3)


def test_clean_augmentation_flags_add_nothing(tmp_path):
    """--add_noise clean and --add_reverb clean are accepted and change
    nothing, as in the JAX CLIs."""
    from speech_recognition_tools_tpu_torch.cli import compute_mfcc as tcli
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import read_ark

    scp = _write_wavs(tmp_path, lengths=(6000,))
    tcli.main([str(scp), str(tmp_path / "a"), "--device", "cpu"])
    tcli.main([str(scp), str(tmp_path / "b"), "--add_noise", "clean", "--add_reverb", "clean",
               "--device", "cpu"])
    (ka, a), = read_ark(str(tmp_path / "a.ark"))
    (kb, b), = read_ark(str(tmp_path / "b.ark"))
    assert ka == kb and np.array_equal(a, b)
