"""The port's online path held against the JAX package: the streaming FDLP
front-end (StreamingFdlp), the per-chunk encoder step (make_stream_step),
the multi-stream StreamBatcher (eviction, deferral, endpointing restarts),
StreamingRecognizer and OnlineASRPipeline from audio to tokens.

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise, carried over by io/jax_params.py). The JAX
side runs on the CPU with the conftest's x64 and float32 inputs; the port
runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.dsp import FdlpConfig as JFdlpConfig
from speech_recognition_tools_tpu.dsp.streaming import StreamingFdlp as JStreamingFdlp
from speech_recognition_tools_tpu.infer import streaming_asr as jsa
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu_torch.decode.beam_jit import (
    beam_search_batched,
    tokens_to_list,
)
from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig, fdlp_spectrogram_batch
from speech_recognition_tools_tpu_torch.dsp.streaming import StreamingFdlp
from speech_recognition_tools_tpu_torch.infer import streaming_asr as tsa
from speech_recognition_tools_tpu_torch.io.jax_params import transformer_asr_from_jax
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr

torch.set_num_threads(1)

FD = dict(srate=8000, nfilters=8, fduration=0.25, coeff_num=20, order=20)
D = 8
MODEL = dict(vocab_size=11, adim=16, aheads=2, elayers=2, eunits=32, dlayers=1, dunits=32,
             dropout=0.0)


def _signal(n, seed):
    """AR(2) noise with a syllable-rate envelope (tests/test_serve.py's)."""
    rs = np.random.RandomState(seed)
    e = rs.randn(n).astype(np.float32)
    sig = np.zeros(n, np.float32)
    for t in range(2, n):
        sig[t] = 1.2 * sig[t - 1] - 0.5 * sig[t - 2] + e[t]
    return (sig * (0.4 + 0.3 * np.sin(2 * np.pi * np.arange(n) * 3.0 / 8000))
            * 300).astype(np.float32)


def _models(chunk, left, seed=0):
    """(jax model, params, port model) on the same perturbed weights."""
    cfg = dict(MODEL, attn_chunk=chunk, attn_left_chunks=left)
    jmodel = jtasr.TransformerASR(jtasr.TransformerASRConfig(**cfg))
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.zeros((1, 23, D), jnp.float32),
                         jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    rs = np.random.RandomState(seed + 100)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**cfg), D, device="cpu")
    port.load_state_dict(transformer_asr_from_jax(params))
    return jmodel, params, port.eval()


@pytest.fixture(scope="module")
def m42():
    return _models(4, 2, seed=21)


def _stream(streamer, x, sizes):
    outs = [streamer.process(x[off : off + sizes]) for off in range(0, len(x), sizes)]
    outs.append(streamer.finish())
    return np.concatenate(outs, axis=0)


# ------------------------------------------------------------------ featgen


@pytest.mark.parametrize("push", [700, 2000, 5000, None])
def test_streaming_fdlp_matches_jax(push):
    """Port streamer against the JAX streamer on the same pushes (None: one
    push of the whole signal). In float64 both round the float64 log to
    float32 on emit, so they agree to one float32 ulp (rtol 1.2e-7; the
    float64 envelopes themselves agree to 1e-9, test below); in float32 at
    atol 1e-4 (reading 5.1e-5 on every push size). Frame counts equal; the port's
    streamed features equal its batch path's (float64 1.2e-7, float32 2e-5,
    the JAX streamer's own bound)."""
    n = 2 * 8000 + 321
    x = _signal(n, 17)
    push = push or n
    cfg = FdlpConfig(**FD)
    for tdt, jdt, tol in ((torch.float64, jnp.float64, 1.2e-7),
                          (torch.float32, jnp.float32, 1e-4)):
        got = _stream(StreamingFdlp(cfg, block_frames=3, dtype=tdt, device="cpu"), x, push)
        want = _stream(JStreamingFdlp(JFdlpConfig(**FD), block_frames=3, dtype=jdt), x, push)
        assert got.shape == want.shape == (-(-n * 100 // 8000), FD["nfilters"])
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol if tdt == torch.float64 else 0, atol=tol)
        batch, nb = fdlp_spectrogram_batch(x[None], [n], cfg, dtype=tdt, device="cpu")
        batch = batch[0, : int(nb[0])].numpy()
        btol = 1.2e-7 if tdt == torch.float64 else 2e-5
        np.testing.assert_allclose(got, batch, rtol=btol, atol=btol)


def test_window_envelopes_match_jax_f64():
    """The per-window chain both streamers and the batch path share, on one
    block of windows, against JAX's _stream_envelopes in float64 (rtol
    1e-9, atol 1e-9 of the largest envelope)."""
    from speech_recognition_tools_tpu.dsp.streaming import _stream_envelopes
    from speech_recognition_tools_tpu.dsp.fdlp import _host_constants
    from speech_recognition_tools_tpu_torch.dsp.fdlp import _setup, window_envelopes

    cfg = FdlpConfig(**FD)
    s = StreamingFdlp(cfg, device="cpu")
    s.process(_signal(8000, 3))
    wins = s.block_windows(range(5))
    _, _, k = _setup(cfg, torch.float64, "cpu")
    got = window_envelopes(torch.as_tensor(wins, dtype=torch.float64), cfg, k).numpy()
    jcfg = JFdlpConfig(**FD)
    fb = jnp.asarray(np.asarray(_host_constants(jcfg)["fbank"]), jnp.float64)
    want = np.asarray(_stream_envelopes(jnp.asarray(wins, jnp.float64), fb, jcfg))
    assert got.shape == want.shape == (5, FD["nfilters"], 25)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_streamer_windows_are_the_batch_frames():
    """The streamer's analysis windows, end reflection included, give the
    batch path's lags (window_lags against fdlp_lags, float64, exact up
    to the GEMM's summation order: rtol 1e-12)."""
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_lags, window_lags

    cfg = FdlpConfig(**FD)
    n = 8000 + 777
    x = _signal(n, 9)
    s = StreamingFdlp(cfg, dtype=torch.float64, device="cpu")
    s.process(x)
    want, nf = fdlp_lags(x[None], [n], cfg, dtype=torch.float64, device="cpu")
    F = int(nf[0])
    got = window_lags(s.block_windows(range(F), total=n), cfg, dtype=torch.float64,
                      device="cpu")
    np.testing.assert_allclose(got.numpy(), want[:F].numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_streaming_fdlp_emits_while_streaming():
    """Frames leave before finish(), with one analysis window of latency."""
    s = StreamingFdlp(FdlpConfig(**FD), device="cpu")
    x = _signal(3 * 8000, 5)
    emitted = sum(s.process(x[off : off + 2000]).shape[0] for off in range(0, x.size, 2000))
    assert emitted > 200
    assert emitted + s.finish().shape[0] == 300


# ------------------------------------------------------------------ the step


@pytest.mark.parametrize("chunk,left", [(4, 2), (5, 0)])
def test_stream_step_matches_jax(chunk, left):
    """Six rounds of make_stream_step on three rows (a full row, an idle row
    from round 3 on, a partial tail at the end) against the JAX step on the
    same inputs: encoder rows and CTC rows at atol 1e-5 (float32), caches
    (kv at atol 1e-5, kv_valid exactly)."""
    jmodel, params, port = _models(chunk, left, seed=3)
    jstep, jinit = jsa.make_stream_step(jmodel, params)
    tstep, tinit = tsa.make_stream_step(port)
    B, adim = 3, MODEL["adim"]
    jc, tc = jinit(B), tinit(B)
    rs = np.random.RandomState(8)
    pos = np.zeros(B, int)
    for rnd in range(6):
        x = rs.randn(B, 4 * chunk + 3, D).astype(np.float32)
        nv = np.array([chunk, chunk if rnd < 2 else 0, chunk if rnd < 5 else chunk - 2], np.int32)
        up = nv == chunk
        pe = np.stack([tsa._posenc_rows(int(p), chunk, adim) for p in pos])
        jh, jctc, jc = jstep(jnp.asarray(x), jnp.asarray(pe), jnp.asarray(nv), jnp.asarray(up), jc)
        th, tctc, tc = tstep(torch.as_tensor(x), torch.as_tensor(pe), torch.as_tensor(nv).long(),
                             torch.as_tensor(up), tc)
        for r in range(B):
            k = int(nv[r])
            np.testing.assert_allclose(tctc[r, :k].numpy(), np.asarray(jctc)[r, :k], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(th[r, :k].numpy(), np.asarray(jh)[r, :k], rtol=0,
                                       atol=1e-5)
        for i in range(MODEL["elayers"]):
            np.testing.assert_array_equal(tc[f"layer_{i}"]["kv_valid"].numpy(),
                                          np.asarray(jc[f"layer_{i}"]["kv_valid"]))
            np.testing.assert_allclose(tc[f"layer_{i}"]["kv"].numpy(),
                                       np.asarray(jc[f"layer_{i}"]["kv"]), rtol=0, atol=1e-5)
        pos += nv


def test_streaming_recognizer_matches_offline_encode(m42):
    """Ragged pushes through StreamingRecognizer give the port's offline
    chunk-masked encode (memory and CTC at atol 3e-5, the JAX test's) and
    its greedy CTC; the buffer stays bounded."""
    _, _, port = m42
    T = 150
    x = np.random.RandomState(4).randn(T, D).astype(np.float32)
    with torch.no_grad():
        mem, enc_len, ctc = port.encode(torch.as_tensor(x[None]), torch.as_tensor([T]))
    n = int(enc_len[0])
    sr = tsa.StreamingRecognizer(port)
    i = 0
    for sz in (7, 30, 13, 50, 29, 100):
        sr.push(x[i : i + sz])
        assert sr._st.buf.shape[0] <= 4 * sr.chunk + 3 + sz
        i += sz
    hyp = sr.finish()
    assert sr.enc_len == n
    np.testing.assert_allclose(sr.memory, mem[0, :n].numpy(), rtol=0, atol=3e-5)
    np.testing.assert_allclose(sr.ctc_logits, ctc[0, :n].numpy(), rtol=0, atol=3e-5)
    assert hyp == ttasr.greedy_ctc(ctc, enc_len)[0]


def test_streaming_needs_a_streaming_config():
    _, _, full = _models(0, -1)
    with pytest.raises(ValueError, match="attn_chunk"):
        tsa.StreamingRecognizer(full)
    _, _, unbounded = _models(4, -1)
    with pytest.raises(ValueError, match="left"):
        tsa.StreamingRecognizer(unbounded)


# ------------------------------------------------------------------ batcher


def _drive(sb, sids, xs, sizes):
    offs = [0] * len(xs)
    while any(o < len(x) for o, x in zip(offs, xs)):
        for i, sid in enumerate(sids):
            if offs[i] < len(xs[i]):
                sb.push(sid, xs[i][offs[i] : offs[i] + sizes[i]])
                offs[i] += sizes[i]
    return [(sb.finish(sid), sb.state(sid)) for sid in sids]


def test_batcher_with_eviction_matches_singles_and_jax(m42):
    """Three interleaved streams on a two-row batcher (the third evicts a
    non-ready one): hypotheses and times identical to single-stream
    recognizers and to the JAX batcher's; confidences within 1e-5
    relative; memory at atol 3e-5."""
    jmodel, params, port = m42
    rs = np.random.RandomState(2)
    xs = [rs.randn(t, D).astype(np.float32) for t in (150, 90, 201)]
    sizes = [37, 23, 52]
    tsb = tsa.StreamBatcher(port, max_streams=2, store_memory=True)
    got = _drive(tsb, [tsb.open() for _ in xs], xs, sizes)
    jsb = jsa.StreamBatcher(jmodel, params, max_streams=2, store_memory=True)
    want = _drive(jsb, [jsb.open() for _ in xs], xs, sizes)
    assert not tsb._streams and all(s is None for s in tsb._slot_sid)
    for x, (hyp, st), (jhyp, jst) in zip(xs, got, want):
        sr = tsa.StreamingRecognizer(port)
        sr.push(x)
        assert hyp == sr.finish() == jhyp and len(hyp) > 0
        assert st.times == sr.times == jst.times
        np.testing.assert_allclose(st.confs, jst.confs, rtol=1e-5, atol=0)
        np.testing.assert_allclose(st.confs, sr.confs, rtol=1e-5, atol=0)
        assert st.pos == jst.pos == sr.enc_len
        np.testing.assert_allclose(st.memory, jst.memory, rtol=0, atol=3e-5)
        np.testing.assert_allclose(st.memory, sr.memory, rtol=0, atol=3e-5)


def test_batcher_rejects_feat_dim_mismatch_and_abort_frees_slot(m42):
    _, _, port = m42
    rs = np.random.RandomState(6)
    sb = tsa.StreamBatcher(port, max_streams=2)
    a, b = sb.open(), sb.open()
    sb.push(a, rs.randn(10, D).astype(np.float32))
    with pytest.raises(ValueError, match="dim"):
        sb.push(b, rs.randn(10, 4).astype(np.float32))
    sb.push(a, rs.randn(30, D).astype(np.float32))
    slot_a = sb._streams[a].slot
    sb.abort(a)
    assert a not in sb._streams and sb._slot_sid[slot_a] is None
    c = sb.open()
    sb.push(c, rs.randn(60, D).astype(np.float32))
    assert sb.finish(c) is not None


def test_batcher_defer_coalesces_rounds_as_jax(m42):
    """With defer_s, a ready chunk waits for the other live stream; the
    coalesced round gives the JAX batcher's hypotheses, and one round
    serves both streams."""
    jmodel, params, port = m42
    rs = np.random.RandomState(13)
    xs = [rs.randn(90, D).astype(np.float32) for _ in range(2)]
    res = []
    for sb in (tsa.StreamBatcher(port, max_streams=4, defer_s=60.0),
               jsa.StreamBatcher(jmodel, params, max_streams=4, defer_s=60.0)):
        a, b = sb.open(), sb.open()
        sb.push(a, xs[0])  # a is ready, b (live) is not: held back
        assert sb.state(a).pos == 0
        sb.push(b, xs[1])  # both ready: one batched round fires
        assert sb.state(a).pos > 0 and sb.state(b).pos > 0
        res.append((sb.finish(a), sb.finish(b)))
    assert res[0] == res[1] and all(res[0])
    sb = tsa.StreamBatcher(port, max_streams=4, defer_s=60.0)
    a, b = sb.open(), sb.open()
    sb.push(a, xs[0][:19])
    sb.push(b, xs[1][:19])
    assert sb.rounds == 1


def test_endpointing_restart_segments_match_jax():
    """StreamBatcher.restart at a trailing blank run: the port's segments,
    times and confidences against the JAX batcher's on the same frames
    and weights (a seed that endpoints mid-stream with tokens after)."""
    jmodel, params, port = _models(4, 2, seed=7)
    x = np.random.RandomState(107).randn(200, D).astype(np.float32)
    runs = []
    for sb in (tsa.StreamBatcher(port, max_streams=2),
               jsa.StreamBatcher(jmodel, params, max_streams=2)):
        sid = sb.open()
        segs = []
        for off in range(0, len(x), 16):
            sb.push(sid, x[off : off + 16])
            st = sb.state(sid)
            if tsa.endpoint_due(3, st.blank_run, st.hyp):
                segs.append(sb.restart(sid))
        final = sb.finish(sid)
        segs.append((final, list(sb.state(sid).times), list(sb.state(sid).confs)))
        runs.append(segs)
    (got, want) = runs
    assert len(got) == len(want) >= 2 and all(s[0] for s in got)
    for (gt, gtm, gc), (wt, wtm, wc) in zip(got, want):
        assert gt == wt and gtm == wtm
        np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=0)
    assert tsa._blank_run_update(0, 2, np.eye(3)[[0, 0]]) == 4
    assert tsa._blank_run_update(0, 5, np.eye(3)[[1, 0, 0]]) == 2
    assert tsa._blank_run_update(0, 5, np.eye(3)[[0, 2]]) == 0


# ------------------------------------------------------------------ pipeline


def test_online_pipeline_matches_jax_and_final_beam():
    """Audio -> StreamingFdlp -> global CMVN -> recognizer, port against the
    JAX pipeline on the same audio, weights and CMVN: tokens, times
    identical, streamed memory at atol 1e-4 (float32 features differ by
    ~1e-5 between the packages); the recognizer's memory equals the port's
    offline encode of its own streamed features (atol 3e-5);
    rescored_partial after finish() equals the offline beam search of the
    same features token for token."""
    jmodel, params, port = _models(3, 2, seed=9)
    sig = _signal(9000, 1)
    mean = np.full((D,), 0.5, np.float32)
    std = np.linspace(0.8, 1.2, D).astype(np.float32)
    tp = tsa.OnlineASRPipeline(port, fdlp_cfg=FdlpConfig(**FD), cmvn_mean=mean, cmvn_std=std)
    jp = jsa.OnlineASRPipeline(jmodel, params, fdlp_cfg=JFdlpConfig(**FD), cmvn_mean=mean,
                               cmvn_std=std)
    for s in range(0, len(sig), 1500):
        tp.push(sig[s : s + 1500])
        jp.push(sig[s : s + 1500])
    hyp, jhyp = tp.finish(), jp.finish()
    assert hyp == jhyp and len(hyp) > 0
    assert tp.recognizer.times == jp.recognizer.times
    np.testing.assert_allclose(tp.recognizer.memory, jp.recognizer.memory, rtol=0, atol=1e-4)

    sf = StreamingFdlp(FdlpConfig(**FD), device="cpu")
    feats = _stream(sf, sig, 1500)
    feats = (feats - mean) / std
    T = feats.shape[0]
    with torch.no_grad():
        mem, enc_len, _ = port.encode(torch.as_tensor(feats[None]), torch.as_tensor([T]))
    assert tp.recognizer.enc_len == int(enc_len[0])
    np.testing.assert_allclose(tp.recognizer.memory, mem[0].numpy(), rtol=0, atol=3e-5)
    part = tp.recognizer.rescored_partial(port, beam_size=3, max_len=8)
    toks, scores = beam_search_batched(port, feats[None], [T], beam_size=3, max_len=8,
                                       device="cpu")
    assert part == tokens_to_list(toks[0], scores[0], port.cfg.eos_id)
    mid = tsa.StreamingRecognizer(port)
    mid.push(feats[:40])
    assert isinstance(mid.rescored_partial(port, beam_size=2, max_len=4), list)
    with pytest.raises(ValueError, match="store_memory"):
        tsa.StreamingRecognizer(port, store_memory=False).rescored_partial(port)


def test_pipeline_endpoint_segments_match_jax():
    """OnlineASRPipeline with endpointing: segments, their times and start
    frames equal the JAX pipeline's."""
    jmodel, params, port = _models(3, 2, seed=9)
    sig = np.concatenate([_signal(9000, 5), np.zeros(6000, np.float32), _signal(7000, 2)])
    res = []
    for pipe in (tsa.OnlineASRPipeline(port, fdlp_cfg=FdlpConfig(**FD), endpoint_blanks=2),
                 jsa.OnlineASRPipeline(jmodel, params, fdlp_cfg=JFdlpConfig(**FD),
                                       endpoint_blanks=2)):
        for off in range(0, len(sig), 2000):
            pipe.push(sig[off : off + 2000])
        pipe.finish()
        res.append((pipe.segments, pipe.segment_times, pipe.segment_start_frames))
    assert res[0] == res[1] and len(res[0][0]) >= 2


def test_serving_helpers_match_jax(tmp_path):
    """Manifest, CMVN and front-end helpers: same results and same errors."""
    import json
    import os

    fe = {"type": "fdlp", **FD, "lifter_config": [1.0] * 20}
    assert tsa.fdlp_config_from_frontend(fe) == FdlpConfig(**{**FD, "lifter_config": (1.0,) * 20})
    for mod in (tsa, jsa):
        with pytest.raises(ValueError, match="cannot be served online"):
            mod.fdlp_config_from_frontend({"type": "melspec"})
        with pytest.raises(ValueError, match="per-utterance"):
            mod.load_manifest_cmvn(str(tmp_path), {"cmvn": "c.npz", "cmvn_mode": "per_utt"})
    assert tsa.read_serving_manifest(str(tmp_path)) is None
    np.savez(os.path.join(tmp_path, "c.npz"), mean=np.ones(3), std=np.full(3, 2.0))
    man = {"frontend": fe, "cmvn": "c.npz"}
    with open(os.path.join(tmp_path, "serving.json"), "w") as f:
        json.dump(man, f)
    assert tsa.read_serving_manifest(str(tmp_path)) == jsa.read_serving_manifest(str(tmp_path))
    for a, b in zip(tsa.load_manifest_cmvn(str(tmp_path), man),
                    jsa.load_manifest_cmvn(str(tmp_path), man)):
        np.testing.assert_array_equal(a, b)
    f = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    np.testing.assert_array_equal(tsa.apply_cmvn(f, np.ones(3, np.float32), None),
                                  jsa.apply_cmvn(f, np.ones(3, np.float32), None))
    for args in ((0, 9, [1]), (3, 2, [1]), (3, 3, []), (3, 3, [2])):
        assert tsa.endpoint_due(*args) == jsa.endpoint_due(*args)
    for n in (0, 6, 7, 8, 10, 11, 101):
        assert tsa._total_subsampled(n) == jsa._total_subsampled(n)
    rows = np.random.RandomState(1).randn(7, 5).astype(np.float32)
    got, want = ([], [], []), ([], [], [])
    assert (tsa._greedy_extend(0, got[0], 0, rows, got[1], 3, got[2])
            == jsa._greedy_extend(0, want[0], 0, rows, want[1], 3, want[2]))
    assert got == want
