"""The port's serving CLIs held against the JAX package: `cli/serve.py`
(make_server on real sockets, concurrent streams, endpointing, the wire
protocol, resolve_frontend), `cli/serve_client.py`, `cli/transcribe.py`
and `cli/recog_e2e.py` (host search, --jit_decode, --streaming, RNNLM
fusion, --ref_text, a comma-separated model_dir, --api cl), all on model
directories the JAX package wrote.

The same directory, audio and egs go to both packages; hypotheses and
output files must be identical. The JAX side runs on the CPU with the
conftest's x64; the port runs on the CPU (`device="cpu"`).
"""

import json
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import write as wav_write

from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.cli import serve as jserve
from speech_recognition_tools_tpu.cli import transcribe as jtranscribe
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.cli import serve as tserve
from speech_recognition_tools_tpu_torch.cli import transcribe as ttranscribe
from speech_recognition_tools_tpu_torch.cli.serve_client import stream_wav
from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig
from speech_recognition_tools_tpu_torch.eval import wer as twer
from speech_recognition_tools_tpu_torch.infer.streaming_asr import OnlineASRPipeline

torch.set_num_threads(1)

FD = dict(srate=8000, nfilters=8, fduration=0.25, coeff_num=20, order=20)
FCFG = FdlpConfig(**FD)
D = 8


def _audio(seed, n=9000):
    rs = np.random.RandomState(seed)
    e = rs.randn(n).astype(np.float32)
    sig = np.zeros(n, np.float32)
    for t in range(2, n):
        sig[t] = 1.2 * sig[t - 1] - 0.5 * sig[t - 2] + e[t]
    return sig * (0.4 + 0.3 * np.sin(2 * np.pi * np.arange(n) * 3.0 / 8000))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A chunked-attention model directory written by the JAX package
    (perturbed flax init, vocab.json, serving.json with global CMVN) and
    a JAX RNNLM directory beside it."""
    root = tmp_path_factory.mktemp("served")
    vocab = jtext.build_char_vocab(["ab cab d"])
    V = len(vocab)
    hyper = dict(vocab_size=V, adim=16, aheads=2, elayers=2, eunits=32, dlayers=1, dunits=32,
                 mtlalpha=0.3, lsm_weight=0.0, encoder_type="transformer", conv_kernel=15,
                 attn_chunk=3, attn_left_chunks=2)
    cfg = jtasr.TransformerASRConfig(**{k: v for k, v in hyper.items()
                                        if k not in ("conv_kernel",)}, dropout=0.0)
    model = jtasr.TransformerASR(cfg)
    params = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, D)),
                        jnp.asarray([16]), jnp.zeros((1, 4), jnp.int32))
    rs = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
    # blank-leaning CTC head, so that the audio's pauses endpoint
    params["params"]["ctc_head"]["bias"][0] += 3.0
    d = str(root / "am")
    os.makedirs(d)
    jtext.save_vocab(vocab, os.path.join(d, "vocab.json"))
    jckpt.save_checkpoint(d, "final_avg", params, hyper)
    mean = (rs.randn(D) * 0.1).astype(np.float32)
    std = (1.0 + 0.2 * rs.rand(D)).astype(np.float32)
    np.savez(os.path.join(d, "cmvn.npz"), mean=mean, std=std)
    with open(os.path.join(d, "serving.json"), "w") as f:
        json.dump({"frontend": {"type": "fdlp", **FD}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "global"}, f)

    lm = jrnnlm.RNNLM(vocab_size=V, embed_dim=16, hidden=24)
    lm_params = lm.init({"params": jax.random.key(3)}, jnp.zeros((1, 4), jnp.int32))
    lm_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), lm_params)
    lm_dir = str(root / "lm")
    jckpt.save_checkpoint(lm_dir, "final", lm_params, dict(vocab_size=V, embed_dim=16, hidden=24,
                                                           layers=1, cell="gru"))
    return d, lm_dir, vocab


def _serve(make_server, d, **kw):
    server, port = make_server(d, max_streams=2, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, port


def _client(port, sig, chunk=2000, endpoint_blanks=0):
    """(partials, endpoints, final) of one socket stream."""
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    f = s.makefile("rwb")

    def ask(obj):
        f.write((json.dumps(obj) + "\n").encode())
        f.flush()
        return json.loads(f.readline())

    if endpoint_blanks:
        assert ask({"config": {"endpoint_blanks": endpoint_blanks}}) == {"ok": True}
    partials, endpoints = [], []
    for off in range(0, len(sig), chunk):
        resp = ask({"pcm": [float(v) for v in sig[off : off + chunk]]})
        partials.append(resp["partial"])
        if "endpoint" in resp:
            endpoints.append(resp["endpoint"])
    final = ask({"eof": True})
    s.close()
    return partials, endpoints, final


def _concurrent(port, sigs, **kw):
    results = [None] * len(sigs)

    def run(i):
        results[i] = _client(port, sigs[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sigs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return results


def test_serve_two_concurrent_streams_match_pipeline_and_jax(model_dir):
    """Two concurrent socket streams on the JAX-written directory (serving.json
    supplies the front-end and CMVN): each final equals the port pipeline's
    tokens and the JAX server's final (text, tokens, times; confidences,
    which both round to 4 decimals, within one unit of the last: 1.5e-4);
    partials are prefixes of the final; the batcher holds no stream afterwards; malformed frames get an
    error response."""
    d, _, _ = model_dir
    sigs = [_audio(1), _audio(2, n=7000)]
    tserver, tport = _serve(tserve.make_server, d, device="cpu")
    jserver, jport = _serve(jserve.make_server, d)
    try:
        got = _concurrent(tport, sigs)
        want = _concurrent(jport, sigs)
        pipe = OnlineASRPipeline.from_model_dir(d, device="cpu")
        assert pipe.fdlp_cfg == FCFG
        for sig, (partials, _, final), (_, _, jfinal) in zip(sigs, got, want):
            pipe.reset()
            pipe.push(sig)
            assert final["tokens"] == pipe.finish() and final["tokens"]
            for k in ("final", "tokens", "times", "frames"):
                assert final[k] == jfinal[k], k
            np.testing.assert_allclose(final["confs"], jfinal["confs"], rtol=0, atol=1.5e-4)
            assert all(final["final"].startswith(p) for p in partials) and any(partials)
        svc = tserver.service
        assert not svc.batcher._streams and not svc.batcher._finished
        for frame in (b'{"pcm": "oops"}\n', b'"hello"\n', b"[1, 2]\n"):
            s = socket.create_connection(("127.0.0.1", tport), timeout=60)
            f = s.makefile("rwb")
            f.write(frame)
            f.flush()
            assert "error" in json.loads(f.readline()), frame
            s.close()
    finally:
        for server in (tserver, jserver):
            server.shutdown()
            server.server_close()


def test_serve_endpointing_and_client_match_jax(model_dir, tmp_path):
    """Continuous mode ({"config": {"endpoint_blanks": R}}, R the largest
    threshold that splits this audio into >= 2 utterances on the port
    pipeline) with deferral on: the port server's mid-stream endpoints
    (tokens, times) and final equal the JAX server's and the pipeline's
    segments; serve_client.stream_wav gets the pipeline's final with
    confidences in (0, 1]."""
    d, _, _ = model_dir
    sig = np.concatenate([_audio(5), np.zeros(6000, np.float32), _audio(2, n=7000)])
    R, want = None, None
    for cand in (8, 6, 5, 4, 3, 2, 1):
        pipe = OnlineASRPipeline.from_model_dir(d, device="cpu", endpoint_blanks=cand)
        for off in range(0, len(sig), 2000):
            pipe.push(sig[off : off + 2000])
        pipe.finish()
        if len(pipe.segments) >= 2:
            R, want = cand, pipe.segments
            break
    assert R is not None, "the fixture no longer endpoints; adjust its seeds"
    tserver, tport = _serve(tserve.make_server, d, device="cpu", defer_s=0.03)
    jserver, jport = _serve(jserve.make_server, d)
    try:
        (_, t_eps, t_final), = _concurrent(tport, [sig], endpoint_blanks=R)
        (_, j_eps, j_final), = _concurrent(jport, [sig], endpoint_blanks=R)
        assert t_eps, "no endpoint fired mid-stream"
        assert [e["tokens"] for e in t_eps] == [e["tokens"] for e in j_eps]
        assert [e["times"] for e in t_eps] == [e["times"] for e in j_eps]
        assert t_final["tokens"] == j_final["tokens"]
        got = [e["tokens"] for e in t_eps] + ([t_final["tokens"]] if t_final["tokens"] else [])
        assert got == want

        wav = str(tmp_path / "in.wav")
        wav_write(wav, 8000, _audio(9))
        lines = []
        final, events = stream_wav(wav, port=tport, chunk_s=0.25, pace=False, log=lines.append)
        pipe = OnlineASRPipeline.from_model_dir(d, device="cpu")
        pipe.push(_audio(9))
        assert final["tokens"] == pipe.finish()
        assert len(final["confs"]) == len(final["tokens"]) == len(final["times"])
        assert all(0 < c <= 1 for c in final["confs"])
        assert any(e.get("partial") for e in events) and lines[-1].startswith("[final")
    finally:
        for server in (tserver, jserver):
            server.shutdown()
            server.server_close()


def test_resolve_frontend_precedence_matches_jax(tmp_path):
    """Manifest fields overridden per flag; a non-streamable manifest fatal
    unless nfilters replaces the front-end; no manifest: production
    geometry + the checkpoint's feature_dim; per-utterance CMVN refused by
    make_server."""
    d = str(tmp_path / "m")
    os.makedirs(os.path.join(d, "final_avg"))
    with open(os.path.join(d, "serving.json"), "w") as f:
        json.dump({"frontend": {"type": "melspec", "srate": 8000}}, f)
    for mod in (tserve, jserve):
        with pytest.raises(ValueError, match="cannot be served online"):
            mod.resolve_frontend(d)
    over = {"nfilters": 8, "srate": 8000, "fduration": None}
    cfg = tserve.resolve_frontend(d, over)
    assert cfg.nfilters == 8 and cfg.srate == 8000 and cfg.order == 150
    assert cfg.__dict__ == jserve.resolve_frontend(d, over).__dict__
    os.remove(os.path.join(d, "serving.json"))
    with open(os.path.join(d, "final_avg", "config.json"), "w") as f:
        json.dump({"feature_dim": 40}, f)
    cfg = tserve.resolve_frontend(d, {"fduration": 1.0})
    assert cfg.nfilters == 40 and cfg.fduration == 1.0 and cfg.srate == 16000
    assert cfg.__dict__ == jserve.resolve_frontend(d, {"fduration": 1.0}).__dict__
    with open(os.path.join(d, "final_avg", "config.json"), "w") as f:
        json.dump({}, f)
    with pytest.raises(ValueError, match="feature_dim"):
        tserve.resolve_frontend(d)


def test_make_server_refuses_per_utterance_cmvn(model_dir, tmp_path):
    import shutil

    d = str(tmp_path / "per_utt")
    shutil.copytree(model_dir[0], d)
    with open(os.path.join(d, "serving.json"), "w") as f:
        json.dump({"frontend": {"type": "fdlp", **FD}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "per_utt"}, f)
    with pytest.raises(ValueError, match="per-utterance"):
        tserve.make_server(d, device="cpu")


def test_transcribe_cli_matches_jax(model_dir, tmp_path):
    """Text lines and the JSON segments identical to the JAX CLI's (the mean
    confidence, rounded to 4 decimals by both, within one unit of the
    last), one segment per file and endpointed (--endpoint_blanks 2), with
    a small --feed_seconds."""
    d, _, _ = model_dir
    wavs = []
    for utt, sig in (("uttA", _audio(5, n=7000)), ("uttB", np.concatenate(
            [_audio(5), np.zeros(6000, np.float32), _audio(2, n=7000)]))):
        wavs.append(str(tmp_path / f"{utt}.wav"))
        wav_write(wavs[-1], 8000, sig)
    for extra in ([], ["--endpoint_blanks", "2"]):
        outs = {}
        for name, main, dev in (("port", ttranscribe.main, ["--device", "cpu"]),
                                ("jax", jtranscribe.main, [])):
            out, js = str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}.json")
            main([d, *wavs, "--out", out, "--json", js, "--feed_seconds", "0.25", *extra, *dev])
            with open(out) as f, open(js) as g:
                outs[name] = (f.read(), json.load(g))
        assert outs["port"][0] == outs["jax"][0]
        for utt, want in outs["jax"][1].items():
            got = outs["port"][1][utt]
            assert got["text"] == want["text"]
            assert len(got["segments"]) == len(want["segments"])
            for a, b in zip(got["segments"], want["segments"]):
                # conf is a mean rounded to 4 decimals on both sides
                assert abs(a.pop("conf") - b.pop("conf")) < 1.5e-4
                assert a == b
        assert outs["port"][1]["uttA"]["segments"]
    assert len(outs["port"][1]["uttB"]["segments"]) >= 2


def _egs(root, seed=4, lens=(57, 57, 47)):
    """Three utterances; two share a length, so the JAX host searches
    compile once for both."""
    rs = np.random.RandomState(seed)
    feats = [(f"u{i}", rs.randn(T, D).astype(np.float32)) for i, T in enumerate(lens)]
    egs = os.path.join(root, "egs")
    jegs.build_egs(iter(feats), egs)
    ref = os.path.join(root, "ref")
    with open(ref, "w") as f:
        f.writelines(f"u{i} ab cab\n" for i in range(len(lens)))
    return egs, ref


@pytest.mark.parametrize("mode", [
    ["--jit_decode", "--batch_size", "2"],
    ["--streaming", "--streaming_final", "greedy"],
    ["--streaming", "--streaming_final", "beam", "--streaming_feed", "17"],
    [],
])
def test_recog_e2e_cli_matches_jax(model_dir, tmp_path, mode, capsys):
    """out_text identical to the JAX CLI's with the RNNLM fused (beam 2,
    max_len 5) and the same WER line for --ref_text."""
    d, lm_dir, _ = model_dir
    egs, ref = _egs(str(tmp_path))
    common = [egs, "--beam_size", "2", "--max_len", "5", "--lm_dir", lm_dir, "--ref_text", ref,
              *mode]
    tout, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    trecog.main([d, common[0], tout, *common[1:], "--device", "cpu"])
    t_wer = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("WER")]
    jrecog.main([d, common[0], jout, *common[1:]])
    j_wer = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("WER")]
    with open(tout) as f, open(jout) as g:
        got, want = f.read(), g.read()
    assert got == want and len(got.splitlines()) == 3
    assert t_wer == j_wer and len(t_wer) == 1


def test_recog_e2e_streaming_beam_equals_offline(model_dir, tmp_path, capsys):
    """--streaming with the final beam decodes as the offline search does
    (the streamed encoder output is the chunked encode); with
    --streaming_rescore_every 1 a rescored partial is printed after every
    push, the last of them the final beam."""
    d, lm_dir, vocab = model_dir
    egs, _ = _egs(str(tmp_path), seed=8)
    outs = []
    for mode in (["--streaming", "--streaming_feed", "30", "--streaming_rescore_every", "1"],
                 []):
        out = str(tmp_path / f"{len(outs)}.txt")
        trecog.main([d, egs, out, "--beam_size", "3", "--max_len", "8", "--lm_dir", lm_dir,
                     "--device", "cpu", *mode])
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    printed = capsys.readouterr().out.splitlines()
    assert sum("[rescored partial @push" in ln for ln in printed) >= 6


def test_recog_e2e_comma_separated_model_dir_matches_jax(model_dir, tmp_path):
    """model_dir "d,d": both packages load every directory and, under
    --api v1, decode with the first (here the batched search over the 3
    utterances); out_text identical (the repair of
    ROADMAP Queue 3's first fault, where the port passed "d,d" whole to its
    loader)."""
    d, _, _ = model_dir
    egs, _ = _egs(str(tmp_path))
    outs = []
    for main, extra in ((jrecog.main, []), (trecog.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{len(outs)}.txt")
        main([f"{d},{d}", egs, out, "--beam_size", "2", "--max_len", "5", "--jit_decode",
              "--batch_size", "3", *extra])
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 3


@pytest.fixture(scope="module")
def cl_dirs(model_dir, tmp_path_factory):
    """Two more model directories of model_dir's geometry and vocabulary
    (seeds 11 and 12), their decoder output kernels scaled by 4 so that the
    fused scores hold no near ties that bfloat16 rounding would decide."""
    d, _, vocab = model_dir
    root = tmp_path_factory.mktemp("cl")
    with open(os.path.join(d, "final_avg", "config.json")) as f:
        hyper = {k: v for k, v in json.load(f).items() if k != "extra"}
    cfg = jtasr.TransformerASRConfig(**{k: v for k, v in hyper.items()
                                        if k not in ("conv_kernel",)}, dropout=0.0)
    dirs = []
    for seed in (11, 12):
        params = jtasr.TransformerASR(cfg).init(
            {"params": jax.random.key(seed)}, jnp.zeros((1, 16, D), jnp.float32),
            jnp.asarray([16]), jnp.zeros((1, 4), jnp.int32))
        rs = np.random.RandomState(seed)
        params = jax.tree.map(
            lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
        params["params"]["decoder"]["output"]["kernel"] *= 4.0
        out = str(root / f"m{seed}")
        os.makedirs(out)
        jtext.save_vocab(vocab, os.path.join(out, "vocab.json"))
        jckpt.save_checkpoint(out, "final_avg", params, hyper)
        dirs.append(out)
    return ",".join(dirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recog_e2e_api_cl_matches_jax(cl_dirs, tmp_path, dtype):
    """--api cl over two model directories with --pm_scores 0.002,0.001
    (task weights exp(300 pm) / sum: 0.57, 0.43), beam 2, max_len 6,
    --jit_decode --batch_size 2 (cl decodes one utterance at a time all the
    same): out_text identical to the JAX CLI's, in float32 and in
    bfloat16."""
    egs, _ = _egs(str(tmp_path), seed=9)
    outs = []
    for main, extra in ((jrecog.main, []), (trecog.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{len(outs)}.txt")
        main([cl_dirs, egs, out, "--api", "cl", "--pm_scores", "0.002,0.001", "--beam_size",
              "2", "--max_len", "6", "--jit_decode", "--batch_size", "2", "--compute_dtype",
              dtype, *extra])
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 3


@pytest.mark.parametrize("extra", [["--ring_attention", "2"]], ids=["extra2"])
def test_recog_e2e_unported_flags_raise(model_dir, tmp_path, extra):
    d, _, _ = model_dir
    with pytest.raises(NotImplementedError):
        trecog.main([d, str(tmp_path), str(tmp_path / "o.txt"), "--device", "cpu", *extra])


def test_default_device_raises_without_a_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    d, _, _ = model_dir
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.make_server(d)
    with pytest.raises(RuntimeError, match="cuda"):
        OnlineASRPipeline.from_model_dir(d)


def test_wer_matches_jax():
    from speech_recognition_tools_tpu.eval import wer as jwer

    rs = np.random.RandomState(0)
    refs, hyps = {}, {}
    for i in range(20):
        refs[f"u{i}"] = list(rs.randint(0, 5, rs.randint(0, 9)))
        hyps[f"u{i}"] = list(rs.randint(0, 5, rs.randint(0, 9)))
    for u in refs:
        assert twer.edit_distance_csid(refs[u], hyps[u]) == jwer.edit_distance_csid(refs[u],
                                                                                  hyps[u])
    del hyps["u3"]
    assert twer.score_hypotheses(refs, hyps) == jwer.score_hypotheses(refs, hyps)
    assert twer.wer_from_csid(0, 0, 2, 0) == jwer.wer_from_csid(0, 0, 2, 0) == 0.0
