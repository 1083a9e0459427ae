"""The port's int8 serving path held against the JAX package: the weight-only
quantizer (infer/quantize.py: codes, scales, selection, bytes), the JAX
quantized tree carried over by io/jax_params.py, the int8 streaming
recognizer and batcher, and `transcribe --int8` / `serve --int8`.

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise). The JAX side runs on the CPU with the
conftest's x64 and float32 inputs; the port runs on the CPU.
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

from speech_recognition_tools_tpu.cli import transcribe as jtranscribe
from speech_recognition_tools_tpu.infer import quantize as jq
from speech_recognition_tools_tpu.infer import streaming_asr as jsa
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import serve as tserve
from speech_recognition_tools_tpu_torch.cli import transcribe as ttranscribe
from speech_recognition_tools_tpu_torch.infer import quantize as tq
from speech_recognition_tools_tpu_torch.infer import streaming_asr as tsa
from speech_recognition_tools_tpu_torch.io.jax_params import (
    transformer_asr_from_jax,
    transformer_asr_to_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr

torch.set_num_threads(1)

D = 8
MODEL = dict(vocab_size=11, adim=16, aheads=2, elayers=2, eunits=32, dlayers=1, dunits=32,
             dropout=0.0, conv_kernel=7)
FD = dict(srate=8000, nfilters=8, fduration=0.25, coeff_num=20, order=20)


def _models(encoder_type, chunk=4, left=2, seed=0):
    """(jax model, params, port model) on the same perturbed float32 weights."""
    cfg = dict(MODEL, encoder_type=encoder_type, attn_chunk=chunk, attn_left_chunks=left)
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
def quantized():
    """Per encoder type: (jax model, int8 params, port int8 model), both
    quantized at min_size 1 (every kernel of the tiny encoder)."""
    out = {}
    for enc in ("transformer", "conformer"):
        jmodel, params, port = _models(enc, seed=3)
        out[enc] = (jmodel, jq.quantize_encoder(params, min_size=1),
                    tq.quantize_encoder(port, min_size=1))
    return out


def _tie_matrix(rs, rows, cols):
    """Seeded weights with every column's amax 127 (scale exactly 1), so
    the codes meet exact .5 ties (half to even), and one all-zero column."""
    w = rs.randn(rows, cols).astype(np.float32) * 3.0
    w[0] = 127.0
    w[1, :] = np.float32(2.5)
    w[2, :] = np.float32(-3.5)
    w[3, :] = np.float32(0.5)
    w[4, :] = np.float32(-126.5)
    w[:, 1] = 0.0
    return w


# JAX layout -> (the port's weight of that kernel, n_out_axes of flax's)
LAYOUTS = {
    "dense": (lambda w: w.T, 1, (24, 12)),
    "qkv": (lambda w: w.reshape(w.shape[0], -1).T, 2, (24, 3, 4)),
    "heads_out": (lambda w: w.reshape(-1, w.shape[-1]).T, 1, (3, 8, 12)),
    "conv2d": (lambda w: w.transpose(3, 2, 0, 1), 1, (3, 3, 4, 12)),
    "depthwise": (lambda w: w.transpose(2, 1, 0), 1, (7, 1, 12)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_quantize_leaf_matches_jax_bit_for_bit(layout):
    """quantize_leaf of the port's weight against the JAX quantize_leaf of
    flax's kernel: codes and scales bit-identical (scales compared as
    float32 bits), exact .5 ties and an all-zero channel (scale 1, codes
    0) included; the per-channel dequant error at most scale / 2."""
    to_port, n_out, shape = LAYOUTS[layout]
    rs = np.random.RandomState(7)
    cols = int(np.prod(shape[len(shape) - n_out:]))
    rows = int(np.prod(shape[: len(shape) - n_out]))
    w = _tie_matrix(rs, rows, cols).reshape(shape)
    want = jq.quantize_leaf(w, n_out_axes=n_out)
    q, s = tq.quantize_leaf(torch.as_tensor(to_port(w).copy()))
    wq = to_port(np.asarray(want["int8_q"]))
    ws = to_port(np.broadcast_to(np.asarray(want["int8_scale"]), w.shape))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(np.broadcast_to(s.numpy(), q.shape).view(np.int32),
                                  np.ascontiguousarray(ws).view(np.int32))
    zero = to_port(np.broadcast_to(np.arange(cols) == 1, (rows, cols)).reshape(shape))
    assert (q.numpy()[zero] == 0).all() and (np.broadcast_to(s.numpy(), q.shape)[zero] == 1).all()
    # the tie rows: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, -126.5 -> -126
    codes = np.asarray(want["int8_q"]).reshape(rows, cols)
    live = np.arange(cols) != 1
    assert (codes[1, live] == 2).all() and (codes[2, live] == -4).all()
    assert (codes[3, live] == 0).all() and (codes[4, live] == -126).all()
    w_port = torch.as_tensor(to_port(w).copy())
    assert ((w_port - q * s).abs() <= s / 2).all()


def test_qkv_scales_are_per_head_and_selection_follows_min_size():
    """An outlier in head 0 of a query kernel inflates only its own output
    rows' scales (one per (head, head_dim), as flax's (1, H, hd)); the
    attention out-projection keeps one scale per output; quantize_tree
    selects kernels of at least min_size elements, as JAX's quantize_tree."""
    rs = np.random.RandomState(1)
    w = rs.randn(64, 4, 16).astype(np.float32)
    w[0, 0, 3] = 100.0
    jscale = np.asarray(jq.quantize_tree({"query": {"kernel": w}}, min_size=1)
                        ["query"]["kernel"]["int8_scale"])
    lin = torch.nn.Linear(64, 64, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(w.reshape(64, -1).T))
    tq.quantize_tree(lin, min_size=1)
    scale = lin.parametrizations.weight[0].scale
    assert scale.shape == (64, 1)
    np.testing.assert_array_equal(scale.numpy()[:, 0], jscale.reshape(-1))
    assert scale[3] > 10 * scale[16 + 3]
    for enc in ("transformer", "conformer"):
        _, params, port = _models(enc)
        for min_size in (1, 200, 1024, 10**6):
            jtree = jq.quantize_encoder(params, min_size=min_size)
            model = tq.quantize_encoder(_models(enc)[2], min_size=min_size)
            want = {"/".join(str(k.key) for k in path[:-1])
                    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)
                    if path[-1].key == "int8_q"}
            got = {n for n, m in model.named_modules() if tq.is_quantized(m)}
            assert len(got) == len(want), (enc, min_size)
            assert tq.has_quantized(model) == (len(want) > 0)
            assert not tq.has_quantized(port)
    with pytest.raises(ValueError):
        tq.quantize_encoder(torch.nn.Linear(4, 4))


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
@pytest.mark.parametrize("min_size", [1, 1024])
def test_quantize_encoder_matches_jax_bit_for_bit(enc, min_size):
    """quantize_encoder on the port against the JAX quantize_encoder carried
    over by io/jax_params.py: every state_dict entry (int8 codes, float32
    scales, the float32 rest) bit-identical; the port's tree mapped back
    equals JAX's leaf for leaf; quantized_bytes gives JAX's pair; a model
    loaded from the JAX tree equals the one quantized in place."""
    _, params, port = _models(enc, seed=2)
    jtree = jax.tree.map(np.asarray, jq.quantize_encoder(params, min_size=min_size))
    tq.quantize_encoder(port, min_size=min_size)
    sd, psd = transformer_asr_from_jax(jtree), port.state_dict()
    assert set(sd) == set(psd) and any(k.endswith("weight.original") for k in sd)
    for k in sd:
        assert sd[k].dtype == psd[k].dtype and torch.equal(sd[k], psd[k]), k
    back = dict(jax.tree_util.tree_leaves_with_path(transformer_asr_to_jax(psd, 2)))
    leaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(back) == len(leaves)
    for path, leaf in leaves:
        assert back[path].dtype == leaf.dtype and np.array_equal(back[path], leaf), path
    assert tq.quantized_bytes(port) == jq.quantized_bytes(jtree)
    loaded = ttasr.TransformerASR(port.cfg, D, device="cpu")
    tq.load_quantized_state_dict(loaded, sd)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, psd[k]), k


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_int8_streaming_recognizer_matches_jax(quantized, enc):
    """The int8 StreamingRecognizer against the JAX one on the int8 tree:
    memory and CTC logits at atol 3e-5 (the bound the float32 recognizer
    is held to in tests/test_torch_port_streaming.py), identical greedy
    tokens and lengths; the quantized weights stay int8 between calls."""
    jmodel, qparams, port = quantized[enc]
    x = np.random.RandomState(33).randn(150, D).astype(np.float32)
    jr = jsa.StreamingRecognizer(jmodel, qparams)
    tr = tsa.StreamingRecognizer(port)
    for off in range(0, 150, 37):
        jr.push(x[off : off + 37])
        tr.push(x[off : off + 37])
    assert tr.finish() == jr.finish()
    assert tr.enc_len == jr.enc_len
    np.testing.assert_allclose(tr.memory, jr.memory, rtol=0, atol=3e-5)
    np.testing.assert_allclose(tr.ctc_logits, jr.ctc_logits, rtol=0, atol=3e-5)
    w = port.encoder.layers[0].self_attn.query if enc == "transformer" else (
        port.encoder.layers[0].conv_depthwise)
    w = w.parametrizations.weight
    assert w.original.dtype == torch.int8 and not w.original.is_floating_point()


@pytest.mark.parametrize("enc", ["transformer", "conformer"])
def test_int8_batcher_matches_int8_single_stream(quantized, enc):
    """Three interleaved streams on a two-row int8 StreamBatcher (the third
    evicts a non-ready holder and is restored): tokens identical to int8
    single-stream recognizers, memory at rtol 1e-4 / atol 3e-5 (JAX's
    tests/test_quantize.py:145,176 bounds)."""
    _, _, port = quantized[enc]
    rs = np.random.RandomState(9)
    lens, sizes = [140, 90, 170], [31, 19, 45]
    xs = [rs.randn(t, D).astype(np.float32) for t in lens]
    singles = []
    for x in xs:
        sr = tsa.StreamingRecognizer(port)
        sr.push(x)
        singles.append((sr.finish(), sr.memory, sr.enc_len))
    sb = tsa.StreamBatcher(port, max_streams=2, store_memory=True)
    sids = [sb.open() for _ in xs]
    offs = [0] * 3
    while any(o < t for o, t in zip(offs, lens)):
        for i, sid in enumerate(sids):
            if offs[i] < lens[i]:
                sb.push(sid, xs[i][offs[i] : offs[i] + sizes[i]])
                offs[i] += sizes[i]
    for i, sid in enumerate(sids):
        hyp, (want_hyp, want_mem, want_len) = sb.finish(sid), singles[i]
        st = sb.state(sid)
        assert hyp == want_hyp and st.pos == want_len, i
        np.testing.assert_allclose(st.memory, want_mem, rtol=1e-4, atol=3e-5)


def _audio(seed, n=9000):
    rs = np.random.RandomState(seed)
    e = rs.randn(n).astype(np.float32)
    sig = np.zeros(n, np.float32)
    for t in range(2, n):
        sig[t] = 1.2 * sig[t - 1] - 0.5 * sig[t - 2] + e[t]
    return sig * (0.4 + 0.3 * np.sin(2 * np.pi * np.arange(n) * 3.0 / 8000))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A chunked-attention model directory written by the JAX package, wide
    enough (eunits 64) that min_size 1024 quantizes its FFNs and conv front
    end, with serving.json and global CMVN."""
    root = tmp_path_factory.mktemp("int8")
    vocab = jtext.build_char_vocab(["ab cab d"])
    hyper = dict(vocab_size=len(vocab), adim=16, aheads=2, elayers=2, eunits=64, dlayers=1,
                 dunits=32, mtlalpha=0.3, lsm_weight=0.0, encoder_type="transformer",
                 attn_chunk=3, attn_left_chunks=2)
    model = jtasr.TransformerASR(jtasr.TransformerASRConfig(**hyper, dropout=0.0))
    params = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, D)),
                        jnp.asarray([16]), jnp.zeros((1, 4), jnp.int32))
    rs = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)
    params["params"]["ctc_head"]["bias"][0] += 3.0  # pauses endpoint
    d = str(root / "am")
    os.makedirs(d)
    jtext.save_vocab(vocab, os.path.join(d, "vocab.json"))
    jckpt.save_checkpoint(d, "final_avg", params, hyper)
    np.savez(os.path.join(d, "cmvn.npz"), mean=(rs.randn(D) * 0.1).astype(np.float32),
             std=(1.0 + 0.2 * rs.rand(D)).astype(np.float32))
    with open(os.path.join(d, "serving.json"), "w") as f:
        json.dump({"frontend": {"type": "fdlp", **FD}, "cmvn": "cmvn.npz",
                   "cmvn_mode": "global"}, f)
    return d


def test_transcribe_int8_matches_jax(model_dir, tmp_path):
    """transcribe --int8: text lines and segments (tokens, times; the mean
    confidence within one unit of its 4th decimal) identical to the JAX
    CLI's --int8, one segment per file and endpointed."""
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
            main([model_dir, *wavs, "--int8", "--out", out, "--json", js, "--feed_seconds",
                  "0.25", *extra, *dev])
            with open(out) as f, open(js) as g:
                outs[name] = (f.read(), json.load(g))
        assert outs["port"][0] == outs["jax"][0]
        for utt, want in outs["jax"][1].items():
            got = outs["port"][1][utt]
            assert got["text"] == want["text"] and len(got["segments"]) == len(want["segments"])
            for a, b in zip(got["segments"], want["segments"]):
                assert abs(a.pop("conf") - b.pop("conf")) < 1.5e-4
                assert a == b
        assert outs["port"][1]["uttA"]["segments"]


def test_int8_server_and_pipeline_run_quantized(model_dir, monkeypatch):
    """make_server(int8=True) and OnlineASRPipeline.from_model_dir(int8=True)
    quantize the encoder only (min_size 1024: conv1 and the FFNs), and a
    socket stream's final equals the int8 pipeline's tokens."""
    models = []
    real = tq.quantize_encoder
    monkeypatch.setattr(tq, "quantize_encoder", lambda m: models.append(real(m)) or m)
    pipe = tsa.OnlineASRPipeline.from_model_dir(model_dir, int8=True, device="cpu")
    got = {n for n, m in models[0].named_modules() if tq.is_quantized(m)}
    assert all(n.startswith("encoder.") for n in got)
    assert {"encoder.embed.conv1", "encoder.layers.0.ff_in", "encoder.layers.1.ff_out"} <= got
    sig = _audio(1)
    pipe.push(sig)
    want = pipe.finish()
    server, port = tserve.make_server(model_dir, max_streams=2, int8=True, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert len(models) == 2 and tq.has_quantized(models[1])
        s = socket.create_connection(("127.0.0.1", port), timeout=120)
        f = s.makefile("rwb")
        for off in range(0, len(sig), 2000):
            f.write((json.dumps({"pcm": [float(v) for v in sig[off : off + 2000]]})
                     + "\n").encode())
            f.flush()
            assert "partial" in json.loads(f.readline())
        f.write(b'{"eof": true}\n')
        f.flush()
        final = json.loads(f.readline())
        s.close()
    finally:
        server.shutdown()
        server.server_close()
    assert final["tokens"] == want and want
