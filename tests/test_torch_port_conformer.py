"""The port's conformer encoder held against the JAX package: the block, the
model's encode / forward, the joint loss and its gradients, the batched
beam search, the converters and initialisers, train_e2e --encoder_type
conformer with checkpoints both ways, and the streaming step with its
causal-conv tail cache inside the StreamBatcher.

Both sides get the same numpy inputs and the same weights: a flax init
perturbed with seeded noise, so that every bias is nonzero, carried over
by io/jax_params.py. Batches are padded. With a nonzero
`conv_pointwise_in` bias the JAX block's non-causal conv (attn_chunk 0)
carries padded frames into the last valid ones; the port computes the
same, and `test_offline_padding_leak_is_the_jax_packages` holds it to
that. The JAX side runs on the CPU with the conftest's x64 and float32
weights unless a test says float64; the port runs on the CPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.decode import beam_jit as jbeam
from speech_recognition_tools_tpu.infer import streaming_asr as jsa
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu_torch.decode import beam_jit as tbeam
from speech_recognition_tools_tpu_torch.infer import streaming_asr as tsa
from speech_recognition_tools_tpu_torch.io.jax_params import (
    transformer_asr_from_jax,
    transformer_asr_to_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr

torch.set_num_threads(1)

MODEL = dict(vocab_size=12, adim=32, aheads=2, elayers=2, eunits=48, dlayers=1, dunits=40,
             dropout=0.0, encoder_type="conformer")
D = 16
EOS = MODEL["vocab_size"] - 1
# (conv_kernel, attn_chunk, attn_left_chunks): odd and even kernels, with
# the non-causal ("SAME") conv of full attention and the causal conv of
# chunked attention
CASES = [(7, 0, -1), (4, 0, -1), (7, 3, 1), (4, 2, -1)]


def _init(jmodel, seed):
    return jax.jit(jmodel.init)({"params": jax.random.key(seed)},
                                jnp.zeros((1, 23, D), jnp.float32), jnp.asarray([23]),
                                jnp.zeros((1, 3), jnp.int32))


def _encode(jmodel, params, x, lens):
    """The flax model's encode, jitted (one compile in place of many eager
    per-op ones)."""
    return jax.jit(lambda p, f, n: jmodel.apply(p, f, n, method=jmodel.encode))(
        params, jnp.asarray(x), jnp.asarray(lens))


def _models(kernel, chunk, left, seed=0, noise=0.2, dtype=np.float32):
    """(jax model, perturbed params, port model in eval mode)."""
    cfg = dict(MODEL, conv_kernel=kernel, attn_chunk=chunk, attn_left_chunks=left)
    jmodel = jtasr.TransformerASR(jtasr.TransformerASRConfig(**cfg))
    params = _init(jmodel, seed)
    rs = np.random.RandomState(seed + 100)
    # float32 values on both sides (the converters carry float32)
    params = jax.tree.map(lambda a: (np.asarray(a) + noise * rs.randn(*a.shape)).astype(
        np.float32).astype(dtype), params)
    bias = params["params"]["encoder"]["layer_0"]["conv_pointwise_in"]["bias"]
    assert np.abs(bias).mean() > noise / 2  # nonzero biases: the padding leak shows
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**cfg), D, device="cpu")
    port.load_state_dict(transformer_asr_from_jax(params))
    if dtype == np.float64:
        port = port.double()
    return jmodel, params, port.eval()


def _feats(B=3, T=70, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(B, T, D).astype(dtype), np.array([T, T - 13, T - 31])[:B]


def _valid(a, n):
    return [np.asarray(a)[b, : int(n[b])] for b in range(len(n))]


def _close(got, want, n, atol):
    for g, w in zip(_valid(got, n), _valid(want, n)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _tree_get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("kernel,chunk,left", CASES)
def test_conformer_block_matches_flax(kernel, chunk, left):
    """One block on a padded batch (its padding mask and, with attn_chunk,
    the chunk mask) against _ConformerBlock on the same params: every
    row, padded ones included, at atol 1e-5 (float32)."""
    jmodel, params, port = _models(kernel, chunk, left)
    c = jmodel.cfg
    rs = np.random.RandomState(1)
    x = rs.randn(3, 19, c.adim).astype(np.float32)
    n = np.array([19, 12, 5])
    mask = np.arange(19)[None, :] < n[:, None]
    want = jax.jit(jtasr._ConformerBlock(c, c.eunits).apply)(
        {"params": params["params"]["encoder"]["layer_0"]}, jnp.asarray(x), jnp.asarray(mask))
    tmask = torch.as_tensor(mask)
    self_mask = tmask[:, None, None, :]
    if chunk:
        self_mask = self_mask & ttasr.chunk_attention_mask(19, chunk, left)[None, None]
    block = port.encoder.layers[0]
    assert isinstance(block, ttasr.ConformerBlock)
    with torch.no_grad():
        got = block(torch.as_tensor(x), self_mask, tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel,chunk,left", CASES)
def test_encode_and_forward_match_flax(kernel, chunk, left):
    """encode (memory, lengths, CTC logits) and forward's decoder logits on a
    padded batch against the flax model, valid rows at atol 2e-5."""
    jmodel, params, port = _models(kernel, chunk, left, seed=1)
    x, lens = _feats()
    mj, lj, cj = _encode(jmodel, params, x, lens)
    with torch.no_grad():
        mt, lt, ct = port.encode(torch.as_tensor(x), torch.as_tensor(lens))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    _close(mt.numpy(), mj, lt, 2e-5)
    _close(ct.numpy(), cj, lt, 2e-5)
    tok = np.full((3, 6), -1, np.int32)
    tok[:, 0] = EOS
    tok[:, 1:4] = np.random.RandomState(2).randint(1, EOS, (3, 3))
    cjf, dj, _ = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(lens),
                                       jnp.asarray(tok))
    with torch.no_grad():
        ctf, dt, _ = port(torch.as_tensor(x), torch.as_tensor(lens), torch.as_tensor(tok))
    _close(ctf.numpy(), cjf, lt, 2e-5)
    np.testing.assert_allclose(dt[:, :4].numpy(), np.asarray(dj)[:, :4], rtol=0, atol=2e-5)


@pytest.mark.parametrize("chunk,left", [(0, -1), (3, 1)])
def test_offline_padding_leak_is_the_jax_packages(chunk, left):
    """The shortest utterance encoded alone and inside a padded batch.
    With attn_chunk 0 the non-causal conv carries the padding (made
    nonzero by conv_pointwise_in's bias) into its last conv_kernel // 2
    valid frames: the two encodes differ there by more than 1e-2 in JAX,
    and the port's equal JAX's in both cases (atol 2e-5). With the
    causal conv of attn_chunk 3 the two encodes agree (atol 2e-5)."""
    jmodel, params, port = _models(7, chunk, left, seed=2)
    x, lens = _feats()
    n = int(lens[2])
    alone = x[2:, :n]
    mj, lj, _ = _encode(jmodel, params, x, lens)
    aj, _, _ = _encode(jmodel, params, alone, [n])
    with torch.no_grad():
        mt, lt, _ = port.encode(torch.as_tensor(x), torch.as_tensor(lens))
        at, _, _ = port.encode(torch.as_tensor(alone), torch.as_tensor([n]))
    f = int(lj[2])
    batch_j, alone_j = np.asarray(mj)[2, :f], np.asarray(aj)[0, :f]
    np.testing.assert_allclose(mt[2, :f].numpy(), batch_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(at[0, :f].numpy(), alone_j, rtol=0, atol=2e-5)
    leak = np.abs(batch_j - alone_j).max(axis=1)
    if chunk == 0:
        assert leak[-(7 // 2):].min() > 1e-2, leak
    else:
        assert leak.max() < 2e-5, leak


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_asr_loss_and_grads_match_jax(dtype):
    """asr_loss at dropout 0 on a padded batch (kernel 7, full attention):
    float64 loss rtol 1e-9 and every gradient entry within 1e-9 of the
    largest; float32 loss rtol 1e-5 and gradients within 1e-4 of it."""
    f64 = dtype == "float64"
    jmodel, params, port = _models(7, 0, -1, seed=3, dtype=np.float64 if f64 else np.float32)
    c = jmodel.cfg
    x, lens = _feats(dtype=np.float64 if f64 else np.float32)
    rs = np.random.RandomState(4)
    tl = np.array([5, 3, 4], np.int32)
    tokens = rs.randint(1, EOS, (3, 8)).astype(np.int32)
    tokens[np.arange(8)[None, :] >= tl[:, None]] = 0
    b = {"feats": x, "lengths": lens.astype(np.int32), "tokens": tokens, "token_lengths": tl}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jtasr.asr_loss(jmodel, p, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.key(1), c), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    port.train()
    tloss, taux = ttasr.asr_loss(port, {k: torch.as_tensor(v) for k, v in b.items()},
                                 port.cfg, train=True)
    tloss.backward()
    rtol, rel = (1e-9, 1e-9) if f64 else (1e-5, 1e-4)
    for got, want in ((tloss, jl), (taux["ctc"], jaux["ctc"]), (taux["att"], jaux["att"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    got_g = transformer_asr_to_jax({k: p.grad for k, p in port.named_parameters()},
                                   MODEL["aheads"])
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jg))
    scale = max(np.abs(w).max() for _, w in flat)
    for path, w in flat:
        np.testing.assert_allclose(_tree_get(got_g, path), w, rtol=0, atol=rel * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kernel,chunk,left", [(7, 0, -1), (4, 2, 1)])
def test_beam_search_matches_jax_batched(kernel, chunk, left):
    """B = 3 padded utterances, beam 4, max_len 10, ctc_weight 0.3: best
    hypotheses token-identical to beam_search_jit_batched and all K scores
    at atol 1e-4."""
    jmodel, params, port = _models(kernel, chunk, left, seed=4, noise=0.3)
    x, lens = _feats(seed=5)
    jt, js = jbeam.beam_search_jit_batched(jmodel, params, jnp.asarray(x), jnp.asarray(lens),
                                           beam_size=4, max_len=10, ctc_weight=0.3)
    jt, js = np.asarray(jt), np.asarray(js)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=10, ctc_weight=0.3,
                                       device="cpu")
    for b in range(3):
        want = jbeam.tokens_to_list(jt[b], js[b], EOS)
        assert tbeam.tokens_to_list(tt[b], ts[b], EOS) == want
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)


def test_converters_are_exact_inverses_for_the_conformer():
    """flax -> port -> flax is bit-exact over every leaf of both kernels'
    trees, the port's state_dict is exactly what the flax tree fills, and
    a stray entry is refused."""
    for kernel in (7, 4):
        _, params, port = _models(kernel, 0, -1)
        back = transformer_asr_to_jax(port.state_dict(), MODEL["aheads"])
        want = jax.tree_util.tree_leaves_with_path(params)
        assert len(want) == len(jax.tree_util.tree_leaves(back))
        for path, w in want:
            np.testing.assert_array_equal(_tree_get(back, path), w)
        dw = back["params"]["encoder"]["layer_1"]["conv_depthwise"]["kernel"]
        assert dw.shape == (kernel, 1, MODEL["adim"])
        sd = port.state_dict()
        assert set(transformer_asr_from_jax(params)) == set(sd)
        with pytest.raises(ValueError):
            transformer_asr_to_jax({**sd, "stray.weight": torch.zeros(1)}, MODEL["aheads"])


def test_conformer_init_std_matches_flax():
    """Each leaf's standard deviation within 10% of flax's init, the
    depthwise kernel's lecun_normal with fan_in = conv_kernel among them
    (zero and constant leaves: equal), at adim 64 and kernel 15 so that
    every drawn leaf has at least 960 entries."""
    cfg = dict(MODEL, adim=64, aheads=4, eunits=96, dunits=64, conv_kernel=15)
    jmodel = jtasr.TransformerASR(jtasr.TransformerASRConfig(**cfg))
    params = _init(jmodel, 3)
    m = ttasr.TransformerASR(ttasr.TransformerASRConfig(**cfg), D, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(3))
    got = transformer_asr_to_jax(m.state_dict(), cfg["aheads"])
    for path, w in jax.tree_util.tree_leaves_with_path(params):
        g = _tree_get(got, path)
        sw, sg = float(np.std(w)), float(np.std(g))
        if sw == 0:
            assert sg == 0 and float(np.mean(g)) == float(np.mean(w)), jax.tree_util.keystr(path)
        else:
            assert abs(sg / sw - 1) < 0.1, (jax.tree_util.keystr(path), sg, sw)


# ------------------------------------------------------------------ CLI


def _corpus(root, n=10, seed=9):
    from speech_recognition_tools_tpu_torch.io import egs as tegs

    rs = np.random.RandomState(seed)
    feats, texts = [], {}
    for i in range(n):
        feats.append((f"u{i}", rs.randn(int(rs.randint(48, 90)), D).astype(np.float32)))
        texts[f"u{i}"] = " ".join("".join(rs.choice(list("abcdefgh"), rs.randint(1, 4)))
                                  for _ in range(2))
    egs = os.path.join(root, "egs")
    tegs.build_egs(iter(feats), egs)
    text = os.path.join(root, "text")
    with open(text, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return egs, text


def test_train_e2e_conformer_checkpoints_both_ways(tmp_path):
    """train_e2e.main --encoder_type conformer --conv_kernel 5 on the CPU
    (chunked attention, so the model also streams): config.json records
    both fields; the JAX recog_e2e decodes its final_avg to the port
    recog_e2e's text; the JAX CLI resumes from the port's epoch_2 to the
    epoch_3 the port's own resume gives (params at atol 1e-5, the
    attention's zero-gradient key biases at the epoch's summed rate), and the
    port resumes from that JAX-written epoch_3; OnlineASRPipeline and the
    server build the conformer from the model directory."""
    from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
    from speech_recognition_tools_tpu.cli import train_e2e as jcli
    from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
    from speech_recognition_tools_tpu_torch.cli import serve as tserve
    from speech_recognition_tools_tpu_torch.cli import train_e2e as tcli
    from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt

    egs, text = _corpus(str(tmp_path))
    store = str(tmp_path / "am")
    argv = [egs, text, store, "--adim", "32", "--aheads", "2", "--elayers", "2",
            "--eunits", "48", "--dlayers", "1", "--dunits", "40", "--encoder_type", "conformer",
            "--conv_kernel", "5", "--attn_chunk", "3", "--attn_left_chunks", "1",
            "--dropout", "0", "--batch_size", "4", "--average_last", "2",
            "--warmup_steps", "3", "--transformer_lr", "0.01"]
    losses = tcli.main(argv + ["--epochs", "2", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    with open(os.path.join(store, "final_avg", "config.json")) as f:
        meta = json.load(f)
    assert meta["encoder_type"] == "conformer" and meta["conv_kernel"] == 5

    # decode: the JAX CLI and the port's on the same model directory
    common = ["--beam_size", "3", "--max_len", "6", "--jit_decode", "--batch_size", "2"]
    tout, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    trecog.main([store, egs, tout, *common, "--device", "cpu"])
    jrecog.main([store, egs, jout, *common])
    with open(tout) as f, open(jout) as g:
        got, want = f.read(), g.read()
    assert got == want and len(got.splitlines()) == 10

    # resume both ways from the port's epoch_2
    for name in ("jax", "port"):
        d = str(tmp_path / f"resume_{name}")
        os.makedirs(d)
        for sub in ("epoch_1", "epoch_2"):
            shutil.copytree(os.path.join(store, sub), os.path.join(d, sub))
        shutil.copy(os.path.join(store, "vocab.json"), d)
    jcli.main([*argv[:2], str(tmp_path / "resume_jax"), *argv[3:], "--epochs", "3"])
    tcli.main([*argv[:2], str(tmp_path / "resume_port"), *argv[3:], "--epochs", "3",
               "--device", "cpu"])
    pj, _ = tckpt.load_checkpoint(str(tmp_path / "resume_jax" / "epoch_3"))
    pt, _ = tckpt.load_checkpoint(str(tmp_path / "resume_port" / "epoch_3"))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(pt["params"]))
    for path, w in jax.tree_util.tree_leaves_with_path(pj["params"]):
        name = jax.tree_util.keystr(path)
        # attention key biases get an exactly zero gradient, so Adam moves
        # them on each side by up to lr x (rounding noise / its own size):
        # at most the epoch's summed rate, 3 steps of <= 7e-4
        atol = 2.1e-3 if "['key']['bias']" in name else 1e-5
        np.testing.assert_allclose(flat_t[path], w, rtol=0, atol=atol, err_msg=name)
    shutil.rmtree(str(tmp_path / "resume_jax" / "final_avg"))
    losses = tcli.main([*argv[:2], str(tmp_path / "resume_jax"), *argv[3:], "--epochs", "4",
                        "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    _, meta4 = tckpt.load_checkpoint(str(tmp_path / "resume_jax" / "epoch_4"))
    assert meta4["extra"] == {"epoch": 4}

    pipe = tsa.OnlineASRPipeline.from_model_dir(store, "final_avg", device="cpu")
    assert pipe.recognizer.cfg.encoder_type == "conformer"
    assert pipe.recognizer.cfg.conv_kernel == 5
    model, cfg, _ = trecog._load(store, "final_avg", device="cpu")
    assert all(isinstance(m, ttasr.ConformerBlock) for m in model.encoder.layers)
    assert model.encoder.layers[0].conv_depthwise.kernel_size == (5,)
    server, _ = tserve.make_server(store, ckpt="final_avg", port=0, device="cpu")
    server.server_close()


# ------------------------------------------------------------------ streaming


@pytest.mark.parametrize("kernel", [7, 4])
def test_stream_step_matches_jax(kernel):
    """Six rounds of make_stream_step on three rows (a full row, an idle
    row from round 3 on, a partial tail at the end) against the JAX step:
    encoder and CTC rows, and every cache (kv, kv_valid and the conv tail)
    after every round, at rtol 1e-5 / atol 2e-5 (float32 rows of
    magnitude ~20; kv_valid exactly)."""
    chunk = 3
    jmodel, params, port = _models(kernel, chunk, 2, seed=6)
    jstep, jinit = jsa.make_stream_step(jmodel, params)
    tstep, tinit = tsa.make_stream_step(port)
    B, adim = 3, MODEL["adim"]
    jc, tc = jinit(B), tinit(B)
    assert tc["layer_0"]["conv"].shape == (B, kernel - 1, adim)
    rs = np.random.RandomState(8)
    pos = np.zeros(B, int)
    for rnd in range(6):
        x = rs.randn(B, 4 * chunk + 3, D).astype(np.float32)
        nv = np.array([chunk, chunk if rnd < 2 else 0, chunk if rnd < 5 else chunk - 1],
                      np.int32)
        up = nv == chunk
        pe = np.stack([tsa._posenc_rows(int(p), chunk, adim) for p in pos])
        jh, jctc, jc = jstep(jnp.asarray(x), jnp.asarray(pe), jnp.asarray(nv), jnp.asarray(up),
                             jc)
        th, tctc, tc = tstep(torch.as_tensor(x), torch.as_tensor(pe),
                             torch.as_tensor(nv).long(), torch.as_tensor(up), tc)
        for r in range(B):
            k = int(nv[r])
            np.testing.assert_allclose(tctc[r, :k].numpy(), np.asarray(jctc)[r, :k],
                                       rtol=1e-5, atol=2e-5)
            np.testing.assert_allclose(th[r, :k].numpy(), np.asarray(jh)[r, :k], rtol=1e-5,
                                       atol=2e-5)
        for i in range(MODEL["elayers"]):
            assert set(tc[f"layer_{i}"]) == set(jc[f"layer_{i}"]) == {"kv", "kv_valid", "conv"}
            np.testing.assert_array_equal(tc[f"layer_{i}"]["kv_valid"].numpy(),
                                          np.asarray(jc[f"layer_{i}"]["kv_valid"]))
            for key in ("kv", "conv"):
                np.testing.assert_allclose(tc[f"layer_{i}"][key].numpy(),
                                           np.asarray(jc[f"layer_{i}"][key]), rtol=1e-5,
                                           atol=2e-5, err_msg=f"round {rnd} layer {i} {key}")
        pos += nv


def test_streamed_conformer_is_the_offline_chunked_encode():
    """Ragged pushes through StreamingRecognizer give the offline
    chunk-masked causal-conv encode (memory and CTC at atol 3e-5) and its
    greedy CTC."""
    _, _, port = _models(7, 3, 1, seed=7)
    T = 150
    x = np.random.RandomState(4).randn(T, D).astype(np.float32)
    with torch.no_grad():
        mem, enc_len, ctc = port.encode(torch.as_tensor(x[None]), torch.as_tensor([T]))
    n = int(enc_len[0])
    sr = tsa.StreamingRecognizer(port)
    i = 0
    for sz in (7, 30, 13, 50, 29, 100):
        sr.push(x[i : i + sz])
        i += sz
    hyp = sr.finish()
    assert sr.enc_len == n
    np.testing.assert_allclose(sr.memory, mem[0, :n].numpy(), rtol=0, atol=3e-5)
    np.testing.assert_allclose(sr.ctc_logits, ctc[0, :n].numpy(), rtol=0, atol=3e-5)
    assert hyp == ttasr.greedy_ctc(ctc, enc_len)[0]


def _batcher_run(sb, xs):
    """Stream a alone to its end, then b and c (c takes a's freed slot, with
    a's stale conv tail in it) interleaved; then d, which evicts one."""
    a = sb.open()
    sb.push(a, xs[0])
    out = {"a": sb.finish(a)}
    b, c = sb.open(), sb.open()
    for off in range(0, 120, 17):
        sb.push(b, xs[1][off : off + 17])
        sb.push(c, xs[2][off : off + 17])
    d = sb.open()
    sb.push(d, xs[3])
    for name, sid in (("b", b), ("c", c), ("d", d)):
        out[name] = sb.finish(sid)
    states = {k: sb.state(s) for k, s in (("a", a), ("b", b), ("c", c), ("d", d))}
    return out, states


def test_batcher_with_slot_reuse_matches_jax_and_singles():
    """A two-row batcher whose slot is reused by a fresh stream and whose
    rows are evicted once: hypotheses and times identical to the JAX
    batcher's and to single-stream recognizers', memory at atol 3e-5. The
    reused slot's conv tail is zeroed, as a fresh stream needs."""
    jmodel, params, port = _models(7, 3, 1, seed=8, noise=0.3)
    rs = np.random.RandomState(3)
    xs = [rs.randn(t, D).astype(np.float32) for t in (80, 120, 120, 95)]
    got, gst = _batcher_run(tsa.StreamBatcher(port, max_streams=2, store_memory=True), xs)
    want, wst = _batcher_run(jsa.StreamBatcher(jmodel, params, max_streams=2,
                                               store_memory=True), xs)
    assert any(got.values())
    for k, x in zip("abcd", xs):
        sr = tsa.StreamingRecognizer(port)
        sr.push(x)
        assert got[k] == want[k] == sr.finish(), k
        assert gst[k].times == wst[k].times == sr.times
        np.testing.assert_allclose(gst[k].memory, wst[k].memory, rtol=0, atol=3e-5)
        np.testing.assert_allclose(gst[k].memory, sr.memory, rtol=0, atol=3e-5)
