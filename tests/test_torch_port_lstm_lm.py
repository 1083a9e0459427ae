"""The port's LSTM RNNLM held against the JAX package: `RNNLM(cell="lstm")`
(flax OptimizedLSTMCell layers `rnn_{i}`, carry frozen past each length),
`lm_loss`, `step` against `forward`, the converters and initialisers of
the LSTM tree, `train_lm --cell lstm` resuming from the other package's
epoch 1 both ways, and the batched beam search fused with an LSTM LM.

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise, carried over by io/jax_params.py). The JAX
side runs on the CPU with the conftest's x64 and float32 weights; the port
runs on the CPU in float32.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.cli import train_lm as jtrain_lm
from speech_recognition_tools_tpu.decode import beam_jit as jbeam
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.cli import train_lm
from speech_recognition_tools_tpu_torch.decode import beam_jit as tbeam
from speech_recognition_tools_tpu_torch.io.jax_params import (
    rnnlm_from_jax,
    rnnlm_to_jax,
    transformer_asr_from_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM, lm_loss
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

E, H = 8, 16
TINY = ["--embed_dim", str(E), "--hidden", str(H), "--batch_size", "4", "--bptt_len", "12",
        "--cell", "lstm"]


def _texts(seed=0, n=9):
    rs = np.random.RandomState(seed)
    letters = "abcdefg"
    return {f"u{i}": " ".join("".join(letters[j] for j in rs.randint(0, 7, rs.randint(1, 6)))
                              for _ in range(rs.randint(1, 4)))
            for i in range(n)}


def _write_text(path, texts):
    with open(path, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return str(path)


V = len(jtext.build_char_vocab(_texts(1).values()))


def _perturb(params, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rs.randn(*a.shape)).astype(np.float32), params)


def _jax_lm(vocab, layers=1, seed=3, embed=E, hidden=H):
    lm = jrnnlm.RNNLM(vocab_size=vocab, embed_dim=embed, hidden=hidden, layers=layers,
                      cell="lstm")
    params = lm.init({"params": jax.random.key(seed)}, jnp.zeros((1, 4), jnp.int32))
    return lm, _perturb(params, seed + 100)


def _port_lm(params, vocab, layers=1, embed=E, hidden=H):
    lm = RNNLM(vocab, embed, hidden, layers, "lstm", device="cpu")
    lm.load_state_dict(rnnlm_from_jax(params))
    return lm.eval()


def _batch():
    texts = _texts(1)
    vocab = jtext.build_char_vocab(texts.values())
    return next(train_lm.lm_batches(texts, vocab, 5, 12, seed=2))


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_forward_and_loss_match_jax(layers):
    """Logits on ragged, padded batches and lm_loss within 1e-5 (float32
    both sides); padded outputs are zeroed before the output Dense, as in
    the JAX layer."""
    jlm, params = _jax_lm(V, layers)
    port = _port_lm(params, V, layers)
    toks, lens = _batch()
    assert len(set(lens.tolist())) > 1
    want = np.asarray(jlm.apply(params, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        got = port(torch.as_tensor(toks).long(), torch.as_tensor(lens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jloss = float(jrnnlm.lm_loss(jlm, params, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        tloss = float(lm_loss(port, torch.as_tensor(toks).long(), torch.as_tensor(lens).long()))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_lstm_gradients_match_jax():
    """The lm_loss gradients of every LSTM leaf, in flax's layout, within
    1e-5."""
    jlm, params = _jax_lm(V, 2)
    port = _port_lm(params, V, 2)
    toks, lens = _batch()
    jg = jax.grad(lambda q: jrnnlm.lm_loss(jlm, q, jnp.asarray(toks), jnp.asarray(lens)))(params)
    lm_loss(port, torch.as_tensor(toks).long(), torch.as_tensor(lens).long()).backward()
    got = rnnlm_to_jax({k: p.grad for k, p in port.named_parameters()})["params"]
    want = jax.tree.map(np.asarray, jg)["params"]
    assert set(got) == set(want) == {"embed", "rnn_0", "rnn_1", "output"}
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        w = want
        for k in path:
            w = w[k.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_step_is_the_time_loop(layers):
    """step() over a sequence, one token at a time with the (h, c) carry,
    gives forward()'s logits at every position (atol 1e-6), and
    reorder_state takes both h and c at the given rows."""
    _, params = _jax_lm(V, layers)
    port = _port_lm(params, V, layers)
    toks = torch.as_tensor(np.random.RandomState(0).randint(0, V, (3, 9)))
    with torch.no_grad():
        full = port(toks)
        state = port.init_state(3)
        assert isinstance(state, tuple) and state[0].shape == (layers, 3, H)
        for s in range(9):
            logits, state = port.step(toks[:, s], state)
            np.testing.assert_allclose(logits.numpy(), full[:, s].numpy(), rtol=0, atol=1e-6)
    rows = torch.tensor([2, 0, 2])
    h, c = port.reorder_state(state, rows)
    assert torch.equal(h, state[0][:, rows]) and torch.equal(c, state[1][:, rows])


def test_lstm_converters_and_init_match_flax():
    """rnnlm_to_jax inverts rnnlm_from_jax bit for bit for the LSTM tree (the
    leaves and names flax's RNNLM(cell="lstm") has); the port's
    reset_parameters draws each leaf with flax's std within 10% (vocab 60,
    embed 64, hidden 128; lecun_normal input kernels, orthogonal recurrent
    kernels, zero biases)."""
    _, params = _jax_lm(V, 2)
    back = rnnlm_to_jax(rnnlm_from_jax(params))
    flat = lambda t: {"/".join(str(k.key) for k in p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    fb, fp = flat(back), flat(params)
    assert set(fb) == set(fp)
    assert all(np.array_equal(fb[k], fp[k]) for k in fp)

    init = jrnnlm.RNNLM(vocab_size=60, embed_dim=64, hidden=128, cell="lstm").init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 4), jnp.int32))
    m = RNNLM(60, 64, 128, cell="lstm", device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    got, want = flat(rnnlm_to_jax(m.state_dict())), flat(init)
    assert set(got) == set(want)
    for k, w in want.items():
        sw, sg = float(np.std(w)), float(np.std(got[k]))
        assert (sg == 0) if sw == 0 else abs(sg / sw - 1) < 0.1, (k, sg, sw)


def test_port_lstm_checkpoint_loads_in_jax_recog(tmp_path):
    """train_lm.main --cell lstm: config.json records the cell, and the JAX
    recog_e2e._load_lm restores the final checkpoint, whose logits equal
    the port _load_lm's (which reads the cell from the config) within
    1e-5."""
    text = _write_text(tmp_path / "text", _texts())
    store = str(tmp_path / "lm")
    nll = train_lm.main([text, store, *TINY, "--epochs", "1", "--device", "cpu"])
    assert len(nll) == 1 and np.isfinite(nll[0])
    _, cfg = tckpt.load_checkpoint(os.path.join(store, "final"))
    assert cfg["cell"] == "lstm"
    jlm, jparams = jrecog._load_lm(store)
    assert jlm.cell == "lstm"
    vocab = jtext.load_vocab(os.path.join(store, "vocab.json"))
    toks, lens = next(train_lm.lm_batches(_texts(), vocab, 4, 12, seed=0))
    want = np.asarray(jlm.apply(jparams, jnp.asarray(toks), jnp.asarray(lens)))
    port = trecog._load_lm(store, device="cpu")
    assert port.cell == "lstm"
    with torch.no_grad():
        got = port(torch.as_tensor(toks).long(), torch.as_tensor(lens).long()).numpy()
    valid = np.arange(toks.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_cli_resumes_the_others_lstm_epoch(tmp_path, capsys, first):
    """One package trains epoch 1 of an LSTM LM (its final is then
    removed), the other resumes from epoch_1 (parameters and the Adam
    state) and trains epoch 2; the same resume by the first package gives
    the same epoch-2 nll (rtol 1e-5) and parameters (atol 1e-4)."""
    text = _write_text(tmp_path / "text", _texts())
    mains = {"jax": jtrain_lm.main, "port": lambda a: train_lm.main(a + ["--device", "cpu"])}
    second = "port" if first == "jax" else "jax"
    stores = {}
    for who in (second, first):
        store = str(tmp_path / f"resumed_by_{who}")
        mains[first]([text, store, *TINY, "--epochs", "1"])
        shutil.rmtree(os.path.join(store, "final"))
        capsys.readouterr()
        mains[who]([text, store, *TINY, "--epochs", "2"])
        out = capsys.readouterr().out
        assert f"resumed from {store}/epoch_1 at epoch 1" in out, out
        nll = [ln for ln in out.splitlines() if ln.startswith("epoch 2: nll")]
        assert len(nll) == 1
        stores[who] = (store, float(nll[0].split()[3]))
    (s_a, nll_a), (s_b, nll_b) = stores[second], stores[first]
    np.testing.assert_allclose(nll_a, nll_b, rtol=1e-5)
    p_a = tckpt.load_checkpoint(os.path.join(s_a, "final"))[0]["params"]
    p_b = tckpt.load_checkpoint(os.path.join(s_b, "final"))[0]["params"]
    assert set(p_a["params"]) == set(p_b["params"]) == {"embed", "rnn_0", "output"}
    for path, a in jax.tree_util.tree_flatten_with_path(p_a)[0]:
        b = p_b
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=str(path))


MODEL = dict(vocab_size=14, adim=32, aheads=4, elayers=2, eunits=64, dlayers=2, dunits=64)
EOS = MODEL["vocab_size"] - 1


@pytest.mark.parametrize("incremental", [False, True])
def test_beam_search_with_lstm_lm_matches_jax(incremental):
    """B = 3 ragged utterances, beam 4, max_len 12, ctc_weight 0.3, a 2-layer
    LSTM LM at weight 1.0: the port's batched search (its LM state (h, c)
    reordered with the beams; full-prefix or KV-cached decoder) is
    token-identical to beam_search_jit_batched with the JAX fusion scorer,
    all K scores within atol 1e-4 (float32 here, float64 there)."""
    jm = jtasr.TransformerASR(jtasr.TransformerASRConfig(**MODEL))
    params = _perturb(jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 23, 8), jnp.float32),
                              jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32)), 100, 0.05)
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**MODEL), 8, device="cpu")
    port.load_state_dict(transformer_asr_from_jax(params))
    port.eval()
    jlm, lm_params = _jax_lm(MODEL["vocab_size"], 2, embed=16, hidden=24)
    lm_port = _port_lm(lm_params, MODEL["vocab_size"], 2, embed=16, hidden=24)
    rs = np.random.RandomState(0)
    x, lens = rs.randn(3, 80, 8).astype(np.float32), np.array([80, 70, 61], np.int32)
    jt, js = jbeam.beam_search_jit_batched(
        jm, params, jnp.asarray(x), jnp.asarray(lens), beam_size=4, max_len=12,
        ctc_weight=0.3, lm_apply=jrnnlm.make_jit_fusion_scorer(jlm, lm_params), lm_weight=1.0,
        incremental=incremental)
    jt, js = np.asarray(jt), np.asarray(js)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=12, ctc_weight=0.3,
                                       lm=lm_port, lm_weight=1.0, device="cpu",
                                       incremental=incremental)
    for b in range(3):
        want = jbeam.tokens_to_list(jt[b], js[b], EOS)
        assert tbeam.tokens_to_list(tt[b], ts[b], EOS) == want
        assert len(want) > 0
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)


def test_unknown_cell_raises():
    with pytest.raises(ValueError, match="cell"):
        RNNLM(V, E, H, cell="rnn", device="cpu")
