"""The port's RNNLM training stage held against the JAX package:
`models/rnnlm.py::lm_loss`, `io/jax_params.py::rnnlm_to_jax` (the inverse
of rnnlm_from_jax), plain optax.adam's state layout, and
`cli/train_lm.py` (lm_batches, main, checkpoints both ways, resume both
ways, the JAX recog_e2e loading the port's LM).

Both sides get the same numpy inputs and the same weights (carried over
with rnnlm_from_jax / rnnlm_to_jax). The JAX side runs on the CPU with the
conftest's x64; the port runs on the CPU.
"""

import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.cli import train_lm as jtrain_lm
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.cli import train_lm
from speech_recognition_tools_tpu_torch.io.jax_params import (
    adam_state_from_jax,
    adam_state_to_jax,
    rnnlm_from_jax,
    rnnlm_to_jax,
)
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM, lm_loss
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt
from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

torch.set_num_threads(1)

E, H = 8, 16
TINY = ["--embed_dim", str(E), "--hidden", str(H), "--batch_size", "4", "--bptt_len", "12"]


def _texts(seed=0, n=9):
    """n transcripts of 3-17 characters over a small alphabet."""
    rs = np.random.RandomState(seed)
    letters = "abcdefg"
    return {f"u{i}": " ".join("".join(letters[j] for j in rs.randint(0, 7, rs.randint(1, 6)))
                              for _ in range(rs.randint(1, 4)))
            for i in range(n)}


def _write_text(path, texts):
    with open(path, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return str(path)


def _jax_lm(V, seed=3, layers=1):
    lm = jrnnlm.RNNLM(vocab_size=V, embed_dim=E, hidden=H, layers=layers)
    params = lm.init({"params": jax.random.key(seed)}, jnp.zeros((1, 4), jnp.int32))
    rs = np.random.RandomState(seed + 100)
    return lm, jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _port_lm(params, V, layers=1):
    lm = RNNLM(V, E, H, layers, device="cpu")
    lm.load_state_dict(rnnlm_from_jax(params))
    return lm


def _tree_close(got, want, rtol=0.0, atol=0.0, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, (path, k, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{path}/{k}")


def _batch(V):
    texts = _texts(1)
    vocab = jtext.build_char_vocab(texts.values())
    assert len(vocab) == V
    return next(train_lm.lm_batches(texts, vocab, 5, 12, seed=2))


V = len(jtext.build_char_vocab(_texts(1).values()))


@pytest.mark.parametrize("seed", [None, 4])
def test_lm_batches_match_jax(seed):
    """The same arrays, batch for batch, shuffled (numpy RandomState) or not,
    with sequences split at bptt_len."""
    texts = _texts()
    vocab = jtext.build_char_vocab(texts.values())
    got = list(train_lm.lm_batches(texts, vocab, 4, 7, seed=seed))
    want = list(jtrain_lm.lm_batches(texts, vocab, 4, 7, seed=seed))
    assert len(got) == len(want) > 2
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
        assert gt.dtype == wt.dtype and gl.dtype == wl.dtype
    assert max(int(ln.max()) for _, ln in got) == 7


@pytest.mark.parametrize("layers", [1, 2])
def test_lm_loss_matches_jax(layers):
    """Next-token cross-entropy over valid positions, ragged lengths, at
    rtol 1e-6."""
    jlm, params = _jax_lm(V, layers=layers)
    toks, lens = _batch(V)
    assert len(set(lens.tolist())) > 1
    want = float(jrnnlm.lm_loss(jlm, params, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        got = float(lm_loss(_port_lm(params, V, layers), torch.as_tensor(toks).long(),
                            torch.as_tensor(lens).long()))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rnnlm_converters_are_exact_inverses_and_init_matches_flax():
    """rnnlm_to_jax inverts rnnlm_from_jax bit for bit, both ways; the port's
    reset_parameters draws each leaf with flax's std within 10% (V 60,
    embed 64, hidden 128, zero biases zero)."""
    _, params = _jax_lm(V, layers=2)
    _tree_close(rnnlm_to_jax(rnnlm_from_jax(params)), params)
    sd = _port_lm(params, V, 2).state_dict()
    back = rnnlm_from_jax(rnnlm_to_jax(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)

    fl = jrnnlm.RNNLM(vocab_size=60, embed_dim=64, hidden=128).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 4), jnp.int32))
    m = RNNLM(60, 64, 128, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    got = {"/".join(k): v for k, v in _flat(rnnlm_to_jax(m.state_dict())).items()}
    want = {"/".join(k): v for k, v in _flat(jax.tree.map(np.asarray, fl)).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        sw, sg = float(np.std(w)), float(np.std(got[k]))
        assert (sg == 0) if sw == 0 else abs(sg / sw - 1) < 0.1, (k, sg, sw)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_train_step_matches_jax_and_adam_matches_optax_in_float64():
    """One train_lm step (make_train_step: lm_loss, backward, Adam) in
    float32 from the same weights: loss at rtol 1e-6, every gradient at
    atol 1e-6. Then plain optax.adam(lr) against the port's Adam for two
    updates in float64 on both sides, fed the same (JAX's) gradients:
    parameters and the optimizer state, in optax's layout, at rtol 1e-12.
    The JAX GRU keeps a float32 carry, so the model itself cannot run in
    float64 there; in float32 Adam's first update lr * g / (|g| + eps)
    turns rounding of near-zero gradient entries into differences up to
    lr."""
    lr = 1e-2
    jlm, params = _jax_lm(V)
    texts = _texts(1)
    vocab = jtext.build_char_vocab(texts.values())
    batches = list(train_lm.lm_batches(texts, vocab, 5, 12, seed=2))[:2]
    jgrads = []
    for toks, lens in batches:
        jl, jg = jax.value_and_grad(lambda q: jrnnlm.lm_loss(
            jlm, q, jnp.asarray(toks), jnp.asarray(lens)))(params)
        jgrads.append(jax.tree.map(np.asarray, jg))
        if len(jgrads) == 1:
            jloss = float(jl)
    model = _port_lm(params, V)
    params_t = dict(model.named_parameters())
    opt = ClipAdam(lr, None, inject=False)
    step = train_lm.make_train_step(model, opt)
    _, tl = step(opt.init(params_t), *(torch.as_tensor(a).long() for a in batches[0]))
    np.testing.assert_allclose(float(tl), jloss, rtol=1e-6)
    _tree_close(rnnlm_to_jax({k: p.grad for k, p in params_t.items()}), jgrads[0], atol=1e-6)

    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    tx = optax.adam(lr)
    st = tx.init(p64)
    port = {k: v.double() for k, v in rnnlm_from_jax(params).items()}
    ost = opt.init(port)
    for g in jgrads:
        u, st = tx.update(jax.tree.map(lambda a: np.asarray(a, np.float64), g), st, p64)
        p64 = optax.apply_updates(p64, u)
        ost, _ = opt.apply(port, {k: v.double() for k, v in rnnlm_from_jax(g).items()}, ost)
    _tree_close(rnnlm_to_jax(port), jax.tree.map(np.asarray, p64), rtol=1e-12)
    tree = adam_state_to_jax(ost, rnnlm_to_jax, clip=False, inject=False)
    want = flax.serialization.to_state_dict(st)
    _tree_close(tree, jax.tree.map(np.asarray, want), rtol=1e-12)
    assert set(want) == {"0", "1"} and want["1"] == {}
    back = adam_state_from_jax(tree, rnnlm_from_jax, clip=False)
    assert back["count"] == 2 and "learning_rate" not in back


def test_port_train_lm_checkpoint_loads_in_jax_recog(tmp_path):
    """train_lm.main --device cpu: vocab.json, epoch_N with the Adam state
    and extra.epoch, a final whose config is the flags plus model_class and
    vocab_size; the JAX recog_e2e._load_lm restores final, whose logits
    equal the port _load_lm's (atol 1e-5)."""
    text = _write_text(tmp_path / "text", _texts())
    store = str(tmp_path / "lm")
    nll = train_lm.main([text, store, *TINY, "--epochs", "2", "--device", "cpu"])
    assert len(nll) == 2 and all(np.isfinite(nll))
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "final", "vocab.json"]
    payload, meta = tckpt.load_checkpoint(os.path.join(store, "epoch_2"))
    assert meta["extra"] == {"epoch": 2} and set(payload) == {"params", "opt_state"}
    assert int(payload["opt_state"]["0"]["count"]) == 2 * 3  # 9 texts, batch 4
    _, cfg = tckpt.load_checkpoint(os.path.join(store, "final"))
    vocab = jtext.load_vocab(os.path.join(store, "vocab.json"))
    assert vocab == jtext.build_char_vocab(_texts().values())
    assert cfg["model_class"] == "RNNLM" and cfg["vocab_size"] == len(vocab)
    assert cfg["hidden"] == H and cfg["embed_dim"] == E and cfg["cell"] == "gru"

    jlm, jparams = jrecog._load_lm(store)
    toks, lens = next(train_lm.lm_batches(_texts(), vocab, 4, 12, seed=0))
    want = np.asarray(jlm.apply(jparams, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        got = trecog._load_lm(store, device="cpu")(torch.as_tensor(toks).long(),
                                                   torch.as_tensor(lens).long()).numpy()
    valid = np.arange(toks.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_cli_resumes_from_the_others_epoch(tmp_path, capsys, first):
    """One package trains epoch 1 (the run is then interrupted: its final is
    removed), the other resumes from epoch_1 and trains epoch 2; the same
    resume by the first package gives the same epoch-2 nll (rtol 1e-5) and
    parameters (atol 1e-4)."""
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
        assert len(nll) == 1 and not any(ln.startswith("epoch 1:") for ln in out.splitlines())
        stores[who] = (store, float(nll[0].split()[3]))
    (s_a, nll_a), (s_b, nll_b) = stores[second], stores[first]
    np.testing.assert_allclose(nll_a, nll_b, rtol=1e-5)
    p_a = tckpt.load_checkpoint(os.path.join(s_a, "final"))[0]["params"]
    p_b = tckpt.load_checkpoint(os.path.join(s_b, "final"))[0]["params"]
    _tree_close(p_a, p_b, atol=1e-4)


@pytest.mark.parametrize("extra,match", [(["--unit", "word"], "item 3"),
                                         (["--unit", "word", "--cell", "lstm"], "item 3")],
                         ids=["extra0-item 10", "extra1-item 7"])
def test_unported_train_lm_options_raise(tmp_path, extra, match):
    text = _write_text(tmp_path / "text", _texts())
    with pytest.raises(NotImplementedError, match=match):
        train_lm.main([text, str(tmp_path / "lm"), *TINY, "--device", "cpu", *extra])


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    text = _write_text(tmp_path / "text", _texts())
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main([text, str(tmp_path / "lm"), *TINY])
