"""The port's training half of the e2e slice held against the JAX package:
the CTC loss (optax's recursion and floor), the joint CTC/attention loss,
the train step with its Noam-scheduled, clipped Adam, SpecAugment on
JAX's own draws, dropout and initialisation, the transformer converters in
both directions, and the train_e2e CLI with checkpoints either package
restores.

Both sides get the same numpy inputs and weights (a flax init carried over
by io/jax_params.py). The JAX side runs on the CPU with the conftest's
x64; the port runs on the CPU. Losses, gradients and train steps are
compared in float64 on both sides (the flax transformer computes in the
dtype of its parameters and inputs), where Adam's first updates would
otherwise amplify float32 rounding of near-zero gradient entries by
lr / eps.
"""

import json
import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tools_tpu.cli import train_e2e as jcli
from speech_recognition_tools_tpu.dsp import specaug as jspec
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import train_e2e as tcli
from speech_recognition_tools_tpu_torch.dsp import specaug as tspec
from speech_recognition_tools_tpu_torch.io import egs as tegs
from speech_recognition_tools_tpu_torch.io.jax_params import (
    adam_state_to_jax,
    transformer_asr_from_jax,
    transformer_asr_to_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.train import checkpoint as tckpt
from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

torch.set_num_threads(1)

MODEL = dict(vocab_size=14, adim=32, aheads=4, elayers=2, eunits=64, dlayers=1, dunits=64)
D = 8


def _jax_asr(seed=0, dtype=jnp.float32, **cfg):
    c = jtasr.TransformerASRConfig(**MODEL, **{"dropout": 0.0, **cfg})
    model = jtasr.TransformerASR(c)
    params = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, 23, D), jnp.float32),
                        jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    return model, c, jax.tree.map(lambda a: np.asarray(a, dtype), params)


def _port_asr(params, dtype=torch.float32, **cfg):
    c = ttasr.TransformerASRConfig(**MODEL, **{"dropout": 0.0, **cfg})
    m = ttasr.TransformerASR(c, D, device="cpu").to(dtype)
    m.load_state_dict(transformer_asr_from_jax(params))
    return m, c


def _batch(seed=0, dtype=np.float64, B=3, T=60, U=16):
    rs = np.random.RandomState(seed)
    tl = np.array([9, 4, 6], np.int32)[:B]
    tokens = rs.randint(1, MODEL["vocab_size"] - 1, (B, U)).astype(np.int32)
    tokens[np.arange(U)[None, :] >= tl[:, None]] = 0
    tokens[0, 2] = tokens[0, 1]  # a repeated label
    return {"feats": rs.randn(B, T, D).astype(dtype),
            "lengths": np.array([T, T - 11, T - 23], np.int32)[:B],
            "tokens": tokens, "token_lengths": tl}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _tree_close(got, want, rtol=0.0, atol=0.0, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, (path, k, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{path}/{k}")


def _to_tree(sd):
    return transformer_asr_to_jax({k: v.detach() for k, v in sd.items()}, MODEL["aheads"])


# ------------------------------------------------------------------ CTC


def _ctc_case():
    """Four rows over T = 8, K = 5: feasible; infeasible by repeats (four
    1s need 7 frames, 5 are valid); padded frames (6 valid) and padded
    labels; a row that is exactly feasible (labels 1 2 2 in 4 frames)."""
    rs = np.random.RandomState(5)
    B, T, K, N = 4, 8, 5, 4
    logits = rs.randn(B, T, K)
    labels = np.array([[1, 2, 3, 0], [1, 1, 1, 1], [4, 2, 0, 0], [1, 2, 2, 0]], np.int32)
    lab_pad = np.array([[0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 1, 1], [0, 0, 0, 1]], np.float64)
    log_pad = np.zeros((B, T))
    log_pad[1, 5:] = 1
    log_pad[2, 6:] = 1
    log_pad[3, 4:] = 1
    return logits, log_pad, labels, lab_pad


def test_ctc_loss_matches_optax_with_gradient():
    """Every row (feasible, infeasible by repeats, padded) and the gradient
    of their sum, float64, rtol 1e-10; the infeasible row is finite
    (~1e5) with a finite gradient."""
    logits, log_pad, labels, lab_pad = _ctc_case()
    args = [jnp.asarray(a) for a in (log_pad, labels, lab_pad)]
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), *args))
    jg = np.asarray(jax.grad(lambda x: jnp.sum(optax.ctc_loss(x, *args)))(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got = ttasr.ctc_loss(x, *(torch.as_tensor(a) for a in (log_pad, labels, lab_pad)))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-8, atol=1e-12)
    assert 9e4 < got[1].item() < 2e5 and np.isfinite(x.grad.numpy()).all()


def test_ctc_loss_where_torch_ctc_gives_inf():
    """T = 5, labels 1 1 1 1: optax (and the port) give ~1.00005e5, torch's
    F.ctc_loss gives inf; on a feasible row all three agree (rtol 1e-10)."""
    rs = np.random.RandomState(6)
    logits = rs.randn(2, 5, 3)
    labels = np.array([[1, 1, 1, 1], [1, 2, 0, 0]], np.int32)
    lab_pad = np.array([[0, 0, 0, 0], [0, 0, 1, 1]], np.float64)
    log_pad = np.zeros((2, 5))
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(log_pad),
                                     jnp.asarray(labels), jnp.asarray(lab_pad)))
    x = torch.tensor(logits, requires_grad=True)
    got = ttasr.ctc_loss(x, torch.as_tensor(log_pad), torch.as_tensor(labels),
                         torch.as_tensor(lab_pad))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10)
    assert abs(got[0].item() - 1.0000507e5) < 10 and torch.isfinite(x.grad).all()
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.as_tensor(logits), -1).transpose(0, 1), torch.as_tensor(labels),
        torch.tensor([5, 5]), torch.tensor([4, 2]), reduction="none")
    assert torch.isinf(lib[0])
    np.testing.assert_allclose(lib[1].item(), want[1], rtol=1e-10)


# ------------------------------------------------------------------ joint loss


def test_joint_loss_matches_jax_with_gradient():
    """_joint_loss on random logits (ragged enc_len, padded tokens, a
    repeat): loss, ctc and att parts rtol 1e-10; gradients wrt both logit
    arrays rtol 1e-8."""
    rs = np.random.RandomState(7)
    b = _batch()
    c = jtasr.TransformerASRConfig(**MODEL)
    ctc, dec = rs.randn(3, 12, 14), rs.randn(3, 16, 14)
    enc_len = np.array([12, 9, 7], np.int32)
    jb = {k: jnp.asarray(b[k]) for k in ("tokens", "token_lengths")}

    def jf(a, d):
        return jtasr._joint_loss(a, d, jnp.asarray(enc_len), jb, c)

    (jl, jaux), (ga, gd) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ctc), jnp.asarray(dec))
    ta = torch.tensor(ctc, requires_grad=True)
    td = torch.tensor(dec, requires_grad=True)
    tl, taux = ttasr.joint_loss(ta, td, torch.as_tensor(enc_len), _t(b),
                                ttasr.TransformerASRConfig(**MODEL))
    tl.backward()
    for got, want in ((tl, jl), (taux["ctc"], jaux["ctc"]), (taux["att"], jaux["att"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=1e-8, atol=1e-13)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_asr_loss_and_grads_match_jax(dtype):
    """asr_loss at dropout 0 through the whole model: float64 loss rtol
    1e-9 and every gradient entry within 1e-9 of the largest gradient
    entry; float32 loss rtol 1e-5 and gradients within 1e-4 of it (the
    attention's key biases have an exactly zero gradient, so their
    entries are rounding noise on both sides)."""
    f64 = dtype == "float64"
    model, c, params = _jax_asr(dtype=np.float64 if f64 else np.float32)
    b = _batch(dtype=np.float64 if f64 else np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtasr.asr_loss(model, p, jb, jax.random.key(1), c), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    port, tc = _port_asr(params, torch.float64 if f64 else torch.float32)
    tl, taux = ttasr.asr_loss(port, _t(b), tc, train=True)
    tl.backward()
    rtol, rel = (1e-9, 1e-9) if f64 else (1e-5, 1e-4)
    for got, want in ((tl, jl), (taux["ctc"], jaux["ctc"]), (taux["att"], jaux["att"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    got_g = _to_tree({k: p.grad for k, p in port.named_parameters()})
    flat_w = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jg))
    scale = max(np.abs(w).max() for _, w in flat_w)
    for path, w in flat_w:
        node = got_g
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=0, atol=rel * scale,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ train step


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(steps):
    """train_e2e.make_train_step with chain(clip 5, adam(noam(32, warmup 3,
    factor 1), b2 0.98)) on both sides for 1 and 3 steps (float64, dropout
    0; the rates differ every step): each step's loss rtol 1e-9, params
    and the optimizer state, in optax's layout, rtol 1e-6 (params atol
    1e-10: the attention's key biases have an exactly zero gradient, so
    each side moves them by lr x rounding noise / eps, ~1e-11)."""
    model, c, params = _jax_asr(dtype=np.float64)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(jtasr.noam_schedule(32, 3, 1.0), b2=0.98))
    jp = jax.tree.map(jnp.asarray, params)
    jst = tx.init(jp)
    jstep = jcli.make_train_step(model, c, tx)
    port, tc = _port_asr(params, torch.float64)
    opt = ClipAdam(ttasr.noam_schedule(32, 3, 1.0), 5.0, b2=0.98)
    tparams = dict(port.named_parameters())
    tst = opt.init(tparams)
    tstep = tcli.make_train_step(port, tc, opt)
    for s in range(steps):
        b = _batch(seed=s)
        jp, jst, jl, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()},
                               jax.random.key(s))
        tst, tl, _ = tstep(tst, _t(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-9)
    _tree_close(_to_tree(tparams), jax.tree.map(np.asarray, jp), rtol=1e-6, atol=1e-10)
    _tree_close(adam_state_to_jax(tst, _to_tree, clip=True),
                jax.tree.map(np.asarray, flax.serialization.to_state_dict(jst)),
                rtol=1e-6, atol=1e-15)


def test_noam_schedule_first_three_rates():
    """noam(0..3) equal to the JAX schedule's (step clamped to 1, so the
    first two updates share noam(1)); the lag itself is pinned in
    test_torch_port_train.py."""
    for step in range(4):
        np.testing.assert_allclose(ttasr.noam_schedule(256, 25000, 10.0)(step),
                                   float(jtasr.noam_schedule(256, 25000, 10.0)(step)),
                                   rtol=1e-12)
    sched = ttasr.noam_schedule(256, 25000, 10.0)
    assert sched(0) == sched(1) < sched(2) < sched(3)


def test_average_checkpoints_matches_jax():
    rs = np.random.RandomState(8)
    trees = [{"a": rs.randn(3, 2), "b": rs.randn(4)} for _ in range(3)]
    want = jtasr.average_checkpoints([jax.tree.map(jnp.asarray, t) for t in trees])
    got = ttasr.average_checkpoints([{k: torch.as_tensor(v) for k, v in t.items()}
                                     for t in trees])
    _tree_close({k: v.numpy() for k, v in got.items()}, jax.tree.map(np.asarray, want),
                rtol=1e-15)


# ------------------------------------------------------------------ SpecAugment


def _jax_draws(key, B, cfg):
    """The draws jax spec_augment makes, in its own split order."""
    k1, k2, k3 = jax.random.split(key, 3)
    _, a, b = jax.random.split(k1, 3)
    draws = {"warp_center": jax.random.uniform(a, (B,)),
             "warp_shift": jax.random.randint(b, (B,), -cfg.max_time_warp,
                                              cfg.max_time_warp + 1)}
    for name, key, n, width in (("freq", k2, cfg.n_freq_masks, cfg.freq_mask_width),
                                ("time", k3, cfg.n_time_masks, cfg.time_mask_width)):
        ws, us = [], []
        for _ in range(n):
            key, a, b = jax.random.split(key, 3)
            ws.append(jax.random.randint(a, (B,), 0, width + 1))
            us.append(jax.random.uniform(b, (B,)))
        draws[f"{name}_width"], draws[f"{name}_start"] = jnp.stack(ws), jnp.stack(us)
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_specaug_matches_jax_on_its_draws(seed, zero):
    """spec_augment_apply on the draws jax.random makes equals the JAX
    spec_augment (ragged lengths, 80 bands, mean or zero fill): warped and
    unmasked frames exactly, the mean fill to float32 rounding (its sum
    runs in another order), so rtol 1e-6 while a misplaced mask would
    differ by O(1)."""
    rs = np.random.RandomState(seed)
    B, T, F = 4, 120, 80
    feats = rs.randn(B, T, F).astype(np.float32)
    lengths = np.array([120, 97, 64, 41], np.int32)
    cfg_j = jspec.SpecAugConfig(replace_with_zero=zero)
    key = jax.random.key(seed)
    want = np.asarray(jspec.spec_augment(key, jnp.asarray(feats), jnp.asarray(lengths), cfg_j))
    cfg_t = tspec.SpecAugConfig(replace_with_zero=zero)
    got = tspec.spec_augment_apply(torch.as_tensor(feats), torch.as_tensor(lengths),
                                   _jax_draws(key, B, cfg_j), cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if zero:
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, feats)


def test_specaug_draws_are_in_range():
    cfg = tspec.SpecAugConfig()
    d = tspec.draw_specaug(torch.Generator().manual_seed(0), 64, cfg)
    assert d["warp_shift"].abs().max() <= cfg.max_time_warp
    assert d["freq_width"].shape == (2, 64) and 0 <= d["freq_width"].min()
    assert d["freq_width"].max() <= cfg.freq_mask_width
    assert d["time_width"].max() <= cfg.time_mask_width
    assert 0 <= d["time_start"].min() and d["time_start"].max() < 1
    feats = torch.randn(64, 100, 40)
    out = tspec.spec_augment(feats, torch.full((64,), 100), torch.Generator().manual_seed(0))
    assert out.shape == feats.shape and torch.isfinite(out).all()


# ------------------------------------------------------------------ model


def test_train_mode_at_dropout_zero_equals_eval():
    """forward in train mode at dropout 0 equals eval mode; at dropout 0.5
    it differs, while encode and decode_step stay deterministic in train
    mode (as the JAX encode / decode_step are)."""
    _, _, params = _jax_asr()
    b = _t(_batch(dtype=np.float32))
    tok_in = ttasr.decoder_inputs(b["tokens"], b["token_lengths"], MODEL["vocab_size"] - 1)
    m, _ = _port_asr(params)
    drop, _ = _port_asr(params, dropout=0.5)
    with torch.no_grad():
        run = [m.train()(b["feats"], b["lengths"], tok_in), m.eval()(b["feats"], b["lengths"],
                                                                     tok_in)]
        assert all(torch.equal(x, y) for x, y in zip(*run))
        noisy = drop.train()(b["feats"], b["lengths"], tok_in)
        assert not torch.equal(noisy[0], run[1][0]) and not torch.equal(noisy[1], run[1][1])
        enc = drop.encode(b["feats"], b["lengths"])
        assert drop.training
        assert all(torch.equal(x, y) for x, y in zip(enc, m.eval().encode(b["feats"],
                                                                          b["lengths"])))
        assert torch.equal(drop.decode_step(tok_in, enc[0], enc[1]),
                           m.decode_step(tok_in, enc[0], enc[1]))


def test_transformer_converters_are_exact_inverses():
    _, _, params = _jax_asr()
    _tree_close(_to_tree(transformer_asr_from_jax(params)), params)
    port, _ = _port_asr(params)
    sd = port.state_dict()
    back = transformer_asr_from_jax(_to_tree(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError):
        transformer_asr_to_jax({**sd, "stray.weight": torch.zeros(1)}, MODEL["aheads"])


def test_transformer_init_std_matches_flax():
    """Each leaf's standard deviation within 10% of flax's init (zero and
    constant leaves: zero)."""
    _, _, params = _jax_asr(seed=3)
    m = ttasr.TransformerASR(ttasr.TransformerASRConfig(**MODEL), D, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(3))
    got = _to_tree(m.state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(params):
        node = got
        for p in path:
            node = node[p.key]
        sw, sg = float(np.std(w)), float(np.std(node))
        if sw == 0:
            assert sg == 0, jax.tree_util.keystr(path)
        else:
            assert abs(sg / sw - 1) < 0.1, (jax.tree_util.keystr(path), sg, sw)


# ------------------------------------------------------------------ CLI


def _e2e_corpus(root, n=10, seed=9):
    rs = np.random.RandomState(seed)
    letters = "abcdefghij"
    feats, texts = [], {}
    for i in range(n):
        T = int(rs.randint(48, 90))
        feats.append((f"u{i}", rs.randn(T, D).astype(np.float32)))
        words = ["".join(rs.choice(list(letters), rs.randint(1, 4))) for _ in range(2)]
        texts[f"u{i}"] = " ".join(words)
    texts["u1"] = "aab bb"  # repeats
    egs = os.path.join(root, "egs")
    tegs.build_egs(iter(feats), egs)
    text = os.path.join(root, "text")
    with open(text, "w") as f:
        for k, v in texts.items():
            f.write(f"{k} {v}\n")
    return egs, text, texts


def test_token_batches_match_jax(tmp_path):
    egs, _, texts = _e2e_corpus(str(tmp_path))
    texts["u5"] = "abcdefghijabcdefghijabcdefghij"  # too long for its frames
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab

    vocab = build_char_vocab(texts.values())
    for thr in ((1.0, 0), (0.5, 2)):
        assert tcli.ctc_feasible(60, 13, *thr) == jcli.ctc_feasible(60, 13, *thr)
        want = list(jcli.token_batches(egs, texts, vocab, 4, *thr, 16))
        got = list(tcli.token_batches(egs, texts, vocab, 4, *thr, 16))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_train_e2e_main_checkpoints_both_ways(tmp_path):
    """train_e2e.main on the CPU (2 epochs, SpecAugment on): epoch and
    final_avg checkpoints that the JAX load_checkpoint restores (params and
    optimizer state), final_avg the mean of the two epochs, the JAX model
    on the restored params giving the port's CTC logits (rtol = atol =
    1e-5),
    resume from the newest epoch, --init_from a checkpoint the JAX package
    wrote, and NotImplementedError for the unported flags."""
    egs, text, _ = _e2e_corpus(str(tmp_path))
    store = str(tmp_path / "am")
    geo = ["--adim", "32", "--aheads", "4", "--elayers", "2", "--eunits", "64",
           "--dlayers", "1", "--dunits", "64"]
    argv = [egs, text, store, *geo, "--batch_size", "4", "--average_last", "2",
            "--warmup_steps", "3", "--transformer_lr", "1.0", "--device", "cpu", "--specaug"]
    tcli.main(argv + ["--epochs", "2"])
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "final_avg", "vocab.json"]
    with open(os.path.join(store, "vocab.json")) as f:
        V = len(json.load(f))
    cfg_j = jtasr.TransformerASRConfig(vocab_size=V, adim=32, aheads=4, elayers=2, eunits=64,
                                       dlayers=1, dunits=64)
    jmodel = jtasr.TransformerASR(cfg_j)
    template = jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 23, D), jnp.float32),
                           jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(jtasr.noam_schedule(32, 3, 10.0), b2=0.98))
    pay2, meta = jckpt.load_checkpoint(os.path.join(store, "epoch_2"), template={
        "params": template, "opt_state": tx.init(template)})
    assert meta["model_class"] == "TransformerASR" and meta["vocab_size"] == V
    assert meta["extra"] == {"epoch": 2} and meta["feature_dim"] == D
    assert int(pay2["opt_state"][1][0].count) == int(pay2["opt_state"][1][1].count) > 2
    pay1, _ = jckpt.load_checkpoint(os.path.join(store, "epoch_1"), template={"params": template})
    avg, meta = jckpt.load_checkpoint(os.path.join(store, "final_avg"),
                                      template={"params": template})
    assert meta["extra"] == {"averaged": 2}
    _tree_close(jax.tree.map(np.asarray, avg["params"]),
                jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
                             pay1["params"], pay2["params"]), rtol=1e-6, atol=1e-7)
    b = _batch(dtype=np.float32)
    mem_j, len_j, ctc_j = jmodel.apply(avg["params"], jnp.asarray(b["feats"]),
                                       jnp.asarray(b["lengths"]), method=jmodel.encode)
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**{**MODEL, "vocab_size": V}), D,
                                device="cpu")
    port.load_state_dict(transformer_asr_from_jax(
        tckpt.load_checkpoint(os.path.join(store, "final_avg"))[0]["params"]))
    with torch.no_grad():
        mem_t, len_t, ctc_t = port.encode(torch.as_tensor(b["feats"]),
                                          torch.as_tensor(b["lengths"]))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(ctc_t.numpy(), np.asarray(ctc_j), rtol=1e-5, atol=1e-5)

    shutil.rmtree(os.path.join(store, "final_avg"))  # as after an interrupted run
    tcli.main(argv + ["--epochs", "3"])
    assert sorted(os.listdir(store)) == ["epoch_1", "epoch_2", "epoch_3", "final_avg",
                                         "vocab.json"]
    pay3, _ = jckpt.load_checkpoint(os.path.join(store, "epoch_3"), template={
        "params": template, "opt_state": tx.init(template)})
    assert int(pay3["opt_state"][1][0].count) > int(pay2["opt_state"][1][0].count)

    # a checkpoint the JAX package wrote warm-starts the port
    src = str(tmp_path / "jax_am")
    jckpt.save_checkpoint(src, "final", template, {**meta, "vocab_size": V})
    shutil.copy(os.path.join(store, "vocab.json"), src)
    warm = str(tmp_path / "warm")
    tcli.main([egs, text, warm, "--init_from", src, "--batch_size", "4", "--epochs", "1",
               "--device", "cpu"])
    assert tcli.resolve_init_checkpoint(src) == (os.path.join(src, "final"), src)
    assert os.path.isdir(os.path.join(warm, "final_avg"))

    for bad in (["--tensor_parallel", "2"], ["--pipeline_parallel", "2"], ["--data_parallel"]):
        with pytest.raises(NotImplementedError):
            tcli.main([egs, text, str(tmp_path / "x"), *geo, "--device", "cpu", *bad])


def test_train_e2e_grad_clip_zero_matches_jax(tmp_path):
    """--grad_clip 0 chains clip_by_global_norm(0) in both packages: one step
    of each CLI from the same initial checkpoint (written by the JAX
    package) leaves every parameter exactly as it was (g / |g| * 0 = 0,
    and Adam's update of zero moments is zero)."""
    egs, text, _ = _e2e_corpus(str(tmp_path), n=4)
    _, _, params = _jax_asr(seed=4)
    src = str(tmp_path / "init")
    meta = dict(model_class="TransformerASR", **MODEL, feature_dim=D, mtlalpha=0.3,
                lsm_weight=0.1, encoder_type="transformer")
    from speech_recognition_tools_tpu_torch.io.text import build_char_vocab, save_vocab

    vocab = build_char_vocab(["abcdefghij"])  # the corpus's letters: 14 ids
    assert len(vocab) == MODEL["vocab_size"]
    jckpt.save_checkpoint(src, "final", params, meta)
    save_vocab(vocab, os.path.join(src, "vocab.json"))
    argv = ["--init_from", src, "--grad_clip", "0", "--epochs", "1", "--batch_size", "8",
            "--average_last", "1", "--warmup_steps", "3"]
    losses = tcli.main([egs, text, str(tmp_path / "port"), *argv, "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0]) and losses[0] > 0  # a step ran
    jcli.main([egs, text, str(tmp_path / "jax"), *argv])
    want = jax.tree.map(np.asarray, params)
    for name in ("port", "jax"):
        got, cfg = tckpt.load_checkpoint(str(tmp_path / name / "final_avg"))
        assert cfg["grad_clip"] == 0.0
        _tree_close(got["params"], want)
