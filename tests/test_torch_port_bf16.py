"""The port's bf16 mixed precision (compute_dtype "bfloat16") held against
the JAX package's, for the transformer and the conformer encoder: the
encoder output, the CTC and decoder logits (float32 heads), `asr_loss`,
its float32 gradients and one clipped-Adam step; the joint beam search with
the full-prefix and the KV-cached decoder; the streaming step against the
offline chunked encode; `train_e2e --compute_dtype bfloat16` writing
float32 checkpoints that the JAX package reads; and `recog_e2e
--compute_dtype bfloat16` (offline and `--streaming`) against the JAX
CLI's output text.

Both sides get the same numpy inputs and the same float32 weights (a flax
init perturbed with seeded noise, carried over by io/jax_params.py). JAX
runs its bf16 model jitted on the CPU; the port runs on the CPU. Each side
rounds to bf16 after its own operations (XLA may keep a fused chain in
float32 where torch rounds each op), so the two agree to bf16 rounding,
not bit for bit. Each tolerance is stated relative to the reference
tensor's scale (its largest magnitude) and was set at about twice the
first reading, within 5e-2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
from speech_recognition_tools_tpu.decode import beam_jit as jbeam
from speech_recognition_tools_tpu.io import egs as jegs
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.train import checkpoint as jckpt
from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog
from speech_recognition_tools_tpu_torch.cli import train_e2e as ttrain
from speech_recognition_tools_tpu_torch.decode import beam_jit as tbeam
from speech_recognition_tools_tpu_torch.infer import streaming_asr as tsa
from speech_recognition_tools_tpu_torch.io.jax_params import (
    transformer_asr_from_jax,
    transformer_asr_to_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.train.optim import ClipAdam

torch.set_num_threads(1)

MODEL = dict(vocab_size=12, adim=16, aheads=2, elayers=2, eunits=32, dlayers=2, dunits=32,
             dropout=0.0, conv_kernel=5, compute_dtype="bfloat16")
D = 12
EOS = MODEL["vocab_size"] - 1
ENCODERS = ["transformer", "conformer"]

# limits relative to the reference tensor's largest magnitude (first
# readings in the comments)
MEM_REL = 2e-2  # encoder output (bf16): 6e-3 / 9e-3
LOGIT_REL = 2.5e-2  # CTC and decoder logits: 6e-3 / 1.2e-2
LOSS_REL = 1e-2  # asr_loss: 1e-3
# the whole gradient tree: the norm of the difference over the norm, and
# the largest entry of the difference over the largest gradient entry
# (3.7e-2 / 1.3e-2 and 2.6e-2 / 2.3e-2). A single leaf can differ more: a
# ReLU unit whose input rounds to either side of zero in bf16 moves its
# whole row, and JAX's own bf16 and float32 gradients differ by as much
# (3.8e-2 / 2.0e-2 in norm).
GRAD_REL = 5e-2
STREAM_REL = 1e-2  # streamed against offline bf16 memory, one implementation


def _perturb(params, seed, scale=0.2):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rs.randn(*a.shape)).astype(np.float32), params)


def _models(encoder_type, seed=0, head_scale=1.0, **extra):
    """(jax bf16 model, perturbed float32 params, port bf16 model in eval
    mode) on the same weights; `head_scale` multiplies both logit heads'
    kernels."""
    cfg = dict(MODEL, encoder_type=encoder_type, **extra)
    jm = jtasr.TransformerASR(jtasr.TransformerASRConfig(**cfg))
    params = jax.jit(jm.init)({"params": jax.random.key(seed)}, jnp.zeros((1, 23, D)),
                              jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    params = _perturb(params, seed + 100)
    params["params"]["ctc_head"]["kernel"] *= head_scale
    params["params"]["decoder"]["output"]["kernel"] *= head_scale
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**cfg), D, device="cpu")
    port.load_state_dict(transformer_asr_from_jax(params))
    return jm, params, port.eval()


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(1, EOS, size=(3, 5)).astype(np.int32)
    tokens[1, 4:] = -1
    tokens[2, 2:] = -1
    return dict(feats=rs.randn(3, 48, D).astype(np.float32),
                lengths=np.array([48, 41, 30], np.int32), tokens=tokens,
                token_lengths=np.array([5, 4, 2], np.int32))


def _torch_batch(b):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
            for k, v in b.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _valid(a, n):
    return np.concatenate([np.asarray(a, np.float32)[b, : int(n[b])] for b in range(len(n))])


def _tree_rel(got, want):
    """The largest entry of got - want over the largest entry of want, over
    every leaf of two flat trees."""
    return float(max(np.abs(got[k] - want[k]).max() for k in want)
                 / max(np.abs(w).max() for w in want.values()))


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("encoder_type", ENCODERS)
def test_bf16_forward_matches_jax(encoder_type):
    """encode: bf16 memory within MEM_REL, float32 CTC logits within
    LOGIT_REL on valid frames; forward: float32 decoder logits within
    LOGIT_REL; the parameters stay float32."""
    jm, params, port = _models(encoder_type)
    b = _batch()
    jmem, jlen, jctc = jax.jit(lambda p, f, n: jm.apply(p, f, n, method=jm.encode))(
        params, b["feats"], b["lengths"])
    with torch.no_grad():
        tmem, tlen, tctc = port.encode(torch.as_tensor(b["feats"]),
                                       torch.as_tensor(b["lengths"]).long())
    assert jmem.dtype == jnp.bfloat16 and tmem.dtype == torch.bfloat16
    assert jctc.dtype == jnp.float32 and tctc.dtype == torch.float32
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert _rel(_valid(tmem.float(), tlen), _valid(jmem, jlen)) <= MEM_REL
    assert _rel(_valid(tctc, tlen), _valid(jctc, jlen)) <= LOGIT_REL

    tin = ttasr.decoder_inputs(torch.as_tensor(b["tokens"]).long(),
                               torch.as_tensor(b["token_lengths"]).long(), EOS)
    _, jdec, _ = jax.jit(lambda p, f, n, t: jm.apply(p, f, n, t))(
        params, b["feats"], b["lengths"], tin.numpy().astype(np.int32))
    with torch.no_grad():
        _, tdec, _ = port(torch.as_tensor(b["feats"]), torch.as_tensor(b["lengths"]).long(),
                          tin)
    assert jdec.dtype == jnp.float32 and tdec.dtype == torch.float32
    valid = (tin >= 0).numpy()
    assert _rel(tdec.numpy()[valid], np.asarray(jdec)[valid]) <= LOGIT_REL
    assert {p.dtype for p in port.parameters()} == {torch.float32}


@pytest.mark.parametrize("encoder_type", ENCODERS)
def test_bf16_loss_gradients_and_adam_step_match_jax(encoder_type):
    """asr_loss (dropout off) within LOSS_REL; every gradient float32, the
    gradient tree within GRAD_REL (in norm and in its largest entry); one
    step of clip-by-global-norm 5 + Adam (b2 0.98, lr 1e-3) leaves float32
    parameters and moments, the parameters within 2.5 x lr of optax's
    (Adam's first step moves each entry by about lr * sign(g), so an entry
    whose gradient is near zero may move either way) and the first moment
    within GRAD_REL of its largest entry."""
    jm, params, port = _models(encoder_type)
    b = _batch()
    jcfg = jm.cfg

    def jloss(p):
        return jtasr.asr_loss(jm, p, {k: jnp.asarray(v) for k, v in b.items()}, None, jcfg,
                              train=False)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tl, _ = ttasr.asr_loss(port, _torch_batch(b), port.cfg, train=False)
    assert tl.dtype == torch.float32
    assert abs(tl.item() - float(jl)) <= LOSS_REL * abs(float(jl))
    tl.backward()
    named = dict(port.named_parameters())
    assert {p.grad.dtype for p in named.values()} == {torch.float32}
    tg = _flat(transformer_asr_to_jax({k: p.grad for k, p in named.items()}, jcfg.aheads))
    jgf = _flat(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(jgf)
    norm = np.sqrt(sum(((tg[k] - jgf[k]) ** 2).sum() for k in jgf)
                   / sum((g ** 2).sum() for g in jgf.values()))
    assert norm <= GRAD_REL, norm
    assert _tree_rel(tg, jgf) <= GRAD_REL

    lr = 1e-3
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr, b2=0.98))
    st = tx.init(params)
    upd, st = tx.update(jg, st, params)
    jp = _flat(jax.tree.map(np.asarray, optax.apply_updates(params, upd)))
    opt = ClipAdam(lr, 5.0, b2=0.98)
    ost = opt.init(named)
    ost, _ = opt.apply(named, {k: p.grad for k, p in named.items()}, ost)
    tp = _flat(transformer_asr_to_jax({k: p.detach() for k, p in named.items()}, jcfg.aheads))
    assert {v.dtype for v in ost["mu"].values()} == {torch.float32}
    assert {p.dtype for p in named.values()} == {torch.float32}
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 2.5 * lr, k
    jmu = _flat(jax.tree.map(np.asarray, st[1][0].mu))
    assert _tree_rel(_flat(transformer_asr_to_jax(ost["mu"], jcfg.aheads)), jmu) <= GRAD_REL


@pytest.mark.parametrize("encoder_type", ENCODERS)
@pytest.mark.parametrize("incremental", [False, True])
def test_bf16_beam_search_matches_jax(encoder_type, incremental):
    """B = 3 ragged utterances, beam 4, max_len 10, ctc_weight 0.3: the port's
    bf16 search (full-prefix or KV-cached decoder, its cache in bf16) gives
    JAX's bf16 beam_search_jit_batched hypotheses token for token, with
    float32 scores within 2.5e-2 of JAX's, relative (readings 1.3e-2). The logit heads are scaled by 4:
    on the unscaled random model the search's choices are near ties that
    bf16 rounding alone decides (JAX's own bf16 and float32 searches then
    disagree)."""
    jm, params, port = _models(encoder_type, head_scale=4.0)
    b = _batch(2)
    jt, js = jbeam.beam_search_jit_batched(
        jm, params, jnp.asarray(b["feats"]), jnp.asarray(b["lengths"]), beam_size=4,
        max_len=10, ctc_weight=0.3, incremental=incremental)
    jt, js = np.asarray(jt), np.asarray(js)
    tt, ts = tbeam.beam_search_batched(port, b["feats"], b["lengths"], beam_size=4,
                                       max_len=10, ctc_weight=0.3, device="cpu",
                                       incremental=incremental)
    assert ts.dtype == torch.float32
    for i in range(3):
        want = jbeam.tokens_to_list(jt[i], js[i], EOS)
        assert tbeam.tokens_to_list(tt[i], ts[i], EOS) == want
        assert len(want) > 0
    best_t, best_j = ts.max(1).values.numpy(), js.max(1)
    np.testing.assert_allclose(best_t, best_j, rtol=2.5e-2)
    if incremental:
        cache = port.decode_init_cache(torch.zeros((2, 5), dtype=torch.long),
                                       torch.zeros((2, 3, MODEL["adim"])), None)
        assert cache["layers"][0]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("encoder_type", ENCODERS)
def test_bf16_streaming_matches_offline(encoder_type):
    """A chunked model (attn_chunk 3, left 2) in bf16: 3 streams of different
    lengths through one StreamBatcher give the offline bf16 chunked encode
    (STREAM_REL of its scale on every frame), greedy hypotheses equal to
    the offline CTC argmax collapse, and bf16 caches."""
    _, _, port = _models(encoder_type, attn_chunk=3, attn_left_chunks=2)
    rs = np.random.RandomState(5)
    lens = [71, 52, 39]
    xs = [rs.randn(n, D).astype(np.float32) for n in lens]
    sb = tsa.StreamBatcher(port, max_streams=3, store_memory=True)
    assert {c["kv"].dtype for c in sb.caches.values()} == {torch.bfloat16}
    sids = [sb.open() for _ in xs]
    for s in range(0, max(lens), 10):
        for sid, x in zip(sids, xs):
            if s < len(x):
                sb.push(sid, x[s : s + 10])
    hyps = [sb.finish(sid) for sid in sids]
    for sid, x, hyp in zip(sids, xs, hyps):
        st = sb._finished[sid]
        with torch.no_grad():
            mem, n, ctc = port.encode(torch.as_tensor(x[None]), torch.tensor([len(x)]))
        want = mem[0, : int(n[0])].float().numpy()
        assert st.memory.shape == want.shape
        assert _rel(st.memory, want) <= STREAM_REL
        assert hyp == ttasr.greedy_ctc(ctc, n)[0]


def _corpus(root, n=8, n_decode=3, seed=9):
    """A training egs directory of n utterances with texts, and a decode egs
    directory of n_decode more."""
    rs = np.random.RandomState(seed)
    letters = "abcdefghij"
    feats, texts = [], {}
    for i in range(n + n_decode):
        feats.append((f"u{i}", rs.randn(int(rs.randint(48, 90)), D).astype(np.float32)))
        texts[f"u{i}"] = " ".join("".join(rs.choice(list(letters), rs.randint(1, 4)))
                                  for _ in range(2))
    egs, dec = os.path.join(root, "egs"), os.path.join(root, "dec_egs")
    jegs.build_egs(iter(feats[:n]), egs)
    jegs.build_egs(iter(feats[n:]), dec)
    text = os.path.join(root, "text")
    with open(text, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return egs, text, dec


GEO = ["--adim", "16", "--aheads", "2", "--elayers", "2", "--eunits", "32", "--dlayers", "1",
       "--dunits", "32", "--batch_size", "4", "--attn_chunk", "3", "--attn_left_chunks", "2"]


@pytest.fixture(scope="module")
def bf16_model_dir(tmp_path_factory):
    """train_e2e.main --compute_dtype bfloat16 on the CPU: 2 epochs, a chunked
    model so that it also streams."""
    root = str(tmp_path_factory.mktemp("bf16"))
    egs, text, dec = _corpus(root)
    store = os.path.join(root, "am")
    losses = ttrain.main([egs, text, store, *GEO, "--epochs", "2", "--compute_dtype",
                          "bfloat16", "--device", "cpu"])
    return store, dec, losses


def test_train_e2e_bf16_checkpoints_are_float32_and_load_in_jax(bf16_model_dir):
    """Finite losses; config.json records compute_dtype; the JAX package's
    load_checkpoint restores epoch_2's float32 params and Adam state into
    its bf16 model's templates, and the JAX bf16 model on those params
    gives the port's bf16 CTC logits within LOGIT_REL."""
    store, egs, losses = bf16_model_dir
    assert len(losses) == 2 and all(np.isfinite(losses))
    jm, jparams, cfg, _ = jrecog._load(store, "final_avg", compute_dtype="bfloat16")
    assert cfg.compute_dtype == "bfloat16"
    assert {str(a.dtype) for a in jax.tree.leaves(jparams)} == {"float32"}
    payload, meta = jckpt.load_checkpoint(os.path.join(store, "epoch_2"))
    assert meta["compute_dtype"] == "bfloat16" and meta["extra"] == {"epoch": 2}
    assert {str(np.asarray(a).dtype) for a in jax.tree.leaves(payload)
            if np.asarray(a).dtype.kind == "f"} == {"float32"}
    port, _, _ = trecog._load(store, "final_avg", compute_dtype="bfloat16", device="cpu")
    rs = np.random.RandomState(3)
    x, n = rs.randn(2, 60, D).astype(np.float32), np.array([60, 47], np.int32)
    _, jlen, jctc = jax.jit(lambda p, f, ln: jm.apply(p, f, ln, method=jm.encode))(
        jparams, x, n)
    with torch.no_grad():
        _, tlen, tctc = port.encode(torch.as_tensor(x), torch.as_tensor(n).long())
    assert _rel(_valid(tctc, tlen), _valid(jctc, jlen)) <= LOGIT_REL


@pytest.mark.parametrize("mode", [[], ["--streaming", "--streaming_feed", "13"]],
                         ids=["offline", "streaming"])
def test_recog_e2e_bf16_matches_jax_cli(bf16_model_dir, tmp_path, mode):
    """recog_e2e --compute_dtype bfloat16 (beam 3, max_len 6) on the
    bf16-trained model writes the JAX CLI's output text for 3 utterances,
    offline and --streaming."""
    store, egs, _ = bf16_model_dir
    outs = []
    for who, main in (("jax", jrecog.main), ("port", trecog.main)):
        out = str(tmp_path / f"{who}.txt")
        extra = ["--device", "cpu"] if who == "port" else []
        main([store, egs, out, "--beam_size", "3", "--max_len", "6", "--compute_dtype",
              "bfloat16", *mode, *extra])
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) == 3
