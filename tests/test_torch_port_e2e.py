"""The port's e2e recognition slice held against the JAX package:
TransformerASR (conv2d subsampling, encoder, full-prefix decoder) with
weights carried over by io/jax_params.py, CTC prefix scoring, the RNNLM and
its carried-state fusion, the batched joint CTC/attention beam search, the
char vocabulary, and the whole chain wav -> FDLP -> CMVN -> encode -> beam
search -> text.

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise, so that no bias is zero and no LayerNorm is
the identity). The JAX side runs on the CPU with the conftest's x64 and
float32 inputs; the port runs on the CPU in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.decode import beam_jit as jbeam
from speech_recognition_tools_tpu.decode import ctc_prefix as jctc
from speech_recognition_tools_tpu.dsp import FdlpConfig as JaxFdlpConfig
from speech_recognition_tools_tpu.dsp import fdlp_spectrogram_batch as jax_fdlp
from speech_recognition_tools_tpu.io import text as jtext
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu.utils import cmvn as jcmvn
from speech_recognition_tools_tpu_torch.decode import beam_jit as tbeam
from speech_recognition_tools_tpu_torch.decode import ctc_prefix as tctc
from speech_recognition_tools_tpu_torch.dsp.fdlp import FdlpConfig
from speech_recognition_tools_tpu_torch.infer.recognize import recognize_batch
from speech_recognition_tools_tpu_torch.io import text as ttext
from speech_recognition_tools_tpu_torch.io.jax_params import (
    rnnlm_from_jax,
    transformer_asr_from_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
from speech_recognition_tools_tpu_torch.utils import cmvn as tcmvn

torch.set_num_threads(1)

MODEL = dict(vocab_size=14, adim=32, aheads=4, elayers=2, eunits=64, dlayers=2,
             dunits=64)
D = 8  # feature dims of the model tests; the slice test runs FDLP at 20
LM = dict(embed_dim=16, hidden=24)
EOS = MODEL["vocab_size"] - 1


def _perturbed(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _jax_asr(idim, seed=0, **cfg):
    model = jtasr.TransformerASR(jtasr.TransformerASRConfig(**MODEL, **cfg))
    params = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, 23, idim), jnp.float32),
                        jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    return model, _perturbed(params, seed + 100)


def _port_asr(params, idim, **cfg):
    m = ttasr.TransformerASR(ttasr.TransformerASRConfig(**MODEL, **cfg), idim, device="cpu")
    m.load_state_dict(transformer_asr_from_jax(params))
    return m.eval()


def _jax_lm(seed=3):
    lm = jrnnlm.RNNLM(vocab_size=MODEL["vocab_size"], **LM)
    params = lm.init({"params": jax.random.key(seed)}, jnp.zeros((1, 4), jnp.int32))
    return lm, _perturbed(params, seed + 100)


def _port_lm(params):
    lm = RNNLM(MODEL["vocab_size"], **LM, device="cpu")
    lm.load_state_dict(rnnlm_from_jax(params))
    return lm.eval()


@pytest.fixture(scope="module")
def asr():
    model, params = _jax_asr(D)
    return model, params, _port_asr(params, D)


@pytest.fixture(scope="module")
def lm():
    model, params = _jax_lm()
    return model, params, _port_lm(params)


def _feats(B=3, T=80, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(B, T, D).astype(np.float32), np.array([T, T - 10, T - 19], np.int32)[:B]


def _valid(arr, lengths):
    return np.concatenate([np.asarray(arr)[b, : int(lengths[b])] for b in range(len(lengths))])


# ------------------------------------------------------------------ weights


def test_converters_cover_every_leaf_and_parameter(asr, lm):
    _, params, port = asr
    sd = transformer_asr_from_jax(params)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].shape == v.shape, k
    assert set(transformer_asr_from_jax(params["params"])) == set(sd)
    _, lm_params, lm_port = lm
    lsd = rnnlm_from_jax(lm_params)
    assert set(lsd) == set(lm_port.state_dict())
    for k, v in lm_port.state_dict().items():
        assert lsd[k].shape == v.shape, k
    # a leaf the converter does not know is refused, not dropped
    extra = {"params": {**params["params"], "stray": {"kernel": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="stray"):
        transformer_asr_from_jax(extra)
    extra = {"params": {**lm_params["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        rnnlm_from_jax(extra)


# ------------------------------------------------------------------ model


def test_conv2d_subsampling_matches_jax(asr):
    """Outputs at atol 1e-5 and out_len exactly, on ragged lengths with one
    utterance below 7 frames (0 output frames)."""
    _, params, port = asr
    x = np.random.RandomState(1).randn(3, 23, D).astype(np.float32)
    lens = np.array([23, 6, 15], np.int32)
    jsub = jtasr.Conv2dSubsampling(MODEL["adim"])
    jh, jn = jsub.apply({"params": params["params"]["encoder"]["embed"]}, jnp.asarray(x),
                        jnp.asarray(lens))
    with torch.no_grad():
        th, tn = port.encoder.embed(torch.as_tensor(x), torch.as_tensor(lens))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.tolist() == [5, 0, 3]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    for shape in ((1, 6, D), (1, 23, 6)):
        with pytest.raises(ValueError, match="7"):
            jsub.apply({"params": params["params"]["encoder"]["embed"]},
                       jnp.zeros(shape, jnp.float32), jnp.asarray([shape[1]]))
        with pytest.raises(ValueError, match="7"):
            port.encoder.embed(torch.zeros(shape), torch.as_tensor([shape[1]]))


@pytest.mark.parametrize("chunk,left", [(0, -1), (3, -1), (2, 1)])
def test_encode_matches_jax(asr, chunk, left):
    """Memory and CTC logits on valid frames at atol 1e-5, full and chunked
    encoder self-attention."""
    _, params, _ = asr
    jmodel = jtasr.TransformerASR(jtasr.TransformerASRConfig(
        **MODEL, attn_chunk=chunk, attn_left_chunks=left))
    port = _port_asr(params, D, attn_chunk=chunk, attn_left_chunks=left)
    x, lens = _feats()
    jm, jl, jc = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lens),
                              method=jtasr.TransformerASR.encode)
    with torch.no_grad():
        tm, tl, tc = port.encode(torch.as_tensor(x), torch.as_tensor(lens))
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_allclose(_valid(tm, jl), _valid(jm, jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_valid(tc, jl), _valid(jc, jl), rtol=0, atol=1e-5)


def test_decoder_logits_match_jax(asr):
    """decode_step on -1-padded token rows of several lengths, every
    position, at atol 1e-5; also the training forward's logits."""
    jmodel, params, port = asr
    x, lens = _feats()
    rs = np.random.RandomState(2)
    toks = rs.randint(1, EOS, (3, 7)).astype(np.int32)
    toks[:, 0] = EOS
    toks[1, 4:] = -1
    toks[2, 2:] = -1
    jm, jl, _ = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lens),
                             method=jtasr.TransformerASR.encode)
    jd = jmodel.apply(params, jnp.asarray(toks), jm, jl, method=jtasr.TransformerASR.decode_step)
    with torch.no_grad():
        td = port.decode_step(torch.as_tensor(toks).long(), torch.as_tensor(np.array(jm)),
                              torch.as_tensor(np.array(jl)))
        tctc_l, tdec, tlen = port(torch.as_tensor(x), torch.as_tensor(lens),
                                  torch.as_tensor(toks).long())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    jctc_l, jdec, jlen = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(toks))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_greedy_ctc_matches_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 9, 5).astype(np.float32)
    logits[0, 2:5, 3] = 9.0  # a repeated token
    lens = np.array([9, 4, 0])
    assert ttasr.greedy_ctc(torch.as_tensor(logits), lens) == jtasr.greedy_ctc(
        jnp.asarray(logits), lens)


def test_posenc_tables_byte_identical():
    for length, dim in ((1, 32), (37, 32), (300, 256)):
        np.testing.assert_array_equal(ttasr.posenc_host(length, dim),
                                      jtasr.posenc_host(length, dim))
        np.testing.assert_array_equal(ttasr._posenc(length, dim, "cpu").numpy(),
                                      jtasr.posenc_host(length, dim))
    for T, chunk, left in ((9, 2, -1), (9, 4, 1), (5, 5, 0)):
        np.testing.assert_array_equal(ttasr.chunk_attention_mask(T, chunk, left).numpy(),
                                      np.asarray(jtasr.chunk_attention_mask(T, chunk, left)))


@pytest.mark.parametrize("cfg", [dict(compute_dtype="bfloat16"),
                                 dict(compute_dtype="bfloat16", encoder_type="conformer")])
def test_unported_options_raise(cfg):
    with pytest.raises(NotImplementedError):
        ttasr.TransformerASR(ttasr.TransformerASRConfig(**cfg), D, device="cpu")


# ------------------------------------------------------------------ CTC prefix


def _prefix_states(logp, enc_len, seqs):
    """JAX forward variables of each prefix in `seqs`, built by extending
    the empty prefix one token at a time through the JAX scorer."""
    K = len(seqs)
    r = np.asarray(jctc.init_prefix_state(jnp.asarray(logp), enc_len, K))
    states = []
    for k, seq in enumerate(seqs):
        rk, last = r[k:k + 1], -1
        for n, c in enumerate(seq):
            _, _, rn = jctc.ctc_prefix_scores(jnp.asarray(logp), enc_len, None,
                                              jnp.asarray([n]), jnp.asarray([last]),
                                              jnp.asarray(rk))
            rk, last = np.asarray(rn)[:, c], c
        states.append(rk[0])
    return np.stack(states)


def test_ctc_prefix_scores_match_jax():
    """Three utterances (enc_len 11, 7 and 4 of T = 11), K = 4 prefixes: empty,
    [3], [3, 3] (a repeated last token) and [5, 2]. psi, full and the
    extensions' forward variables at atol 1e-4 on entries above -1e29;
    the NEG_INF entries agree."""
    rs = np.random.RandomState(5)
    T, V = 11, 7
    seqs = [[], [3], [3, 3], [5, 2]]
    enc = [11, 7, 4]
    logp = np.stack([np.asarray(jax.nn.log_softmax(jnp.asarray(rs.randn(T, V) * 2), -1))
                     for _ in enc]).astype(np.float32)
    lens = np.array([[len(s) for s in seqs]] * len(enc))
    last = np.array([[s[-1] if s else -1 for s in seqs]] * len(enc))
    r_prev = np.stack([_prefix_states(logp[b], enc[b], seqs) for b in range(len(enc))])
    psi, full, r_new = tctc.ctc_prefix_scores(
        torch.as_tensor(logp), torch.as_tensor(enc), torch.as_tensor(lens),
        torch.as_tensor(last), torch.as_tensor(r_prev.astype(np.float32)))
    dead = 0
    for b in range(len(enc)):
        ref = jctc.ctc_prefix_scores(jnp.asarray(logp[b]), enc[b], None, jnp.asarray(lens[b]),
                                     jnp.asarray(last[b]), jnp.asarray(r_prev[b]))
        for got, want in zip((psi[b], full[b], r_new[b]), ref):
            got, want = got.numpy(), np.asarray(want)
            live = want > -1e29
            assert np.array_equal(got > -1e29, live) and live.any()
            np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got[~live], np.float32(-1e30))
            dead += int((~live).sum())
    assert dead > 0


def test_init_prefix_state_matches_jax():
    rs = np.random.RandomState(6)
    logp = np.log(rs.dirichlet(np.ones(5), size=(2, 9))).astype(np.float32)
    enc = np.array([9, 4])
    got = tctc.init_prefix_state(torch.as_tensor(logp), torch.as_tensor(enc), 3).numpy()
    for b in range(2):
        want = np.asarray(jctc.init_prefix_state(jnp.asarray(logp[b]), enc[b], 3))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)


def test_logaddexp_keeps_neg_inf():
    a = torch.tensor([tctc.NEG_INF, tctc.NEG_INF, -3.0, 2.0])
    b = torch.tensor([tctc.NEG_INF, -1.0, tctc.NEG_INF, 1.5])
    got = tctc._logaddexp(a, b).numpy()
    want = np.asarray(jctc._logaddexp(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0] == np.float32(tctc.NEG_INF)


# ------------------------------------------------------------------ RNNLM


def test_rnnlm_logits_and_carried_fusion_match_jax(lm):
    """Full-sequence logits at atol 1e-5; then the carried-state fusion
    scores of a beam that is reordered every step against the JAX jit
    fusion scorer on the same token buffer, at atol 1e-5."""
    jlm, params, port = lm
    rs = np.random.RandomState(7)
    toks = rs.randint(0, MODEL["vocab_size"], (3, 6)).astype(np.int32)
    lens = np.array([6, 4, 1], np.int32)
    want = np.asarray(jlm.apply(params, jnp.asarray(toks), jnp.asarray(lens)))
    with torch.no_grad():
        got = port(torch.as_tensor(toks).long(), torch.as_tensor(lens)).numpy()
    np.testing.assert_allclose(_valid(got, lens), _valid(want, lens), rtol=0, atol=1e-5)

    K, L = 4, 5
    scorer = jrnnlm.make_jit_fusion_scorer(jlm, params)
    buf = np.full((K, L + 1), -1, np.int32)
    buf[:, 0] = EOS
    state = port.init_state(K)
    for step in range(L):
        ref = np.asarray(scorer(jnp.asarray(buf), step))
        with torch.no_grad():
            logits, nxt = port.step(torch.as_tensor(buf[:, step]).long(), state)
        np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(), ref, rtol=0, atol=1e-5)
        order = rs.randint(0, K, K)  # parents of the next beams, repeats allowed
        buf = buf[order]
        buf[:, step + 1] = rs.randint(1, EOS + 1, K)
        state = nxt[:, torch.as_tensor(order)]


def test_gru_step_is_the_time_loop(lm):
    """MaskedGRULayer.forward and .step share one cell: stepping a sequence
    gives the loop's outputs bit for bit."""
    _, _, port = lm
    layer = port.rnn.layers[0]
    x = torch.as_tensor(np.random.RandomState(8).randn(2, 5, LM["embed_dim"]),
                        dtype=torch.float32)
    with torch.no_grad():
        seq = layer(x, torch.as_tensor([5, 5]))
        h = x.new_zeros((2, LM["hidden"]))
        for t in range(5):
            h = layer.step(x[:, t], h)
            assert torch.equal(h, seq[:, t])


# ------------------------------------------------------------------ beam search


def _jax_beam(jmodel, params, x, lens, lm_apply=None):
    toks, scores = jbeam.beam_search_jit_batched(
        jmodel, params, jnp.asarray(x), jnp.asarray(lens), beam_size=4, max_len=12,
        ctc_weight=0.3, lm_apply=lm_apply, lm_weight=1.0)
    return np.asarray(toks), np.asarray(scores)


@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_search_matches_jax_batched(asr, lm, with_lm):
    """B = 3 ragged utterances, beam 4, max_len 12, ctc_weight 0.3: best
    hypotheses token-identical to beam_search_jit_batched and all K scores
    at atol 1e-4 (float32 here, float64 there)."""
    jmodel, params, port = asr
    jlm, lm_params, lm_port = lm
    x, lens = _feats()
    jt, js = _jax_beam(jmodel, params, x, lens,
                       jrnnlm.make_jit_fusion_scorer(jlm, lm_params) if with_lm else None)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=12,
                                       ctc_weight=0.3, lm=lm_port if with_lm else None,
                                       lm_weight=1.0, device="cpu")
    assert tt.shape == (3, 4, 13) and ts.shape == (3, 4)
    for b in range(3):
        want = jbeam.tokens_to_list(jt[b], js[b], EOS)
        assert tbeam.tokens_to_list(tt[b], ts[b], EOS) == want
        assert len(want) > 0
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_search_matches_jax_host_loop(asr, lm, with_lm):
    """B = 1: token-identical to the host-loop beam_search."""
    jmodel, params, port = asr
    jlm, lm_params, lm_port = lm
    x, lens = _feats(B=1)
    want = jtasr.beam_search(
        jmodel, params, jnp.asarray(x), jnp.asarray(lens), jmodel.cfg, beam_size=4, max_len=12,
        ctc_weight=0.3, lm_weight=1.0,
        lm_apply=jrnnlm.make_fusion_scorer(jlm, lm_params) if with_lm else None)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=12,
                                       ctc_weight=0.3, lm=lm_port if with_lm else None,
                                       device="cpu")
    assert tbeam.tokens_to_list(tt[0], ts[0], EOS) == want


@pytest.mark.parametrize("with_lm,penalty", [(False, 0.0), (True, 0.5)])
def test_beam_search_ctc_weight_one_matches_both_jax_searches(asr, lm, with_lm, penalty):
    """ctc_weight 1.0: beams 2..K start at att_cum -inf, so their rows at
    step 0 are 0 * -inf = NaN. Ranked below every score, as lax.top_k ranks
    them, the search keeps finite CTC-prefix hypotheses: token-identical to
    beam_search_jit_batched (B = 3, scores at atol 1e-4) and to the
    host-loop beam_search (the first utterance)."""
    jmodel, params, port = asr
    jlm, lm_params, lm_port = lm
    x, lens = _feats()
    fused = lm_port if with_lm else None
    jt, js = jbeam.beam_search_jit_batched(
        jmodel, params, jnp.asarray(x), jnp.asarray(lens), beam_size=4, max_len=12,
        ctc_weight=1.0, penalty=penalty, lm_weight=1.0,
        lm_apply=jrnnlm.make_jit_fusion_scorer(jlm, lm_params) if with_lm else None)
    jt, js = np.asarray(jt), np.asarray(js)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=12, ctc_weight=1.0,
                                       penalty=penalty, lm=fused, lm_weight=1.0, device="cpu")
    assert torch.isfinite(ts).all() and np.isfinite(js).all()
    got = [tbeam.tokens_to_list(tt[b], ts[b], EOS) for b in range(3)]
    assert got == [jbeam.tokens_to_list(jt[b], js[b], EOS) for b in range(3)]
    assert all(g and any(t != 0 for t in g) for g in got)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)
    host = jtasr.beam_search(
        jmodel, params, jnp.asarray(x[:1]), jnp.asarray(lens[:1]), jmodel.cfg, beam_size=4,
        max_len=12, ctc_weight=1.0, penalty=penalty, lm_weight=1.0,
        lm_apply=jrnnlm.make_fusion_scorer(jlm, lm_params) if with_lm else None)
    assert got[0] == host


def test_top_k_ranks_nan_as_lax_top_k():
    """The NaN of 0 * -inf (sign bit set) below -inf, exact ties to the
    lower index, as jax.lax.top_k ranks them."""
    inf = np.float32(np.inf)
    with np.errstate(invalid="ignore"):
        nan = np.float32(0.0) * -inf
    assert np.isnan(nan) and np.signbit(nan)
    rows = np.array([[nan, 1.0, -inf, 1.0, nan, -2.0],
                     [nan, nan, -inf, nan, 0.5, -inf]], np.float32)
    vals, idx = tbeam._top_k(torch.as_tensor(rows), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(rows), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_recog_e2e_ctc_weight_one_matches_jax_cli(asr, lm, tmp_path):
    """recog_e2e --ctc_weight 1.0 --jit_decode (beam 3, max_len 6, the RNNLM
    fused) on a model and LM directory the JAX package wrote: out_text
    identical to the JAX CLI's (its batched search: one compile, where its
    host loop compiles every step), and no hypothesis empty."""
    from speech_recognition_tools_tpu.cli import recog_e2e as jrecog
    from speech_recognition_tools_tpu.io import egs as jegs
    from speech_recognition_tools_tpu.train import checkpoint as jckpt
    from speech_recognition_tools_tpu_torch.cli import recog_e2e as trecog

    _, params, _ = asr
    _, lm_params, _ = lm
    d, lm_dir = str(tmp_path / "am"), str(tmp_path / "lm")
    jckpt.save_checkpoint(d, "final_avg", params, dict(
        **MODEL, mtlalpha=0.3, lsm_weight=0.0, encoder_type="transformer", feature_dim=D))
    jtext.save_vocab(ttext.build_char_vocab(["abcdefghij"]), f"{d}/vocab.json")
    jckpt.save_checkpoint(lm_dir, "final", lm_params, dict(
        vocab_size=MODEL["vocab_size"], **LM, layers=1, cell="gru"))
    x, _ = _feats(B=2)  # one length, so one padded batch
    egs = str(tmp_path / "egs")
    jegs.build_egs(iter([(f"u{b}", x[b]) for b in range(2)]), egs)
    common = ["--beam_size", "3", "--max_len", "6", "--ctc_weight", "1.0", "--lm_dir", lm_dir,
              "--jit_decode", "--batch_size", "2"]
    tout, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    trecog.main([d, egs, tout, *common, "--device", "cpu"])
    jrecog.main([d, egs, jout, *common])
    with open(tout) as f, open(jout) as g:
        got, want = f.read(), g.read()
    assert got == want
    assert len(got.splitlines()) == 2
    assert all(len(ln.split(maxsplit=1)) == 2 for ln in got.splitlines())


def test_beam_search_stops_when_every_beam_has_finished(asr):
    """A decoder biased hard towards eos: every beam ends within a few
    steps, the loop stops there (the rest of the buffer stays -1) and the
    JAX search, which runs on appending eos, gives the same best lists and
    scores."""
    jmodel, params, _ = asr
    p = jax.tree.map(np.copy, params)
    out = p["params"]["decoder"]["output"]
    out["bias"][:] = -50.0
    out["bias"][EOS] = 50.0
    port = _port_asr(p, D)
    x, lens = _feats(B=2)
    jt, js = _jax_beam(jmodel, p, x, lens)
    tt, ts = tbeam.beam_search_batched(port, x, lens, beam_size=4, max_len=12, device="cpu")
    steps = int((tt[0, 0] >= 0).sum()) - 1
    assert 1 <= steps < 12 and (tt[:, :, steps + 1:] == -1).all()
    assert (tt[:, :, 1:steps + 1] >= 0).all()
    for b in range(2):
        assert tbeam.tokens_to_list(tt[b], ts[b], EOS) == jbeam.tokens_to_list(jt[b], js[b], EOS)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4)
    # the timed search returns the same and adds a time under each part
    timings = {}
    with torch.no_grad():
        mem, enc_len, ctc = port.encode(torch.as_tensor(x), torch.as_tensor(lens).long())
    t2, s2 = tbeam.beam_search_encoded(port, mem, enc_len, ctc, beam_size=4, max_len=12,
                                       timings=timings)
    assert torch.equal(t2, tt) and torch.equal(s2, ts)
    assert set(timings) == {"decoder", "ctc", "topk", "update"}


# ------------------------------------------------------------------ text


def test_text_helpers_match_jax(tmp_path):
    texts = ["hello world", "a b  c", "zebra"]
    vocab = ttext.build_char_vocab(texts)
    assert vocab == jtext.build_char_vocab(texts)
    toks = [0, 1, 2, 5, vocab["<sos/eos>"], 3, 99, 2]
    assert ttext.decode_tokens(toks, vocab) == jtext.decode_tokens(toks, vocab)
    jtext.save_vocab(vocab, tmp_path / "vocab.json")
    assert ttext.load_vocab(tmp_path / "vocab.json") == jtext.load_vocab(tmp_path / "vocab.json")
    (tmp_path / "text").write_text("u1 hello world\nu2\nu3 a b\n")
    assert ttext.read_text_file(tmp_path / "text") == jtext.read_text_file(tmp_path / "text")


# ------------------------------------------------------------------ the slice


def test_e2e_slice_matches_jax():
    """wav -> FDLP (20 bands, order 50) -> global CMVN -> encode -> beam
    search, 3 utterances of 1-2 s, the same waveforms and weights on both
    sides. CTC log-probs on valid frames at atol 1e-2 (float32 FDLP noise,
    as the hybrid slice test allows); decoding the JAX features gives
    token-identical hypotheses; recognize_batch returns the texts of the
    port's own chain."""
    rng = np.random.RandomState(9)
    lens = np.array([32000, 24000, 16000], np.int32)
    x = (rng.randn(3, 32000) * 1000).astype(np.float32)
    for b, n in enumerate(lens):
        x[b, n:] = 0
    nf = 20
    jmodel, params = _jax_asr(nf, seed=1)
    port = _port_asr(params, nf)
    jfeats, jn = jax_fdlp(x, lens, JaxFdlpConfig(nfilters=nf, lpc_backend="scan"))
    jmean, jstd = jcmvn.cmvn_stats_masked(jfeats, jn)
    jfeats = jcmvn.apply_cmvn(jfeats, jmean, jstd)
    jm, jl, jc = jmodel.apply(params, jfeats, jn, method=jtasr.TransformerASR.encode)
    jlogp = np.asarray(jax.nn.log_softmax(jc, -1))

    cfg = FdlpConfig(nfilters=nf)
    from speech_recognition_tools_tpu_torch.dsp.fdlp import fdlp_spectrogram_batch

    tfeats, tn = fdlp_spectrogram_batch(x, lens, cfg, device="cpu")
    tmean, tstd = tcmvn.cmvn_stats_masked(tfeats, tn)
    tfeats = tcmvn.apply_cmvn(tfeats, tmean, tstd)
    with torch.no_grad():
        _, tl, tc = port.encode(tfeats, tn)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    err = np.max(np.abs(_valid(torch.log_softmax(tc, -1), jl) - _valid(jlogp, jl)))
    assert np.isfinite(err) and err < 1e-2, err

    jt, js = _jax_beam(jmodel, params, np.asarray(jfeats), np.asarray(jn))
    tt, ts = tbeam.beam_search_batched(port, np.array(jfeats), np.array(jn), beam_size=4,
                                       max_len=12, device="cpu")
    want = [jbeam.tokens_to_list(jt[b], js[b], EOS) for b in range(3)]
    assert [tbeam.tokens_to_list(tt[b], ts[b], EOS) for b in range(3)] == want

    vocab = ttext.build_char_vocab(["abcdefghij"])  # 14 ids, as the model's vocab
    assert len(vocab) == MODEL["vocab_size"]
    texts = recognize_batch(x, lens, cfg, tmean, tstd, port, vocab, beam_size=4, max_len=12,
                            device="cpu")
    tt, ts = tbeam.beam_search_batched(port, tfeats, tn, beam_size=4, max_len=12, device="cpu")
    assert texts == [ttext.decode_tokens(tbeam.tokens_to_list(tt[b], ts[b], EOS), vocab)
                     for b in range(3)]
    assert all(isinstance(t, str) and t for t in texts)


# ------------------------------------------------------------------ devices


def test_default_device_raises_without_a_card(asr):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, port = asr
    x, lens = _feats(B=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ttasr.TransformerASR(ttasr.TransformerASRConfig(**MODEL), D)
    with pytest.raises(RuntimeError, match="cuda"):
        RNNLM(MODEL["vocab_size"], **LM)
    with pytest.raises(RuntimeError, match="cuda"):
        tbeam.beam_search_batched(port, x, lens, beam_size=2, max_len=2)
    with pytest.raises(RuntimeError, match="cuda"):
        recognize_batch(np.zeros((1, 16000), np.float32), [16000], FdlpConfig(), np.zeros(20),
                        np.ones(20), port, {})
