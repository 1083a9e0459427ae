"""The port's KV-cached incremental decoder held against the JAX package:
TransformerASR.decode_init_cache / decode_incremental and the beam search's
incremental=True (decode/beam_jit.py).

Both sides get the same numpy inputs and the same weights (a flax init
perturbed with seeded noise, so that no bias is zero and no LayerNorm is
the identity). The JAX side runs on the CPU with the conftest's x64 and
float32 inputs; the port runs on the CPU in float32. Logits are compared
at atol 1e-5, beam scores at atol 1e-4; hypotheses must be
token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tools_tpu.decode import beam_jit as jbeam
from speech_recognition_tools_tpu.models import rnnlm as jrnnlm
from speech_recognition_tools_tpu.models import transformer_asr as jtasr
from speech_recognition_tools_tpu_torch.decode import beam_jit as tbeam
from speech_recognition_tools_tpu_torch.io.jax_params import (
    rnnlm_from_jax,
    transformer_asr_from_jax,
)
from speech_recognition_tools_tpu_torch.models import transformer_asr as ttasr
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM

torch.set_num_threads(1)

MODEL = dict(vocab_size=14, adim=32, aheads=4, elayers=2, eunits=64, dlayers=2,
             dunits=64)
D = 8
LM = dict(embed_dim=16, hidden=24)
EOS = MODEL["vocab_size"] - 1
BEAM = dict(beam_size=4, max_len=12)


def _perturbed(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def asr():
    model = jtasr.TransformerASR(jtasr.TransformerASRConfig(**MODEL))
    params = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 23, D), jnp.float32),
                        jnp.asarray([23]), jnp.zeros((1, 3), jnp.int32))
    params = _perturbed(params, 100)
    port = ttasr.TransformerASR(ttasr.TransformerASRConfig(**MODEL), D, device="cpu")
    port.load_state_dict(transformer_asr_from_jax(params))
    return model, params, port.eval()


@pytest.fixture(scope="module")
def lm():
    model = jrnnlm.RNNLM(vocab_size=MODEL["vocab_size"], **LM)
    params = model.init({"params": jax.random.key(3)}, jnp.zeros((1, 4), jnp.int32))
    params = _perturbed(params, 103)
    port = RNNLM(MODEL["vocab_size"], **LM, device="cpu")
    port.load_state_dict(rnnlm_from_jax(params))
    return model, params, port.eval()


def _feats(B=3, T=80, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(B, T, D).astype(np.float32), np.array([T, T - 10, T - 19], np.int32)[:B]


def test_decode_incremental_logits_match_jax_step_by_step(asr):
    """Six steps of a (3, 1) token column on ragged memory: each step's
    logits equal the JAX decode_incremental's (atol 1e-5) and the port's
    own full-prefix decode_step at that position (atol 1e-5)."""
    jmodel, params, port = asr
    rs = np.random.RandomState(5)
    N, L, steps = 3, 9, 6
    mem = rs.randn(N, 17, MODEL["adim"]).astype(np.float32)
    mem_len = np.array([17, 11, 4], np.int32)
    toks = rs.randint(0, MODEL["vocab_size"], (N, L)).astype(np.int32)
    toks[:, 0] = EOS  # sos
    dummy = np.full((N, L), -1, np.int32)
    _, mut = jmodel.apply(params, jnp.asarray(dummy), jnp.asarray(mem), jnp.asarray(mem_len),
                          method=jtasr.TransformerASR.decode_init_cache, mutable=["cache"])
    jcache = mut["cache"]
    step_fn = jax.jit(lambda c, t, p: jmodel.apply(
        {**params, "cache": c}, t, p, jnp.asarray(mem), jnp.asarray(mem_len),
        method=jtasr.TransformerASR.decode_incremental, pe_len=16, mutable=["cache"]))
    tmem, tlen = torch.as_tensor(mem), torch.as_tensor(mem_len)
    cache = port.decode_init_cache(torch.as_tensor(dummy), tmem, tlen)
    assert cache["index"] == 0 and len(cache["layers"]) == MODEL["dlayers"]
    assert cache["layers"][0]["k"].shape == (N, MODEL["aheads"], L,
                                             MODEL["adim"] // MODEL["aheads"])
    for pos in range(steps):
        jl, mut = step_fn(jcache, jnp.asarray(toks[:, pos : pos + 1]), pos)
        jcache = mut["cache"]
        with torch.no_grad():
            tl = port.decode_incremental(torch.as_tensor(toks[:, pos : pos + 1]).long(), pos,
                                         tmem, tlen, cache, pe_len=16)
            full = port.decode_step(torch.as_tensor(toks[:, : pos + 1]).long(), tmem, tlen)
        assert tl.shape == (N, 1, MODEL["vocab_size"]) and cache["index"] == pos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, pos].numpy(), rtol=0, atol=1e-5)


def test_decode_incremental_refuses_positions_past_its_tables(asr):
    _, _, port = asr
    mem, mem_len = torch.zeros(2, 5, MODEL["adim"]), torch.tensor([5, 3])
    cache = port.decode_init_cache(torch.full((2, 3), -1), mem, mem_len)
    tok = torch.zeros(2, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="positional table"):
        port.decode_incremental(tok, 16, mem, mem_len, cache, pe_len=16)
    for pos in range(3):
        port.decode_incremental(tok, pos, mem, mem_len, cache, pe_len=16)
    with pytest.raises(ValueError, match="past its end"):
        port.decode_incremental(tok, 3, mem, mem_len, cache, pe_len=16)


def test_reorder_cache_takes_the_parents_rows(asr):
    _, _, port = asr
    mem, mem_len = torch.zeros(3, 5, MODEL["adim"]), torch.tensor([5, 3, 2])
    cache = port.decode_init_cache(torch.full((3, 4), -1), mem, mem_len)
    for kv in cache["layers"]:
        for t in kv.values():
            t.copy_(torch.arange(3.0)[:, None, None, None].expand_as(t))
    cache["index"] = 2
    got = port.reorder_cache(cache, torch.tensor([2, 2, 0]))
    assert got["index"] == 2
    for kv in got["layers"]:
        for t in kv.values():
            assert t[:, 0, 0, 0].tolist() == [2.0, 2.0, 0.0]


@pytest.mark.parametrize("ctc_weight", [0.3, 1.0])
@pytest.mark.parametrize("with_lm", [False, True])
def test_incremental_search_matches_full_prefix_and_jax(asr, lm, with_lm, ctc_weight):
    """B = 3 ragged utterances, beam 4, max_len 12: the eager loop's
    incremental search is token-identical to its full-prefix search (scores
    at atol 1e-4), to the search over the fixed-buffer step that
    beam_search_batched runs (the same) and to
    beam_search_jit_batched(incremental=True) (all K scores at atol 1e-4;
    float32 here, float64 there)."""
    jmodel, params, port = asr
    jlm, lm_params, lm_port = lm
    x, lens = _feats()
    fused = lm_port if with_lm else None
    kw = dict(BEAM, ctc_weight=ctc_weight, lm=fused, lm_weight=1.0)
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(x), torch.as_tensor(lens).long())
    it, isc = tbeam.beam_search_eager(port, *enc, incremental=True, **kw)
    ft, fsc = tbeam.beam_search_eager(port, *enc, **kw)
    xt, xsc = tbeam.beam_search_batched(port, x, lens, incremental=True, device="cpu", **kw)
    assert torch.equal(xt, it)
    np.testing.assert_allclose(xsc.numpy(), isc.numpy(), rtol=0, atol=1e-4)
    jt, js = jbeam.beam_search_jit_batched(
        jmodel, params, jnp.asarray(x), jnp.asarray(lens), ctc_weight=ctc_weight,
        lm_weight=1.0, incremental=True, **BEAM,
        lm_apply=jrnnlm.make_jit_fusion_scorer(jlm, lm_params) if with_lm else None)
    jt, js = np.asarray(jt), np.asarray(js)
    got = [tbeam.tokens_to_list(it[b], isc[b], EOS) for b in range(3)]
    assert got == [tbeam.tokens_to_list(ft[b], fsc[b], EOS) for b in range(3)]
    assert got == [jbeam.tokens_to_list(jt[b], js[b], EOS) for b in range(3)]
    assert all(g for g in got)
    assert torch.isfinite(isc).all()
    np.testing.assert_allclose(isc.numpy(), fsc.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(isc.numpy(), js, rtol=0, atol=1e-4)


def test_incremental_search_serves_the_conformer_encoder():
    """The decoder's cache does not depend on the encoder: on a conformer
    model (random weights, port only) the incremental search (the eager
    loop's, and the fixed-buffer step's that beam_search_batched runs)
    equals the full-prefix search token for token (scores at atol 1e-4)."""
    cfg = ttasr.TransformerASRConfig(**MODEL, encoder_type="conformer", conv_kernel=5)
    port = ttasr.TransformerASR(cfg, D, device="cpu").eval()
    port.reset_parameters(torch.Generator().manual_seed(4))
    x, lens = _feats(seed=2)
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(x), torch.as_tensor(lens).long())
    it, isc = tbeam.beam_search_eager(port, *enc, incremental=True, **BEAM)
    xt, xsc = tbeam.beam_search_batched(port, x, lens, incremental=True, device="cpu", **BEAM)
    ft, fsc = tbeam.beam_search_eager(port, *enc, **BEAM)
    assert torch.equal(xt, it)
    np.testing.assert_allclose(xsc.numpy(), isc.numpy(), rtol=0, atol=1e-4)
    for b in range(3):
        assert tbeam.tokens_to_list(it[b], isc[b], EOS) == tbeam.tokens_to_list(
            ft[b], fsc[b], EOS)
    np.testing.assert_allclose(isc.numpy(), fsc.numpy(), rtol=0, atol=1e-4)
