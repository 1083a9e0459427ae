"""The beam search over fixed buffers (decode/beam_jit.py::beam_search_fixed)
and TransformerASR's fixed-buffer decoder step behind it.

On the CPU the fixed step runs eagerly: its search is held to the eager
loop's full-prefix search (beam_search_eager) token for token, scores
within 1e-5 relative, over beam 4 and 10, ctc_weight 0.3 and 1.0 (where
0 * -inf gives the NaNs that _top_k ranks last), with and without the
RNNLM, one utterance and three of unequal lengths, float32 and bfloat16;
the cross-attention of the K beams as query positions against the B
utterances' keys and values equals that over the memory repeated K times;
max_len 2 and 100 meet one graph; the speech LLM and a prefix_scorer
search take the eager loop.

On the card (skipped without one): at the decode cell's longest batch
(B 8, K 10, V 52, T2 303, the wsj_fdlp_e2e decoder and its 1 x 1000 GRU
RNNLM) and at B 1, the graphed search against the fixed step run eagerly
on the card and against the full-prefix search; a search that stops early;
two shapes interleaved; the counters and K2's launches; no host sync
before the step's wait; and the speech LLM capturing nothing. Run there
with `python -m pytest --noconftest tests/test_torch_search_graph.py`
(tests/conftest.py imports JAX; these tests need torch alone).
"""

import pytest
import torch
from torch_card import card  # noqa: F401  (the fixture)

from speech_recognition_tools_tpu_torch.decode import beam_jit
from speech_recognition_tools_tpu_torch.decode import ctc_prefix as ctc
from speech_recognition_tools_tpu_torch.models.rnnlm import RNNLM
from speech_recognition_tools_tpu_torch.models.transformer_asr import (
    MultiHeadAttention,
    TransformerASR,
    TransformerASRConfig,
)

V = 14
SMALL = dict(vocab_size=V, adim=32, aheads=4, elayers=1, eunits=32, dlayers=2, dunits=64,
             dropout=0.0)
# the decode cell's decoder and RNNLM (benchmark/configs/wsj_fdlp_e2e.json)
CELL = dict(vocab_size=52, adim=256, aheads=4, elayers=1, eunits=64, dlayers=6, dunits=2048,
            dropout=0.0)
CELL_LM = dict(embed_dim=256, hidden=1000)
COUNTERS = ("steps", "graph_steps", "graph_captures")


def _asr(spec, device, seed=0, compute_dtype="float32", eos_bias=0.0):
    """A model with seeded weights and its decoder's head scaled by 4 (on
    random weights the search's choices are otherwise near ties);
    `eos_bias` on eos's logit makes searches finish early."""
    cfg = TransformerASRConfig(**spec, compute_dtype=compute_dtype)
    model = TransformerASR(cfg, 8, device="cpu").eval()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.decoder.output.weight.mul_(4.0)
        model.decoder.output.bias[cfg.eos_id] += eos_bias
    if torch.device(device).type == "cpu":
        return model
    # built on the card, which switches TF32 off, then given the weights
    on_card = TransformerASR(cfg, 8, device=device).eval()
    on_card.load_state_dict(model.state_dict())
    return on_card


def _lm(vocab, spec, device, seed=1):
    lm = RNNLM(vocab, **spec, device="cpu").eval()
    lm.reset_parameters(torch.Generator().manual_seed(seed))
    if torch.device(device).type == "cpu":
        return lm
    on_card = RNNLM(vocab, **spec, device=device).eval()
    on_card.load_state_dict(lm.state_dict())
    return on_card


def _encoded(B, T2, lo, adim, vocab, device, seed=2):
    """Random encoder output: memory (B, T2, adim), enc_len spread over
    [lo, T2] (the first utterance the longest), CTC logits (B, T2, V)."""
    g = torch.Generator().manual_seed(seed)
    memory = torch.randn(B, T2, adim, generator=g)
    enc_len = torch.linspace(T2, lo, B).round().long()
    logits = 3.0 * torch.randn(B, T2, vocab, generator=g)
    return memory.to(device), enc_len.to(device), logits.to(device)


def _counters():
    return {k: getattr(beam_jit.beam_search_encoded, k) for k in COUNTERS}


def _delta(before):
    return {k: v - before[k] for k, v in _counters().items()}


def _steps(tokens):
    return int((tokens[:, :, 1:] >= 0).any(0).any(0).sum())


def _assert_same_search(got, want, rtol):
    """Token-identical, scores within rtol relative; the NaN and infinite
    scores at the same places."""
    (tg, sg), (tw, sw) = got, want
    assert tg.shape == tw.shape and torch.equal(tg.cpu(), tw.cpu())
    sg, sw = sg.cpu(), sw.cpu()
    assert torch.equal(torch.isnan(sg), torch.isnan(sw))
    assert torch.equal(torch.isinf(sg), torch.isinf(sw))
    ok = torch.isfinite(sw)
    torch.testing.assert_close(sg[ok], sw[ok], rtol=rtol, atol=0)


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("with_lm", [False, True], ids=["no_lm", "rnnlm"])
@pytest.mark.parametrize("ctc_weight", [0.3, 1.0])
@pytest.mark.parametrize("beam", [4, 10])
def test_fixed_search_matches_the_full_prefix_search(beam, ctc_weight, with_lm, B):
    """The fixed-buffer step run eagerly on the CPU (beam_search_encoded's
    path for a TransformerASR there) against the eager loop's full-prefix
    decoder: the same tokens, scores within 1e-5 relative."""
    model = _asr(SMALL, "cpu")
    lm = _lm(V, dict(embed_dim=16, hidden=24), "cpu") if with_lm else None
    enc = _encoded(B, 20, 9, SMALL["adim"], V, "cpu")
    kw = dict(beam_size=beam, max_len=12, ctc_weight=ctc_weight, lm=lm)
    before = _counters()
    got = beam_jit.beam_search_encoded(model, *enc, **kw)
    assert _delta(before) == {"steps": _steps(got[0]), "graph_steps": 0, "graph_captures": 0}
    _assert_same_search(got, beam_jit.beam_search_eager(model, *enc, **kw), 1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fixed_search_that_stops_early_matches_the_full_prefix_search(compute_dtype):
    """eos made likely: the searches stop before max_len, at the same step,
    with -1 past it in the same buffer; bfloat16 computes the cache and the
    cross keys and values in bfloat16, as the full-prefix pass does."""
    model = _asr(SMALL, "cpu", compute_dtype=compute_dtype, eos_bias=6.0)
    enc = _encoded(3, 20, 9, SMALL["adim"], V, "cpu")
    kw = dict(beam_size=4, max_len=30, lm=_lm(V, dict(embed_dim=16, hidden=24), "cpu"))
    got = beam_jit.beam_search_encoded(model, *enc, **kw)
    assert 1 <= _steps(got[0]) < 30 and (got[0][:, :, _steps(got[0]) + 1:] == -1).all()
    if compute_dtype == "bfloat16":
        assert model.decode_fixed_buffers(1, 1, 128, 4, "cpu")["cache"].dtype == torch.bfloat16
    _assert_same_search(got, beam_jit.beam_search_eager(model, *enc, **kw), 1e-5)


def test_fixed_step_logits_match_decode_step():
    """Step by step over a reordered token buffer, the fixed step's logits
    equal the full-prefix pass's at the position (atol 1e-5)."""
    model = _asr(SMALL, "cpu")
    B, K, steps = 2, 3, 7
    memory, enc_len, _ = _encoded(B, 11, 5, SMALL["adim"], V, "cpu")
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, V, (B * K, steps), generator=g)
    tokens[:, 0] = V - 1
    bufs = model.decode_fixed_buffers(B, K, beam_jit.fixed_cap(steps), 11, "cpu")
    model.decode_fixed_load(bufs, memory, enc_len)
    mem, mem_len = memory.repeat_interleave(K, 0), enc_len.repeat_interleave(K)
    with torch.no_grad():
        for s in range(steps):
            got = model.decode_fixed_step(tokens[:, s], torch.tensor([s]), bufs)
            want = model.decode_step(tokens[:, :s + 1], mem, mem_len)[:, s]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
            # the cache follows the rows as the search reorders them: each
            # to a parent of its own utterance
            rows = (torch.arange(B)[:, None] * K
                    + torch.randint(0, K, (B, K), generator=g)).view(-1)
            tokens = tokens[rows]
            model.decode_fixed_reorder(bufs, rows)


def test_cross_attention_over_utterance_rows_equals_repeated_memory():
    """The K beams of an utterance as K query positions against the B
    rows' keys and values: (B, H, K, hd) @ (B, H, hd, T2) equals the
    attention of B x K rows over the memory repeated K times, to 1e-6."""
    B, K, T2, D = 3, 5, 17, 32
    attn = MultiHeadAttention(D, 4, device="cpu")
    g = torch.Generator().manual_seed(6)
    for p in attn.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) / D**0.5)
    memory = torch.randn(B, T2, D, generator=g)
    q = torch.randn(B * K, 1, D, generator=g)
    mask = (torch.arange(T2)[None, :] < torch.tensor([17, 9, 4])[:, None])[:, None, None, :]
    with torch.no_grad():
        want = attn(q, memory.repeat_interleave(K, 0), mask.repeat_interleave(K, 0))
        k, v = attn.kv(memory)
        got = attn.attend(q.view(B, K, D), k, v, mask).view(B * K, 1, D)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_max_len_2_and_100_meet_one_graph():
    """The positions round up to a multiple of 128, so the benchmark's
    two-step warm-up searches capture the graphs its window replays; the
    graph cache keys on the shape, not on max_len, and keeps at most
    _MAX_GRAPHS."""
    assert beam_jit.fixed_cap(2) == beam_jit.fixed_cap(100) == beam_jit.fixed_cap(127) == 128
    assert beam_jit.fixed_cap(128) == 256
    model = _asr(SMALL, "cpu")
    dev = torch.device("cpu")
    args = (model, None, 2, 4, 20)
    rest = (torch.float32, (0.3, 1.0, 0.0), dev)
    saved = beam_jit._graphs.copy()
    try:
        beam_jit._graphs.clear()
        first = beam_jit._cached_search(*args, beam_jit.fixed_cap(2), *rest)
        assert beam_jit._cached_search(*args, beam_jit.fixed_cap(100), *rest) is first
        assert beam_jit._cached_search(model, None, 2, 4, 21, 128, *rest) is not first
        for t2 in range(22, 22 + beam_jit._MAX_GRAPHS):
            beam_jit._cached_search(model, None, 2, 4, t2, 128, *rest)
        assert len(beam_jit._graphs) == beam_jit._MAX_GRAPHS
        assert first not in beam_jit._graphs.values()
    finally:
        beam_jit._graphs.clear()
        beam_jit._graphs.update(saved)


def test_speech_llm_and_prefix_scorer_searches_take_the_eager_loop(monkeypatch):
    """A model without a fixed-buffer step (the speech LLM) and a search
    with a prefix_scorer (the word LM's hook) run beam_search_eager; a
    TransformerASR search without one runs beam_search_fixed."""
    from speech_recognition_tools_tpu_torch.models.moe_lm import MoELMConfig
    from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLM, SpeechLLMConfig

    calls = []
    for name in ("beam_search_fixed", "beam_search_eager"):
        fn = getattr(beam_jit, name)
        monkeypatch.setattr(beam_jit, name,
                            lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    llm = MoELMConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                      moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=2,
                      n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
                      first_k_dense_replace=1, kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=8, v_head_dim=8, dtype="float32")
    enc_cfg = TransformerASRConfig(adim=16, aheads=2, elayers=1, eunits=32, dropout=0.0)
    slm = SpeechLLM(SpeechLLMConfig(llm=llm, encoder=enc_cfg, idim=8), device="cpu").eval()
    x = torch.randn(2, 40, 8, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        memory, P, _ = slm.encode(x, torch.tensor([40, 32]))
    before = _counters()
    toks, _ = beam_jit.beam_search_encoded(slm, memory, P, None, beam_size=2, max_len=3,
                                           ctc_weight=0.0, incremental=True)
    assert calls == ["beam_search_eager"]
    assert _delta(before) == {"steps": _steps(toks), "graph_steps": 0, "graph_captures": 0}

    model = _asr(SMALL, "cpu")
    enc = _encoded(2, 12, 7, SMALL["adim"], V, "cpu")
    calls.clear()
    beam_jit.beam_search_encoded(model, *enc, beam_size=2, max_len=3,
                                 prefix_scorer=lambda t: torch.zeros(t.shape[0], V))
    assert calls == ["beam_search_eager"]
    calls.clear()
    beam_jit.beam_search_encoded(model, *enc, beam_size=2, max_len=3, incremental=True)
    assert calls == ["beam_search_fixed"]


# ------------------------------------------------------------------ card


def _eager_fixed(model, memory, enc_len, logits, lm, beam_size, max_len, ctc_weight=0.3,
                 lm_weight=1.0):
    """The fixed step run eagerly on the card, step by step, as
    beam_search_fixed runs it on the CPU."""
    B, T2, _ = memory.shape
    st = beam_jit._FixedSearch(model, lm, B, beam_size, T2, beam_jit.fixed_cap(max_len),
                               logits.dtype, (ctc_weight, lm_weight, 0.0), memory.device)
    with torch.no_grad():
        st.load(model, lm, memory, enc_len, logits)
        for _ in range(max_len):
            st.step(model, lm)
            if bool(st.all_done):
                break
    return st.tokens[:, :max_len + 1].reshape(B, beam_size, max_len + 1), st.scores


@pytest.fixture(scope="module")
def cell_models():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    dev = torch.device("cuda")
    return _asr(CELL, dev), _lm(CELL["vocab_size"], CELL_LM, dev)


@pytest.mark.parametrize("B,T2,lo", [(8, 303, 100), (1, 160, 160)], ids=["B8", "B1"])
def test_card_graphed_search_matches_the_eager_searches(card, cell_models, B, T2, lo):
    """The graphed search token-identical to the fixed step run eagerly on
    the card and to the full-prefix search, scores within 1e-6 relative;
    the second search of the shape replays every step, and K2 launches
    once a step."""
    model, lm = cell_models
    enc = _encoded(B, T2, lo, CELL["adim"], CELL["vocab_size"], card)
    kw = dict(beam_size=10, max_len=100, lm=lm)
    first = beam_jit.beam_search_encoded(model, *enc, **kw)
    before, launches = _counters(), ctc.ctc_prefix_scores.launches
    got = beam_jit.beam_search_encoded(model, *enc, **kw)
    steps = _steps(got[0])
    assert steps >= 2
    assert _delta(before) == {"steps": steps, "graph_steps": steps, "graph_captures": 0}
    assert ctc.ctc_prefix_scores.launches - launches == steps
    _assert_same_search(got, first, 0)
    _assert_same_search(got, _eager_fixed(model, *enc, lm, 10, 100), 1e-6)
    _assert_same_search(got, beam_jit.beam_search_eager(model, *enc, **kw), 1e-6)


def test_card_a_capturing_search_counts_its_steps_and_launches(card, cell_models):
    """A shape's first search runs its first step eagerly, captures, and
    replays the rest: K2's launches still equal the steps."""
    model, lm = cell_models
    enc = _encoded(2, 77, 40, CELL["adim"], CELL["vocab_size"], card, seed=9)
    before, launches = _counters(), ctc.ctc_prefix_scores.launches
    toks, _ = beam_jit.beam_search_encoded(model, *enc, beam_size=10, max_len=100, lm=lm)
    steps = _steps(toks)
    assert _delta(before) == {"steps": steps, "graph_steps": steps - 1, "graph_captures": 1}
    assert ctc.ctc_prefix_scores.launches - launches == steps


def test_card_a_search_that_stops_early_returns_the_same_buffer(card):
    """eos made likely on both sides (its logit raised, and CTC posteriors
    mostly blank, so that the prefix's full-sequence score is high): the
    graphed search stops before max_len with -1 past its last step, as the
    eager searches do."""
    model = _asr(CELL, card, seed=3, eos_bias=8.0)
    memory, enc_len, logits = _encoded(3, 120, 60, CELL["adim"], CELL["vocab_size"], card,
                                       seed=5)
    logits[..., 0] += 15.0
    enc = (memory, enc_len, logits)
    kw = dict(beam_size=10, max_len=100)
    beam_jit.beam_search_encoded(model, *enc, **kw)  # captures
    got = beam_jit.beam_search_encoded(model, *enc, **kw)
    steps = _steps(got[0])
    assert 1 <= steps < 100 and got[0].shape == (3, 10, 101)
    assert (got[0][:, :, steps + 1:] == -1).all()
    _assert_same_search(got, _eager_fixed(model, *enc, None, 10, 100), 1e-6)
    # scores of ~-3 here: 1e-5 is ~17 of float32's steps at that size
    _assert_same_search(got, beam_jit.beam_search_eager(model, *enc, **kw), 1e-5)


def test_card_two_shapes_interleaved_replay_their_own_graphs(card, cell_models):
    model, lm = cell_models
    shapes = [_encoded(4, t2, t2 // 2, CELL["adim"], CELL["vocab_size"], card, seed=t2)
              for t2 in (91, 133)]
    kw = dict(beam_size=10, max_len=40, lm=lm)
    want = [beam_jit.beam_search_encoded(model, *enc, **kw) for enc in shapes]
    before = _counters()
    for enc, w in [(shapes[0], want[0]), (shapes[1], want[1]), (shapes[0], want[0])]:
        _assert_same_search(beam_jit.beam_search_encoded(model, *enc, **kw), w, 0)
    got = _delta(before)
    assert got["graph_captures"] == 0 and got["graph_steps"] == got["steps"] > 0


def test_card_a_graphed_search_syncs_only_at_the_wait(card, cell_models):
    """After its capture, a search's set-up and its first replayed step run
    without a host sync; the first sync is the step's wait."""
    import traceback

    model, lm = cell_models
    enc = _encoded(2, 64, 30, CELL["adim"], CELL["vocab_size"], card, seed=11)
    kw = dict(beam_size=10, max_len=20, lm=lm)
    beam_jit.beam_search_encoded(model, *enc, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError) as e:
            beam_jit.beam_search_encoded(model, *enc, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    frames = traceback.extract_tb(e.value.__traceback__)
    inside = [f for f in frames if f.filename.endswith("beam_jit.py")]
    assert inside[-1].line.strip() == "stop = bool(st.all_done)", frames


def test_card_a_speech_llm_search_captures_nothing_here(card):
    """The speech LLM's search (bfloat16, as its cell runs it; its own
    DecodeGraph) leaves the fixed-buffer search's counters and K2 alone."""
    from speech_recognition_tools_tpu_torch.models.moe_lm import MoELMConfig
    from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLM, SpeechLLMConfig

    llm = MoELMConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                      moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                      n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                      first_k_dense_replace=1, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=16, v_head_dim=16, dtype="bfloat16")
    enc_cfg = TransformerASRConfig(adim=16, aheads=2, elayers=1, eunits=32, dropout=0.0)
    slm = SpeechLLM(SpeechLLMConfig(llm=llm, encoder=enc_cfg, idim=8), device=card).eval()
    g = torch.Generator(device=card).manual_seed(12)
    with torch.no_grad():
        for p in slm.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=card, dtype=p.dtype)
                    / max(p.shape[-1], 1) ** 0.5)
    x = torch.randn(2, 40, 8, generator=torch.Generator().manual_seed(8)).to(card)
    with torch.no_grad():
        memory, P, _ = slm.encode(x, torch.tensor([40, 32], device=card))
    before, launches = _counters(), ctc.ctc_prefix_scores.launches
    toks, _ = beam_jit.beam_search_encoded(slm, memory, P, None, beam_size=2, max_len=3,
                                           ctc_weight=0.0, incremental=True)
    assert _delta(before) == {"steps": _steps(toks), "graph_steps": 0, "graph_captures": 0}
    assert ctc.ctc_prefix_scores.launches == launches
