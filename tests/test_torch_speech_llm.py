"""The speech LLM (models/speech_llm.py) and its MoE decoder
(models/moe_lm.py) against the plain reference benchmark/reference/moe_lm.py,
at tiny widths on the CPU in float32: the LLM's logits; the prefill and
the cached (absorbed) decoding against the uncached forward pass; the
router's correction bias; the expert layer's grouped products against a
loop over experts; the beam search's scores against the reference's sums;
a model directory through `recog_e2e --jit_decode`; the search's CTC
skip against the CTC branch at ctc_weight 0.

On the card (skipped without one): a decode step of the full-size model
makes no host sync before `search.wait`; the step as a CUDA graph against
the step op by op; the expert layer's grouped products at the published
widths in bfloat16 against a loop over experts. Run there with
`python -m pytest --noconftest tests/test_torch_speech_llm.py`
(tests/conftest.py imports JAX; these tests need torch alone).
"""

import json
import os

import pytest
import torch
from torch_card import card  # noqa: F401  (the fixture)

from benchmark.reference import moe_lm as ref
from speech_recognition_tools_tpu_torch.decode import beam_jit
from speech_recognition_tools_tpu_torch.models import speech_llm
from speech_recognition_tools_tpu_torch.models.moe_lm import (
    MoEGate,
    MoELM,
    MoELMConfig,
    RoutedExperts,
)
from speech_recognition_tools_tpu_torch.models.speech_llm import SpeechLLM, SpeechLLMConfig
from speech_recognition_tools_tpu_torch.models.transformer_asr import (
    TransformerASR,
    TransformerASRConfig,
)

LLM = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
           num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8, n_shared_experts=1,
           num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, dtype="float32")
CFG = MoELMConfig(**LLM).to_dict()  # every config.json key, as the reference reads them
ENC = TransformerASRConfig(adim=16, aheads=2, elayers=2, eunits=32, dropout=0.0)
AM = dict(adim=16, aheads=2, elayers=2)
IDIM = 8


def _draw(model, seed, bias_std=0.1):
    """Seeded weights, as the benchmark draws them: matrices N(0, 1/fan_in),
    norm scales 1 + 0.02 N, other vectors 0.02 N, the correction bias
    bias_std N."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = torch.randn(p.shape, generator=g)
            if name.endswith("e_score_correction_bias"):
                p.copy_(bias_std * d)
            elif p.dim() >= 2:
                p.copy_(d / p.shape[-1] ** 0.5)
            elif "norm" in name:
                p.copy_(1 + 0.02 * d)
            else:
                p.copy_(0.02 * d)
    return model.eval()


@pytest.fixture(scope="module")
def model():
    cfg = SpeechLLMConfig(llm=MoELMConfig(**LLM), encoder=ENC, idim=IDIM)
    return _draw(SpeechLLM(cfg, device="cpu"), 1)


@pytest.fixture(scope="module")
def state(model):
    return dict(model.state_dict())


@pytest.fixture(scope="module")
def feats():
    g = torch.Generator().manual_seed(7)
    # two lengths in one padded batch: 17 and 12 encoder frames, prefixes of 8 and 6
    return torch.randn(2, 72, IDIM, generator=g), torch.tensor([72, 52])


@pytest.fixture(scope="module")
def searched(model, feats):
    x, lens = feats
    with torch.no_grad():
        return beam_jit.beam_search_batched(model, x, lens, beam_size=3, max_len=6,
                                            ctc_weight=0.0, device="cpu", incremental=True)


def test_llm_logits_match_the_reference(model, state):
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, LLM["vocab_size"], (3, 9), generator=g)
    with torch.no_grad():
        got = model.llm(tokens)
    want = ref.lm_logits(ref.Weights(state), tokens, CFG)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_prefill_then_cached_decoding_equal_the_full_forward(model, state, feats):
    """Left-padded prefixes of two lengths prefilled once, the cache expanded
    to 2 beams, then 4 tokens a beam through the absorbed attention: every
    step's log-probabilities equal the uncached reference's at that
    position."""
    x, lens = feats
    K, steps = 2, 4
    g = torch.Generator().manual_seed(5)
    text = torch.randint(0, 250, (2 * K, steps), generator=g)
    text[:, 0] = model.cfg.sos_id
    with torch.no_grad():
        memory, P, ctc = model.encode(x, lens)
        assert ctc is None and P.tolist() == [8, 6]
        cache = model.decode_init_cache(torch.zeros(2 * K, steps + 1, dtype=torch.long), memory, P)
        got = torch.stack([torch.log_softmax(model.decode_incremental(text[:, s:s + 1], s, None,
                                                                      None, cache)[:, 0], -1)
                           for s in range(steps)], 1)
    _, _, prefixes = ref.audio_prefix(state, x, lens, AM, 2)
    rows = [b for b in range(2) for _ in range(K)]
    W = ref.Weights(state)
    for i, r in enumerate(rows):
        seq = torch.cat([prefixes[r], W["llm.embed_tokens.weight"][text[i]]])[None]
        out, _ = ref.decoder(W, seq, torch.tensor([len(seq[0])]), CFG)
        want = torch.log_softmax(out[0, len(prefixes[r]):] @ W["llm.lm_head.weight"].T, -1)
        torch.testing.assert_close(got[i], want, rtol=0, atol=2e-5)


def test_a_step_over_the_whole_buffer_equals_one_over_its_filled_slots(model):
    """The step as the CUDA graph runs it (over every slot of a longer
    buffer, those past the step's slot holding other values, masked) gives
    the logits and experts of the step over the filled slots alone."""
    lm = model.llm
    g = torch.Generator().manual_seed(37)
    N, S, cap = 4, 5, 16
    h = torch.randn(N, S, LLM["hidden_size"], generator=g)
    pad = torch.tensor([0, 2, 1, 3])
    tokens = torch.randint(0, 250, (N,), generator=g)
    with torch.no_grad():
        cache, _ = lm.prefill(h, pad, S + 2)
        buf = torch.randn(cache["kv"].shape[:2] + (cap, cache["kv"].shape[3]), generator=g)
        buf[:, :, :S + 2] = cache["kv"]
        want = lm.step(tokens, cache)
        slot = torch.tensor([S])
        got, routes = lm._step(tokens, slot, pad, buf, cap)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(routes, cache["routes"])
    torch.testing.assert_close(buf[:, :, :S + 1], cache["kv"][:, :, :S + 1])


def test_the_correction_bias_moves_the_choice_not_the_weights():
    cfg = MoELMConfig(**LLM)
    gate = MoEGate(cfg, device="cpu")
    g = torch.Generator().manual_seed(11)
    x = torch.randn(64, cfg.hidden_size, generator=g)
    with torch.no_grad():
        gate.weight.copy_(torch.randn(gate.weight.shape, generator=g) / 8)
        idx0, w0 = gate(x)
        gate.e_score_correction_bias.copy_(0.3 * torch.randn(cfg.n_routed_experts, generator=g))
        idx1, w1 = gate(x)
    moved = (idx0.sort(-1).values != idx1.sort(-1).values).any(-1)
    assert 0 < int(moved.sum()) < len(x)
    s = torch.sigmoid(x @ gate.weight.T)
    for idx, w in ((idx0, w0), (idx1, w1)):  # weights: the unbiased scores, normalised
        want = s.gather(1, idx)
        torch.testing.assert_close(w, want / want.sum(-1, keepdim=True) * 2.446)
    same = ~moved  # where the choice holds, so do the weights
    torch.testing.assert_close(w0[same].sort(-1).values, w1[same].sort(-1).values)


def test_grouped_experts_equal_a_loop_over_experts():
    cfg = MoELMConfig(**LLM)
    ex = _draw(RoutedExperts(cfg, device="cpu"), 13)
    g = torch.Generator().manual_seed(17)
    x = torch.randn(40, cfg.hidden_size, generator=g)
    idx = torch.rand(40, cfg.n_routed_experts, generator=g).topk(2, -1).indices
    idx[:5] = torch.tensor([0, 3])  # an expert with many tokens, some with none
    w = torch.rand(40, 2, generator=g)
    with torch.no_grad():
        got, counts = ex(x, idx, w)
    want = torch.zeros_like(got)
    for t in range(40):
        for j in range(2):
            e = int(idx[t, j])
            h = x[t] @ ex.w13[e].T
            want[t] += (torch.nn.functional.silu(h[:32]) * h[32:]) @ ex.w2[e].T * w[t, j]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert counts.tolist() == torch.bincount(idx.view(-1), minlength=8).tolist()


def test_the_search_scores_are_the_references_sums(model, state, feats, searched):
    x, lens = feats
    toks, scores = searched
    _, _, prefixes = ref.audio_prefix(state, x, lens, AM, 2)
    rows, hyps = [], []
    for b in range(2):
        for k in range(3):
            h = []
            for t in toks[b, k, 1:].tolist():
                if t < 0:
                    break
                h.append(t)
                if t == model.cfg.eos_id:
                    break
            rows.append(b)
            hyps.append(h)
    total, _, _ = ref.hypothesis_logp(state, prefixes, rows, hyps, CFG, model.cfg.sos_id)
    torch.testing.assert_close(scores.double(), total.view(2, 3), rtol=1e-5, atol=0)


def test_a_model_directory_decodes_through_recog_e2e(model, feats, searched, tmp_path):
    """recog_e2e --jit_decode loads the directory `speech_llm.save` wrote
    and returns the search's best hypotheses; it refuses the CTC weight,
    the RNNLM and the word LM for it."""
    from speech_recognition_tools_tpu_torch.cli import recog_e2e
    from speech_recognition_tools_tpu_torch.io.egs import build_egs
    from speech_recognition_tools_tpu_torch.io.text import save_vocab

    d = str(tmp_path / "llm")
    speech_llm.save(model, d, "final_avg")
    save_vocab({f"w{i}": i for i in range(LLM["vocab_size"])}, f"{d}/vocab.json")
    x, lens = feats
    egs = str(tmp_path / "egs")
    build_egs(iter([("u0", x[0, : lens[0]].numpy()), ("u1", x[1, : lens[1]].numpy())]), egs)
    out = str(tmp_path / "hyp.txt")
    args = [d, egs, out, "--jit_decode", "--batch_size", "2", "--beam_size", "3",
            "--max_len", "6", "--bucket_frames", "72", "--device", "cpu"]
    hyps = recog_e2e.main(args)
    toks, scores = searched
    for b, key in enumerate(["u0", "u1"]):
        best = beam_jit.tokens_to_list(toks[b], scores[b], model.cfg.eos_id)
        assert hyps[key] == "".join(f"w{t}" for t in best)
    with open(out) as f:
        assert len(f.read().splitlines()) == 2
    for bad in (["--ctc_weight", "0.3"], ["--lm_dir", d], ["--word_lm_dir", d]):
        with pytest.raises(ValueError, match="speech-LLM model"):
            recog_e2e.main(args + bad)


def test_the_ctc_skip_equals_the_ctc_branch_at_weight_zero():
    asr = TransformerASR(TransformerASRConfig(vocab_size=14, adim=16, aheads=2, elayers=2,
                                              eunits=32, dlayers=2, dunits=32, dropout=0.0),
                         IDIM, device="cpu").eval()
    g = torch.Generator().manual_seed(19)
    x, lens = torch.randn(2, 40, IDIM, generator=g), torch.tensor([40, 33])
    with torch.no_grad():
        memory, enc_len, ctc_logits = asr.encode(x, lens)
        beam = dict(beam_size=4, max_len=8, ctc_weight=0.0)
        t0, s0 = beam_jit.beam_search_encoded(asr, memory, enc_len, ctc_logits, **beam)
        t1, s1 = beam_jit.beam_search_encoded(asr, memory, enc_len, None, **beam)
        with pytest.raises(ValueError, match="no CTC head"):
            beam_jit.beam_search_encoded(asr, memory, enc_len, None, beam_size=4, max_len=8)
    assert torch.equal(t0, t1)
    assert torch.equal(s0, s1)


def test_the_configuration_file_is_moonlight():
    """The benchmark's configuration builds Moonlight-16B-A3B's published
    shape: ~15.96 B parameters (counted on "meta", nothing allocated)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "wsj_fdlp_speech_llm.json")) as f:
        c = json.load(f)
    cfg = MoELMConfig.from_dict(c)
    assert cfg == MoELMConfig()
    lm = MoELM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert abs(n - 15.96e9) < 0.01e9


def test_card_grouped_experts_at_the_published_widths(card):
    """bf16 grouped products for 80 decode rows and a 1,200-position prefill
    against a float32 loop over the same bf16 weights."""
    cfg = MoELMConfig()
    ex = RoutedExperts(cfg, device=card)
    g = torch.Generator(device=card).manual_seed(23)
    with torch.no_grad():
        ex.w13.copy_(torch.randn(ex.w13.shape, generator=g, device=card) / 2048 ** 0.5)
        ex.w2.copy_(torch.randn(ex.w2.shape, generator=g, device=card) / 1408 ** 0.5)
        for T in (80, 1200):
            x = torch.randn(T, 2048, generator=g, device=card).to(torch.bfloat16)
            idx = torch.rand(T, 64, generator=g, device=card).topk(6, -1).indices
            w = torch.rand(T, 6, generator=g, device=card)
            got, _ = ex(x, idx, w)
            want = torch.zeros(T, 2048, device=card)
            for e in range(64):
                t, j = (idx == e).nonzero(as_tuple=True)
                h = x[t].float() @ ex.w13[e].float().T
                y = (torch.nn.functional.silu(h[:, :1408]) * h[:, 1408:]) @ ex.w2[e].float().T
                want.index_put_((t,), y * w[t, j, None], accumulate=True)
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel < 2e-2, (T, rel)


@pytest.fixture(scope="module")
def full_size():
    """The full-size speech LLM on the card, random weights, and the
    encoded prefixes of 8 utterances of 12 s and less."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test needs one")
    card = torch.device("cuda")
    model = SpeechLLM.empty(SpeechLLMConfig(), card)
    g = torch.Generator(device=card).manual_seed(29)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=card, dtype=p.dtype)
                    / max(p.shape[-1], 1) ** 0.5)
        x = torch.randn(8, 1216, 80, generator=g, device=card)
        lens = torch.full((8,), 1216, device=card) - torch.arange(8, device=card) * 20
        memory, P, _ = model.encode(x, lens)
    yield model, memory, P
    model.llm._decode_graphs.clear()


def test_card_a_decode_step_syncs_only_at_the_wait(full_size):
    """The full-size speech LLM under torch.cuda.set_sync_debug_mode("error"),
    after a search that captured the step's CUDA graph: the search's set-up
    (the prefill included) and its first step, a replay of that graph, run
    without a host sync; the first sync is the step's `search.wait`."""
    import traceback

    model, memory, P = full_size
    beam = dict(beam_size=10, max_len=4, ctc_weight=0.0, incremental=True)
    with torch.no_grad():
        beam_jit.beam_search_encoded(model, memory, P, None, **beam)
        assert model.llm._decode_graphs[80].graph is not None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError) as e:
                beam_jit.beam_search_encoded(model, memory, P, None, **beam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    frames = traceback.extract_tb(e.value.__traceback__)
    inside = [f for f in frames if f.filename.endswith("beam_jit.py")]
    assert inside[-1].line.strip() == "stop = bool(all_done)", frames


def test_card_the_graphed_step_equals_the_step_op_by_op(full_size):
    """Six teacher-forced steps of 80 beams, op by op and then as replays of
    the CUDA graph (attention over the whole buffer, masked): the same
    experts nearly everywhere and logits within bfloat16's rounding; a
    cache whose buffer a newer cache took over refuses to step."""
    model, memory, P = full_size
    B, K, steps = 8, 10, 6
    g = torch.Generator(device=memory.device).manual_seed(31)
    text = torch.randint(0, 160000, (B * K, steps), generator=g, device=memory.device)
    dummy = torch.zeros(B * K, steps + 1, dtype=torch.long)
    out = {}
    with torch.no_grad():
        for graphed in (False, True):
            model.llm.cuda_graphs = graphed
            cache = model.decode_init_cache(dummy, memory, P)
            logits, routes = [], []
            for s in range(steps):
                logits.append(model.decode_incremental(text[:, s:s + 1], s, None, None,
                                                       cache)[:, 0].clone())
                routes.append(cache["routes"].clone())
            out[graphed] = torch.stack(logits), torch.stack(routes), cache
        model.llm.cuda_graphs = True
        (l0, r0, old), (l1, r1, _) = out[False], out[True]
        same = (r0.sort(-1).values == r1.sort(-1).values).all(-1).float().mean()
        assert float(same) > 0.9, float(same)
        gap = float((l0 - l1).abs().max() / l0.abs().max())
        assert gap < 0.05, gap
        with pytest.raises(ValueError, match="took this cache's buffer over"):
            model.decode_incremental(text[:, :1], steps, None, None, old)
