"""The speech-LLM cell (`wsj_fdlp_speech_llm.decode`) at a tiny size on the
CPU against reference/moe_lm.py: it runs and is correct, plain and traced
(its six per-layer metrics read numbers); each of its four controls (the
expert weights in fp8, top-(k-1) routing, no shared experts, no correction
bias), judged in the program's place, makes it not correct, and so does a
planted fault; at the configuration's own size a CPU run is refused before
it draws a weight. The tiny copy cuts every width of the configuration
(this file's TINY_LLM), which conftest.py's tiny copy leaves whole."""

import json
import math
import os

import pytest

from conftest import ROOT, make_tiny_root, run_tiny

CELL = "wsj_fdlp_speech_llm.decode"
CONFIG = "wsj_fdlp_speech_llm"
TINY_LLM = {
    "hidden_size": 128, "intermediate_size": 256, "moe_intermediate_size": 64,
    "num_hidden_layers": 4, "num_attention_heads": 4, "n_routed_experts": 16,
    "n_shared_experts": 1, "num_experts_per_tok": 4, "first_k_dense_replace": 1,
    "kv_lora_rank": 64, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
    "vocab_size": 4096,
    "llm": {"type": "moe_lm", "dtype": "bfloat16", "sos_id": 4094, "eos_id": 4095},
    "frontend": {"nfilters": 20},
    "am": {"adim": 16, "aheads": 2, "elayers": 2, "eunits": 32},
}
TINY_CELL = {"batch": 2, "utterances": 6, "seconds_lo": 0.5, "seconds_hi": 0.8,
             "bucket_frames": 8, "max_len": 6}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
METRICS = [m["name"] for m in SPEC["per_layer"] if CELL in m.get("workloads", [])]


def _tiny(dest: str) -> str:
    make_tiny_root(dest)
    bench = os.path.join(dest, "benchmark")
    path = os.path.join(bench, "configs", CONFIG + ".json")
    with open(path) as f:
        cfg = json.load(f)
    for k, v in TINY_LLM.items():
        cfg[k] = dict(cfg[k], **v) if isinstance(v, dict) and k in cfg else v
    with open(path, "w") as f:
        json.dump(cfg, f)
    path = os.path.join(bench, "workloads", CELL + ".json")
    with open(path) as f:
        cell = json.load(f)
    cell["params"].update(TINY_CELL)
    with open(path, "w") as f:
        json.dump(cell, f)
    return dest


@pytest.fixture(scope="module")
def llm_root(tmp_path_factory):
    return _tiny(str(tmp_path_factory.mktemp("speech_llm")))


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_the_cell_runs_and_is_correct(llm_root, trace):
    # the readers of the traced run leave out the profiled batch: the window
    # has to outlast it, also on a host that other tests keep busy
    result, ctx = run_tiny(llm_root, CELL, trace, seconds=4.0 if trace else 1.0)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"enc_rel", "logp_abs", "score_rel", "route_diff"}
    if trace:
        assert set(result["metrics"]) == set(METRICS)
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in result["metrics"].values())
    else:
        assert set(result["metrics"]) == {"decode_audio_s_per_s", "setup_s"}


def test_the_prefill_runs_once_an_utterance(llm_root):
    """`llm.prefill` counts the batch's prefix positions (not K times them),
    once a search; every step has one `llm.attn` and one `llm.moe` a layer
    (expert layers) under `search.decoder`, and no CTC prefix span."""
    import collections

    from speech_recognition_tools_tpu_torch.utils.profiling import last_units

    _, ctx = run_tiny(llm_root, CELL, trace=True, seconds=1.0)
    cfg = ctx.config
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    units = last_units("search", ctx.tracer.done)
    assert units
    for u, (root, below) in enumerate(units):
        names = collections.Counter(r.name for r in below)
        prefill = [r for r in below if r.name == "llm.prefill"]
        assert len(prefill) == 1 and prefill[0].n == sum(ctx.facts["prefix_lens"][u])
        decoders = {r.id for r in below if r.name == "search.decoder"}
        assert len(decoders) == root.n and names["search.ctc_prefix"] == 0
        in_steps = collections.Counter(r.name for r in below if r.parent in decoders)
        assert in_steps["llm.attn"] == root.n * cfg["num_hidden_layers"]
        assert in_steps["llm.moe"] == root.n * moe_layers
        assert in_steps["llm.head"] == root.n


def test_the_controls_fail_and_the_program_passes(llm_root):
    result, ctx = run_tiny(llm_root, CELL, prepare=lambda c: c.facts.update(control=True),
                           seconds=1.0)
    limits = ctx.cell["limits"]
    program = ctx.facts["readings"]
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert not result["correct"], result["checks"]  # the fp8 control in the program's place
    faults = ctx.facts["fault_readings"]
    k = TINY_LLM["num_experts_per_tok"]
    assert set(faults) == {f"top{k - 1}", "no_shared", "no_bias"}
    for name, fault in faults.items():
        assert any(fault[m] > limits[m] for m in limits), (name, fault, limits)


def test_a_planted_fault_is_caught(llm_root):
    """A token of the first returned hypothesis altered where the search
    returns it: its summed log-probability no longer matches."""
    from speech_recognition_tools_tpu_torch.decode import beam_jit

    real = beam_jit.beam_search_batched

    def altered(*a, **kw):
        toks, scores = real(*a, **kw)
        toks = toks.clone()
        toks[0, 0, 1] = (toks[0, 0, 1] + 1) % TINY_LLM["llm"]["sos_id"]
        return toks, scores

    beam_jit.beam_search_batched = altered
    try:
        result, _ = run_tiny(llm_root, CELL)
    finally:
        beam_jit.beam_search_batched = real
    assert not result["correct"]
    assert result["checks"]["score_rel"]["value"] > result["checks"]["score_rel"]["limit"]


def test_the_full_size_is_refused_on_the_cpu(tmp_path):
    """At the configuration's own widths (16 B parameters) a CPU run stops
    in set-up, before any weight is drawn."""
    root = make_tiny_root(str(tmp_path))
    with pytest.raises(RuntimeError, match="runs on the card"):
        run_tiny(root, CELL)
