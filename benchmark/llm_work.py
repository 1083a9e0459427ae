"""The speech LLM's work, counted from its configuration and shapes: the
parameters it holds, the bytes a decode step must read and the operations
a prefill and a decode step need (2 flops a multiply-add), with the H100's
bf16 peak. The per-layer metrics `llm.step_bw_share` and `llm.mfu` read
them.

`cfg` is the configuration file's dict (its config.json keys at the top
level). Counts are of the work the configuration needs, not of what one
implementation launches: the decode step's attention in the absorbed form
over each row's real positions, each token through its own experts, the
head over the whole vocabulary; a prefill's attention causal over each
utterance's own positions.
"""

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores
H100_BF16_FLOPS = 989e12
BYTES = 2  # bf16


def _dims(cfg):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def attention_params(cfg) -> int:
    H, nh, dn, dr, dv, R = _dims(cfg)
    return (H * nh * (dn + dr) + H * (R + dr) + R * nh * (dn + dv) + nh * dv * H
            + R + 2 * H)  # + kv_a_layernorm and the layer's two norms


def expert_params(cfg) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def moe_fixed_params(cfg) -> int:
    """An expert layer's parameters outside its routed experts: the shared
    experts and the router (its weight and correction bias)."""
    H, E = cfg["hidden_size"], cfg["n_routed_experts"]
    return 3 * H * cfg["n_shared_experts"] * cfg["moe_intermediate_size"] + E * H + E


def layer_counts(cfg):
    dense = cfg["first_k_dense_replace"]
    return dense, cfg["num_hidden_layers"] - dense


def llm_params(cfg) -> int:
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    dense, moe = layer_counts(cfg)
    per_moe = attention_params(cfg) + moe_fixed_params(cfg) + cfg["n_routed_experts"] * \
        expert_params(cfg)
    per_dense = attention_params(cfg) + 3 * H * cfg["intermediate_size"]
    return dense * per_dense + moe * per_moe + 2 * V * H + H


def step_bytes(cfg, rows: int, attended: int, active: list) -> int:
    """Bytes one decode step of `rows` tokens must read: every weight it
    uses once (the experts of `active`, the distinct experts each expert
    layer used in the step, the shared experts, the routers, attention, the
    dense layers, the head, the tokens' embedding rows) and the latent
    cache of `attended` positions in all (summed over the rows), in every
    layer."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    dense, moe = layer_counts(cfg)
    n = (dense + moe) * attention_params(cfg) + dense * 3 * H * cfg["intermediate_size"]
    n += moe * moe_fixed_params(cfg) + sum(active) * expert_params(cfg)
    n += V * H + H + rows * H
    n += (dense + moe) * attended * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
    return n * BYTES


def _token_flops(cfg) -> int:
    """A token's products outside attention's scores, in every layer: the
    projections and the MLP or experts (k routed and the shared, with the
    router)."""
    H, nh, dn, dr, dv, R = _dims(cfg)
    dense, moe = layer_counts(cfg)
    proj = 2 * (H * nh * (dn + dr) + H * (R + dr) + nh * dv * H)
    mlp_dense = 2 * 3 * H * cfg["intermediate_size"]
    mlp_moe = 2 * (cfg["num_experts_per_tok"] * expert_params(cfg)
                   + 3 * H * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
                   + cfg["n_routed_experts"] * H)
    return (dense + moe) * proj + dense * mlp_dense + moe * mlp_moe


def step_flops(cfg, rows: int, attended: int) -> int:
    """A decode step of `rows` tokens, `attended` positions over the rows:
    the absorbed attention (q_nope into the latent, scores over latent +
    rope, the weighted latent, out through the value part), the rest of
    every layer, and the head."""
    H, nh, dn, dr, dv, R = _dims(cfg)
    L = cfg["num_hidden_layers"]
    per_row = _token_flops(cfg) + L * 2 * nh * (dn * R + R * dv) + 2 * H * cfg["vocab_size"]
    return rows * per_row + L * attended * 2 * nh * (R + dr + R)


def prefill_flops(cfg, positions: list, stack_in: int) -> int:
    """The prefill of prefixes of `positions` (one count an utterance):
    the projector (stack_in -> hidden -> hidden), then every layer with
    keys and values expanded (kv_b_proj on each position) and causal
    attention over the utterance's own positions."""
    H, nh, dn, dr, dv, R = _dims(cfg)
    L = cfg["num_hidden_layers"]
    per_pos = 2 * (stack_in * H + H * H) + _token_flops(cfg) + L * 2 * R * nh * (dn + dv)
    total = 0
    for P in positions:
        pairs = P * (P + 1) // 2  # (query, key) pairs under the causal mask
        total += P * per_pos + L * pairs * 2 * nh * (dn + dr + dv)
    return total
