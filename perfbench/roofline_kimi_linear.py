"""The work a fire of a kimi_linear model needs, and the least time of
its KDA kernel: the yardsticks of `llm_mfu_pct` and `kda_roofline_pct`
in the kimilinear cell. (roofline_llm.py counts deepseek_v3's keys and
latent attention in every layer.)

Model FLOPs are the usual count, whatever form the program computes:
2 x the active parameters outside the embedding and the head for every
token through the layers (prefill and decode alike), the routed experts
at their expected share on this card, top_k x held / router experts a
token; the KDA recurrence's 7 x dim^2 a token and head (the decay, S^T k,
the rank-1 update and S^T q); latent attention's QK (nope + rope dims)
and PV (v dims) for every query-key pair a causal pass attends, in each
MLA layer (the program's `llm.attn_keys` counts one layer's pairs); the
head once a sequence at prefill and once a token at decode.

The KDA kernel's least work: q, k, v and g (dim f32 values each) and
beta read once and o written once a token and head, the f32 state read
and written as the program counts it (`llm.kda_state_bytes`: written
once a row at prefill, read and written at each decode step); its FLOPs
at the card's f32 rate outside the tensor cores, 67 TFLOP/s, and its
bytes at 3.35 TB/s (NVIDIA's H100 SXM data sheet). The least time is
the prefill's and the decode steps' each taken apart, the larger of its
two times, and added: the prefill is bound by its operations, a decode
step by its bytes.
"""

from __future__ import annotations

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def kda_layers(cfg: dict) -> int:
    return len(cfg["linear_attn_config"]["kda_layers"])


def kda_params(cfg: dict) -> int:
    """One KDA layer: q, k, v, the low-rank f and g gates, beta, the
    conv taps and o."""
    lin = cfg["linear_attn_config"]
    D, W = cfg["hidden_size"], lin["num_heads"] * lin["head_dim"]
    rank = lin["head_dim"]
    return (3 * W * D + 2 * (rank * D + W * rank) + lin["num_heads"] * D
            + 3 * W * lin["short_conv_kernel_size"] + W * D)


def mla_params(cfg: dict) -> int:
    """One latent attention layer (no q-LoRA)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    rank = cfg["kv_lora_rank"]
    return (H * qk * D + (rank + cfg["qk_rope_head_dim"]) * D
            + H * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) * rank
            + D * H * cfg["v_head_dim"])


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def active_params(cfg: dict) -> float:
    """Parameters a token uses outside the embedding and the head, the
    routed experts at their expected share on this card."""
    layers, kda = cfg["num_hidden_layers"], kda_layers(cfg)
    dense = cfg.get("first_k_dense_replace", 0)
    routers = cfg.get("router_num_experts", cfg["num_experts"])
    routed = cfg["num_experts_per_token"] * cfg["num_experts"] / routers
    moe = (routed + (cfg.get("num_shared_experts") or 0)) \
        * expert_params(cfg) + routers * cfg["hidden_size"]
    return (kda * kda_params(cfg) + (layers - kda) * mla_params(cfg)
            + dense * 3 * cfg["hidden_size"] * cfg["intermediate_size"]
            + (layers - dense) * moe)


def model_flops(cfg: dict, counters: dict) -> float:
    """FLOPs of the fires whose program counters are `counters`."""
    H = cfg["num_attention_heads"]
    pair = 2 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])
    mla = cfg["num_hidden_layers"] - kda_layers(cfg)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    tokens = counters.get("llm.prefill_tokens", 0) \
        + counters.get("llm.decode_tokens", 0)
    return (2.0 * active_params(cfg) * tokens
            + kda_flops(cfg, counters.get("llm.kda_tokens", 0))
            + pair * mla * counters.get("llm.attn_keys", 0)
            + head * (counters.get("llm.requests", 0)
                      + counters.get("llm.decode_tokens", 0)))


def kda_flops(cfg: dict, kda_tokens: int) -> float:
    """The recurrence over `kda_tokens` (tokens summed over layers)."""
    lin = cfg["linear_attn_config"]
    return 7.0 * lin["head_dim"] ** 2 * lin["num_heads"] * kda_tokens


def kda_least_seconds(cfg: dict, counters: dict) -> float:
    """The KDA kernel's least time for the fires of `counters`."""
    lin = cfg["linear_attn_config"]
    H, K = lin["num_heads"], lin["head_dim"]
    decode = kda_layers(cfg) * counters.get("llm.decode_tokens", 0)
    prefill = counters.get("llm.kda_tokens", 0) - decode
    decode_state = decode * 2 * H * K * K * 4
    prefill_state = counters.get("llm.kda_state_bytes", 0) - decode_state

    def least(tokens: int, state: int) -> float:
        moved = tokens * H * (5 * K + 1) * 4 + state
        return max(kda_flops(cfg, tokens) / F32_FLOPS_PER_S,
                   moved / HBM_BYTES_PER_S)
    return least(prefill, prefill_state) + least(decode, decode_state)
