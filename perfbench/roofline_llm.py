"""The work a fire of a deepseek_v3 model needs, and the card's bf16
peaks: the yardstick of `llm_mfu_pct`.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989.4 TFLOP/s in bf16
on the tensor cores, 3.35 TB/s of HBM.

Model FLOPs are the usual count, whatever form the program computes:
2 x the active parameters outside the embedding and the head for every
token through the layers (prefill and decode alike); attention's QK
(qk_nope + qk_rope dims) and PV (v dims) for every query-key pair that a
causal pass attends; the head once a sequence at prefill and once a
token at decode. A decode step's bytes are the weights it touches (the
experts that its tokens route to, in expectation for uniform routing)
plus its read of the latent cache and its write of one entry a row.
"""

from __future__ import annotations

BF16_FLOPS_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def attention_params(cfg: dict) -> int:
    """One layer's latent attention."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    rank = cfg["kv_lora_rank"]
    q = H * qk * D if cfg.get("q_lora_rank") is None else \
        cfg["q_lora_rank"] * (D + H * qk)
    kv = (rank + cfg["qk_rope_head_dim"]) * D \
        + H * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) * rank
    return q + kv + D * H * cfg["v_head_dim"]


def expert_params(cfg: dict) -> int:
    """One routed expert (gate, up, down)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def moe_params(cfg: dict, experts: float) -> float:
    """One expert layer with `experts` routed experts counted, plus its
    router and shared experts."""
    D = cfg["hidden_size"]
    return (experts * expert_params(cfg) + cfg["n_routed_experts"] * D
            + (cfg.get("n_shared_experts") or 0) * expert_params(cfg))


def _layers(cfg: dict) -> tuple:
    dense = cfg.get("first_k_dense_replace", 0)
    return dense, cfg["num_hidden_layers"] - dense


def active_params(cfg: dict) -> int:
    """Parameters a token uses outside the embedding and the head."""
    dense, moe = _layers(cfg)
    return (cfg["num_hidden_layers"] * attention_params(cfg)
            + dense * 3 * cfg["hidden_size"] * cfg["intermediate_size"]
            + moe * moe_params(cfg, cfg["num_experts_per_tok"]))


def model_flops(cfg: dict, requests: int, prefill_tokens: int,
                decode_tokens: int, attn_keys: int) -> float:
    """FLOPs of fires that served `requests` prompts of `prefill_tokens`
    tokens in all, fed `decode_tokens` tokens through the cache and
    attended `attn_keys` query-key pairs."""
    H = cfg["num_attention_heads"]
    pair = 2 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return (2.0 * active_params(cfg) * (prefill_tokens + decode_tokens)
            + pair * attn_keys + head * (requests + decode_tokens))


def decode_step_bytes(cfg: dict, batch: int, cache_tokens: int) -> float:
    """Bytes one decode step of `batch` rows moves at least: every weight
    but the embedding's other rows and the experts no token routes to
    (expected over uniform routing), the latent cache of `cache_tokens`
    positions in all rows read once, one entry a row and layer
    written."""
    b = BYTES[cfg.get("torch_dtype", "bfloat16")]
    D, V, E = cfg["hidden_size"], cfg["vocab_size"], cfg["n_routed_experts"]
    k = cfg["num_experts_per_tok"]
    touched = E * (1.0 - (1.0 - k / E) ** batch)
    dense, moe = _layers(cfg)
    weights = (cfg["num_hidden_layers"] * attention_params(cfg)
               + dense * 3 * D * cfg["intermediate_size"]
               + moe * moe_params(cfg, touched) + V * D + batch * D)
    entry = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) \
        * cfg["num_hidden_layers"]
    return b * (weights + entry * (cache_tokens + batch))
