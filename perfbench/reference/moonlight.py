"""Plain reference of a `deepseek_v3` causal LM (DeepSeek-V3, Moonlight):
one sequence, a full causal forward pass in float32, no cache, no
batching and no kernel of any program.

It follows the DeepSeek-V3 report (arXiv:2412.19437) as transformers'
`models/deepseek_v3/modeling_deepseek_v3.py` writes it:

* multi-head latent attention: q = q_proj(h) (or q_b(rmsnorm(q_a(h))));
  (c, k_rot) = kv_a(h) split at kv_lora_rank; c = rmsnorm(c) with eps
  1e-6 (transformers builds both latent norms with its default eps);
  k_nope and v from kv_b(c) per head; RoPE on q's and k's rotary dims,
  their pairs first laid out as halves where `rope_interleave`; scores
  (q_nope . k_nope + q_rot . k_rot) / sqrt(nope + rope), causal softmax,
  the heads' outputs through o_proj;
* the first `first_k_dense_replace` layers a dense SwiGLU MLP, the rest
  routed experts: router logits, sigmoid scores, the experts chosen by
  the top-k of score + e_score_correction_bias (within the best
  `topk_group` groups where `n_group` > 1), weighted by their unbiased
  scores, normalised where `norm_topk_prob`, times
  `routed_scaling_factor`; each expert run over its own tokens in a
  loop; plus the shared experts' MLP;
* pre-norm residual blocks, RMSNorm (x / sqrt(mean(x^2) + eps) * w),
  a final norm and the untied head.

`routes`, where given, holds the experts a program chose at every
position and layer, (layers, L, top_k): the reference then routes each
token to those experts, weighted by its own scores, as it takes the
program's generated ids; and `stats["route_gap"]` reads how far the
choice strayed from its own, the largest over tokens and layers of its
k-th best choice score less the least choice score of the experts taken
(0 where they are its own top-k, inf where a token takes an expert
twice). A choice flips on rounding where two experts' scores nearly tie,
as a greedy token does where two logits nearly tie.

`weights` maps transformers' DeepseekV3ForCausalLM names to tensors of
any float type on any device; each layer's weights are upcast to f32 as
the layer runs, so the f32 model is never held whole. Both TF32 flags
are set False for the forward pass: on a CUDA card an f32 matrix
product may otherwise run in TF32.
"""

from __future__ import annotations

import math

import torch

LATENT_EPS = 1e-6


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
          interleave: bool) -> torch.Tensor:
    """x (..., L, d) rotated at positions pos (L,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float()
                           / d))
    ang = pos.float()[:, None] * inv[None, :]
    cos = torch.cat((ang, ang), -1).cos()
    sin = torch.cat((ang, ang), -1).sin()
    if interleave:
        x = torch.cat((x[..., 0::2], x[..., 1::2]), -1)
    half = torch.cat((-x[..., d // 2:], x[..., :d // 2]), -1)
    return x * cos + half * sin


def _mlp(h, get, prefix):
    gate = h @ get(prefix + "gate_proj.weight").T
    up = h @ get(prefix + "up_proj.weight").T
    return (torch.nn.functional.silu(gate) * up) @ get(
        prefix + "down_proj.weight").T


def _attention(cfg, h, get, a, pos):
    L = h.shape[0]
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    interleave = cfg.get("rope_interleave", True)
    theta = cfg.get("rope_theta", 10000.0)
    if cfg.get("q_lora_rank") is None:
        q = h @ get(a + "q_proj.weight").T
    else:
        qa = _norm(h @ get(a + "q_a_proj.weight").T,
                   get(a + "q_a_layernorm.weight"), LATENT_EPS)
        q = qa @ get(a + "q_b_proj.weight").T
    q = q.view(L, H, nope + rope).transpose(0, 1)          # (H, L, .)
    kv = h @ get(a + "kv_a_proj_with_mqa.weight").T
    c, k_rot = kv[:, :rank], kv[:, rank:]
    c = _norm(c, get(a + "kv_a_layernorm.weight"), LATENT_EPS)
    kvb = (c @ get(a + "kv_b_proj.weight").T).view(L, H, nope + vd)
    k_nope = kvb[..., :nope].transpose(0, 1)
    v = kvb[..., nope:].transpose(0, 1)
    q_rot = _rope(q[..., nope:], pos, theta, interleave)
    k_rot = _rope(k_rot, pos, theta, interleave)           # (L, rope)
    scores = (q[..., :nope] @ k_nope.transpose(1, 2)
              + q_rot @ k_rot.T) / math.sqrt(nope + rope)
    future = torch.ones(L, L, dtype=torch.bool, device=h.device).triu(1)
    probs = scores.masked_fill(future, float("-inf")).softmax(-1)
    o = (probs @ v).transpose(0, 1).reshape(L, H * vd)
    return o @ get(a + "o_proj.weight").T


def _experts(cfg, h, get, m, forced, stats):
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = (h @ get(m + "gate.weight").T).sigmoid()
    choice = scores + get(m + "gate.e_score_correction_bias")
    groups = cfg.get("n_group") or 1
    if groups > 1:
        g = choice.view(-1, groups, E // groups)
        best = g.topk(2, -1)[0].sum(-1).topk(cfg["topk_group"], -1)[1]
        keep = torch.zeros(h.shape[0], groups, dtype=torch.bool,
                           device=h.device).scatter_(1, best, True)
        choice = choice.masked_fill(
            ~keep[:, :, None].expand_as(g).reshape(-1, E), 0.0)
    best, idx = choice.topk(k, -1)
    if forced is not None:
        idx = forced
        taken = choice.gather(1, idx).min(-1)[0]
        gap = float((best[:, -1] - taken).clamp(min=0.0).max())
        if bool((idx.sort(-1)[0].diff(dim=-1) == 0).any()):
            gap = math.inf
        stats["route_gap"] = max(stats.get("route_gap", 0.0), gap)
    w = scores.gather(1, idx)
    if cfg.get("norm_topk_prob", True):
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.where(idx == e)
        if tok.numel():
            y = _mlp(h[tok], get, f"{m}experts.{e}.")
            out.index_add_(0, tok, y * w[tok, slot, None])
    if cfg.get("n_shared_experts"):
        out = out + _mlp(h, get, m + "shared_experts.")
    return out


def forward(cfg: dict, weights, ids, routes=None,
            stats: dict | None = None) -> torch.Tensor:
    """The f32 logits (L, vocab) of the sequence `ids` (L,) under the
    config `cfg` (transformers' config keys) and `weights`; with
    `routes`, on the experts they give (module docstring)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(cfg, weights, ids, routes,
                            {} if stats is None else stats)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _forward(cfg, weights, ids, routes, stats):
    dev = weights["model.embed_tokens.weight"].device
    ids = torch.as_tensor(ids, device=dev).reshape(-1)
    eps = cfg.get("rms_norm_eps", 1e-6)

    def get(name):
        return weights[name].to(dev, torch.float32)

    x = weights["model.embed_tokens.weight"][ids].float()
    pos = torch.arange(ids.shape[0], device=dev)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        h = _norm(x, get(pre + "input_layernorm.weight"), eps)
        x = x + _attention(cfg, h, get, pre + "self_attn.", pos)
        h = _norm(x, get(pre + "post_attention_layernorm.weight"), eps)
        if i < cfg.get("first_k_dense_replace", 0):
            x = x + _mlp(h, get, pre + "mlp.")
        else:
            forced = None if routes is None else \
                torch.as_tensor(routes[i], device=dev).long()
            x = x + _experts(cfg, h, get, pre + "mlp.", forced, stats)
    x = _norm(x, get("model.norm.weight"), eps)
    return x @ get("lm_head.weight").T
