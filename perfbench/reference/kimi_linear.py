"""Plain reference of a `kimi_linear` causal LM (Kimi Linear): one
sequence, a full causal forward pass in float32, no cache, no batching
and no kernel of any program.

It follows the Kimi Linear report (arXiv:2510.26692) and fla-org's
`fla/layers/kda.py` and `fla/ops/kda/naive.py`. Layers are KDA or MLA as
`linear_attn_config` lists them (1-indexed):

* Kimi Delta Attention: for each of q, k, v, x @ W^T, a causal depthwise
  conv of `short_conv_kernel_size` taps (no bias; tap j multiplies the
  input taps - 1 - j tokens back), SiLU; q and k L2-normalised per head
  (x / sqrt(sum x^2 + 1e-6)); beta = sigmoid(x @ W_b^T) a head; the
  gate a key channel g = -exp(A_log) softplus(x W_fa^T W_fb^T +
  dt_bias); from S = 0 (K x V a head), token by token:
  S <- Diag(exp g) S; u = v - S^T k; S <- S + beta k u^T;
  o = S^T q / sqrt(head_dim); the output (RMSNorm(o) w * sigmoid(x
  W_ga^T W_gb^T)) @ W_o^T, the norm over a head with `rms_norm_eps`;
* latent attention with `mla_use_nope`: q = x W_q^T, (c, k_r) =
  x W_kv_a^T split at kv_lora_rank, c RMS-normed (eps 1e-6), k_nope and v
  from c W_kv_b^T per head; scores (q_nope . k_nope + q_r . k_r) /
  sqrt(nope + rope) with nothing rotated, causal softmax, o_proj;
* a dense SwiGLU MLP in the first `first_k_dense_replace` layers, then
  routed experts: sigmoid scores of the router's logits over
  `router_num_experts` experts, the top `num_experts_per_token` of score
  plus e_score_correction_bias (within the best `topk_group` of
  `num_expert_group` groups), weighted by their unbiased scores,
  renormalised (`moe_renormalize`) and times `routed_scaling_factor`;
  plus the shared experts' MLP;
* pre-norm residual blocks, RMSNorm, a final norm and the untied head.

Departures from the published description, each the configuration's:
the expert share. Only experts [0, `num_experts`) contribute, the
experts of the card of rank 0 of an expert-parallel deployment; the
router still scores all `router_num_experts` and picks its top-k among
them, and the weights keep their normalisation over the top-k. The
recurrence runs token by token where fla computes it in chunks (the same
sums in another order). Weight names follow the model card's
modeling_kimi.py as far as they are known (the program's model says
which are recalled rather than checked).

`routes`, where given, holds the experts a program chose at every
position and layer, (layers, L, top_k), among all `router_num_experts`:
the reference then routes each token to those experts, weighted by its
own scores, as it takes the program's generated ids, and
`stats["route_gap"]` reads how far the choice strayed from its own: the
mean over tokens and expert layers, of every sequence passed the same
`stats`, of its k-th best choice score less the least choice score of
the experts taken (0 where they are its own top-k, inf where a token
takes an expert twice; `route_gap_sum` and `route_gap_tokens` keep the
sum and the count). The mean, and not moonlight.py's largest gap, since
the largest of ~10^5 near-ties is as much the draw's as the program's.

`weights` maps those names to tensors of any float type on any device;
each layer's weights are upcast to f32 as the layer runs, so the f32
model is never held whole. Both TF32 flags are set False for the forward
pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LATENT_EPS = 1e-6
L2_EPS = 1e-6


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv of x (L, C) with taps w (C,
    taps), zeros before the first token."""
    L, taps = x.shape[0], w.shape[1]
    y = torch.zeros_like(x)
    for j in range(taps):
        back = taps - 1 - j
        y[back:] += w[:, j] * x[:L - back]
    return F.silu(y)


def recurrence(q, k, v, g, beta, scale: float) -> torch.Tensor:
    """The gated delta rule from a zero state: q, k, v, g (L, H, K), beta
    (L, H); o (L, H, V)."""
    L, H, K = k.shape
    S = torch.zeros(H, K, v.shape[-1], dtype=v.dtype, device=v.device)
    o = torch.empty_like(v)
    for t in range(L):
        S = S * g[t].exp()[..., None]
        u = v[t] - torch.einsum("hkv,hk->hv", S, k[t])
        S = S + torch.einsum("hk,hv->hkv", beta[t][:, None] * k[t], u)
        o[t] = torch.einsum("hkv,hk->hv", S, q[t]) * scale
    return o


def _kda(cfg, h, get, a):
    lin = cfg["linear_attn_config"]
    H, K = lin["num_heads"], lin["head_dim"]
    L = h.shape[0]

    def conv(n):
        return short_conv(h @ get(f"{a}{n}_proj.weight").T,
                          get(f"{a}{n}_conv1d.weight")[:, 0])

    q = _l2norm(conv("q").view(L, H, K))
    k = _l2norm(conv("k").view(L, H, K))
    v = conv("v").view(L, H, K)
    f = (h @ get(a + "f_a_proj.weight").T) @ get(a + "f_b_proj.weight").T
    g = -get(a + "A_log").reshape(H, 1).exp() * F.softplus(
        f.view(L, H, K) + get(a + "dt_bias").view(H, K))
    beta = (h @ get(a + "b_proj.weight").T).sigmoid()
    o = recurrence(q, k, v, g, beta, K ** -0.5)
    gate = (h @ get(a + "g_a_proj.weight").T) @ get(a + "g_b_proj.weight").T
    o = _norm(o, get(a + "o_norm.weight"), cfg.get("rms_norm_eps", 1e-6)) \
        * gate.view(L, H, K).sigmoid()
    return o.reshape(L, H * K) @ get(a + "o_proj.weight").T


def _mla(cfg, h, get, a):
    L = h.shape[0]
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    if cfg.get("q_lora_rank") is None:
        q = h @ get(a + "q_proj.weight").T
    else:
        qa = _norm(h @ get(a + "q_a_proj.weight").T,
                   get(a + "q_a_layernorm.weight"), LATENT_EPS)
        q = qa @ get(a + "q_b_proj.weight").T
    q = q.view(L, H, nope + rope).transpose(0, 1)          # (H, L, .)
    kv = h @ get(a + "kv_a_proj_with_mqa.weight").T
    c, k_r = kv[:, :rank], kv[:, rank:]
    c = _norm(c, get(a + "kv_a_layernorm.weight"), LATENT_EPS)
    kvb = (c @ get(a + "kv_b_proj.weight").T).view(L, H, nope + vd)
    k_nope = kvb[..., :nope].transpose(0, 1)
    v = kvb[..., nope:].transpose(0, 1)
    scores = (q[..., :nope] @ k_nope.transpose(1, 2)
              + q[..., nope:] @ k_r.T) / math.sqrt(nope + rope)
    future = torch.ones(L, L, dtype=torch.bool, device=h.device).triu(1)
    probs = scores.masked_fill(future, float("-inf")).softmax(-1)
    o = (probs @ v).transpose(0, 1).reshape(L, H * vd)
    return o @ get(a + "o_proj.weight").T


def _mlp(h, get, prefix, gate="gate_proj", up="up_proj", down="down_proj"):
    return (F.silu(h @ get(f"{prefix}{gate}.weight").T)
            * (h @ get(f"{prefix}{up}.weight").T)) \
        @ get(f"{prefix}{down}.weight").T


def experts(cfg, h, get, m, forced=None, stats=None, shared=True):
    """Expert layer `m` (its name prefix) over tokens h (T, D): this
    card's routed experts, and with `shared` the shared experts."""
    held = cfg["num_experts"]
    E = cfg.get("router_num_experts", held)
    k = cfg["num_experts_per_token"]
    scores = (h @ get(m + "gate.weight").T).sigmoid()
    choice = scores + get(m + "gate.e_score_correction_bias")
    groups = cfg.get("num_expert_group") or 1
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
        gaps = (best[:, -1] - taken).clamp(min=0.0)
        if bool((idx.sort(-1)[0].diff(dim=-1) == 0).any()):
            gaps = gaps + math.inf
        if stats is not None:
            stats["route_gap_sum"] = stats.get("route_gap_sum", 0.0) \
                + float(gaps.sum())
            stats["route_gap_tokens"] = stats.get("route_gap_tokens", 0) \
                + gaps.numel()
            stats["route_gap"] = stats["route_gap_sum"] \
                / stats["route_gap_tokens"]
    w = scores.gather(1, idx)
    if cfg.get("moe_renormalize", True):
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(h)
    for e in range(held):
        tok, slot = torch.where(idx == e)
        if tok.numel():
            y = _mlp(h[tok], get, f"{m}experts.{e}.", "w1", "w3", "w2")
            out.index_add_(0, tok, y * w[tok, slot, None])
    if shared and cfg.get("num_shared_experts"):
        out = out + _mlp(h, get, m + "shared_experts.")
    return out


def routed(cfg: dict, weights, layer: int, h, route) -> torch.Tensor:
    """The f32 weighted sum (T, D) of this card's routed experts of
    expert layer `layer` (0-indexed) over tokens h (T, D), each token on
    the experts `route` (T, top_k) gives, weighted by the reference's own
    scores: the expert layer alone, without the shared experts."""
    dev = weights["model.embed_tokens.weight"].device
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return experts(
                cfg, h.to(dev, torch.float32),
                lambda n: weights[n].to(dev, torch.float32),
                f"model.layers.{layer}.block_sparse_moe.",
                torch.as_tensor(route, device=dev).long(), shared=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def forward(cfg: dict, weights, ids, routes=None,
            stats: dict | None = None) -> torch.Tensor:
    """The f32 logits (L, vocab) of the sequence `ids` (L,) under the
    config `cfg` and `weights`; with `routes`, on the experts they give
    (module docstring)."""
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
    kda = {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}

    def get(name):
        return weights[name].to(dev, torch.float32)

    x = weights["model.embed_tokens.weight"][ids].float()
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        h = _norm(x, get(pre + "input_layernorm.weight"), eps)
        mixer = _kda if i in kda else _mla
        x = x + mixer(cfg, h, get, pre + "self_attn.")
        h = _norm(x, get(pre + "post_attention_layernorm.weight"), eps)
        if i < cfg.get("first_k_dense_replace", 0):
            x = x + _mlp(h, get, pre + "mlp.")
        else:
            forced = None if routes is None else \
                torch.as_tensor(routes[i], device=dev).long()
            x = x + experts(cfg, h, get, pre + "block_sparse_moe.", forced,
                            stats)
    x = _norm(x, get("model.norm.weight"), eps)
    return x @ get("lm_head.weight").T
