"""The causal LM of `kimi_linear` configurations (Kimi Linear) on torch
ops and the KDA kernel, serving a batch of streams in one forward pass.

The block follows the Kimi Linear report (arXiv:2510.26692) and fla-org's
`fla/layers/kda.py`. Its layers are of two kinds, given 1-indexed by the
config's `linear_attn_config` (`kda_layers`, `full_attn_layers`):

* Kimi Delta Attention (KDA): q, k, v = SiLU(causal depthwise conv of
  `short_conv_kernel_size` taps over W x), q and k L2-normalised (eps
  1e-6); beta = sigmoid(W_b x), one a head; the gate a key channel
  g = -exp(A_log) softplus(W_fb W_fa x + dt_bias); per head and token
  the gated delta rule of ops/kda.py (scale 1/sqrt(head_dim)); the
  output W_o (RMSNorm(o) * sigmoid(W_gb W_ga x)). The gates, beta, the
  conv, q, k, v and the state are f32; the projections are in the
  config's dtype;
* multi-head latent attention with `mla_use_nope`: deepseek_v3's MLA
  (Kimi Linear has no q-LoRA) with the 64 "rope" dims never rotated;
  softmax scale 1/sqrt(qk_nope_head_dim + qk_rope_head_dim);

each followed by deepseek_v3's MLP: dense in the first
`first_k_dense_replace` layers, then the sigmoid router with its
correction bias over `router_num_experts` experts (the published
`num_experts`), top `num_experts_per_token`, renormalised
(`moe_renormalize`) and times `routed_scaling_factor`, and the shared
experts. This card holds experts [0, `num_experts`) of the router's: the
card of rank 0 of an expert-parallel deployment. Pairs routed to other
experts are dropped before the grouped products and add nothing; the
weights keep their normalisation over all top-k, so the layer's output
is this card's part of the whole, which the deployment's exchange would
sum over the cards.

A fire (`generate`, deepseek_v3's) holds two kinds of per-stream state
side by side (`HybridCache`): the latent cache of the MLA layers, and of
each KDA layer a (rows, heads, 128, 128) f32 state and the conv's last
`conv - 1` inputs, fixed in size whatever the prompt's length. Prefill
runs the right-padded rows of a chunk through the KDA kernel, each row
up to its own length, so each row's state and conv tail are those after
its last token. The decode step, captured as one CUDA graph, updates the
latent cache, every KDA state and conv tail in place.

`tap` holds, after a fire, its last decode step's expert layers: (the
cache's `moe`, each expert layer's input and routed experts' weighted
sum at every row, and the step's chosen experts (layers, B, top_k)).
It lets a comparison hold the routed experts alone, on the hidden states
the fire computed, against a reference.

Spans and counters: deepseek_v3's, with `llm.attn_keys` the pairs of one
MLA layer; and `llm.kda_tokens` (tokens through KDA layers, prefill and
decode, summed over the layers), `llm.kda_state_bytes` (state bytes the
KDA kernel read and wrote) and `llm.expert_pairs_held` ((token, expert)
pairs computed on this card's experts, of top_k a token routed).

`state_dict()` names follow the model card's `modeling_kimi.py` as far
as they are known here: `self_attn.{q,k,v}_proj`, `{q,k,v}_conv1d`
(weight (C, 1, taps)), `f_a_proj`, `f_b_proj`, `g_a_proj`, `g_b_proj`,
`b_proj`, `A_log` ((1, 1, heads, 1)), `dt_bias`, `o_norm`, `o_proj` in
KDA layers; deepseek_v3's attention names in MLA layers; `mlp.*` in the
dense layer; `block_sparse_moe.gate.weight`,
`block_sparse_moe.gate.e_score_correction_bias`,
`block_sparse_moe.experts.{e}.w1` (gate), `.w3` (up), `.w2` (down) and
`block_sparse_moe.shared_experts.{gate,up,down}_proj` in expert layers.
These are recalled from that file, not checked against it here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gstpu_torch.models.deepseek_v3 import (_DTYPES, BIAS_STD, INIT_STD,
                                            DeepseekV3Lm, Shape, _mlp_names,
                                            rms_norm)
from gstpu_torch.ops.kda import kda_recurrence
from gstpu_torch.utils.tracing import count

L2_EPS = 1e-6               # fla's l2norm of q and k
# seeded gate parameters (fla's KDA init, A narrowed): A = exp(A_log)
# uniform in [1, 12] a head, dt log-uniform in [1e-3, 0.1] a channel,
# dt_bias its inverse softplus: decays exp(-A dt) from ~0.30 to ~0.999
A_RANGE = (1.0, 12.0)
DT_RANGE = (1e-3, 0.1)


@dataclass(frozen=True)
class KimiShape(Shape):
    """deepseek_v3's Shape read from kimi_linear keys, and the KDA
    layers' sizes."""
    kda_heads: int
    kda_dim: int
    conv: int
    kda_layers: tuple       # 0-indexed
    gate_rank: int          # W_fa's and W_ga's width

    @classmethod
    def of(cls, cfg: dict) -> "KimiShape":
        want = {"model_type": "kimi_linear", "hidden_act": "silu",
                "moe_router_activation_func": "sigmoid",
                "mla_use_nope": True, "mla_use_output_gate": False,
                "tie_word_embeddings": False, "rope_scaling": None,
                "moe_layer_freq": 1}
        for k, v in want.items():
            if cfg.get(k, v) != v:
                raise ValueError(f"kimi_linear: {k}={cfg[k]!r} is not "
                                 f"implemented (only {v!r})")
        lin = cfg["linear_attn_config"]
        for k in ("use_full_rank_gate", "gate_lower_bound"):
            if lin.get(k):
                raise ValueError(f"kimi_linear: linear_attn_config {k} is "
                                 f"not implemented")
        layers = cfg["num_hidden_layers"]
        kda = tuple(sorted(i - 1 for i in lin["kda_layers"]))
        full = tuple(i - 1 for i in lin["full_attn_layers"])
        if sorted(kda + full) != list(range(layers)):
            raise ValueError("kimi_linear: kda_layers and full_attn_layers "
                             "do not partition the layers")
        dtype = _DTYPES.get(cfg.get("torch_dtype", "bfloat16"))
        if dtype is None:
            raise ValueError(f"kimi_linear: torch_dtype "
                             f"{cfg['torch_dtype']!r} is not implemented")
        held = cfg["num_experts"]
        experts = cfg.get("router_num_experts", held)
        if not 0 < held <= experts:
            raise ValueError(f"kimi_linear: {held} experts held of "
                             f"{experts}")
        return cls(
            hidden=cfg["hidden_size"], layers=layers,
            vocab=cfg["vocab_size"], heads=cfg["num_attention_heads"],
            nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
            v_dim=cfg["v_head_dim"], kv_rank=cfg["kv_lora_rank"],
            q_rank=cfg.get("q_lora_rank"),
            inter=cfg["intermediate_size"],
            moe_inter=cfg["moe_intermediate_size"], experts=experts,
            shared=cfg.get("num_shared_experts") or 0,
            top_k=cfg["num_experts_per_token"],
            dense_layers=cfg.get("first_k_dense_replace", 0),
            n_group=cfg.get("num_expert_group") or 1,
            topk_group=cfg.get("topk_group") or 1,
            norm_topk=bool(cfg.get("moe_renormalize", True)),
            routed_scale=float(cfg.get("routed_scaling_factor", 1.0)),
            eps=float(cfg.get("rms_norm_eps", 1e-6)), theta=0.0,
            max_pos=cfg.get("model_max_length", 1 << 20), interleave=False,
            dtype=dtype, held=held, rotary=False,
            kda_heads=lin["num_heads"], kda_dim=lin["head_dim"],
            conv=lin["short_conv_kernel_size"], kda_layers=kda,
            gate_rank=lin["head_dim"])

    def is_kda(self, layer: int) -> bool:
        return layer in self.kda_layers

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_dim


def seeded_params(s: KimiShape, seed: int, device) -> dict:
    """Every weight from `seed` in the port's layout (deepseek_v3's for
    MLA and the MLPs, with this card's `held` experts): matrices
    normal(0, INIT_STD) in the config's dtype, norms at 1, the
    correction bias normal(0, BIAS_STD) f32; a KDA layer's `in_proj`
    stacks q, k, v, W_fa, W_ga and W_b, `conv` (3 heads * dim, taps) is
    uniform(+-1/sqrt(taps)) (torch's Conv1d default), A_log and dt_bias
    f32 as A_RANGE and DT_RANGE say."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)

    def mat(*shape):
        return torch.empty(shape, dtype=s.dtype, device=device).normal_(
            0.0, INIT_STD, generator=g)

    def uniform(lo, hi, *shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device).uniform_(
            lo, hi, generator=g)

    def ones(n):
        return torch.ones(n, dtype=s.dtype, device=device)

    D, H, W, r = s.hidden, s.heads, s.kda_width, s.gate_rank
    p = {"embed": mat(s.vocab, D), "layers": []}
    for i in range(s.layers):
        lw = {"in_norm": ones(D), "post_norm": ones(D)}
        if s.is_kda(i):
            lw["in_proj"] = mat(3 * W + 2 * r + s.kda_heads, D)
            bound = 1.0 / math.sqrt(s.conv)
            lw["conv"] = uniform(-bound, bound, 3 * W, s.conv,
                                 dtype=s.dtype)
            lw["f_b"] = mat(W, r)
            lw["g_b"] = mat(W, r)
            lw["A_log"] = uniform(*A_RANGE, s.kda_heads).log()
            dt = uniform(*map(math.log, DT_RANGE), W).exp()
            lw["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
            lw["o_norm"] = ones(s.kda_dim)
        else:
            if s.q_rank is None:
                lw["q"] = mat(H * s.qk_dim, D)
            else:
                lw["q_a"] = mat(s.q_rank, D)
                lw["q_a_norm"] = ones(s.q_rank)
                lw["q_b"] = mat(H * s.qk_dim, s.q_rank)
            lw["kv_a"] = mat(s.kv_rank + s.rope, D)
            lw["kv_norm"] = ones(s.kv_rank)
            lw["kv_b"] = mat(H * (s.nope + s.v_dim), s.kv_rank)
        lw["o"] = mat(D, W if s.is_kda(i) else H * s.v_dim)
        if s.is_moe(i):
            lw["router"] = mat(s.experts, D)
            lw["bias"] = torch.empty(s.experts, dtype=torch.float32,
                                     device=device).normal_(
                0.0, BIAS_STD, generator=g)
            lw["w13"] = mat(s.held, 2 * s.moe_inter, D)
            lw["w2"] = mat(s.held, D, s.moe_inter)
            if s.shared:
                n = s.shared * s.moe_inter
                lw["shared_gate_up"] = mat(2 * n, D)
                lw["shared_down"] = mat(D, n)
        else:
            lw["gate_up"] = mat(2 * s.inter, D)
            lw["down"] = mat(D, s.inter)
        p["layers"].append(lw)
    p["norm"] = ones(D)
    p["head"] = mat(s.vocab, D)
    return p


@dataclass
class HybridCache:
    """A fire's per-stream state: `latent` (MLA layers, B, Lc, rank +
    rope) in the config's dtype; `kda` (KDA layers, B, heads, dim, dim)
    and `conv` (KDA layers, B, 3 heads * dim, taps - 1) f32; `ones` (B,)
    int32, a decode step's run length; `moe` (layers, 2, B, hidden) in
    the config's dtype, each expert layer's input and routed experts'
    weighted sum at the last decode step (0 in dense layers)."""
    latent: torch.Tensor
    kda: torch.Tensor
    conv: torch.Tensor
    ones: torch.Tensor
    moe: torch.Tensor


class KimiLinearLm(DeepseekV3Lm):
    """A kimi_linear causal LM on one device."""

    shape_type = KimiShape
    draw = staticmethod(seeded_params)

    def __init__(self, config: dict, params: dict):
        super().__init__(config, params)
        s = self.shape
        # a layer's index among the layers of its kind
        kinds = [s.is_kda(i) for i in range(s.layers)]
        self._slot = [kinds[:i].count(k) for i, k in enumerate(kinds)]
        self._n_kda = sum(kinds)
        # the conv taps and the output norm in f32, as they are applied
        self._conv = {i: lw["conv"].float()
                      for i, lw in enumerate(params["layers"])
                      if s.is_kda(i)}
        self._o_norm = {i: lw["o_norm"].float()
                        for i, lw in enumerate(params["layers"])
                        if s.is_kda(i)}
        self.tap = None

    # -- weights under the published names --------------------------------
    def state_dict(self) -> dict:
        """Every weight under the names of the module docstring, as views
        of the port's tensors (no copy)."""
        s, p = self.shape, self.p
        W, r = s.kda_width, s.gate_rank
        out = {"model.embed_tokens.weight": p["embed"],
               "model.norm.weight": p["norm"], "lm_head.weight": p["head"]}
        for i, lw in enumerate(p["layers"]):
            pre = f"model.layers.{i}."
            a = pre + "self_attn."
            out[pre + "input_layernorm.weight"] = lw["in_norm"]
            out[pre + "post_attention_layernorm.weight"] = lw["post_norm"]
            out[a + "o_proj.weight"] = lw["o"]
            if s.is_kda(i):
                q, k, v, fa, ga, b = lw["in_proj"].split(
                    [W, W, W, r, r, s.kda_heads])
                for n, w in (("q", q), ("k", k), ("v", v)):
                    out[a + f"{n}_proj.weight"] = w
                for n, w in zip("qkv", lw["conv"].split(W)):
                    out[a + f"{n}_conv1d.weight"] = w.unsqueeze(1)
                out[a + "f_a_proj.weight"] = fa
                out[a + "f_b_proj.weight"] = lw["f_b"]
                out[a + "g_a_proj.weight"] = ga
                out[a + "g_b_proj.weight"] = lw["g_b"]
                out[a + "b_proj.weight"] = b
                out[a + "A_log"] = lw["A_log"].view(1, 1, -1, 1)
                out[a + "dt_bias"] = lw["dt_bias"]
                out[a + "o_norm.weight"] = lw["o_norm"]
            else:
                if s.q_rank is None:
                    out[a + "q_proj.weight"] = lw["q"]
                else:
                    out[a + "q_a_proj.weight"] = lw["q_a"]
                    out[a + "q_a_layernorm.weight"] = lw["q_a_norm"]
                    out[a + "q_b_proj.weight"] = lw["q_b"]
                out[a + "kv_a_proj_with_mqa.weight"] = lw["kv_a"]
                out[a + "kv_a_layernorm.weight"] = lw["kv_norm"]
                out[a + "kv_b_proj.weight"] = lw["kv_b"]
            if not s.is_moe(i):
                out.update(_mlp_names(pre + "mlp.", lw["gate_up"],
                                      lw["down"]))
                continue
            m = pre + "block_sparse_moe."
            out[m + "gate.weight"] = lw["router"]
            out[m + "gate.e_score_correction_bias"] = lw["bias"]
            n = s.moe_inter
            for e in range(s.held):
                x = f"{m}experts.{e}."
                out[x + "w1.weight"] = lw["w13"][e, :n]
                out[x + "w3.weight"] = lw["w13"][e, n:]
                out[x + "w2.weight"] = lw["w2"][e]
            if s.shared:
                out.update(_mlp_names(m + "shared_experts.",
                                      lw["shared_gate_up"],
                                      lw["shared_down"]))
        return out

    # -- KDA ---------------------------------------------------------------
    def _kda_qkv(self, y):
        """The kernel's q, k, v (..., H, K) from the conv's output y
        (..., 3 W) f32, which they overwrite: SiLU, then q and k
        L2-normalised."""
        s = self.shape
        W, H, K = s.kda_width, s.kda_heads, s.kda_dim
        qkv = F.silu(y, inplace=True)
        qk = qkv[..., :2 * W].unflatten(-1, (2, H, K))
        qk.mul_(torch.rsqrt(qk.square().sum(-1, keepdim=True) + L2_EPS))
        q, k, v = qkv.unflatten(-1, (3, H, K)).unbind(-3)
        return q, k, v

    def _kda_gates(self, fa, bl, lw):
        """g (..., H, K) and beta (..., H), f32, from the low-rank gate
        input fa and beta's logits bl."""
        s = self.shape
        f = F.linear(fa, lw["f_b"]).float().unflatten(
            -1, (s.kda_heads, s.kda_dim))
        g = -lw["A_log"].exp()[:, None] * F.softplus(
            f + lw["dt_bias"].view(s.kda_heads, s.kda_dim))
        return g, bl.float().sigmoid()

    def _kda_out(self, o, ga, lw, i):
        """W_o (RMSNorm(o) * sigmoid(W_gb ga)), o (..., H, K) f32."""
        s = self.shape
        gate = F.linear(ga, lw["g_b"]).float().unflatten(
            -1, (s.kda_heads, s.kda_dim))
        o = F.rms_norm(o, (s.kda_dim,), self._o_norm[i], s.eps) \
            * gate.sigmoid()
        return F.linear(o.flatten(-2).to(self.dtype), lw["o"])

    def _split(self, z):
        """in_proj's output as the conv's input, W_fa x, W_ga x and
        beta's logits."""
        s = self.shape
        W, r = s.kda_width, s.gate_rank
        return z.split([3 * W, r, r, s.kda_heads], -1)

    def _kda_prefill(self, h, lw, i, lens, state, tail):
        """KDA over right-padded rows h (b, L, D), row r up to lens[r];
        writes each row's final state (b, H, K, K) and conv tail (b, 3 W,
        taps - 1)."""
        s = self.shape
        b, L, _ = h.shape
        x, fa, ga, bl = self._split(F.linear(h, lw["in_proj"]))
        x = x.float()
        c = s.conv - 1
        # the last c inputs of each row, 0 before its first
        pos = lens.long()[:, None] + torch.arange(-c, 0, device=h.device)
        rows = torch.arange(b, device=h.device)[:, None]
        last = x[rows, pos.clamp(min=0)].masked_fill_(
            (pos < 0)[..., None], 0.0)
        tail.copy_(last.transpose(1, 2))
        y = F.conv1d(x.transpose(1, 2), self._conv[i][:, None], padding=c,
                     groups=x.shape[-1])[..., :L]
        q, k, v = self._kda_qkv(y.transpose(1, 2).contiguous())
        g, beta = self._kda_gates(fa, bl, lw)
        o = kda_recurrence(q, k, v, g, beta, state, lens,
                           s.kda_dim ** -0.5, fresh=True)
        return self._kda_out(o, ga, lw, i)

    def _kda_decode(self, h, lw, i, state, tail, ones):
        """One token a row, h (B, D), through the state (B, H, K, K) and
        the conv tail (B, 3 W, taps - 1), both updated in place."""
        s = self.shape
        x, fa, ga, bl = self._split(F.linear(h, lw["in_proj"]))
        win = torch.cat((tail, x.float()[..., None]), -1)
        tail.copy_(win[..., 1:])
        y = (win * self._conv[i]).sum(-1)
        q, k, v = self._kda_qkv(y[:, None])
        g, beta = self._kda_gates(fa[:, None], bl[:, None], lw)
        o = kda_recurrence(q, k, v, g, beta, state, ones,
                           s.kda_dim ** -0.5, fresh=False)
        return self._kda_out(o[:, 0], ga, lw, i)

    # -- the block ---------------------------------------------------------
    def _prefill(self, ids, last, slots, routes) -> torch.Tensor:
        s = self.shape
        b, L = ids.shape
        latent, kda, conv = slots
        lens = (last + 1).to(torch.int32)
        x = self.p["embed"][ids]
        for i, lw in enumerate(self.p["layers"]):
            h = rms_norm(x, lw["in_norm"], s.eps)
            j = self._slot[i]
            if s.is_kda(i):
                x = x + self._kda_prefill(h, lw, i, lens, kda[j], conv[j])
            else:
                x = x + self._attn_prefill(h, lw, None, None, latent[j])
            h = rms_norm(x, lw["post_norm"], s.eps)
            x = x + self._mlp(h.view(b * L, -1), i, routes).view(b, L, -1)
        return self._head(x[torch.arange(b, device=x.device), last])

    def _decode(self, tok, pos, cache: HybridCache, routes) -> torch.Tensor:
        s = self.shape
        rows = torch.arange(cache.latent.shape[1], device=tok.device)
        keys = torch.arange(cache.latent.shape[2], device=tok.device)
        masked = (keys[None, :] > pos[:, None])[:, None]
        x = self.p["embed"][tok]
        for i, lw in enumerate(self.p["layers"]):
            h = rms_norm(x, lw["in_norm"], s.eps)
            j = self._slot[i]
            if s.is_kda(i):
                x = x + self._kda_decode(h, lw, i, cache.kda[j],
                                         cache.conv[j], cache.ones)
            else:
                x = x + self._attn_decode(h, lw, None, None,
                                          cache.latent[j], rows, pos, masked)
            h = rms_norm(x, lw["post_norm"], s.eps)
            x = x + self._mlp(h, i, routes, cache.moe[i])
        return self._head(x)

    # -- a fire's state ----------------------------------------------------
    def _cache(self, B: int, Lc: int) -> HybridCache:
        s, dev = self.shape, self.device
        return HybridCache(
            latent=torch.zeros(s.layers - self._n_kda, B, Lc,
                               s.kv_rank + s.rope, dtype=self.dtype,
                               device=dev),
            kda=torch.zeros(self._n_kda, B, s.kda_heads, s.kda_dim,
                            s.kda_dim, dtype=torch.float32, device=dev),
            conv=torch.zeros(self._n_kda, B, 3 * s.kda_width, s.conv - 1,
                             dtype=torch.float32, device=dev),
            ones=torch.ones(B, dtype=torch.int32, device=dev),
            moe=torch.zeros(s.layers, 2, B, s.hidden, dtype=self.dtype,
                            device=dev))

    def _step_for(self, B: int, Lc: int):
        step = super()._step_for(B, Lc)
        self.tap = (step.cache.moe, step.routes)
        return step

    @staticmethod
    def _slots(cache: HybridCache, r0: int, r1: int, L: int):
        return (cache.latent[:, r0:r1, :L], cache.kda[:, r0:r1],
                cache.conv[:, r0:r1])

    def _count(self, sl: list, T: int) -> None:
        super()._count(sl, T)
        s, B = self.shape, len(sl)
        count("llm.kda_tokens", self._n_kda * (sum(sl) + B * (T - 1)))
        state = 4 * B * s.kda_heads * s.kda_dim ** 2
        count("llm.kda_state_bytes", self._n_kda * state * (1 + 2 * (T - 1)))
