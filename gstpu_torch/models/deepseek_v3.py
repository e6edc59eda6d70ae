"""The causal LM of `deepseek_v3` configurations (DeepSeek-V3, Moonlight)
on torch ops, serving a batch of streams in one forward pass.

The block follows the DeepSeek-V3 report (arXiv:2412.19437) as
transformers' `models/deepseek_v3/modeling_deepseek_v3.py` computes it:

* multi-head latent attention: the query from `q_proj` (or the q-LoRA
  pair `q_a_proj`, its norm, `q_b_proj`), the latent
  `c = rmsnorm(kv_a(h)[:kv_lora_rank])` and one rotary key shared by the
  heads, `kv_a(h)[kv_lora_rank:]`; RoPE on the rotary dims in DeepSeek's
  interleaved order where `rope_interleave` (transformers' default);
  softmax scale 1/sqrt(qk_nope_head_dim + qk_rope_head_dim), no YaRN;
  the two latent norms take eps 1e-6, as transformers builds them;
* a dense MLP in the first `first_k_dense_replace` layers, then routed
  experts: sigmoid scores of f32 router logits, the top-k of score plus
  the correction bias (within the best `topk_group` of `n_group` groups),
  weighted by the unbiased scores, normalised (`norm_topk_prob`) and
  times `routed_scaling_factor`, then rounded to the config's dtype and
  summed in f32 (transformers keeps the weights in f32); plus the shared
  experts as one MLP;
* RMSNorm in f32 with one rounding; hidden states and weights in the
  config's `torch_dtype`.

A fire (`generate`) serves B ragged prompts. The prompts are sorted by
length; row r of the latent cache, (c, k_rope) = kv_lora_rank +
qk_rope_head_dim values a token and layer, holds the r-th shortest.
Prefill runs runs of adjacent rows, right-padded to their longest and
chunked to `PREFILL_TOKENS`, through causal flash attention with keys
and values expanded from the latent (a padded position is never attended
by a real one; its cache entries are overwritten or masked). Greedy
decode then feeds every row one token a step through the cache in the
absorbed form: W_UK folded into the query, W_UV into the output, so a
step expands nothing. The expert layer sorts its (token, expert) pairs
by expert and runs each projection as one grouped matrix product over
all experts (`torch._grouped_mm`): two launches, whatever the number of
experts. No decode step waits for the card: positions, routing offsets
and masks are device tensors, so on CUDA a step is one captured graph
(`DecodeStep`), and the host reads the generated ids once, after the
last step.

Spans `llm.fire` (fire number), `llm.prefill` and `llm.decode` (device,
one a step), `llm.moe_route` (host, one an expert layer a step);
counters `llm.requests`, `llm.prefill_tokens`, `llm.decode_tokens`,
`llm.pad_tokens` (padding of the prefill chunks) and `llm.attn_keys`
(query-key pairs attended, prefill and decode).
"""

from __future__ import annotations

import json
import os
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from gstpu_torch.core.device import tf32_off
from gstpu_torch.utils.tracing import count, span

PREFILL_TOKENS = 32_768     # padded tokens in one prefill chunk at most
CACHE_BUCKET = 512          # cache positions come in runs of this many
INIT_STD = 0.02             # seeded weights: normal(0, INIT_STD)
BIAS_STD = 0.05             # seeded expert correction bias
LATENT_EPS = 1e-6           # kv_a_layernorm and q_a_layernorm
WEIGHT_SUFFIXES = (".safetensors", ".bin", ".pt", ".pth", ".gguf")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def config_only(path: str) -> dict | None:
    """The config of a `deepseek_v3` model directory that holds a
    config.json and no weights; None for any other directory."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        return None
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg.get("model_type") != "deepseek_v3":
        return None
    if any(n.endswith(WEIGHT_SUFFIXES) for n in os.listdir(path)):
        return None
    return cfg


@dataclass(frozen=True)
class Shape:
    """The sizes and settings of a deepseek_v3 config that the forward
    pass reads; `of` refuses what it does not implement."""
    hidden: int
    layers: int
    vocab: int
    heads: int
    nope: int
    rope: int
    v_dim: int
    kv_rank: int
    q_rank: int | None
    inter: int
    moe_inter: int
    experts: int
    shared: int
    top_k: int
    dense_layers: int
    n_group: int
    topk_group: int
    norm_topk: bool
    routed_scale: float
    eps: float
    theta: float
    max_pos: int
    interleave: bool
    dtype: torch.dtype

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        want = {"model_type": "deepseek_v3", "hidden_act": "silu",
                "scoring_func": "sigmoid", "topk_method": "noaux_tc",
                "rope_scaling": None, "attention_bias": False,
                "tie_word_embeddings": False}
        for k, v in want.items():
            if cfg.get(k, v) != v:
                raise ValueError(f"deepseek_v3: {k}={cfg[k]!r} is not "
                                 f"implemented (only {v!r})")
        dtype = _DTYPES.get(cfg.get("torch_dtype", "bfloat16"))
        if dtype is None:
            raise ValueError(f"deepseek_v3: torch_dtype "
                             f"{cfg['torch_dtype']!r} is not implemented")
        return cls(
            hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
            vocab=cfg["vocab_size"], heads=cfg["num_attention_heads"],
            nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
            v_dim=cfg["v_head_dim"], kv_rank=cfg["kv_lora_rank"],
            q_rank=cfg.get("q_lora_rank"),
            inter=cfg["intermediate_size"],
            moe_inter=cfg["moe_intermediate_size"],
            experts=cfg["n_routed_experts"],
            shared=cfg.get("n_shared_experts") or 0,
            top_k=cfg["num_experts_per_tok"],
            dense_layers=cfg.get("first_k_dense_replace", 0),
            n_group=cfg.get("n_group") or 1,
            topk_group=cfg.get("topk_group") or 1,
            norm_topk=bool(cfg.get("norm_topk_prob", True)),
            routed_scale=float(cfg.get("routed_scaling_factor", 1.0)),
            eps=float(cfg.get("rms_norm_eps", 1e-6)),
            theta=float(cfg.get("rope_theta", 10000.0)),
            max_pos=cfg.get("max_position_embeddings", 4096),
            interleave=bool(cfg.get("rope_interleave", True)),
            dtype=dtype)

    @property
    def qk_dim(self) -> int:
        return self.nope + self.rope

    def is_moe(self, layer: int) -> bool:
        return layer >= self.dense_layers


def seeded_params(s: Shape, seed: int, device) -> dict:
    """Every weight from `seed`, in the port's layout: matrices
    normal(0, INIT_STD) in the config's dtype, norms at 1, the correction
    bias normal(0, BIAS_STD) in f32. Experts are stacked: `w13` (E, 2 *
    moe_inter, hidden) holds gate then up, `w2` (E, hidden, moe_inter);
    dense and shared MLPs hold gate and up as one matrix."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)

    def mat(*shape):
        return torch.empty(shape, dtype=s.dtype, device=device).normal_(
            0.0, INIT_STD, generator=g)

    def ones(n):
        return torch.ones(n, dtype=s.dtype, device=device)

    D, H = s.hidden, s.heads
    p = {"embed": mat(s.vocab, D), "layers": []}
    for i in range(s.layers):
        lw = {"in_norm": ones(D), "post_norm": ones(D)}
        if s.q_rank is None:
            lw["q"] = mat(H * s.qk_dim, D)
        else:
            lw["q_a"] = mat(s.q_rank, D)
            lw["q_a_norm"] = ones(s.q_rank)
            lw["q_b"] = mat(H * s.qk_dim, s.q_rank)
        lw["kv_a"] = mat(s.kv_rank + s.rope, D)
        lw["kv_norm"] = ones(s.kv_rank)
        lw["kv_b"] = mat(H * (s.nope + s.v_dim), s.kv_rank)
        lw["o"] = mat(D, H * s.v_dim)
        if s.is_moe(i):
            lw["router"] = mat(s.experts, D)
            lw["bias"] = torch.empty(s.experts, dtype=torch.float32,
                                     device=device).normal_(
                0.0, BIAS_STD, generator=g)
            lw["w13"] = mat(s.experts, 2 * s.moe_inter, D)
            lw["w2"] = mat(s.experts, D, s.moe_inter)
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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim in one fused op (f32 inside, one
    rounding to x's dtype; transformers rounds before the weight too)."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleave: bool) -> torch.Tensor:
    """RoPE on the last dim d: x cos + rotate_half(x) sin, with `sin`
    given signed as (-sin, sin) over the halves, so that rotate_half is
    a roll by d/2; with `interleave` the pairs (0, 1), (2, 3) ... are
    first laid out as halves, as DeepSeek's weights expect."""
    if interleave:
        x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return torch.addcmul(x * cos, x.roll(x.shape[-1] // 2, -1), sin)


def _swiglu(h: torch.Tensor, gate_up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    gu = F.linear(h, gate_up)
    n = gu.shape[-1] // 2
    return F.linear(F.silu(gu[..., :n]) * gu[..., n:], down)


def grouped_experts(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                    offs: torch.Tensor) -> torch.Tensor:
    """Rows of `x` sorted by expert through their experts' SwiGLU MLPs:
    rows offs[e-1]:offs[e] go through expert e (offs: int32 running ends).
    Two grouped matrix products over every expert."""
    gu = torch._grouped_mm(x, w13.transpose(1, 2), offs=offs)
    n = gu.shape[-1] // 2
    a = F.silu(gu[:, :n]) * gu[:, n:]
    return torch._grouped_mm(a, w2.transpose(1, 2), offs=offs)


@dataclass
class Generation:
    """What a fire made: each prompt's generated ids, in the callers'
    order; for each kept prompt, on the device, the logits (max_tokens,
    vocab) f32 at the positions that chose them and the experts chosen
    at every position of the prompt and the reply fed back, (layers,
    prompt + max_tokens - 1, top_k), -1 in dense layers."""
    ids: list
    logits: dict
    routes: dict


class DeepseekV3Lm:
    """A deepseek_v3 causal LM on one device (the device its parameters
    lie on)."""

    # shared by every element that loads the same directory and seed
    _loaded: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

    def __init__(self, config: dict, params: dict):
        self.config = config
        self.shape = s = Shape.of(config)
        self.p = params
        self.device = params["embed"].device
        self.dtype = s.dtype
        self.sm_scale = s.qk_dim ** -0.5
        self.fires = 0
        self._step = None           # the persistent captured DecodeStep
        self._expert_ids = torch.arange(s.experts, device=self.device)
        inv = 1.0 / (s.theta ** (torch.arange(
            0, s.rope, 2, dtype=torch.int64, device=self.device).float()
            / s.rope))
        pos = torch.arange(s.max_pos, device=self.device).float()
        freqs = torch.outer(pos, inv)
        self._cos = torch.cat((freqs, freqs), -1).cos().to(s.dtype)
        self._sin = torch.cat((-freqs.sin(), freqs.sin()), -1).to(s.dtype)
        # the routers in f32, as their logits are computed
        self._routers = [lw["router"].float() if "router" in lw else None
                         for lw in params["layers"]]

    @classmethod
    def from_seed(cls, config: dict, seed: int,
                  device) -> "DeepseekV3Lm":
        return cls(config, seeded_params(Shape.of(config), seed, device))

    @classmethod
    def load(cls, path: str, config: dict, seed: int,
             device) -> "DeepseekV3Lm":
        """The model of a config-only directory with weights from
        `seed`, shared with every caller that holds it for the same
        directory, seed and device."""
        key = (os.path.realpath(path), seed, str(torch.device(device)))
        model = cls._loaded.get(key)
        if model is None:
            model = cls.from_seed(config, seed, device)
            cls._loaded[key] = model
        return model

    # -- weights under transformers' names ---------------------------------
    def state_dict(self) -> dict:
        """Every weight under transformers' DeepseekV3ForCausalLM names,
        as views of the port's tensors (no copy)."""
        s, p = self.shape, self.p
        out = {"model.embed_tokens.weight": p["embed"],
               "model.norm.weight": p["norm"], "lm_head.weight": p["head"]}
        for i, lw in enumerate(p["layers"]):
            pre = f"model.layers.{i}."
            a = pre + "self_attn."
            out[pre + "input_layernorm.weight"] = lw["in_norm"]
            out[pre + "post_attention_layernorm.weight"] = lw["post_norm"]
            if s.q_rank is None:
                out[a + "q_proj.weight"] = lw["q"]
            else:
                out[a + "q_a_proj.weight"] = lw["q_a"]
                out[a + "q_a_layernorm.weight"] = lw["q_a_norm"]
                out[a + "q_b_proj.weight"] = lw["q_b"]
            out[a + "kv_a_proj_with_mqa.weight"] = lw["kv_a"]
            out[a + "kv_a_layernorm.weight"] = lw["kv_norm"]
            out[a + "kv_b_proj.weight"] = lw["kv_b"]
            out[a + "o_proj.weight"] = lw["o"]
            m = pre + "mlp."
            if not s.is_moe(i):
                out.update(_mlp_names(m, lw["gate_up"], lw["down"]))
                continue
            out[m + "gate.weight"] = lw["router"]
            out[m + "gate.e_score_correction_bias"] = lw["bias"]
            for e in range(s.experts):
                out.update(_mlp_names(f"{m}experts.{e}.", lw["w13"][e],
                                      lw["w2"][e]))
            if s.shared:
                out.update(_mlp_names(m + "shared_experts.",
                                      lw["shared_gate_up"],
                                      lw["shared_down"]))
        return out

    # -- the block ---------------------------------------------------------
    def _query(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        if "q" in lw:
            return F.linear(h, lw["q"])
        return F.linear(rms_norm(F.linear(h, lw["q_a"]), lw["q_a_norm"],
                                 LATENT_EPS), lw["q_b"])

    def _latent(self, h, lw, cos, sin):
        """(c, k_rope): the normed latent and the rotated shared key."""
        s = self.shape
        c, kr = F.linear(h, lw["kv_a"]).split([s.kv_rank, s.rope], -1)
        return (rms_norm(c, lw["kv_norm"], LATENT_EPS),
                apply_rope(kr, cos, sin, s.interleave))

    def _attn_prefill(self, h, lw, cos, sin, slot):
        """Causal attention over right-padded rows h (b, L, D); writes
        the rows' latent cache into `slot` (b, L, rank + rope)."""
        s = self.shape
        b, L, _ = h.shape
        q = self._query(h, lw).view(b, L, s.heads, s.qk_dim)
        q[..., s.nope:] = apply_rope(q[..., s.nope:], cos[:, None],
                                     sin[:, None], s.interleave)
        c, k_rot = self._latent(h, lw, cos, sin)
        slot.copy_(torch.cat((c, k_rot), -1))
        kv = F.linear(c, lw["kv_b"]).view(b, L, s.heads, s.nope + s.v_dim)
        k_nope, v = kv.split([s.nope, s.v_dim], -1)
        q = q.transpose(1, 2)
        k = torch.cat((k_nope, k_rot[:, :, None].expand(
            b, L, s.heads, s.rope)), -1).transpose(1, 2)
        v = v.transpose(1, 2)
        if s.v_dim < s.qk_dim:         # one head size for flash attention
            v = F.pad(v, (0, s.qk_dim - s.v_dim))
        # flash attention, whose kernels serve every length: cuDNN's
        # backend builds a plan for each new (rows, length) shape, which
        # a fire of ragged prompts meets in seconds
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=self.sm_scale)
        o = o[..., :s.v_dim].transpose(1, 2).reshape(b, L, -1)
        return F.linear(o, lw["o"])

    def _attn_decode(self, h, lw, cos, sin, cache, rows, pos, masked):
        """One token a row, h (B, D), at positions `pos` through the
        latent cache (B, Lc, rank + rope) in the absorbed form."""
        s = self.shape
        B = h.shape[0]
        q = self._query(h, lw).view(B, s.heads, s.qk_dim)
        q_nope, q_rot = q.split([s.nope, s.rope], -1)
        q_rot = apply_rope(q_rot, cos[:, None], sin[:, None], s.interleave)
        c, k_rot = self._latent(h, lw, cos, sin)
        cache.index_put_((rows, pos), torch.cat((c, k_rot), -1))
        kv_b = lw["kv_b"].view(s.heads, s.nope + s.v_dim, s.kv_rank)
        w_uk, w_uv = kv_b.split([s.nope, s.v_dim], 1)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
        scores = torch.bmm(torch.cat((q_lat, q_rot), -1),
                           cache.transpose(1, 2)).float() * self.sm_scale
        probs = scores.masked_fill_(masked, float("-inf")).softmax(-1)
        o_lat = torch.bmm(probs.to(self.dtype), cache[..., :s.kv_rank])
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
        return F.linear(o.transpose(0, 1).reshape(B, -1), lw["o"])

    def _route(self, h: torch.Tensor, i: int):
        """(expert of each (token, slot) pair, its weight), (T, top_k),
        in layer i."""
        s, lw = self.shape, self.p["layers"][i]
        scores = F.linear(h.float(), self._routers[i]).sigmoid()
        choice = scores + lw["bias"]
        if s.n_group > 1:
            T = choice.shape[0]
            grouped = choice.view(T, s.n_group, -1)
            best = grouped.topk(2, dim=-1)[0].sum(-1).topk(
                s.topk_group, dim=-1, sorted=False)[1]
            keep = torch.zeros(T, s.n_group, dtype=torch.bool,
                               device=h.device).scatter_(1, best, True)
            choice = choice.masked_fill(
                ~keep[:, :, None].expand_as(grouped).reshape(T, -1), 0.0)
        idx = choice.topk(s.top_k, dim=-1, sorted=False)[1]
        w = scores.gather(1, idx)
        if s.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * s.routed_scale

    def _moe(self, h: torch.Tensor, i: int, routes) -> torch.Tensor:
        """Routed and shared experts of layer i over tokens h (T, D);
        the chosen experts go into routes[i] (T, top_k) where given."""
        s, lw = self.shape, self.p["layers"][i]
        with span("llm.moe_route"):
            idx, w = self._route(h, i)
            if routes is not None:
                routes[i].copy_(idx)
            flat = idx.flatten()
            order = flat.argsort(stable=True)
            offs = torch.searchsorted(flat[order], self._expert_ids,
                                      right=True).to(torch.int32)
        y = grouped_experts(h[order // s.top_k], lw["w13"], lw["w2"], offs)
        # back to (token, slot) order, then each token's weighted sum
        back = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        routed = torch.bmm(w.to(h.dtype).unsqueeze(1),
                           y[back].view(h.shape[0], s.top_k, -1)).squeeze(1)
        if s.shared:
            routed = routed + _swiglu(h, lw["shared_gate_up"],
                                      lw["shared_down"])
        return routed

    def _mlp(self, h: torch.Tensor, i: int, routes) -> torch.Tensor:
        if self.shape.is_moe(i):
            return self._moe(h, i, routes)
        lw = self.p["layers"][i]
        return _swiglu(h, lw["gate_up"], lw["down"])

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(rms_norm(x, self.p["norm"], self.shape.eps),
                        self.p["head"])

    def _prefill(self, ids, last, slots, routes) -> torch.Tensor:
        """Rows ids (b, L) right-padded; the logits (b, V) at each row's
        last position `last` (b,); slots[i] (b, L, rank + rope) takes
        layer i's latent cache, routes (layers, b * L, top_k) the chosen
        experts where given."""
        s = self.shape
        b, L = ids.shape
        cos, sin = self._cos[:L], self._sin[:L]
        x = self.p["embed"][ids]
        for i, lw in enumerate(self.p["layers"]):
            h = rms_norm(x, lw["in_norm"], s.eps)
            x = x + self._attn_prefill(h, lw, cos, sin, slots[i])
            h = rms_norm(x, lw["post_norm"], s.eps)
            x = x + self._mlp(h.view(b * L, -1), i, routes).view(b, L, -1)
        return self._head(x[torch.arange(b, device=x.device), last])

    def _decode(self, tok, pos, cache, routes) -> torch.Tensor:
        """Token tok[r] of each row r at position pos[r] through the
        latent cache (layers, B, Lc, rank + rope), which it extends; the
        logits (B, V); routes (layers, B, top_k) takes the chosen
        experts."""
        s = self.shape
        rows = torch.arange(cache.shape[1], device=tok.device)
        keys = torch.arange(cache.shape[2], device=tok.device)
        masked = (keys[None, :] > pos[:, None])[:, None]
        cos, sin = self._cos[pos], self._sin[pos]
        x = self.p["embed"][tok]
        for i, lw in enumerate(self.p["layers"]):
            h = rms_norm(x, lw["in_norm"], s.eps)
            x = x + self._attn_decode(h, lw, cos, sin, cache[i], rows, pos,
                                      masked)
            h = rms_norm(x, lw["post_norm"], s.eps)
            x = x + self._mlp(h, i, routes)
        return self._head(x)

    # -- a fire ------------------------------------------------------------
    @staticmethod
    def chunks(lens: list, budget: int = PREFILL_TOKENS) -> list:
        """Runs (r0, r1) of ascending `lens` whose rows, padded to the
        run's longest, hold at most `budget` tokens (a row alone may hold
        more)."""
        out, r0 = [], 0
        for r in range(1, len(lens) + 1):
            if r == len(lens) or (r + 1 - r0) * lens[r] > budget:
                out.append((r0, r))
                r0 = r
        return out

    def _step_for(self, B: int, Lc: int) -> "DecodeStep":
        """The decode step of B rows over a zeroed latent cache of at
        least Lc positions, in runs of CACHE_BUCKET. On CUDA one captured
        step and its cache persist and serve every fire of B rows that
        fits (a shorter fire masks the positions it does not use); a
        fire of another B or of more positions replaces them. Elsewhere
        a new step a fire."""
        s = self.shape
        Lc = min(-(-Lc // CACHE_BUCKET) * CACHE_BUCKET, s.max_pos)
        step = self._step
        if step is not None and step.cache.shape[1] == B \
                and step.cache.shape[2] >= Lc:
            return step
        self._step = None                 # free before the new cache
        step = DecodeStep(self, torch.zeros(
            s.layers, B, Lc, s.kv_rank + s.rope, dtype=self.dtype,
            device=self.device), graph=self.device.type == "cuda")
        if step.graph:
            self._step = step
        return step

    @torch.inference_mode()
    def generate(self, prompts: list, max_tokens: int,
                 keep=()) -> Generation:
        """Greedy replies of `max_tokens` ids to every prompt (sequences
        of ids), in one prefill and max_tokens - 1 decode steps; keeps
        the logits and the chosen experts of the prompts whose indices
        are in `keep`."""
        s = self.shape
        B, T = len(prompts), max_tokens
        prompts = [np.asarray(p, dtype=np.int64).reshape(-1)
                   for p in prompts]
        lens = [p.size for p in prompts]
        if min(lens) < 1 or T < 1:
            raise ValueError("deepseek_v3: an empty prompt or reply")
        if max(lens) + T - 1 > s.max_pos:
            raise ValueError(f"deepseek_v3: {max(lens)} prompt tokens and "
                             f"{T} more pass max_position_embeddings "
                             f"{s.max_pos}")
        order = sorted(range(B), key=lens.__getitem__)   # row -> prompt
        row_of = {b: r for r, b in enumerate(order)}
        sl = [lens[b] for b in order]
        dev = self.device
        step = self._step_for(B, sl[-1] + T - 1)
        out = torch.empty(B, T, dtype=torch.int64, device=dev)
        kept_rows = [row_of[b] for b in keep]
        kept = routes = None
        moe = slice(s.dense_layers, s.layers)
        if kept_rows:
            kept = torch.empty(len(kept_rows), T, s.vocab, device=dev)
            routes = [torch.full((s.layers, sl[r] + T - 1, s.top_k), -1,
                                 device=dev) for r in kept_rows]
        self.fires += 1
        with span("llm.fire", self.fires), tf32_off():
            count("llm.requests", B)
            count("llm.prefill_tokens", sum(sl))
            count("llm.decode_tokens", B * (T - 1))
            count("llm.attn_keys", sum(n * (n + 1) // 2 + (T - 1) * n
                                       + T * (T - 1) // 2 for n in sl))
            with span("llm.prefill", device=True):
                for r0, r1 in self.chunks(sl):
                    L = sl[r1 - 1]
                    count("llm.pad_tokens", (r1 - r0) * L - sum(sl[r0:r1]))
                    ids = np.zeros((r1 - r0, L), np.int64)
                    for j, r in enumerate(range(r0, r1)):
                        ids[j, :sl[r]] = prompts[order[r]]
                    last = torch.tensor([n - 1 for n in sl[r0:r1]])
                    mine = [(j, r) for j, r in enumerate(kept_rows)
                            if r0 <= r < r1]
                    chunk_routes = torch.empty(
                        s.layers, (r1 - r0) * L, s.top_k, dtype=torch.int64,
                        device=dev) if mine else None
                    logits = self._prefill(torch.from_numpy(ids).to(dev),
                                           last.to(dev),
                                           step.cache[:, r0:r1, :L],
                                           chunk_routes)
                    out[r0:r1, 0] = logits.argmax(-1)
                    for j, r in mine:
                        kept[j, 0] = logits[r - r0]
                        routes[j][moe, :sl[r]] = chunk_routes.view(
                            s.layers, r1 - r0, L, -1)[moe, r - r0, :sl[r]]
            step.start(torch.tensor(sl, device=dev))
            kept_idx = torch.tensor(kept_rows, dtype=torch.int64,
                                    device=dev)
            for t in range(1, T):
                with span("llm.decode", device=True):
                    logits = step(out[:, t - 1])
                    out[:, t] = logits.argmax(-1)
                    if kept is not None:
                        kept[:, t] = logits[kept_idx]
                        for j, r in enumerate(kept_rows):
                            routes[j][moe, sl[r] + t - 1] = \
                                step.routes[moe, r]
            ids = out.cpu().tolist()
        return Generation(
            ids=[ids[row_of[b]] for b in range(B)],
            logits={b: kept[j] for j, b in enumerate(keep)}
            if kept is not None else {},
            routes={b: routes[j] for j, b in enumerate(keep)}
            if routes is not None else {})


class DecodeStep:
    """One greedy decode step of every row through a latent cache
    (layers, B, Lc, rank + rope): `start(pos)` sets the rows' positions,
    then each call feeds one token a row at them, returns the logits
    (B, V) and moves the positions on; `routes` (layers, B, top_k) holds
    the step's chosen experts. With `graph` the step is captured as a
    CUDA graph at its first call and replayed after (one launch from the
    host a step); its inputs and outputs are then static tensors."""

    def __init__(self, model: DeepseekV3Lm, cache: torch.Tensor,
                 graph: bool = False):
        s = model.shape
        B, dev = cache.shape[1], cache.device
        # the model keeps its steps: a weak reference leaves no cycle
        self.model, self.cache = weakref.ref(model), cache
        self.tok = torch.zeros(B, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(B, dtype=torch.int64, device=dev)
        self.routes = torch.zeros(s.layers, B, s.top_k, dtype=torch.int64,
                                  device=dev)
        self.graph = graph
        self._captured = None
        self.logits = None

    def start(self, pos: torch.Tensor) -> None:
        self.pos.copy_(pos)

    def _run(self) -> torch.Tensor:
        return self.model()._decode(self.tok, self.pos, self.cache,
                                    self.routes)

    def __call__(self, tok: torch.Tensor) -> torch.Tensor:
        self.tok.copy_(tok)
        if not self.graph:
            logits = self._run()
        else:
            if self._captured is None:
                self._capture()
            self._captured.replay()
            logits = self.logits
        self.pos += 1
        return logits

    def _capture(self) -> None:
        """Run the step once on a side stream (it writes the cache entry
        that the replay writes again), then capture it."""
        side = torch.cuda.Stream(self.cache.device)
        side.wait_stream(torch.cuda.current_stream(self.cache.device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(self.cache.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.logits = self._run()
        self._captured = g


def _mlp_names(prefix: str, gate_up: torch.Tensor,
               down: torch.Tensor) -> dict:
    n = gate_up.shape[0] // 2
    return {prefix + "gate_proj.weight": gate_up[:n],
            prefix + "up_proj.weight": gate_up[n:],
            prefix + "down_proj.weight": down}
