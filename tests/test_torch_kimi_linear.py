"""The port's own kimi_linear model (gstpu_torch/models/kimi_linear.py),
its KDA recurrence (gstpu_torch/ops/kda.py), its plain reference
(perfbench/reference/kimi_linear.py) and llamatexttransform's
config-only path over it, on the CPU at a tiny size of Kimi Linear's
shape: 5 layers (1 dense; KDA, KDA, KDA, MLA), 2 KDA heads of 16, 8
routed experts of which 4 held here and 3 a token, 1 shared, latent
attention of rank 32 without RoPE.

(a) the reference's recurrence, with the gate equal over a head's
channels, against transformers' torch_recurrent_gated_delta_rule, and
its short conv against torch_causal_conv1d_update; (b) the port's
prefill, then decode through the latent cache and the KDA state, against
the reference's full forward pass at every generated position, ragged
rows: f32 within F32_REL, bf16 within BF16_REL on the port's experts;
(c) the state carries a changed first token to the last position;
(d) four shares of a quarter of the experts add up to the uncut
reference's expert layer; (e) the plain recurrence against a
transcription of kernels/kda.cu's steps; (f) several pipelines in one
ItemContext against each alone. Nothing is downloaded: the weights are
drawn from seeds.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import gstpu_torch
import test_torch_llm_model as llm_tests
from gstpu_torch import models
from gstpu_torch.models.kimi_linear import KimiLinearLm, KimiShape
from gstpu_torch.ops import kda
from torch_session import torch_test_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(
    model_type="kimi_linear", hidden_size=64, num_hidden_layers=5,
    vocab_size=300, num_attention_heads=4, num_key_value_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, q_lora_rank=None, intermediate_size=128,
    moe_intermediate_size=32, num_experts=4, router_num_experts=8,
    num_experts_per_token=3, num_shared_experts=1, first_k_dense_replace=1,
    num_expert_group=1, topk_group=1, moe_renormalize=True,
    routed_scaling_factor=2.446, moe_router_activation_func="sigmoid",
    mla_use_nope=True, rms_norm_eps=1e-5, hidden_act="silu",
    tie_word_embeddings=False, rope_scaling=None, model_max_length=4096,
    torch_dtype="float32", linear_attn_config=dict(
        kda_layers=[1, 2, 3], full_attn_layers=[4, 5], head_dim=16,
        num_heads=2, short_conv_kernel_size=4))
# f32: the same arithmetic in another order (the recurrence, SDPA, the
# absorbed decode, grouped products): ~1e-6 of the logits' norm (seeds
# 1-3)
F32_REL = 1e-5
# bf16 against the f32 reference on the port's experts: projections and
# hidden states rounded to bf16 through 5 layers read 1.5-2.1% (seeds
# 1-5); an expert choice that flips on rounding lies within ROUTE_GAP
BF16_REL = 0.03
ROUTE_GAP = 0.005
PROMPTS = [[(7 * n + 3 * i) % 256 for i in range(n)] for n in (9, 30, 17, 2)]


def _ref():
    spec = importlib.util.spec_from_file_location(
        "reference_kimi_linear", ROOT / "perfbench" / "reference"
        / "kimi_linear.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _ref()


def _cfg(**kw):
    return dict(TINY, **kw)


def _gaps(cfg, model, gen, prompts, own_routes=False):
    """(largest relative logit error over positions, route gap)."""
    weights, stats, worst = model.state_dict(), {}, 0.0
    for b, p in enumerate(prompts):
        want = ref.forward(cfg, weights, torch.tensor(p + gen.ids[b][:-1]),
                           routes=None if own_routes else gen.routes[b],
                           stats=stats)[len(p) - 1:]
        got = gen.logits[b]
        worst = max(worst, float(((got - want).norm(dim=-1)
                                  / want.norm(dim=-1)).max()))
    return worst, stats.get("route_gap", 0.0)


# -- (a) the reference's pieces against transformers' ------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_recurrence_matches_transformers(seed):
    """(a) With one gate a head, the gated delta rule of the reference is
    transformers' Qwen3-Next recurrence."""
    qn = pytest.importorskip(
        "transformers.models.qwen3_next.modeling_qwen3_next")
    g = torch.Generator().manual_seed(seed)
    L, H, K = 40, 3, 16
    q = ref._l2norm(torch.randn(L, H, K, generator=g))
    k = ref._l2norm(torch.randn(L, H, K, generator=g))
    v = torch.randn(L, H, K, generator=g)
    gate = -torch.rand(L, H, generator=g) * 0.5
    beta = torch.rand(L, H, generator=g)
    got = ref.recurrence(q, k, v, gate[..., None].expand(L, H, K), beta,
                         K ** -0.5)
    want, _ = qn.torch_recurrent_gated_delta_rule(
        q[None], k[None], v[None], gate[None], beta[None],
        initial_state=None, output_final_state=False)
    assert float((got - want[0]).abs().max()) < 1e-5


def test_reference_conv_matches_transformers():
    """(a) The reference's short conv (SiLU of a causal depthwise conv)
    is transformers' torch_causal_conv1d_update from a zero state."""
    qn = pytest.importorskip(
        "transformers.models.qwen3_next.modeling_qwen3_next")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(23, 12, generator=g)
    w = torch.rand(12, 4, generator=g) - 0.5
    state = torch.zeros(1, 12, 3)
    want = qn.torch_causal_conv1d_update(x.T[None], state, w,
                                         activation="silu")
    got = ref.short_conv(x, w)
    assert float((got - want[0].T).abs().max()) < 1e-6
    assert torch.equal(state[0], x[-3:].T)


# -- (b) prefill and decode against the full forward pass --------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cached_decode_matches_the_full_forward_f32(seed):
    """(b) f32: the port's prefill into the latent cache and KDA state,
    then decode through both, give the reference's logits at every
    generated position of ragged rows, on the reference's own experts."""
    cfg = _cfg()
    model = KimiLinearLm.from_seed(cfg, seed, "cpu")
    gen = model.generate(PROMPTS, 6, keep=range(len(PROMPTS)))
    rel, gap = _gaps(cfg, model, gen, PROMPTS, own_routes=True)
    assert rel < F32_REL, rel
    for b in range(len(PROMPTS)):
        assert gen.ids[b] == gen.logits[b].argmax(-1).tolist()
    assert _gaps(cfg, model, gen, PROMPTS)[1] == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cached_decode_matches_the_full_forward_bf16(seed):
    """(b) bf16, routed to the port's experts: within BF16_REL, and the
    port's choices within ROUTE_GAP of the reference's own."""
    cfg = _cfg(torch_dtype="bfloat16")
    model = KimiLinearLm.from_seed(cfg, seed, "cpu")
    gen = model.generate(PROMPTS, 8, keep=range(len(PROMPTS)))
    rel, gap = _gaps(cfg, model, gen, PROMPTS)
    assert rel < BF16_REL and gap < ROUTE_GAP, (rel, gap)


def test_a_fire_equals_each_prompt_alone():
    """Each row's state stops at its own last token: a prompt's reply
    and logits in a fire of ragged rows are those it gets alone."""
    model = KimiLinearLm.from_seed(_cfg(), 4, "cpu")
    together = model.generate(PROMPTS, 5, keep=range(len(PROMPTS)))
    for b, p in enumerate(PROMPTS):
        alone = model.generate([p], 5, keep=[0])
        assert alone.ids[0] == together.ids[b]
        assert torch.allclose(alone.logits[0], together.logits[b],
                              rtol=1e-5, atol=1e-5)


# -- (c) the state carries information --------------------------------------

def test_the_state_carries_the_first_token():
    """(c) With KDA layers only, the last position's logits of a
    30-token prompt move by far more than F32_REL when its first token
    changes: only the recurrent state spans that distance."""
    cfg = _cfg(linear_attn_config=dict(TINY["linear_attn_config"],
                                       kda_layers=[1, 2, 3, 4, 5],
                                       full_attn_layers=[]))
    model = KimiLinearLm.from_seed(cfg, 5, "cpu")
    a = PROMPTS[1]
    b = [(a[0] + 101) % 256] + a[1:]
    gen = model.generate([a, b], 1, keep=[0, 1])
    la, lb = gen.logits[0][0], gen.logits[1][0]
    assert float((la - lb).norm() / la.norm()) > 1000 * F32_REL


# -- (d) the expert share ----------------------------------------------------

def test_four_shares_add_up_to_the_whole_layer():
    """(d) Four cards of two experts each (each share's experts moved to
    [0, 2) by a rotation of the router's rows), the shared expert and
    the rest counted once, add up to the uncut reference's expert layer
    of eight."""
    whole = _cfg(num_experts=8, router_num_experts=8)
    model = KimiLinearLm.from_seed(whole, 6, "cpu")
    weights = model.state_dict()
    i = 2                                   # an expert layer
    h = torch.randn(37, 64, generator=torch.Generator().manual_seed(6))

    def get(name):
        return weights[name].float()

    want = ref.experts(whole, h, get, f"model.layers.{i}.block_sparse_moe.")
    lw = model.p["layers"][i]
    shares = []
    for q in range(4):
        part = dict(lw, router=lw["router"].roll(-2 * q, 0),
                    bias=lw["bias"].roll(-2 * q, 0),
                    w13=lw["w13"][2 * q:2 * q + 2],
                    w2=lw["w2"][2 * q:2 * q + 2])
        params = dict(model.p, layers=[dict(x) for x in model.p["layers"]])
        params["layers"][i] = part
        card = KimiLinearLm(_cfg(num_experts=2, router_num_experts=8),
                            params)
        shares.append(card._moe(h, i, None))
    shared = ref._mlp(h, get, f"model.layers.{i}.block_sparse_moe."
                      "shared_experts.")
    got = sum(shares) - 3 * shared
    assert float((got - want).norm() / want.norm()) < F32_REL
    # and one share alone is the reference given the same share
    share = ref.experts(_cfg(num_experts=2, router_num_experts=8), h, get,
                        f"model.layers.{i}.block_sparse_moe.")
    assert float((shares[0] - share).norm() / share.norm()) < F32_REL


def test_absent_experts_are_not_computed():
    """Pairs routed to experts held elsewhere take no rows: the held
    pairs counter reads the pairs whose expert is below `num_experts`,
    of top_k at every position and expert layer."""
    from gstpu_torch.utils import tracing
    model = KimiLinearLm.from_seed(_cfg(), 1, "cpu")
    prog = tracing.ProgramSpans()
    prog.install()
    try:
        gen = model.generate([PROMPTS[1]], 3, keep=[0])
    finally:
        prog.uninstall()
    routes = gen.routes[0][1:]              # (expert layers, positions, k)
    held = prog.snapshot()["counters"]["llm.expert_pairs_held"]
    assert held == int((routes < 4).sum()) < routes.numel()
    assert int((routes >= 4).sum()) > 0


# -- (e) the plain form against the kernel's steps ---------------------------

def kernel_steps(q, k, v, g, beta, state, lens, scale: float, fresh: bool):
    """kernels/kda.cu's arithmetic in numpy f32, the columns side by
    side: a thread holds K/4 rows of one column (32 at K = 128); each
    product rounds on its own and each __fmaf_rn once (a product exact
    in f64, one rounding of the sum); a sum over rows is a slab's terms
    in order, then the two xor shuffles ((slab 0 + slab 1) + (slab 2 +
    slab 3)). Returns (o, state) as numpy arrays."""
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):
        return (f64(a) * f64(b) + f64(c)).astype(f32)

    q, k, v, g, beta = (np.asarray(x, f32) for x in (q, k, v, g, beta))
    rows, L, H, K = q.shape
    slab = K // 4
    S_all = np.zeros((rows, H, K, K), f32) if fresh \
        else np.array(state, f32)
    o = np.zeros((rows, L, H, K), f32)

    def row_sum(part):
        return (part[0] + part[1]) + (part[2] + part[3])

    for r in range(rows):
        for h in range(H):
            S = S_all[r, h]
            for t in range(min(int(lens[r]), L)):
                e = np.exp(g[r, t, h])
                kk = k[r, t, h]
                qq = q[r, t, h] * f32(scale)
                bk = f32(beta[r, t, h]) * kk
                part = []
                for s0 in range(0, K, slab):
                    acc = np.zeros(K, f32)
                    for i in range(s0, s0 + slab):
                        S[i] = S[i] * e[i]
                        acc = fma(S[i], kk[i], acc)
                    part.append(acc)
                u = v[r, t, h] - row_sum(part)
                part = []
                for s0 in range(0, K, slab):
                    acc = np.zeros(K, f32)
                    for i in range(s0, s0 + slab):
                        S[i] = fma(bk[i], u, S[i])
                        acc = fma(S[i], qq[i], acc)
                    part.append(acc)
                o[r, t, h] = row_sum(part)
    return o, S_all


@pytest.mark.parametrize("fresh", [True, False])
def test_plain_recurrence_follows_the_kernels_steps(fresh):
    """(e) kda_recurrence's plain form and a transcription of
    kernels/kda.cu's arithmetic (lane slabs, fused multiply-adds, the
    shuffle sums) agree at the kernel's head width on ragged rows; past
    a row's length its output is 0 and its state stays as the row left
    it."""
    g = torch.Generator().manual_seed(11)
    R, L, H, K = 3, 7, 2, kda.HEAD_DIM
    q = torch.nn.functional.normalize(torch.randn(R, L, H, K, generator=g),
                                      dim=-1)
    k = torch.nn.functional.normalize(torch.randn(R, L, H, K, generator=g),
                                      dim=-1)
    v = torch.randn(R, L, H, K, generator=g)
    gate = -torch.rand(R, L, H, K, generator=g)
    beta = torch.rand(R, L, H, generator=g)
    state = torch.randn(R, H, K, K, generator=g) * 0.1
    lens = torch.tensor([7, 3, 1], dtype=torch.int32)
    s1 = state.clone()
    o = kda.kda_recurrence(q, k, v, gate, beta, s1, lens, K ** -0.5, fresh)
    o2, s2 = kernel_steps(q, k, v, gate, beta, state.numpy(),
                                    lens.numpy(), K ** -0.5, fresh)
    assert np.abs(o.numpy() - o2).max() <= 1e-6 * np.abs(o2).max()
    assert np.abs(s1.numpy() - s2).max() <= 1e-6 * np.abs(s2).max()
    assert float(o[1, 3:].abs().max()) == 0.0


def test_plain_recurrence_is_the_references():
    """The plain form from a zero state is the reference's recurrence,
    row by row, each up to its own length."""
    g = torch.Generator().manual_seed(12)
    R, L, H, K = 2, 9, 2, 8
    q = ref._l2norm(torch.randn(R, L, H, K, generator=g))
    k = ref._l2norm(torch.randn(R, L, H, K, generator=g))
    v = torch.randn(R, L, H, K, generator=g)
    gate = -torch.rand(R, L, H, K, generator=g)
    beta = torch.rand(R, L, H, generator=g)
    lens = torch.tensor([9, 4], dtype=torch.int32)
    state = torch.empty(R, H, K, K)
    o = kda.kda_recurrence(q, k, v, gate, beta, state, lens, K ** -0.5,
                           True)
    for r, n in enumerate(lens.tolist()):
        want = ref.recurrence(q[r, :n], k[r, :n], v[r, :n], gate[r, :n],
                              beta[r, :n], K ** -0.5)
        assert torch.allclose(o[r, :n], want, rtol=1e-5, atol=1e-6)


# -- (f) the element ----------------------------------------------------------

def _model_dir(tmp_path, **kw) -> str:
    d = tmp_path / "kimi-tiny"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(dict(TINY, **kw)))
    return str(d)


def test_three_pipelines_in_one_context_match_each_alone(tmp_path):
    """(f) One fire a round for three streams through a config-only
    kimi_linear directory gives each stream the replies, pts, durations
    and (within f32's reordering) the logits it gets alone."""
    path = _model_dir(tmp_path)
    together = llm_tests._run(path, [0, 1, 2], "kimi-three")
    for i in range(3):
        alone = llm_tests._run(path, [i], f"kimi-alone-{i}")
        assert together[0][i] == alone[0][0]
        for a, b in zip(together[1][i], alone[1][0]):
            assert float((a - b).norm() / b.norm()) < F32_REL
    for k, (text, pts, dur) in enumerate(together[0][0]):
        assert (pts, dur) == (k * 3_000_000_000, 3_000_000_000)
        assert len(text) == 7 and all(32 <= c < 127 for c in text)


def test_config_only_directory_selects_the_model(tmp_path):
    """A config-only kimi_linear directory loads KimiLinearLm; a sampled
    temperature is refused as for deepseek_v3."""
    path = _model_dir(tmp_path)
    assert models.config_only(path)["model_type"] == "kimi_linear"
    assert models.port_model("kimi_linear") is KimiLinearLm
    gstpu_torch.init(device="cpu")
    p = gstpu_torch.parse_launch(
        'appsrc caps="text/x-raw, format=utf8" ! llamatexttransform '
        f'name=lm model-path={path} temp=0.8 context=kimi-temp ! appsink')
    p.set_state(gstpu_torch.State.PLAYING)
    assert "greedily" in p._error_seen.fields["text"]
    p.set_state(gstpu_torch.State.NULL)


@pytest.mark.parametrize("key,value", [
    ("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
    ("linear_attn_config", dict(TINY["linear_attn_config"],
                                full_attn_layers=[5]))])
def test_shape_refuses_what_it_does_not_implement(key, value):
    with pytest.raises(ValueError, match="kimi_linear"):
        KimiShape.of(_cfg(**{key: value}))


def test_kda_counters():
    """`llm.kda_tokens` is every real token through every KDA layer, and
    `llm.kda_state_bytes` a write of each row's state at prefill and a
    read and a write each decode step."""
    from gstpu_torch.utils import tracing
    model = KimiLinearLm.from_seed(_cfg(), 1, "cpu")
    prog = tracing.ProgramSpans()
    prog.install()
    try:
        model.generate(PROMPTS, 4)
    finally:
        prog.uninstall()
    c = prog.snapshot()["counters"]
    n = sum(len(p) for p in PROMPTS) + 4 * 3
    assert c["llm.kda_tokens"] == 3 * n
    assert c["llm.kda_state_bytes"] == 3 * 4 * 4 * 2 * 16 * 16 * (1 + 2 * 3)
    assert c["llm.attn_keys"] == sum(m * (m + 1) // 2 + 3 * m + 6
                                     for m in map(len, PROMPTS))


def test_state_dict_names_and_views():
    """Every weight under the published names, as views of the port's
    tensors; only the held experts are there."""
    model = KimiLinearLm.from_seed(_cfg(), 1, "cpu")
    sd = model.state_dict()
    a = "model.layers.0.self_attn."
    assert sd[a + "q_conv1d.weight"].shape == (32, 1, 4)
    assert sd[a + "A_log"].shape == (1, 1, 2, 1)
    assert sd[a + "f_a_proj.weight"].shape == (16, 64)
    assert "model.layers.3.self_attn.kv_a_proj_with_mqa.weight" in sd
    m = "model.layers.1.block_sparse_moe."
    assert sd[m + "gate.weight"].shape == (8, 64)
    assert m + "experts.3.w1.weight" in sd and m + "experts.4.w1.weight" \
        not in sd
    assert sd[a + "q_proj.weight"].data_ptr() \
        == model.p["layers"][0]["in_proj"].data_ptr()


def test_reference_imports_nothing_of_the_program():
    text = (ROOT / "perfbench" / "reference" / "kimi_linear.py").read_text()
    assert "gstpu" not in text and "jax" not in text and "triton" not in text
