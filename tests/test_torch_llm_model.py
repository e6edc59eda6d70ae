"""The port's own deepseek_v3 model (gstpu_torch/models/deepseek_v3.py),
its plain reference (reference/deepseek_v3.py) and llamatexttransform's
config-only path and `context`, on the CPU at a tiny size of Moonlight's
shape: 3 layers (1 dense), 8 routed experts of which 3 a token, 2 shared,
latent attention of rank 32; and the roofline counts of
perfbench/roofline_llm.py against a count by hand at Moonlight's sizes.

(a) the reference against transformers' DeepseekV3ForCausalLM with the
same weights, f32, 1e-5 relative; (b) the port's prefill and cached
absorbed decode against the reference's full forward pass: f32 within
1e-5, bf16 within BF16_REL (routed to the port's experts); (c) the
grouped expert layer against a loop over the experts; (d) three
pipelines in one DeviceContext against each alone; (e) the roofline
counts. Nothing is downloaded: the weights are drawn from seeds.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import gstpu_torch
from gstpu_torch.models import deepseek_v3 as dv
from torch_session import torch_test_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(
    model_type="deepseek_v3", hidden_size=64, num_hidden_layers=3,
    vocab_size=300, num_attention_heads=4, num_key_value_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, q_lora_rank=None, intermediate_size=128,
    moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
    num_experts_per_tok=3, first_k_dense_replace=1, n_group=1,
    topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.446,
    scoring_func="sigmoid", topk_method="noaux_tc", rms_norm_eps=1e-5,
    rope_theta=50000, rope_scaling=None, max_position_embeddings=2048,
    hidden_act="silu", attention_bias=False, tie_word_embeddings=False,
    torch_dtype="float32")
# variants of the tiny shape: the q-LoRA branch, group-limited routing,
# RoPE without DeepSeek's interleaving
VARIANTS = {"moonlight": {}, "q_lora": {"q_lora_rank": 24},
            "groups": {"n_group": 2, "topk_group": 1},
            "no_interleave": {"rope_interleave": False}}
# f32: the same arithmetic in another order (SDPA, the absorbed decode,
# grouped products): a few ulp of the logits' norm
F32_REL = 1e-5
# bf16 against the f32 reference on the port's experts: weights and
# hidden states rounded to bf16 through 3 layers read ~0.7% (seeds 1-3);
# an expert choice that flips on rounding lies within ROUTE_GAP of a tie
BF16_REL = 0.02
ROUTE_GAP = 0.005
PROMPTS = [[(7 * n + 3 * i) % 256 for i in range(n)] for n in (9, 30, 17)]


def _ref():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "reference_deepseek_v3", ROOT / "reference" / "deepseek_v3.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _ref()


def _cfg(variant="moonlight", **kw):
    return dict(TINY, **VARIANTS[variant], **kw)


def _compare(cfg, model, gen, prompts):
    """(largest relative logit error over positions, route gap)."""
    weights, stats, worst = model.state_dict(), {}, 0.0
    for b, p in enumerate(prompts):
        want = ref.forward(cfg, weights, torch.tensor(p + gen.ids[b][:-1]),
                           routes=gen.routes[b], stats=stats)[len(p) - 1:]
        got = gen.logits[b]
        worst = max(worst, float(((got - want).norm(dim=-1)
                                  / want.norm(dim=-1)).max()))
    return worst, stats.get("route_gap", 0.0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_matches_transformers(variant, seed):
    """(a) The plain reference and transformers' DeepseekV3ForCausalLM,
    loaded strictly with the port's weights, give the same f32 logits."""
    tf = pytest.importorskip("transformers")
    cfg = _cfg(variant)
    model = dv.DeepseekV3Lm.from_seed(cfg, seed, "cpu")
    weights = model.state_dict()
    hf_cfg = tf.DeepseekV3Config(**{
        k: v for k, v in cfg.items()
        if k not in ("model_type", "torch_dtype", "scoring_func",
                     "topk_method")})
    hf = tf.DeepseekV3ForCausalLM(hf_cfg).eval()
    hf.load_state_dict({k: v.clone() for k, v in weights.items()},
                       strict=True)
    ids = torch.tensor(PROMPTS[1] + PROMPTS[2])
    with torch.no_grad():
        want = hf(ids[None]).logits[0]
    got = ref.forward(cfg, weights, ids)
    assert float((got - want).norm() / want.norm()) < F32_REL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cached_decode_matches_the_full_forward_f32(variant, seed):
    """(b) f32: the port's prefill into the latent cache and its absorbed
    decode give the reference's logits at every generated position, and
    choose the reference's own experts, with no routes given to it."""
    cfg = _cfg(variant)
    model = dv.DeepseekV3Lm.from_seed(cfg, seed, "cpu")
    gen = model.generate(PROMPTS, 6, keep=range(3))
    weights = model.state_dict()
    for b, p in enumerate(PROMPTS):
        want = ref.forward(cfg, weights, torch.tensor(
            p + gen.ids[b][:-1]))[len(p) - 1:]
        got = gen.logits[b]
        assert float(((got - want).norm(dim=-1)
                      / want.norm(dim=-1)).max()) < F32_REL
        assert gen.ids[b] == got.argmax(-1).tolist()
    assert _compare(cfg, model, gen, PROMPTS)[1] == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cached_decode_matches_the_full_forward_bf16(seed):
    """(b) bf16, routed to the port's experts: within BF16_REL, and the
    port's expert choices within ROUTE_GAP of the reference's own."""
    cfg = _cfg(torch_dtype="bfloat16")
    model = dv.DeepseekV3Lm.from_seed(cfg, seed, "cpu")
    gen = model.generate(PROMPTS, 8, keep=range(3))
    rel, gap = _compare(cfg, model, gen, PROMPTS)
    assert rel < BF16_REL and gap < ROUTE_GAP, (rel, gap)


def test_reference_reads_a_flipped_choice():
    """The route gap is 0 on the reference's own choice, the margin on a
    choice that swaps its k-th expert for the next, inf on a repeat."""
    cfg = _cfg()
    model = dv.DeepseekV3Lm.from_seed(cfg, 4, "cpu")
    gen = model.generate(PROMPTS[:1], 4, keep=[0])
    routes = gen.routes[0].clone()
    ids = torch.tensor(PROMPTS[0] + gen.ids[0][:-1])
    stats = {}
    ref.forward(cfg, model.state_dict(), ids, routes=routes, stats=stats)
    assert stats["route_gap"] == 0.0
    # swap one of layer 2's chosen experts at position 0 for an unchosen
    # one: the gap is then positive
    chosen = set(routes[2, 0].tolist())
    other = next(e for e in range(8) if e not in chosen)
    routes[2, 0, 0] = other
    ref.forward(cfg, model.state_dict(), ids, routes=routes, stats=stats)
    assert stats["route_gap"] > 0.0
    routes[2, 0, 1] = other
    ref.forward(cfg, model.state_dict(), ids, routes=routes, stats=stats)
    assert math.isinf(stats["route_gap"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts,rows", [(8, 24), (64, 768), (64, 5)])
def test_grouped_experts_match_a_loop(dtype, experts, rows):
    """(c) Two grouped products over every expert give each expert's
    SwiGLU MLP on its own rows, empty experts included."""
    g = torch.Generator().manual_seed(experts + rows)
    D, n = 64, 48
    w13 = (torch.randn(experts, 2 * n, D, generator=g) * 0.1).to(dtype)
    w2 = (torch.randn(experts, D, n, generator=g) * 0.1).to(dtype)
    x = torch.randn(rows, D, generator=g).to(dtype)
    e = torch.randint(0, experts, (rows,), generator=g).sort().values
    offs = torch.searchsorted(e, torch.arange(experts),
                              right=True).to(torch.int32)
    got = dv.grouped_experts(x, w13, w2, offs)
    want = torch.empty_like(got)
    for j in range(experts):
        r = e == j
        gu = x[r] @ w13[j].T
        want[r] = (torch.nn.functional.silu(gu[:, :n]) * gu[:, n:]) \
            @ w2[j].T
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


def test_chunks_hold_the_budget():
    lens = [3, 5, 5, 8, 9, 20, 40]
    runs = dv.DeepseekV3Lm.chunks(lens, budget=24)
    assert runs == [(0, 3), (3, 5), (5, 6), (6, 7)]
    assert [r for a, b in runs for r in range(a, b)] == list(range(7))
    assert all((b - a) * lens[b - 1] <= 24 or b - a == 1 for a, b in runs)


def test_config_only_directory(tmp_path):
    """A config.json of deepseek_v3 with no weights selects the port's
    model; weights beside it, or another model_type, do not."""
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    assert dv.config_only(str(tmp_path)) == TINY
    (tmp_path / "model.safetensors").write_bytes(b"")
    assert dv.config_only(str(tmp_path)) is None
    other = tmp_path / "gpt2"
    other.mkdir()
    (other / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    assert dv.config_only(str(other)) is None
    with pytest.raises(ValueError, match="scoring_func"):
        dv.Shape.of(dict(TINY, scoring_func="softmax"))


def _model_dir(tmp_path, **kw) -> str:
    d = tmp_path / "moonlight-tiny"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(dict(TINY, **kw)))
    return str(d)


LINES = [[b"hello there", b"second line here", b"x"],
         [b"a much longer line of caption text", b"ok", b"third"],
         [b"zz", b"what is it", b"end of show"]]


def _run(path, streams, context):
    """Each stream's three lines through its own pipeline, every pipeline
    in `context` (None: alone); (replies with pts and duration, logits
    of each reply) per stream."""
    gstpu_torch.init(device="cpu")
    ctx = f" context={context}" if context else ""
    pipes = [gstpu_torch.parse_launch(
        'appsrc name=src caps="text/x-raw, format=utf8" ! '
        f'llamatexttransform name=lm model-path={path} temp=0 seed=5 '
        f'max-tokens=7 history-size=2 system-prompt=rewrite{ctx} ! '
        'appsink name=out') for _ in streams]
    for p in pipes:
        p.get_by_name("lm").keep_logits = True
        p.set_state(gstpu_torch.State.PLAYING)
        assert p._error_seen is None, p._error_seen
    outs = [[] for _ in pipes]
    logits = [[] for _ in pipes]
    for k in range(3):
        for i, p in zip(streams, pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                LINES[i][k], pts=k * 3_000_000_000, duration=3_000_000_000))
            while p.iterate():
                pass
        for j, p in enumerate(pipes):
            outs[j] += [(b.to_bytes(), b.pts, b.duration)
                        for b in p.get_by_name("out").pull_all()]
            logits[j].append(p.get_by_name("lm").last_reply.logits)
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run(timeout=60)
        p.set_state(gstpu_torch.State.NULL)
    return outs, logits


def test_three_pipelines_in_one_context_match_each_alone(tmp_path):
    """(d) One fire a round for three streams gives each stream the
    replies, pts, durations and (within f32's reordering) the logits it
    gets alone; a reply of n tokens is n printable bytes."""
    path = _model_dir(tmp_path)
    together = _run(path, [0, 1, 2], "llm-three")
    for i in range(3):
        alone = _run(path, [i], f"llm-alone-{i}")
        assert together[0][i] == alone[0][0]
        for a, b in zip(together[1][i], alone[1][0]):
            assert float((a - b).norm() / b.norm()) < F32_REL
    for k, (text, pts, dur) in enumerate(together[0][0]):
        assert (pts, dur) == (k * 3_000_000_000, 3_000_000_000)
        assert len(text) == 7 and all(32 <= c < 127 for c in text)


def test_port_model_without_context_matches_the_context(tmp_path):
    """The config-only path without `context` serves each buffer alone
    with the same replies as one stream in a context."""
    path = _model_dir(tmp_path)
    gstpu_torch.init(device="cpu")
    p = gstpu_torch.parse_launch(
        'appsrc name=src caps="text/x-raw, format=utf8" ! '
        f'llamatexttransform model-path={path} temp=0 seed=5 max-tokens=7 '
        'history-size=2 system-prompt=rewrite ! appsink name=out')
    p.set_state(gstpu_torch.State.PLAYING)
    for k, line in enumerate(LINES[1]):
        p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
            line, pts=k * 3_000_000_000, duration=3_000_000_000))
    p.get_by_name("src").end_of_stream()
    p.run(timeout=60)
    got = [(b.to_bytes(), b.pts, b.duration)
           for b in p.get_by_name("out").pull_all()]
    p.set_state(gstpu_torch.State.NULL)
    assert got == _run(path, [1], "llm-one")[0][0]


@pytest.mark.parametrize("launch,message", [
    ("temp=0.8 context=c1", "greedily"),
    ("temp=0 context=c2 model-path=NONE", "context batching")])
def test_port_path_refusals(tmp_path, launch, message):
    """The port's model refuses sampling; `context` refuses a model that
    is not a config-only deepseek_v3 directory."""
    path = _model_dir(tmp_path)
    other = tmp_path / "gpt2"
    other.mkdir()
    (other / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    launch = launch.replace("NONE", str(other))
    if "model-path" not in launch:
        launch += f" model-path={path}"
    gstpu_torch.init(device="cpu")
    p = gstpu_torch.parse_launch(
        'appsrc name=src caps="text/x-raw, format=utf8" ! '
        f'llamatexttransform {launch} ! appsink name=out')
    p.set_state(gstpu_torch.State.PLAYING)
    assert p._error_seen is not None
    assert message in p._error_seen.fields["text"]
    p.set_state(gstpu_torch.State.NULL)


def test_eos_serves_a_queued_prompt_alone(tmp_path):
    """A stream that reaches EOS with a prompt queued in the context
    gets its reply from a fire of its own; the others fire without it."""
    path = _model_dir(tmp_path)
    gstpu_torch.init(device="cpu")
    pipes = [gstpu_torch.parse_launch(
        'appsrc name=src caps="text/x-raw, format=utf8" ! '
        f'llamatexttransform model-path={path} temp=0 seed=5 max-tokens=5 '
        'context=llm-eos ! appsink name=out') for _ in range(2)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
    a, b = pipes
    a.get_by_name("src").push_buffer(gstpu_torch.Buffer(b"only me", pts=0))
    while a.iterate():
        pass
    assert a.get_by_name("out").pull_all() == []     # waits for b
    a.get_by_name("src").end_of_stream()
    a.run(timeout=60)
    got = a.get_by_name("out").pull_all()
    assert len(got) == 1 and len(got[0].to_bytes()) == 5
    b.get_by_name("src").push_buffer(gstpu_torch.Buffer(b"then me", pts=0))
    while b.iterate():
        pass
    assert len(b.get_by_name("out").pull_all()) == 1
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)


def test_reference_copy_in_the_benchmark_is_the_reference():
    """perfbench/reference/moonlight.py is reference/deepseek_v3.py."""
    assert (ROOT / "perfbench" / "reference" / "moonlight.py").read_text() \
        == (ROOT / "reference" / "deepseek_v3.py").read_text()


def test_reference_imports_nothing_of_the_program():
    text = (ROOT / "reference" / "deepseek_v3.py").read_text()
    assert "gstpu" not in text and "jax" not in text and "triton" not in text


MOONLIGHT = json.loads((ROOT / "perfbench" / "configs"
                        / "moonlight-16b-a3b.json").read_text())


def test_roofline_counts_by_hand():
    """(e) Moonlight-16B-A3B by hand: attention 16*192*2048 (q) +
    576*2048 (kv_a) + 16*256*512 (kv_b) + 2048*2048 (o) = 13,762,560 a
    layer; the dense MLP 3*2048*11264; an expert layer's active part 6
    routed experts and 2 shared of 3*2048*1408 and the 64-row router."""
    from perfbench import roofline_llm as rl
    assert rl.attention_params(MOONLIGHT) == 13_762_560
    assert rl.expert_params(MOONLIGHT) == 8_650_752
    active = 27 * 13_762_560 + 3 * 2048 * 11264 \
        + 26 * (8 * 8_650_752 + 64 * 2048)
    assert rl.active_params(MOONLIGHT) == active == 2_243_559_424
    # one request of 10 tokens, 2 generated: 11 tokens through the
    # layers, 10*11/2 + 11 pairs, the head for 1 + 1 positions
    pairs = 10 * 11 // 2 + 11
    want = 2 * active * 11 + 2 * 16 * (192 + 128) * pairs \
        + 2 * 2048 * 163840 * 2
    assert rl.model_flops(MOONLIGHT, 1, 10, 1, pairs) == want
    # a decode step of 128 rows: 64 (1 - (58/64)^128) experts touched in
    # expectation, 1,000 cached positions a row
    b = rl.decode_step_bytes(MOONLIGHT, 128, 128_000)
    touched = 64 * (1 - (58 / 64) ** 128)
    weights = 27 * 13_762_560 + 3 * 2048 * 11264 \
        + 26 * ((touched + 2) * 8_650_752 + 64 * 2048) \
        + 163840 * 2048 + 128 * 2048
    cache = 27 * 576 * (128_000 + 128)
    assert b == pytest.approx(2 * (weights + cache), rel=1e-6)


def test_attn_keys_counter_counts_pairs():
    """The model's `llm.attn_keys` counter is the causal pairs of the
    prefill and of every decode step."""
    from gstpu_torch.utils import tracing
    model = dv.DeepseekV3Lm.from_seed(TINY, 1, "cpu")
    prog = tracing.ProgramSpans()
    prog.install()
    try:
        model.generate(PROMPTS, 4)
    finally:
        prog.uninstall()
    c = prog.snapshot()["counters"]
    lens = [len(p) for p in PROMPTS]
    assert c["llm.attn_keys"] == sum(n * (n + 1) // 2 + n + 1 + n + 2
                                     + n + 3 for n in lens)
    assert c["llm.prefill_tokens"] == sum(lens)
    assert c["llm.decode_tokens"] == 3 * 3
    assert c["llm.requests"] == 3
    assert c["llm.pad_tokens"] == 3 * max(lens) - sum(lens)
    sums = prog.snapshot()["calls"]
    assert sums["llm.fire"] == 1 and sums["llm.prefill"] == 1
    assert sums["llm.decode"] == 3
    assert sums["llm.moe_route"] == 2 * (1 + 3)


def test_the_model_goes_with_its_last_element(tmp_path):
    """A pipeline set to NULL frees the model its context shared: ~32 GB
    at Moonlight's size, which the next model on the card needs."""
    import weakref
    path = _model_dir(tmp_path)
    gstpu_torch.init(device="cpu")
    p = gstpu_torch.parse_launch(
        'appsrc name=src caps="text/x-raw, format=utf8" ! '
        f'llamatexttransform name=lm model-path={path} temp=0 '
        'context=llm-free ! appsink name=out')
    p.set_state(gstpu_torch.State.PLAYING)
    p.get_by_name("src").push_buffer(gstpu_torch.Buffer(b"hello", pts=0))
    while p.iterate():
        pass
    model = weakref.ref(p.get_by_name("lm")._lm.model)
    p.set_state(gstpu_torch.State.NULL)
    assert model() is None
