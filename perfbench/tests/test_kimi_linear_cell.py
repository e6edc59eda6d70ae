"""The kimilinear cell's driver, reference comparison and readers: on
the CPU at a tiny size of the model's layer pattern, with faults planted
under the timed path; on the card at the cell's own widths (`card`)."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.harness import Record
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import bench

CELL = "kimilinear-captions-128"
# Kimi Linear's pattern at a CPU's size: 1 dense layer, then KDA, KDA,
# KDA, MLA; 8 experts of which 4 held here, 3 a token, 1 shared
TINY = dict(
    name="kimi-linear-tiny", hidden_size=64, num_hidden_layers=5,
    vocab_size=300, num_attention_heads=4, num_key_value_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, intermediate_size=128, moe_intermediate_size=32,
    num_experts=4, router_num_experts=8, num_experts_per_token=3,
    model_max_length=2048, torch_dtype="float32",
    linear_attn_config=dict(kda_layers=[1, 2, 3], full_attn_layers=[4, 5],
                            head_dim=16, num_heads=2,
                            short_conv_kernel_size=4))
READERS = ("llm_prefill_ms", "llm_decode_step_ms", "llm_mfu_pct",
           "launches_per_fire", "kda_roofline_pct")


def tiny_cell(seed: int = 2 ** 31 + 23):
    cell = harness.load_cell(bench(), CELL, ROOT, seed=seed, seconds=4.0,
                             device="cpu", born=time.perf_counter())
    cell.config.update(TINY)
    cell.traffic.update(streams=3, warm_rounds=1, check_requests=2,
                        system_prompt_tokens=24, max_tokens=6,
                        history_size=2, line_tokens=dict(
                            median=8, sigma=0.6, min=4, max=16))
    return cell


def test_tiny_cell_runs_and_is_correct():
    cell = tiny_cell()
    rec, ok = harness.run(cell)
    line = harness.result_line(cell, rec, {"platform": "cpu"})
    assert ok and line["correct"], line["checks"]
    assert rec.attempted > 0 and rec.failed == 0
    assert set(line["checks"]) == {"logit_rel_rms", "logit_max_gap",
                                   "route_gap", "expert_rel_rms"}
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def _broken_generate(real, kind: str):
    """KimiLinearLm.generate with one fault planted under it."""

    def generate(self, prompts, max_tokens, keep=()):
        if kind == "rows":                # each prompt answered as the next
            return real(self, prompts[1:] + prompts[:1], max_tokens, keep)
        gen = real(self, prompts, max_tokens, keep)
        for b in keep:
            if kind == "logits":
                gen.logits[b] = gen.logits[b] * 1.1
            else:             # one layer's tokens each on a wrong expert
                r = gen.routes[b] = gen.routes[b].clone()
                for t in range(r.shape[1]):
                    chosen = set(r[1, t].tolist())
                    r[1, t, 0] = next(e for e in range(8)
                                      if e not in chosen)
        return gen
    return generate


@pytest.mark.parametrize("kind", ["rows", "logits", "routes"])
def test_kimi_fault_is_caught(kind, monkeypatch):
    from gstpu_torch.models.kimi_linear import KimiLinearLm
    monkeypatch.setattr(KimiLinearLm, "generate", _broken_generate(
        KimiLinearLm.generate, kind))
    rec, ok = harness.run(tiny_cell())
    assert not ok, rec.checks


def test_fp8_experts_are_caught(monkeypatch):
    """Every fire's routed experts on their weights rounded to fp8 e4m3,
    the weights as drawn again after it: the routed experts' own number
    reads it."""
    from gstpu_torch.models.kimi_linear import KimiLinearLm
    real = KimiLinearLm.generate

    def generate(self, prompts, max_tokens, keep=()):
        layers = [lw for lw in self.p["layers"] if "w13" in lw]
        drawn = [(lw["w13"], lw["w2"]) for lw in layers]
        for lw in layers:
            lw["w13"], lw["w2"] = (w.to(torch.float8_e4m3fn).to(w.dtype)
                                   for w in (lw["w13"], lw["w2"]))
        try:
            return real(self, prompts, max_tokens, keep)
        finally:
            for lw, (w13, w2) in zip(layers, drawn):
                lw["w13"], lw["w2"] = w13, w2
    monkeypatch.setattr(KimiLinearLm, "generate", generate)
    rec, ok = harness.run(tiny_cell())
    value, limit = rec.checks["expert_rel_rms"]
    assert not ok and value > limit, rec.checks


def test_expert_gap_reads_the_last_decode_step():
    """The tap holds the last decode step's expert layers: the program's
    routed experts there against the reference's, in f32, and inf where
    no decode step has run."""
    from gstpu_torch.models.kimi_linear import KimiLinearLm
    from perfbench.drivers import llm_hybrid_pipelines as drv
    cell = tiny_cell()
    model = KimiLinearLm.from_seed(drv.llm.model_config(cell.config), 3,
                                   "cpu")
    assert drv.expert_gap(model, cell.reference) == float("inf")
    model.generate([[5, 6, 7]], 1)              # a prefill alone
    assert drv.expert_gap(model, cell.reference) == float("inf")
    gen = model.generate([[5, 6, 7], [9] * 11], 4, keep=[0])
    moe, routes = model.tap
    assert moe[model.shape.dense_layers:, 1].abs().sum() > 0
    # the last step's routes are those the fire kept for its last token
    assert (routes[1:, 0] == gen.routes[0][1:, -1]).all()
    assert drv.expert_gap(model, cell.reference) < 1e-5


def test_an_unbiased_router_is_caught(monkeypatch):
    """The router choosing on its scores without the correction bias."""
    from gstpu_torch.models.deepseek_v3 import DeepseekV3Lm
    route = DeepseekV3Lm._route

    def unbiased(self, h, i):
        lw = self.p["layers"][i]
        bias = lw["bias"]
        lw["bias"] = torch.zeros_like(bias)
        try:
            return route(self, h, i)
        finally:
            lw["bias"] = bias
    monkeypatch.setattr(DeepseekV3Lm, "_route", unbiased)
    rec, ok = harness.run(tiny_cell())
    value, limit = rec.checks["route_gap"]
    assert not ok and value > limit, rec.checks


def test_a_dropped_state_is_caught(monkeypatch):
    """Every decode step starting from a zeroed KDA state."""
    from gstpu_torch.models.deepseek_v3 import DecodeStep
    step = DecodeStep.__call__

    def forgetful(self, tok):
        self.cache.kda.zero_()
        return step(self, tok)
    monkeypatch.setattr(DecodeStep, "__call__", forgetful)
    rec, ok = harness.run(tiny_cell())
    assert not ok, rec.checks


def test_readers_find_nothing_on_an_untraced_run():
    cell = tiny_cell()
    cell.trace = True                  # per-layer readers, no trace taken
    rec, _ = harness.run(cell)
    line = harness.result_line(cell, rec, {"platform": "cpu"})
    assert not set(READERS) & set(line["metrics"])
    other = Record(streams=1, media_s=1.0, window=(0.0, 1.0),
                   work={"kind": "llm", "fires": 1, "fire_s": 1.0,
                         "flops": 1.0})
    assert harness.load_module(harness.HERE / "metrics"
                               / "kda_roofline_pct.py").read(other) is None


def test_roofline_counts_by_hand():
    """Kimi-Linear-48B-A3B's cell configuration by hand: a KDA layer
    (12,288 + 256 + 32) x 2304 (in_proj) + 2 x 4096 x 128 (f_b, g_b) +
    12,288 x 4 (conv) + 2304 x 4096 (o); an MLA layer 32 x 192 x 2304 +
    576 x 2304 + 32 x 256 x 512 + 2304 x 4096; an expert layer's active
    part 8 x 64 / 256 routed experts and 1 shared of 3 x 2304 x 1024 and
    the 256-row router; the recurrence 7 x 128^2 a token and head."""
    import json

    from perfbench import roofline_kimi_linear as rk
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "kimi-linear-48b-a3b-ep4.json").read_text())
    kda = 12_576 * 2304 + 2 * 4096 * 128 + 12_288 * 4 + 2304 * 4096
    mla = 32 * 192 * 2304 + 576 * 2304 + 32 * 256 * 512 + 2304 * 4096
    expert = 3 * 2304 * 1024
    assert rk.kda_params(cfg) == kda
    assert rk.mla_params(cfg) == mla
    active = 20 * kda + 7 * mla + 3 * 2304 * 9216 \
        + 26 * ((8 * 64 / 256 + 1) * expert + 256 * 2304)
    assert rk.active_params(cfg) == pytest.approx(active, rel=1e-12)
    c = {"llm.requests": 1, "llm.prefill_tokens": 10,
         "llm.decode_tokens": 1, "llm.kda_tokens": 20 * 11,
         "llm.attn_keys": 10 * 11 // 2 + 11,
         "llm.kda_state_bytes": 20 * 32 * 128 * 128 * 4 * 3}
    want = 2 * active * 11 + 7 * 128 ** 2 * 32 * 220 \
        + 2 * 32 * 320 * 7 * 66 + 2 * 2304 * 163_840 * 2
    assert rk.model_flops(cfg, c) == pytest.approx(want, rel=1e-12)
    # prefill: 200 tokens, the state written once; decode: 20 tokens, the
    # state read and written; each the larger of its two times
    state = 20 * 32 * 128 * 128 * 4
    least = max(7 * 128 ** 2 * 32 * 200 / 67e12,
                (200 * 32 * 641 * 4 + state) / 3.35e12) \
        + max(7 * 128 ** 2 * 32 * 20 / 67e12,
              (20 * 32 * 641 * 4 + 2 * state) / 3.35e12)
    assert rk.kda_least_seconds(cfg, c) == pytest.approx(least, rel=1e-12)
    # the whole model: 98.2 GB in bf16; this card's share 27.6 GB
    emb = 2 * 163_840 * 2304
    whole = emb + 20 * kda + 7 * mla + 3 * 2304 * 9216 \
        + 26 * (257 * expert + 256 * 2304) + 27 * 2 * 2304 + 2304
    here = whole - 26 * 192 * expert
    assert round(2 * whole / 1e9, 1) == 98.2
    assert round(2 * here / 1e9, 1) == 27.6


# -- on the card ---------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_controls_at_the_cells_size(seed, card):
    """The program within every limit, and each control (the routed
    experts in fp8 e4m3, the KDA state held in bf16) above at least one,
    on check_requests prompts of the window's shape at the published
    widths."""
    from perfbench.drivers import llm_hybrid_pipelines as drv
    cell = harness.load_cell(bench(), CELL, ROOT, seed=seed, device=card)
    lim = cell.config["limits"]
    got = drv.readings(cell)
    print(f"seed {seed}: {got}")
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["fp8_experts"][k] > v for k, v in lim.items()), got
    assert any(got["bf16_state"][k] > v for k, v in lim.items()), got
