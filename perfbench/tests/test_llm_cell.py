"""The moonlight cell's driver, reference comparison and readers: on the
CPU at a tiny size of the model's shape, with faults planted under the
timed path; on the card at the cell's own widths (`card`)."""

import json
import time

import numpy as np
import pytest

from perfbench import harness
from perfbench.harness import Record
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import bench

CELL = "moonlight-captions-128"
# Moonlight's shape at a CPU's size: 3 layers (1 dense), 8 experts of
# which 3 a token, 2 shared, latent rank 32
TINY = dict(
    name="moonlight-tiny", hidden_size=64, num_hidden_layers=3,
    vocab_size=300, num_attention_heads=4, num_key_value_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, intermediate_size=128, moe_intermediate_size=32,
    n_routed_experts=8, num_experts_per_tok=3,
    max_position_embeddings=2048, torch_dtype="float32")
READERS = ("llm_prefill_ms", "llm_decode_step_ms", "llm_mfu_pct",
           "launches_per_fire")


def tiny_cell(seed: int = 2 ** 31 + 21):
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
                                   "route_gap"}
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def _broken_generate(real, kind: str):
    """DeepseekV3Lm.generate with one fault planted under it."""

    def generate(self, prompts, max_tokens, keep=()):
        if kind == "rows":                # each prompt answered as the next
            return real(self, prompts[1:] + prompts[:1], max_tokens, keep)
        gen = real(self, prompts, max_tokens, keep)
        for b in keep:
            if kind == "logits":
                gen.logits[b] = gen.logits[b] * 1.1
            else:                          # one token on the wrong expert
                r = gen.routes[b] = gen.routes[b].clone()
                chosen = set(r[1, -1].tolist())
                r[1, -1, 0] = next(e for e in range(8) if e not in chosen)
        return gen
    return generate


@pytest.mark.parametrize("kind", ["rows", "logits", "routes"])
def test_llm_fault_is_caught(kind, monkeypatch):
    from gstpu_torch.models.deepseek_v3 import DeepseekV3Lm
    monkeypatch.setattr(DeepseekV3Lm, "generate", _broken_generate(
        DeepseekV3Lm.generate, kind))
    rec, ok = harness.run(tiny_cell())
    assert not ok, rec.checks


def test_readers_find_nothing_on_an_untraced_run():
    cell = tiny_cell()
    cell.trace = True                  # per-layer readers, no trace taken
    rec, _ = harness.run(cell)
    line = harness.result_line(cell, rec, {"platform": "cpu"})
    assert not set(READERS) & set(line["metrics"])
    other = Record(streams=1, media_s=1.0, window=(0.0, 1.0),
                   work={"kind": "grade"}, trace={"launches": 5})
    assert all(harness.load_module(
        harness.HERE / "metrics" / f"{m}.py").read(other) is None
        for m in READERS)


def test_readers_on_a_traced_record():
    """Two traced fires: prefill and decode device times, FLOPs over
    wall time at the bf16 peak, launches a fire."""
    from perfbench import roofline_llm
    rec = Record(streams=2, media_s=3.0, window=(0.0, 10.0),
                 trace={"launches": 1000, "busy_s": 1.0, "window_s": 2.0},
                 work=dict(kind="llm", fires=2, fire_s=4.0,
                           prefill_ms=[100.0, 300.0],
                           decode_ms=[10.0, 20.0, 30.0],
                           flops=0.5 * roofline_llm.BF16_FLOPS_PER_S))
    got = {m: harness.load_module(harness.HERE / "metrics"
                                  / f"{m}.py").read(rec) for m in READERS}
    assert got == {"llm_prefill_ms": 200.0, "llm_decode_step_ms": 20.0,
                   "llm_mfu_pct": 12.5, "launches_per_fire": 500.0}


def test_captions_are_seeded_and_sized():
    from perfbench.drivers.llm_pipelines import caption, system_prompt
    spec = {"median": 48, "sigma": 0.6, "min": 16, "max": 160}
    lines = [caption(2 ** 33 + 5, i, k, spec) for i in range(64)
             for k in range(8)]
    assert lines == [caption(2 ** 33 + 5, i, k, spec) for i in range(64)
                     for k in range(8)]
    n = np.array([len(x) for x in lines])
    assert n.min() >= 16 and n.max() <= 160
    assert 40 <= np.median(n) <= 56
    assert all(x == x.strip() and x.isascii() for x in lines)
    assert len(system_prompt(384)) == 384


# -- on the card ---------------------------------------------------------

@pytest.mark.card
def test_one_request_at_full_width_through_the_element(card, tmp_path):
    """One caption through `llamatexttransform context=...` at Moonlight's
    published widths: the cached decode against the reference within
    the configuration's limits, and the fire's prefill and decode device
    intervals inside its host interval."""
    import gstpu_torch
    from gstpu_torch.utils import tracing
    from perfbench.drivers import llm_pipelines as drv
    cell = harness.load_cell(bench(), CELL, ROOT, seed=2 ** 31 + 505,
                             device=card)
    cfg = cell.config
    path = tmp_path / "moonlight"
    path.mkdir()
    (path / "config.json").write_text(json.dumps(drv.model_config(cfg)))
    gstpu_torch.init(device=card)
    p = gstpu_torch.parse_launch(drv.launch_string(
        cfg, cell.traffic, str(path), cell.seed).replace(
        drv.CONTEXT, "card-one"))
    lm = p.get_by_name("lm")
    lm.keep_logits = True
    lm.system_prompt = drv.system_prompt(384)
    p.set_state(gstpu_torch.State.PLAYING)
    assert p._error_seen is None, p._error_seen
    prog = tracing.ProgramSpans(device=True)
    prog.install()
    prog.keep(True)
    try:
        p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
            drv.caption(cell.seed, 0, 0, cell.traffic["line_tokens"])
            .encode(), pts=0, duration=3_000_000_000))
        while p.iterate():
            pass
        out = p.get_by_name("sink").pull_all()
        got = drv.logit_gaps(lm._lm.model, [lm.last_reply], cell.reference)
    finally:
        prog.keep(False)
        prog.uninstall()
        p.set_state(gstpu_torch.State.NULL)
    assert len(out) == 1 and len(out[0].to_bytes()) == 64
    print(f"one request: {got}")
    assert all(got[k] <= v for k, v in cfg["limits"].items()), got
    fire = [iv for iv in prog.intervals() if iv[2] == "llm.fire"]
    dev = prog.device_intervals()
    assert len(fire) == 1
    pre = [d for d in dev if d[2] == "llm.prefill"]
    dec = [d for d in dev if d[2] == "llm.decode"]
    assert len(pre) == 1 and len(dec) == 63
    a, b = fire[0][0], fire[0][1]
    assert all(a <= d[0] <= d[1] <= b for d in pre + dec)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_control_fails_at_the_cells_size(seed, card):
    """The program within every limit and the control (every expert
    weight rounded to fp8 e4m3) above at least one, on check_requests
    prompts of the window's shape at the published widths."""
    from perfbench.drivers import llm_pipelines as drv
    cell = harness.load_cell(bench(), CELL, ROOT, seed=seed, device=card)
    lim = cell.config["limits"]
    program, control = drv.readings(cell)
    print(f"seed {seed}: program {program} control {control}")
    assert all(program[k] <= v for k, v in lim.items()), program
    assert any(control[k] > v for k, v in lim.items()), control
