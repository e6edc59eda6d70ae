"""The harness drives every cell end to end on the CPU at small sizes,
and a fault planted under the timed path makes `correct` false."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import TRAFFIC, bench, small_cell

CELLS = [(w["name"], None) for w in bench()["workloads"]]


def test_every_cell_has_a_small_form():
    assert all(w["traffic"] in TRAFFIC for w in bench()["workloads"])


@pytest.mark.parametrize("name,traffic", CELLS)
def test_cell_runs_and_is_correct(name, traffic):
    cell = small_cell(name, traffic)
    rec, ok = harness.run(cell)
    line = harness.result_line(cell, rec, {"platform": "cpu"})
    assert ok and line["correct"], line["checks"]
    assert rec.attempted > 0 and rec.failed == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def _broken_step(real, kind: str):
    """The chain's step with one fault planted under it."""

    def chain(cfg):
        prime, step, init, n_prime, n_step = real(cfg)

        def bad(state, x, intensity, feedback, mark=None):
            new, out, met = step(state, x, intensity, feedback)
            if kind == "state_unchanged":
                return state, out, met
            out = out.clone()
            if kind == "half_batch":
                h = out.shape[0] // 2
                out[h:] = out[:h]
            elif kind == "answer_altered":
                out[:, 7] += 1e-6  # 10x the sample limit
            return new, out, met
        return prime, bad, init, n_prime, n_step
    return chain


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_audio_fault_is_caught(kind, monkeypatch):
    cell = small_cell("audiofx-fused-capacity")
    drv = cell.driver
    monkeypatch.setattr(drv, "_program_chain",
                        _broken_step(drv._program_chain, kind))
    _, ok = harness.run(cell)
    assert not ok


@pytest.mark.parametrize("n,k", [(768, 4), (96, 4), (7, 3), (2, 2)])
def test_checked_lanes_meet_every_half(n, k):
    """The checked lanes meet either contiguous half of the batch and
    both even and odd lanes, on any seed: a fault in half the batch
    cannot pass unseen."""
    from perfbench.drivers.audiofx_step import checked_lanes
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 33 + 7):
        lanes = checked_lanes(n, k, seed)
        assert len(set(lanes)) == k and all(0 <= i < n for i in lanes)
        assert min(lanes) < n // 2 <= max(lanes)
        assert {i % 2 for i in lanes} == {0, 1}


@pytest.mark.card
@pytest.mark.parametrize("kind", ["half_batch", "answer_altered"])
def test_audio_fault_is_caught_at_the_cells_size(kind, card, monkeypatch):
    """The same planted faults under the cell as it runs on the card, at
    its own lanes, over a short window."""
    cell = harness.load_cell(bench(), "audiofx-fused-capacity", ROOT,
                             seed=2 ** 31 + 404, seconds=3.0, device=card)
    drv = cell.driver
    monkeypatch.setattr(drv, "_program_chain",
                        _broken_step(drv._program_chain, kind))
    rec, ok = harness.run(cell)
    print(f"{kind} at {cell.traffic['lanes']} lanes: {rec.checks}")
    assert not ok


@pytest.mark.parametrize("kind", ["half_batch", "answer_altered"])
def test_grade_fault_is_caught(kind, monkeypatch):
    from gstpu_torch.elements.video import colorlut
    real = colorlut.apply_lut_3d

    def bad(pix, *a, **kw):
        out = real(pix, *a, **kw)
        if kind == "half_batch":       # the second half left as it came
            h = out.shape[0] // 2
            out[h:] = pix[h:]
        else:
            out.view(-1)[0] ^= 1
        return out
    monkeypatch.setattr(colorlut, "apply_lut_3d", bad)
    _, ok = harness.run(small_cell("grade4k-ctx-16"))
    assert not ok


def test_metrics_read_only_what_the_run_has():
    """A reader that finds nothing returns None, and the harness leaves
    the metric out of the line."""
    cell = small_cell("grade4k-ctx-16")
    cell.trace = True                  # per-layer readers, no trace taken
    rec, _ = harness.run(cell)
    line = harness.result_line(cell, rec, {"platform": "cpu"})
    assert "launches_per_frame" not in line["metrics"]
    assert "grade_roofline_pct" not in line["metrics"]
    assert line["metrics"]["pipeline_host_ms"]["value"] > 0
    assert rec.completed().size > 0
    assert np.all(rec.completed() >= 0)
