"""Cells of BENCHMARK.json cut to sizes a CPU test can hold."""

import json
import time

from perfbench import harness
from perfbench.tests.conftest import ROOT

# by traffic mix: the parameters cut, and the window's seconds
TRAFFIC = {
    "fused-capacity": ({"lanes": 2, "bank_rows": 5, "warm_steps": 1,
                        "check_lanes": 2, "check_steps": 2}, 1.5),
    "ctx-16": ({"warm_rounds": 2, "check_frames": 8}, 0.5),
}
CONFIG = {"grade-4k": {"width": 64, "height": 36}}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_cell(name: str, traffic: str | None = None,
               seed: int = 2 ** 31 + 11, device="cpu"):
    """Workload `name` at a small size; with `traffic`, on that mix of
    traffic/ in place of its own."""
    cell = harness.load_cell(bench(), name, ROOT, seed=seed,
                             device=device, born=time.perf_counter())
    if traffic is None:
        traffic = [w for w in bench()["workloads"]
                   if w["name"] == name][0]["traffic"]
    else:
        cell.traffic = json.loads(
            (harness.HERE / "traffic" / f"{traffic}.json").read_text())
    over, cell.seconds = TRAFFIC[traffic]
    cell.traffic.update(over)
    cell.config.update(CONFIG.get(cell.config["name"], {}))
    return cell
