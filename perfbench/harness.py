"""The harness: finds a cell's files by name, runs its driver and its
readers, and builds the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in BENCHMARK.json:

* a configuration: the file that its `configs` entry names, whose
  `reference` key names `reference/<name>.py`, the plain reference;
* a traffic mix: `traffic/<traffic>.json`, whose `driver` key names
  `drivers/<driver>.py`, the general generator that reads it;
* a metric: `metrics/<name>.py`, whose `read(record)` returns the
  number, or None where the run has nothing for it to read.

A driver's `run(cell)` sets up the program, drives it for the window and
returns a `Record`; `check(cell, record)` then runs the reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gstpu")


def load_module(path: Path):
    """Import one file of the benchmark by its path."""
    name = "perfbench._" + "_".join(
        path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Cell:
    """One workload with everything it names, and the run's arguments."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    born: float = 0.0              # perf_counter at process start

    @property
    def driver(self):
        return load_module(HERE / "drivers" / f"{self.traffic['driver']}.py")

    @property
    def reference(self):
        return load_module(HERE / "reference"
                           / f"{self.config['reference']}.py")


def metric_applies(m: dict, cell: str, bench: dict) -> bool:
    """Whether `cell` reports metric `m`: its `workloads` where given,
    else every cell that reports the end-to-end metric it moves (or, for
    an end-to-end metric, every cell)."""
    if "workloads" in m:
        return cell in m["workloads"]
    moves = m.get("moves")
    if moves is None:
        return True
    return any(e["name"] == moves and metric_applies(e, cell, bench)
               for e in bench["end_to_end"])


def load_cell(bench: dict, name: str, root: Path, **run) -> Cell:
    """The cell `name` of BENCHMARK.json `bench` (at `root`)."""
    ws = [w for w in bench["workloads"] if w["name"] == name]
    if not ws:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = ws[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if metric_applies(m, name, bench)],
                per_layer=[m for m in bench["per_layer"]
                           if metric_applies(m, name, bench)],
                **run)


@dataclass
class Record:
    """What one run measured. Times are host `perf_counter` seconds; a
    buffer's `done` is when its output was complete on the device."""
    streams: int
    media_s: float                 # media seconds one buffer completes
    window: tuple                  # (start, end) of the measured window
    push: list = field(default_factory=list)
    done: list = field(default_factory=list)
    traced: tuple | None = None    # (start, end) of the traced part
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    spans: dict = field(default_factory=dict)   # host s, untraced part
    counts: dict = field(default_factory=dict)  # untraced part
    trace: dict | None = None      # timing.summarise of the traced part
    trace_buffers: int = 0         # buffers pushed in the traced part
    work: dict = field(default_factory=dict)    # roofline inputs
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    failed: int = 0
    check_s: float = 0.0           # host seconds the reference took
    state: dict = field(default_factory=dict)   # driver's, for check()

    def completed(self) -> np.ndarray:
        """Latencies (s) of the buffers pushed in the window, outside
        its traced part, that were complete before it closed."""
        p, d = np.asarray(self.push), np.asarray(self.done)
        keep = d <= self.window[1]
        if self.traced is not None:
            keep &= (p < self.traced[0]) | (p >= self.traced[1])
        return d[keep] - p[keep]

    @property
    def attempted(self) -> int:
        return len(self.push)

    @property
    def idle_pct(self) -> float | None:
        if not self.trace:
            return None
        t = self.trace
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def checks_pass(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def read_metrics(cell: Cell, rec: Record) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), each from its reader; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in cell.per_layer if cell.trace else cell.end_to_end:
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell: Cell, rec: Record, device: dict) -> dict:
    correct = checks_pass(rec.checks) and rec.failed == 0
    line = {"correct": correct, "attempted": rec.attempted,
            "failed": rec.failed, "metrics": read_metrics(cell, rec),
            "device": device}
    if cell.trace and rec.trace:
        line["device"] = dict(device, busy_s=rec.trace["busy_s"],
                              window_s=rec.trace["window_s"])
        line["breakdown"] = rec.trace["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in rec.checks.items()}
    return line


def run(cell: Cell) -> tuple[Record, bool]:
    """Drive the cell and check its outputs; (record, correct)."""
    drv = cell.driver
    rec = drv.run(cell)
    t0 = time.perf_counter()
    drv.check(cell, rec)
    rec.check_s = time.perf_counter() - t0
    return rec, checks_pass(rec.checks) and rec.failed == 0
