"""The benchmark of gstpu_torch: one run of one cell on the card(s) of
this machine, printed as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. It reads BENCHMARK.json there, sets up
the cell from the seed, drives it for `--seconds` and checks what the
timed path produced against the plain reference in perfbench/reference.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read over a profiled part of the
window. The numbers compared with the reference and their limits are the
last lines on standard error and the last key of the line.

It exits without a result where there is no CUDA card, fewer cards than
the cell asks for, or where JAX or the JAX package is loaded.
"""

import time

T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


BORN = T_ENTRY - process_age()


def fixed_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout, so that
    only a checkout's first run builds; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BUILD / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    sys.path.insert(0, str(ROOT))
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        return fail(f"no {bench_path}")
    from perfbench import harness
    cell = harness.load_cell(json.loads(bench_path.read_text()),
                             args.workload, ROOT, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device="cuda", born=BORN)
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found")
    torch.set_num_threads(1)
    from perfbench.timing import PHASES, phase
    phase("start and imports")

    rec, _ = harness.run(cell)
    stages, t = [], BORN
    for name, end in PHASES:
        stages.append(f"{name} {end - t:.3f}")
        t = end
    print(f"setup stages (s): {', '.join(stages)}; check "
          f"{rec.check_s:.3f}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded modules of JAX or the JAX package: {bad}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    line = harness.result_line(cell, rec, device)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
