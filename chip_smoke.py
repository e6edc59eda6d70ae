#!/usr/bin/env python3
"""Drive the gstpu_torch port on one CUDA card, end to end.

Run from the repository root:  python3 chip_smoke.py

1. builds the port's CUDA kernels from the sources in the checkout;
2. holds each kernel against its plain PyTorch version on the same
   inputs: hsv_filter_u8 and the u8 lut3d_trilinear bit for bit over a
   4096x4096 frame holding every 24-bit colour once, the u16
   lut3d_trilinear within 1 LSB on a seeded 4K RGBA64 frame;
3. runs the main path, the 4K `videotestsrc ! hsvfilter ! colorlut !
   appsink` pipeline, through parse_launch on the card with every
   kernel's launch count set to 0 just before, and checks every frame
   against the same pipeline run on the CPU with the plain versions,
   then times the source alone and the upload of one frame;
4. runs four device-resident `appsrc ! hsvfilter ! colorlut ! appsink`
   pipelines fed CUDA tensors, their frames pulled every round;
5. times each kernel per 4K frame (median of 30 launches, CUDA events,
   L2 flushed before each) beside its plain version, the bytes bound
   and, for the LUT, torch.nn.functional.grid_sample as a yardstick.

It prints the card's name and power limit, one JSON line of kernels and
last `{"ok": true, "device": {...}}`. Any failed phase raises, and the
script then exits non-zero without that last line; so does a machine
without CUDA or a directory without the gstpu_torch package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

W, H = 3840, 2160
SEED = 20261016
HSV_PARAMS = [(12.0, 1.1, 0.0, 0.9, 0.02),
              (-47.5, 0.8, 0.05, 1.3, -0.1),
              (200.0, 1.5, -0.2, 0.7, 0.1)]
LAYOUTS = {"RGBA": (0, 1, 2), "BGRA": (2, 1, 0), "ARGB": (1, 2, 3),
           "RGB": (0, 1, 2)}
LUT_DOMAIN = (np.array([0.9, 1.1, 1.05], np.float32),
              np.array([0.02, -0.03, 0.01], np.float32))
PIPELINE_FRAMES = 8
N_TIMED = 30
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per pixel, counted roughly from the kernel sources (an
# FMA counts 2): hsv_filter_u8 ~60; lut3d_trilinear 3 channels x (7 for
# the domain + 7 lerps of 3 + 5 for the rounding) = 99. Both kernels
# stay bound by bytes with several times this count.
OPS_PER_PIXEL = {"hsv_filter_u8": 60, "lut3d_trilinear": 99}
ROOT = Path(__file__).resolve().parent


def log(*args) -> None:
    print(*args, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.cpu().to(torch.int32) - b.cpu().to(torch.int32))
               .abs().max())


def colour_cube(layout: str, device) -> torch.Tensor:
    """4096x4096 frame holding every 24-bit colour once, in `layout`;
    the fourth channel, where there is one, holds a byte pattern."""
    p = torch.arange(1 << 24, device=device, dtype=torch.int32)
    rgb = [p & 255, (p >> 8) & 255, p >> 16]
    C = len(layout)
    chans = [(p * 7 + 3) & 255] * C
    for k, i in enumerate(LAYOUTS[layout]):
        chans[i] = rgb[k]
    return torch.stack(chans, -1).to(torch.uint8).reshape(4096, 4096, C)


def seeded_table(rng, n: int = 33) -> np.ndarray:
    """A non-identity n^3 grading table with values past [0, 1]."""
    return (rng.random((n, n, n, 3), dtype=np.float32) * 1.2
            - 0.1).astype(np.float32)


def write_cube(path: Path, rng, n: int = 33) -> None:
    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    table = np.stack([r, gg, b], -1) \
        + rng.normal(0.0, 0.03, (n, n, n, 3)).astype(np.float32)
    lines = [f"LUT_3D_SIZE {n}", "DOMAIN_MIN 0.0 0.0 0.0",
             "DOMAIN_MAX 1.0 1.0 1.0"]
    lines += [f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in table.reshape(-1, 3)]
    path.write_text("\n".join(lines) + "\n")


def time_ms(fn, flush: torch.Tensor, n: int = N_TIMED) -> float:
    """Median device time of fn() over n runs, after 3 warm-up runs.
    Each run follows an L2 flush that keeps the card busy while the
    host enqueues fn, so the events time the device work alone."""
    times = []
    for i in range(n + 3):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_pipeline(gstpu_torch, launch: str, device: str) -> list:
    gstpu_torch.init(device=device)
    p = gstpu_torch.parse_launch(launch)
    p.set_state(gstpu_torch.State.PLAYING)
    p.run(timeout=600)
    out = p.get_by_name("out").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import gstpu_torch
    from gstpu_torch.kernels import build_all
    from gstpu_torch.ops.hsv import (HSV_KERNEL, hsv_filter_frame,
                                     hsv_filter_frame_ref)
    from gstpu_torch.ops.lut import (LUT_KERNEL, apply_lut_3d,
                                     apply_lut_3d_ref, lut_from_numpy)
    kernels = [HSV_KERNEL, LUT_KERNEL]
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.monotonic()
    build_all(kernels)
    log(f"[build] {time.monotonic() - t0:.1f} s for "
        f"{', '.join(k.name for k in kernels)}")
    for k in kernels:
        log(f"[build] {k.name}: {k.library_path.name}, "
            f"nvcc {k.build_seconds}")
        for line in k.compiler_output.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # 2. kernels against their plain versions
    err = {k.name: 0 for k in kernels}
    for layout, rgb_idx in LAYOUTS.items():
        cube = colour_cube(layout, dev)
        cube_cpu = cube.cpu()
        for params in HSV_PARAMS:
            got = hsv_filter_frame(cube, rgb_idx, *params)
            want = hsv_filter_frame_ref(cube_cpu, rgb_idx, *params)
            e = max_abs_err(got, want)
            log(f"[check] hsv_filter_u8 {layout} {params}: max |err| {e}")
            if e != 0:
                raise AssertionError("hsv_filter_u8 differs from its "
                                     "plain version")
            err["hsv_filter_u8"] = max(err["hsv_filter_u8"], e)
        inplace = cube.clone()
        hsv_filter_frame(inplace, rgb_idx, *HSV_PARAMS[0], out=inplace)
        if not torch.equal(inplace, hsv_filter_frame(cube, rgb_idx,
                                                     *HSV_PARAMS[0])):
            raise AssertionError("hsv_filter_u8 in place differs")
    torch.cuda.synchronize()

    rng = np.random.default_rng(SEED)
    table_np = seeded_table(rng)
    lut_dev = lut_from_numpy(table_np, *LUT_DOMAIN, dev)
    lut_cpu = lut_from_numpy(table_np, *LUT_DOMAIN, "cpu")
    cube = colour_cube("RGBA", dev)
    got = apply_lut_3d(cube, lut_dev.table, *LUT_DOMAIN)
    want = apply_lut_3d_ref(cube.cpu(), lut_cpu.table, *LUT_DOMAIN)
    e = max_abs_err(got, want)
    log(f"[check] lut3d_trilinear u8 colour cube, 33^3: max |err| {e}")
    if e != 0:
        raise AssertionError("lut3d_trilinear u8 differs from its plain "
                             "version")
    deep_np = rng.integers(0, 65536, (H, W, 4), dtype=np.uint16)
    deep = torch.from_numpy(deep_np).to(dev)
    got = apply_lut_3d(deep, lut_dev.table, *LUT_DOMAIN, max_val=65535)
    want = apply_lut_3d_ref(torch.from_numpy(deep_np), lut_cpu.table,
                            *LUT_DOMAIN, max_val=65535)
    e16 = max_abs_err(got, want)
    log(f"[check] lut3d_trilinear u16 4K RGBA64: max |err| {e16} LSB, "
        f"{int((got.cpu() != want).sum())} values differ")
    if e16 > 1 or not torch.equal(got[..., 3].cpu(),
                                  torch.from_numpy(deep_np[..., 3])):
        raise AssertionError("lut3d_trilinear u16 beyond 1 LSB or alpha "
                             "touched")
    err["lut3d_trilinear"] = max(e, e16)
    del cube, deep, got, want

    # 3. the main path: the 4K chain through parse_launch
    with tempfile.TemporaryDirectory() as tmp:
        cube_path = Path(tmp) / "grade.cube"
        write_cube(cube_path, rng)
        launch = (
            f"videotestsrc num-buffers={PIPELINE_FRAMES} pattern=snow ! "
            f"video/x-raw, format=RGBA, width={W}, height={H}, "
            f"framerate=30/1 ! hsvfilter hue_shift=12 saturation_mul=1.1 "
            f"value_mul=0.9 value_off=0.02 ! colorlut location={cube_path}"
            f" ! appsink name=out")
        run_pipeline(gstpu_torch, launch.replace(
            f"num-buffers={PIPELINE_FRAMES}", "num-buffers=1"), "cuda")
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.monotonic()
        frames = run_pipeline(gstpu_torch, launch, "cuda")
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = {k.name: k.launches for k in kernels}
        log(f"[pipeline] {len(frames)} 4K frames in {dt:.3f} s: "
            f"{len(frames) / dt:.2f} fps; launches {launches}")
        source = launch.split(" ! hsvfilter")[0] + " ! appsink name=out"
        t0 = time.monotonic()
        n_src = len(run_pipeline(gstpu_torch, source, "cuda"))
        dt = time.monotonic() - t0
        log(f"[pipeline] the source alone (videotestsrc ! appsink): "
            f"{n_src} frames in {dt:.3f} s: {n_src / dt:.2f} fps")
        host = np.random.default_rng(SEED).integers(
            0, 256, (H, W, 4), dtype=np.uint8)
        upload = []
        for _ in range(5):
            t0 = time.monotonic()
            torch.from_numpy(host).to(dev)
            torch.cuda.synchronize()
            upload.append(time.monotonic() - t0)
        log(f"[pipeline] upload of one 4K frame from pageable host "
            f"memory: {statistics.median(upload) * 1e3:.3f} ms (median "
            f"of 5)")
        plain = run_pipeline(gstpu_torch, launch, "cpu")
    if len(frames) != PIPELINE_FRAMES or len(plain) != PIPELINE_FRAMES:
        raise AssertionError(f"pipeline gave {len(frames)} frames on the "
                             f"card and {len(plain)} on the CPU")
    for i, (a, b) in enumerate(zip(frames, plain)):
        if a.data.device.type != "cuda" or a.data.shape != (H, W, 4) \
                or not torch.equal(a.data.cpu(), b.data):
            raise AssertionError(f"pipeline frame {i} differs from the "
                                 f"plain chain")
    log(f"[pipeline] all {PIPELINE_FRAMES} frames equal the plain chain")
    for k in kernels:
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} never launched on the main "
                                 f"path")
    del frames, plain

    # 4. four device-resident pipelines fed CUDA tensors
    gstpu_torch.init(device="cuda")
    caps = f"video/x-raw, format=RGBA, width={W}, height={H}, framerate=30/1"
    hsv = "hue_shift=12 saturation_mul=1.1 value_mul=0.9 value_off=0.02"
    pipes = []
    for _ in range(4):
        p = gstpu_torch.parse_launch(
            f'appsrc name=src caps="{caps}" ! hsvfilter {hsv} ! '
            f'colorlut name=cl ! appsink name=sink')
        p.get_by_name("cl").set_lut(lut_dev)
        p.set_state(gstpu_torch.State.PLAYING)
        pipes.append(p)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bank = [torch.randint(0, 256, (H, W, 4), generator=gen, device=dev,
                          dtype=torch.uint8) for _ in range(4)]
    sinks = [p.get_by_name("sink") for p in pipes]

    def push_round(k: int) -> None:
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                bank[(k + i) % 4], pts=k * 33_333_333))
            while p.iterate():
                pass

    rounds = 100
    push_round(0)
    torch.cuda.synchronize()
    for s in sinks:
        s.samples.clear()
    got = 0
    t0 = time.monotonic()
    for k in range(1, rounds + 1):
        push_round(k)
        # a streaming consumer takes each round's frames
        outs = [s.pull_all() for s in sinks]
        got += sum(map(len, outs))
        last = outs[0][-1].data
    enqueue = time.monotonic() - t0
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    if got != 4 * rounds:
        raise AssertionError(f"device-resident run gave {got} frames")
    want = apply_lut_3d_ref(
        hsv_filter_frame_ref(bank[rounds % 4].cpu(), (0, 1, 2),
                             *HSV_PARAMS[0]),
        lut_cpu.table, *LUT_DOMAIN)
    if last.device.type != "cuda" or not torch.equal(last.cpu(), want):
        raise AssertionError("device-resident output differs from the "
                             "plain chain")
    log(f"[device-resident] 4 pipelines x {rounds} 4K frames: "
        f"{4 * rounds / dt:.2f} fps; the host enqueued them in "
        f"{enqueue * 1e3:.3f} ms of {dt * 1e3:.3f} ms")
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    del pipes, sinks, last

    # 5. timings per 4K frame
    frame = bank[0]
    table = lut_dev.table
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    hsv_args = ((0, 1, 2), *HSV_PARAMS[0])
    n = table.shape[0]
    xyz = (frame[..., :3].float() / 255.0 * torch.from_numpy(
        LUT_DOMAIN[0]).to(dev) + torch.from_numpy(LUT_DOMAIN[1]).to(dev)
           ).clamp(0.0, 1.0)
    grid = (xyz * 2.0 - 1.0).reshape(1, 1, H, W, 3).contiguous()
    volume = table.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    frame_bytes = frame.numel() * frame.element_size()
    rows = []
    for k, fn, plain_fn, library_fn, extra_bytes in (
            (HSV_KERNEL,
             lambda: hsv_filter_frame(frame, *hsv_args),
             lambda: hsv_filter_frame_ref(frame, *hsv_args),
             None, 0),
            (LUT_KERNEL,
             lambda: apply_lut_3d(frame, table, *LUT_DOMAIN),
             lambda: apply_lut_3d_ref(frame, table, *LUT_DOMAIN),
             lambda: torch.nn.functional.grid_sample(
                 volume, grid, mode="bilinear", padding_mode="border",
                 align_corners=True),
             table.numel() * 4)):
        moved = 2 * frame_bytes + extra_bytes
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_PIXEL[k.name] * H * W / F32_OPS_PER_S * 1e3
        row = {
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": ("gstpu/ops/hsv_pallas.py:32"
                         if k is HSV_KERNEL else "gstpu/ops/lut_pallas.py:60"),
            "launches": launches[k.name],
            "max_abs_err": err[k.name],
            "ms": time_ms(fn, flush),
            "plain_ms": time_ms(plain_fn, flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(library_fn, flush) if library_fn else None,
            "bytes_moved": moved,
        }
        if k is HSV_KERNEL:
            row["also_replaces"] = "gstpu/ops/hsv_pallas.py:63"
        log(f"[time] {k.name} per 4K frame: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {moved} B), library "
            f"{row['library_ms']} ms  [{smi}]")
        rows.append(row)

    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
