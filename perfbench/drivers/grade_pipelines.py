"""`streams` pipelines `appsrc ! hsvfilter context=... ! colorlut
context=... ! appsink` in one DeviceContext, fed device frames in a
closed loop.

A round pushes one frame into every pipeline's `appsrc` and runs each
pipeline's scheduler until it idles; the context fires once all
pipelines have submitted their frame: one launch of each kernel over the
(streams, H, W, 4) batch. The round then pulls the outputs; at most
`in_flight` rounds are outstanding on the device.

Input: a bank of `bank_frames` 4K frames like graded camera footage,
made on the card from the seed (`footage`); pipeline i at round k takes
frame (k + 3 i) mod bank_frames. The LUT is a seeded table. A sample of
the window's outputs drawn from the seed, `check_frames` over all, as
many of every pipeline, is copied as it comes and held against the plain
reference once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import Record
from perfbench.timing import Spans, now, phase
from perfbench.window import Reservoir, Window

CONTEXT = "perfbench-grade"


def footage(gen, n: int, h: int, w: int, grain: int, device) -> torch.Tensor:
    """(n, h, w, 4) uint8 RGBA: per frame gradients plus bicubic
    low-frequency noise, and per-pixel grain of +-`grain` code values;
    alpha opaque."""
    y = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    frames = torch.empty(n, h, w, 4, dtype=torch.uint8, device=device)
    for i in range(n):
        coarse = torch.rand((1, 3, 9, 16), generator=gen, device=device)
        noise = torch.nn.functional.interpolate(coarse, size=(h, w),
                                                mode="bicubic")[0]
        rgb = torch.stack([0.6 * x + 0.4 * noise[0],
                           0.6 * y + 0.4 * noise[1],
                           0.3 * (x + y) + 0.4 * noise[2]], -1)
        code = (rgb.clamp(0.0, 1.0) * 255.0).round() + torch.randint(
            -grain, grain + 1, (h, w, 3), generator=gen,
            device=device).to(rgb.dtype)
        frames[i, ..., :3] = code.clamp(0.0, 255.0).to(torch.uint8)
        frames[i, ..., 3] = 255
    return frames


def lut_table(seed: int, n: int) -> np.ndarray:
    """A non-identity n^3 table, values past [0, 1], from the seed."""
    rng = np.random.default_rng(seed % 2 ** 64)
    return (rng.random((n, n, n, 3), dtype=np.float32) * 1.2
            - 0.1).astype(np.float32)


def launch_string(cfg: dict) -> str:
    h = cfg["hsv"]
    ctx = f" context={CONTEXT}"
    caps = (f"video/x-raw, format=RGBA, width={cfg['width']}, "
            f"height={cfg['height']}, framerate={cfg['fps']}/1")
    return (f'appsrc name=src caps="{caps}" ! hsvfilter '
            f'hue_shift={h["hue_shift"]} saturation_mul={h["saturation_mul"]}'
            f' saturation_off={h["saturation_off"]} '
            f'value_mul={h["value_mul"]} value_off={h["value_off"]}{ctx} ! '
            f'colorlut name=cl{ctx} ! appsink name=sink')


def inputs(cell) -> tuple:
    """The frame bank on the cell's device and the LUT table, from the
    seed."""
    cfg, dev = cell.config, torch.device(cell.device)
    gen = torch.Generator(device=dev).manual_seed(cell.seed % 2 ** 64)
    bank = footage(gen, cell.traffic["bank_frames"], cfg["height"],
                   cfg["width"], cfg["grain"], dev)
    return bank, lut_table(cell.seed, cfg["lut"]["size"])


def _tensor(buf) -> torch.Tensor:
    d = buf.data
    return d.tensor() if hasattr(d, "tensor") else d


def run(cell) -> Record:
    import gstpu_torch
    from gstpu_torch.ops.lut import lut_from_numpy
    from gstpu_torch.runtime.device_batch import DeviceContext

    cfg, tr, dev = cell.config, cell.traffic, torch.device(cell.device)
    S, B = tr["streams"], tr["bank_frames"]
    gstpu_torch.init(device=dev)
    phase("program imported")
    bank, table = inputs(cell)
    lut = cfg["lut"]
    dlut = lut_from_numpy(table, lut["domain_scale"], lut["domain_offset"],
                          dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("inputs")

    DeviceContext.release(CONTEXT)
    pipes = [gstpu_torch.parse_launch(launch_string(cfg))
             for _ in range(S)]
    for p in pipes:
        p.get_by_name("cl").set_lut(dlut)
        p.set_state(gstpu_torch.State.PLAYING)
    srcs = [p.get_by_name("src") for p in pipes]
    sinks = [p.get_by_name("sink") for p in pipes]
    spans = Spans(outer=("context",), enabled=cell.trace)
    ctx = DeviceContext.acquire(CONTEXT)
    for method, name in (("submit", "submit"), ("_fire", "fire"),
                         ("_distribute", "distribute")):
        spans.wrap(ctx, method, name)
        spans.wrap(ctx, method, "context")
    phase("pipelines")

    dur = round(1e9 / cfg["fps"])
    per = -(-tr["check_frames"] // S)
    kept = [Reservoir(per, cell.seed + i) for i in range(S)]
    failed = 0
    timed = False

    def one_round(k: int, win: Window | None) -> None:
        nonlocal failed
        pushes, frames = [], []
        for i, p in enumerate(pipes):
            f = (k + 3 * i) % B
            t = now()
            with spans.span("push"):
                srcs[i].push_buffer(gstpu_torch.Buffer(bank[f], pts=k * dur))
            with spans.span("iterate"):
                while p.iterate():
                    pass
            pushes.append(t)
            frames.append(f)
        with spans.span("pull"):
            for i, f in enumerate(frames):
                bufs = sinks[i].pull_all()
                if len(bufs) != 1:
                    failed += 1
                elif timed:
                    kept[i].offer(f, lambda: _tensor(bufs[0]).clone())
        if win is not None:
            win.pushed(pushes, win.clock.mark())

    k = 0
    for k in range(tr["warm_rounds"]):
        one_round(k, None)
    rec = Record(streams=S, media_s=1.0 / cfg["fps"], window=(0.0, 0.0))
    win = Window(cell, rec, spans, tr["in_flight"])
    spans.seconds.clear()
    spans.calls.clear()
    fires0 = ctx.fire_count
    timed = True
    win.open()
    while win.running():
        k += 1
        one_round(k, win)
    win.close()
    rec.failed = failed
    rec.counts = dict(fires=ctx.fire_count - fires0)

    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(CONTEXT)
    rec.state = dict(kept=[kv for r in kept for kv in r.items], bank=bank,
                     table=table)
    del pipes, srcs, sinks, dlut
    rec.work = dict(kind="grade",
                    frame_bytes=cfg["width"] * cfg["height"] * 4,
                    table_bytes=lut["size"] ** 3 * 3 * 4)
    return rec


def frame_gap(cfg: dict, st: dict, ref, dt=torch.float32) -> tuple:
    """Largest code-value gap between the kept outputs and the reference
    in `dt`; the number of frames compared."""
    bank, kept = st["bank"], st["kept"]
    table = torch.from_numpy(st["table"]).to(bank.device)
    want = {f: ref.grade(bank[f], cfg, table, dt)
            for f in sorted({f for f, _ in kept})}
    gap = 0
    for f, got in kept:
        gap = max(gap, int((got.to(torch.int16) - want[f].to(torch.int16))
                           .abs().max()))
    return gap, len(kept)


def control(cell) -> dict:
    """The control's reading: the reference in bfloat16 in the
    program's place, over every frame of the bank."""
    bank, table = inputs(cell)
    ref = cell.reference
    t = torch.from_numpy(table).to(bank.device)
    kept = [(f, ref.grade(bank[f], cell.config, t, torch.bfloat16))
            for f in range(bank.shape[0])]
    gap, _ = frame_gap(cell.config, dict(kept=kept, bank=bank,
                                         table=table), ref)
    return {"frame_gap": float(gap)}


def check(cell, rec: Record) -> None:
    gap, n = frame_gap(cell.config, rec.state, cell.reference)
    rec.checks = {"frame_gap": (float(gap) if n else float("inf"),
                                float(cell.config["limits"]["frame_gap"]))}
    rec.state.clear()
