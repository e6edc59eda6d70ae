"""The fused flagship step over N lanes, in a closed loop.

The program is `gstpu_torch.parallel.chains.make_audiofx_exact_chain`:
its `prime` over the 3 s gain look-ahead in set-up, then its `step`, one
100 ms block of every lane a call, with `in_flight` steps outstanding.

Input: a bank of `bank_rows` blocks of programme-like stereo made on the
card from the seed (`programme`). Lane i plays the bank from block i on,
so a step's input is `bank_rows` blocks' worth of one contiguous slice
(no copy) and every lane differs. Every step's meters are kept, and the
outputs of the prime and of `check_steps` steps drawn from the seed; the
`check_lanes` lanes drawn from the seed, one from each of as many equal
parts of the batch with even and odd lanes taken in turn, are held
against the plain reference, which follows them through every step, once
the window has closed. So a fault in any half of the batch, contiguous or
every other lane, lands on a checked lane.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.harness import Record
from perfbench.timing import Spans, now, phase
from perfbench.window import Reservoir, Window


def programme(gen, rows: int, frames: int, channels: int, rate: int,
              sig: dict, device) -> torch.Tensor:
    """(rows, frames * channels) f64 interleaved blocks: per block a few
    tones and decorrelated noise at a level drawn in `level_dbfs` (RMS),
    and in a share `transient_share` of the blocks one single-sample
    transient `transient_db` above that level, so the normaliser's gain
    and its true-peak limiter both have work."""
    f64 = dict(dtype=torch.float64, device=device)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f64)

    t = torch.arange(frames, **f64) / rate
    lo, hi = sig["tone_hz"]
    x = torch.zeros(rows, frames, channels, **f64)
    for _ in range(sig["tones"]):
        f = torch.exp(u(math.log(lo), math.log(hi), rows, 1))
        ph = u(0.0, 2 * math.pi, rows, 1)
        amp = u(0.2, 1.0, rows, 1)
        pan = u(0.3, 0.7, rows, 1, 1)
        tone = (amp * torch.sin(2 * math.pi * f * t + ph))[..., None]
        x += tone * torch.cat([pan, 1.0 - pan], -1)[:, :, :channels]
    x += sig["noise"] * torch.randn(rows, frames, channels,
                                    generator=gen, **f64)
    rms = x.square().mean((1, 2), keepdim=True).sqrt()
    level = 10.0 ** (u(*sig["level_dbfs"], rows, 1, 1) / 20.0)
    x *= level / rms
    hit = torch.rand(rows, generator=gen, **f64) < sig["transient_share"]
    pos = torch.randint(0, frames, (rows,), generator=gen, device=device)
    lift = 10.0 ** (u(*sig["transient_db"], rows) / 20.0) * level[:, 0, 0]
    r = torch.arange(rows, device=device)
    x[r, pos, :] += torch.where(hit, lift, 0.0)[:, None]
    return x.reshape(rows, frames * channels)


def _program_chain(cfg: dict):
    """The program's chain, after checking that it runs the
    configuration's parameters (it takes only the echo's as
    arguments)."""
    from gstpu_torch.ops import loudnorm_dev as ld
    from gstpu_torch.parallel.chains import make_audiofx_exact_chain
    rate, C = cfg["rate"], cfg["channels"]
    ln = cfg["loudnorm"]
    p = ld.LoudnormParams(channels=C)
    want = dict(rate=ld.RATE, frame=ld.FRAME,
                gain_lookahead=ld.GAIN_LOOKAHEAD, lookahead=ld.LOOKAHEAD,
                target=p.loudness_target, lra=p.loudness_range_target,
                tp=p.max_true_peak)
    have = dict(rate=rate, frame=round(cfg["block_s"] * rate),
                gain_lookahead=round(ln["gain_lookahead_s"] * rate),
                lookahead=round(ln["limiter_lookahead_s"] * rate),
                target=ln["loudness_target"],
                lra=ln["loudness_range_target"], tp=ln["max_true_peak"])
    if have != want or ln["offset_db"] != 0.0:
        raise ValueError(f"the program's chain runs {want}, the "
                         f"configuration asks for {have}")
    e = cfg["echo"]
    return make_audiofx_exact_chain(
        C, echo_delay=round(e["delay_s"] * rate) * C,
        max_delay=round(e["max_delay_s"] * rate) * C)


def inputs(cell) -> tuple:
    """The bank (bank_rows, block) on the cell's device and the checked
    lanes, both from the seed."""
    cfg, tr, dev = cell.config, cell.traffic, torch.device(cell.device)
    if tr["bank_rows"] < tr["lanes"]:
        raise ValueError("bank_rows must be at least lanes")
    rate = cfg["rate"]
    gen = torch.Generator(device=dev).manual_seed(cell.seed % 2 ** 64)
    bank = programme(gen, tr["bank_rows"], round(cfg["block_s"] * rate),
                     cfg["channels"], rate, tr["signal"], dev)
    return bank, checked_lanes(tr["lanes"], tr["check_lanes"], cell.seed)


def checked_lanes(n: int, k: int, seed: int) -> np.ndarray:
    """k of n lanes from the seed: one in each of k equal parts of the
    batch, even in the first part, odd in the second, and so on, where
    a part holds both."""
    if not 2 <= k <= n:
        raise ValueError("check_lanes must be at least 2 and at most lanes")
    rng = np.random.default_rng(seed % 2 ** 64)
    out = []
    for q in range(k):
        lo, hi = q * n // k, (q + 1) * n // k
        pick = [i for i in range(lo, hi) if i % 2 == q % 2] \
            or list(range(lo, hi))
        out.append(int(rng.choice(pick)))
    return np.array(out)


def lane_inputs(bank, lanes, blocks: int) -> np.ndarray:
    """(lanes, blocks, block) on the host: lane i plays bank row i on."""
    dev, M = bank.device, bank.shape[0]
    sel = torch.as_tensor(lanes, device=dev)
    rows = (torch.arange(blocks, device=dev)[None, :] + sel[:, None]) % M
    return bank[rows].cpu().numpy()


def run(cell) -> Record:
    cfg, tr, dev = cell.config, cell.traffic, torch.device(cell.device)
    N, M = tr["lanes"], tr["bank_rows"]
    I, F = cfg["echo"]["intensity"], cfg["echo"]["feedback"]
    prime, step, init, n_prime, n_step = _program_chain(cfg)
    phase("program imported")
    K = n_prime // n_step                       # blocks in the prime
    bank, lanes = inputs(cell)
    bank2 = torch.cat([bank, bank[:N]])         # lane i at block b: b + i
    sel = torch.as_tensor(lanes, device=dev)

    state = init(N, device=dev)
    x0 = bank[(torch.arange(K, device=dev)[None, :]
               + torch.arange(N, device=dev)[:, None]) % M] \
        .reshape(N, n_prime)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda d: None
    sync(dev)
    phase("inputs")
    state, out0 = prime(state, x0, I, F)
    del x0
    sync(dev)
    phase("prime")
    kept = Reservoir(tr["check_steps"], cell.seed)
    meters = []
    spans = Spans(enabled=cell.trace)
    n = 0

    def one_step():
        # the harness launches nothing here: it keeps references to the
        # meters and, for the steps the reservoir draws, to the output
        nonlocal state, n
        o = (K + n) % M
        with spans.span("step"):
            state, out, met = step(state, bank2[o:o + N], I, F)
        meters.append((met["momentary"], met["shortterm"]))
        kept.offer(n, lambda: out)
        n += 1

    for _ in range(tr["warm_steps"]):
        one_step()
    rec = Record(streams=N, media_s=N * cfg["block_s"], window=(0.0, 0.0))
    win = Window(cell, rec, spans, tr["in_flight"])
    spans.seconds.clear()
    spans.calls.clear()
    win.open()
    while win.running():
        t = now()
        one_step()
        win.pushed([t], win.clock.mark())
    win.close()

    # the checked lanes' inputs, outputs and meters to the host; the
    # program's state freed before the reference runs
    rec.state = dict(
        lanes=lanes, steps=n, x=lane_inputs(bank, lanes, K + n),
        out={k: o.index_select(0, sel).cpu().numpy()
             for k, o in [(-1, out0)] + kept.items},
        meters=torch.stack([torch.stack(m) for m in meters])
        .index_select(2, sel).cpu().numpy())
    del state, bank, bank2, kept, meters, out0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.work = dict(kind="audio", lanes=N, samples=n_step)
    return rec


def gaps(cfg: dict, st: dict, ref, dtype=np.float64) -> tuple:
    """Largest |sample| gap and meter gap (LU) between the reference in
    `dtype` and the kept outputs, over every checked lane and step."""
    K = st["x"].shape[1] - st["steps"]
    got = st["out"]
    sample = meter = 0.0
    for i in range(len(st["lanes"])):
        chain = ref.Chain(cfg, dtype)
        x = st["x"][i]
        sample = max(sample, float(np.abs(
            chain.prime(x[:K].reshape(-1)) - got[-1][i]).max()))
        for k in range(st["steps"]):
            o, m, s = chain.step(x[K + k])
            if k in got:
                sample = max(sample, float(np.abs(o - got[k][i]).max()))
            for want, have in zip((m, s), st["meters"][k, :, i]):
                d = 0.0 if want == have else abs(want - float(have))
                meter = max(meter, d if math.isfinite(d) else math.inf)
    return sample, meter


def control(cell, steps: int) -> dict:
    """The control's readings: the reference in float32 in the program's
    place, over the checked lanes of a run of `steps` steps, every
    output compared."""
    cfg = cell.config
    K = round(cfg["loudnorm"]["gain_lookahead_s"] / cfg["block_s"])
    bank, lanes = inputs(cell)
    st = dict(lanes=lanes, steps=steps,
              x=lane_inputs(bank, lanes, K + steps))
    del bank
    ref = cell.reference
    outs, mets = [], []
    for i in range(len(lanes)):
        chain = ref.Chain(cfg, np.float32)
        x = st["x"][i]
        o = [chain.prime(x[:K].reshape(-1))]
        m = []
        for k in range(steps):
            y, mm, ms = chain.step(x[K + k])
            o.append(y)
            m.append((mm, ms))
        outs.append(o)
        mets.append(m)
    st["out"] = {k: np.stack([o[k + 1] for o in outs])
                 for k in range(-1, steps)}
    st["meters"] = np.array(mets).transpose(1, 2, 0)
    sample, meter = gaps(cfg, st, ref)
    return {"sample_gap": sample, "meter_gap_lu": meter}


def check(cell, rec: Record) -> None:
    lim = cell.config["limits"]
    sample, meter = gaps(cell.config, rec.state, cell.reference)
    rec.checks = {"sample_gap": (sample, lim["sample_gap"]),
                  "meter_gap_lu": (meter, lim["meter_gap_lu"])}
