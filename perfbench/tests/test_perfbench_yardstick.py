"""The yardstick: roofline counts, the reference against the CPU path
of the program and against itself, the controls, and the imports."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import roofline
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import bench, small_cell


def _config(name: str) -> dict:
    conf = [c for c in bench()["configs"] if c["name"] == name][0]
    return json.loads((ROOT / conf["file"]).read_text())


def test_grade_bytes_count_one_read_and_one_write():
    cfg = _config("grade-4k")
    frame = cfg["width"] * cfg["height"] * 4
    table = cfg["lut"]["size"] ** 3 * 3 * 4
    assert (frame, table) == (33_177_600, 431_244)
    assert roofline.grade_bytes(frame, table) == 66_786_444
    assert roofline.least_seconds(66_786_444) == pytest.approx(
        66_786_444 / 3.35e12)


def test_audio_bytes_count_samples_and_state_once():
    cfg = _config("audiofx-flagship")
    samples = round(cfg["block_s"] * cfg["rate"]) * cfg["channels"]
    assert samples == 38_400
    # in, out, echo read and write, look-ahead read and write: 8 B each
    assert roofline.audio_bytes(1, samples) == 6 * 38_400 * 8
    n = roofline.audio_bytes(768, samples)
    ops = 768 * samples * roofline.AUDIO_OPS_PER_SAMPLE
    # bound by bytes: ~1 f64 operation a byte against the card's ~10
    assert roofline.least_seconds(n, ops) == n / roofline.HBM_BYTES_PER_S


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0


def _audio_signal(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(round(seconds * 192_000)) / 192_000
    x = 0.2 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(
        t.size)
    x[::9_000] += 0.9                       # peaks for the limiter
    return np.repeat(x, 2)


def test_audio_reference_against_the_program_on_the_cpu():
    """Two lanes through the program's chain on the CPU and the
    reference, lane by lane: within the configuration's limits."""
    from perfbench.drivers.audiofx_step import _program_chain, gaps
    from perfbench.reference import audiofx as ref
    cfg = _config("audiofx-flagship")
    prime, step, init, n_prime, n_step = _program_chain(cfg)
    K, steps = n_prime // n_step, 4
    x = np.stack([_audio_signal(3.4, 1), 0.5 * _audio_signal(3.4, 2)])
    xt = torch.from_numpy(x)
    st, out = prime(init(2, device="cpu"), xt[:, :n_prime], 0.4, 0.3)
    outs, mets = {-1: out.numpy()}, []
    for k in range(steps):
        a = n_prime + k * n_step
        st, out, m = step(st, xt[:, a:a + n_step].contiguous(), 0.4, 0.3)
        outs[k] = out.numpy()
        mets.append([m["momentary"].numpy(), m["shortterm"].numpy()])
    got = dict(lanes=[0, 1], steps=steps, out=outs, meters=np.array(mets),
               x=x[:, :(K + steps) * n_step].reshape(2, K + steps, -1))
    sample, meter = gaps(cfg, got, ref)
    assert sample <= cfg["limits"]["sample_gap"]
    assert meter <= cfg["limits"]["meter_gap_lu"]


def test_audio_reference_is_deterministic_and_echo_exact():
    from perfbench.reference import audiofx as ref
    cfg = _config("audiofx-flagship")
    x = _audio_signal(3.2, 3)
    a, b = ref.Chain(cfg), ref.Chain(cfg)
    pa, pb = a.prime(x[:1_152_000]), b.prime(x[:1_152_000])
    assert np.array_equal(pa, pb)
    sa, sb = a.step(x[1_152_000:1_190_400]), b.step(x[1_152_000:1_190_400])
    assert np.array_equal(sa[0], sb[0]) and sa[1:] == sb[1:]
    # the echo against its per-sample recurrence
    e = ref.Echo(7, 11, 0.4, 0.3, np.float64)
    y = np.concatenate([e(x[:20]), e(x[20:45])])
    ring, want = np.zeros(11), []
    for i, v in enumerate(x[:45]):
        d = ring[(i - 7) % 11]
        want.append(v + 0.4 * d)
        ring[i % 11] = v + 0.3 * d
    assert np.array_equal(y, np.array(want))


def test_grade_reference_against_the_program_on_the_cpu():
    """The reference in f32 equals the program's CPU path bit for bit,
    and in bfloat16 (the control) it does not."""
    from perfbench.drivers.grade_pipelines import lut_table
    from perfbench.reference import grade as ref
    from gstpu_torch.ops.hsv import hsv_filter_frame_ref
    from gstpu_torch.ops.lut import apply_lut_3d_ref
    cfg = _config("grade-4k")
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.integers(0, 256, (96, 128, 4), np.uint8))
    table = lut_table(7, 33)
    h, lut = cfg["hsv"], cfg["lut"]
    want = apply_lut_3d_ref(
        hsv_filter_frame_ref(f, (0, 1, 2), h["hue_shift"],
                             h["saturation_mul"], h["saturation_off"],
                             h["value_mul"], h["value_off"]),
        torch.from_numpy(table), np.float32(lut["domain_scale"]),
        np.float32(lut["domain_offset"]))
    t = torch.from_numpy(table)
    assert torch.equal(ref.grade(f, cfg, t), want)
    assert not torch.equal(ref.grade(f, cfg, t, torch.bfloat16), want)


@pytest.mark.parametrize("name", ["audiofx-fused-capacity",
                                  "grade4k-ctx-16"])
def test_control_fails_at_a_small_size(name):
    """The reference one precision down in the program's place reads
    above the limit on a number compared."""
    cell = small_cell(name)
    drv = cell.driver
    got = drv.control(cell, 3) if "audio" in name else drv.control(cell)
    assert any(v > cell.config["limits"][k] for k, v in got.items()), got


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
@pytest.mark.parametrize("name", ["audiofx-fused-capacity",
                                  "grade4k-ctx-16"])
def test_control_fails_at_the_cells_size(name, seed, card):
    """The control at the cell's own size (the lanes a run checks over
    the ~500 steps a 51 s run makes; the whole frame bank)."""
    from perfbench import harness
    cell = harness.load_cell(bench(), name, ROOT, seed=seed, device=card)
    drv = cell.driver
    got = drv.control(cell, 500) if "audio" in name else drv.control(cell)
    print(f"control {name} seed {seed}: {got}")
    assert any(v > cell.config["limits"][k] for k, v in got.items()), got


def test_nothing_loads_jax_or_the_jax_package():
    """In a fresh interpreter: the harness, every driver, reference and
    metric, and the program they drive, leave no module whose whole
    top-level name is jax, jaxlib, flax or gstpu; the references load
    nothing of the program."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import harness
for d in ("reference",):
    for p in sorted((harness.HERE / d).glob("*.py")):
        harness.load_module(p)
assert not any(m.split(".")[0] == "gstpu_torch" for m in sys.modules), \\
    "a reference loads the program"
for d in ("drivers", "metrics"):
    for p in sorted((harness.HERE / d).glob("*.py")):
        harness.load_module(p)
import gstpu_torch
gstpu_torch.init(device="cpu")
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
