"""The port's device loudnorm (gstpu_torch.ops.loudnorm_dev) against the
host element and gstpu's device core, on the CPU.

Twins of tests/test_loudnorm_device.py: on each signal the port runs
beside the host numpy element (`_LoudNormState`, sample-exact against
the literal reference) and gstpu's jitted core, on the same inputs.
- against the host element: samples within ATOL 1e-9, and the
  per-frame decision traces (limiter state, envelope counter, sustain
  counter, gain index, above-threshold latch, gating count) identical;
- against gstpu's core: samples within 1e-12 abs, traces identical
  (the two differ by FMA contraction and the block biquad's FIR form);
- batch lanes bitwise equal.
The EOS drain (`make_final_step`) and the stand-alone meter
(`make_meter_step`) are held against gstpu's the same way.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.core.audio import AudioInfo
from gstpu.elements.audio.loudnorm import _LoudNormState
from gstpu.ops import biquad as jbq
from gstpu.ops import loudnorm_dev as jln
from gstpu_torch.ops import loudnorm_dev as tln
from torch_session import torch_test_limit  # noqa: F401

RATE = 192_000
ATOL = 1e-9
ATOL_VS_GSTPU = 1e-12
FRAME, GAIN_LOOKAHEAD = tln.FRAME, tln.GAIN_LOOKAHEAD


def _lanes(src, batch):
    return np.ascontiguousarray(np.broadcast_to(src, (batch, src.size)))


def _trace(st, gidx):
    return (int(st["lstate"][0]), int(st["env_cnt"][0]), int(st["sus"][0]),
            int(gidx), bool(st["above"][0]), int(st["bcount"][0]))


def _run_three(x, offset_db=0.0, channels=1, batch=2):
    """Host element, gstpu's core and the port side by side on one
    signal. Returns dict of outputs (host; gstpu lane 0; port lanes 0
    and -1) and per-frame traces, and the final states."""
    flat = x.reshape(-1)
    vec = _LoudNormState(dict(loudness_target=-24.0,
                              loudness_range_target=7.0,
                              max_true_peak=-2.0, offset=offset_db),
                         AudioInfo("F64LE", RATE, channels))
    jparams = jln.LoudnormParams(channels=channels, max_blocks=256)
    params = tln.LoudnormParams(channels=channels, max_blocks=256)
    jst = jln.init_state(jparams, batch, offset_db=offset_db)
    st = tln.init_state(params, batch, offset_db=offset_db, device="cpu")
    jfirst, jinner = jln.make_steps(jparams)
    first, inner = tln.make_steps(params)

    out = {k: [] for k in ("host", "jax", "port", "port_last")}
    tr = {k: [] for k in ("host", "jax", "port")}

    def record(oh, jo, po):
        out["host"].append(oh)
        out["jax"].append(np.asarray(jo)[0])
        out["port"].append(po[0].numpy())
        out["port_last"].append(po[-1].numpy())

    src = flat[:GAIN_LOOKAHEAD * channels]
    oh, _ = vec.process(src, 0)
    jst, jo = jfirst(jst, jnp.asarray(_lanes(src, batch)))
    st, po = first(st, torch.from_numpy(_lanes(src, batch)))
    record(oh, jo, po)
    off = GAIN_LOOKAHEAD * channels
    step = FRAME * channels
    while flat.size - off >= step:
        src = flat[off:off + step]
        oh, _ = vec.process(src, 0)
        jst, jo = jinner(jst, jnp.asarray(_lanes(src, batch)))
        st, po = inner(st, torch.from_numpy(_lanes(src, batch)))
        record(oh, jo, po)
        tr["host"].append((vec.limiter_state, vec.env_cnt,
                           -1 if vec.sustain_cnt is None
                           else vec.sustain_cnt,
                           vec.index, vec.above_threshold,
                           len(vec.r128_in._block_energies)))
        tr["jax"].append(_trace(jst, jst["gidx"]))
        tr["port"].append(_trace(st, st["gidx"]))
        off += step
    return ({k: np.concatenate(v) for k, v in out.items()}, tr, vec, jst,
            st)


def _check(x, offset_db=0.0, channels=1, expect_states=None):
    out, tr, vec, jst, st = _run_three(x, offset_db, channels)
    assert np.array_equal(out["port"], out["port_last"]), \
        "batch lanes must be independent"
    assert tr["port"] == tr["host"], "decisions must match the host element"
    assert tr["port"] == tr["jax"], "decisions must match gstpu's core"
    np.testing.assert_allclose(out["port"], out["host"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0,
                               atol=ATOL_VS_GSTPU)
    if expect_states is not None:
        seen = set(s[0] for s in tr["host"])
        assert expect_states <= seen, (expect_states, seen)
    return vec, st


def _sine(n, f=440.0, amp=0.5):
    t = np.arange(n) / RATE
    return amp * np.sin(2 * np.pi * f * t)


def test_quiet_signal_no_limiting():
    vec, st = _check(_sine(int(4.0 * RATE), amp=0.05))
    assert vec.limiter_state == 0


def test_sustained_limiting():
    """Continuous loud sine + offset: permanent SUSTAIN, including the
    reference's signed first-frame max quirk."""
    _check(_sine(int(5.0 * RATE), amp=0.5), offset_db=20.0,
           expect_states={2})


def test_attack_sustain_release_cycles():
    n = int(6.0 * RATE)
    t = np.arange(n) / RATE
    x = 0.05 * np.sin(2 * np.pi * 300.0 * t)
    for s in range(RATE // 2, n - 40000, int(0.55 * RATE)):
        x[s:s + 25000] += 0.6 * np.sin(2 * np.pi * 1800.0
                                       * t[s:s + 25000])
    _check(np.clip(x, -1, 1), offset_db=14.0, expect_states={0, 1, 2, 3})


def test_random_peak_clusters():
    rng = np.random.default_rng(5)
    n = int(6.0 * RATE)
    t = np.arange(n) / RATE
    x = 0.05 * np.sin(2 * np.pi * 250.0 * t)
    for s in rng.integers(RATE // 2, n - 8000, 120):
        ln = int(rng.integers(100, 2500))
        x[s:s + ln] += float(rng.uniform(0.3, 0.9)) * np.sin(
            2 * np.pi * float(rng.uniform(1e3, 6e3)) * t[s:s + ln])
    _check(np.clip(x, -1, 1), offset_db=12.0, expect_states={0, 1, 3})


def _stereo():
    rng = np.random.default_rng(5)
    n = int(5.0 * RATE)
    t = np.arange(n) / RATE
    mono = 0.05 * np.sin(2 * np.pi * 250.0 * t)
    for s in rng.integers(RATE // 2, n - 8000, 80):
        ln = int(rng.integers(100, 2500))
        mono[s:s + ln] += 0.7 * np.sin(2 * np.pi * 3000.0 * t[s:s + ln])
    return np.clip(np.stack([mono, np.roll(mono, 777)], axis=1), -1, 1)


def test_stereo():
    _check(_stereo(), offset_db=12.0, channels=2)


def test_gain_machine_tracks_loudness():
    """Gating/above-threshold bookkeeping matches the host element."""
    n = int(4.4 * RATE)
    t = np.arange(n) / RATE
    x = 0.05 * np.sin(2 * np.pi * 440.0 * t) \
        + 0.4 * np.sin(2 * np.pi * 97.0 * t)
    vec, st = _check(x)
    assert int(st["bcount"][0]) == len(vec.r128_in._block_energies)
    assert bool(st["above"][0]) == vec.above_threshold
    np.testing.assert_allclose(float(st["prev_delta"][0]), vec.prev_delta,
                               rtol=1e-9)


def test_conformance_loudness_on_device_output():
    """BASELINE gate: output integrated loudness -24 LUFS +- 1 LU,
    sample peak <= -2 dBFS, measured on the port's output with the
    independent host meter."""
    from gstpu.ops.ebur128 import EbuR128
    n = int(10.0 * RATE)
    t = np.arange(n) / RATE
    out, _, _, _, _ = _run_three(0.25 * np.sin(2 * np.pi * 440.0 * t))
    np.testing.assert_allclose(out["port"], out["host"], rtol=0, atol=ATOL)
    meter = EbuR128(1, RATE, frozenset(("I", "sample_peak")))
    meter.add_frames(out["port"].reshape(-1, 1))
    lufs = meter.loudness_global()
    assert abs(lufs - (-24.0)) < 1.0, lufs
    assert meter.sample_peak(0) <= 10 ** (-2.0 / 20.0) + 1e-12


def _assert_states_close(st, jst, loose=None):
    """Every state entry of the port against gstpu's: integers and
    flags equal, floats within ATOL_VS_GSTPU (rel 1e-9 for the
    energies), or the (rtol, atol) that `loose` gives the key."""
    loose = loose or {}
    for k, v in tln.state_to_numpy(st).items():
        want = np.asarray(jst[k])
        assert v.dtype == want.dtype and v.shape == want.shape, k
        if v.dtype.kind == "f":
            rtol, atol = loose.get(k, (1e-9, ATOL_VS_GSTPU))
            np.testing.assert_allclose(v, want, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("n_valid", [0, 7_321])
def test_final_step_matches_gstpu(n_valid):
    """EOS drain after a stereo prime and two inner frames: the 3 s tail
    through the limiter with continuing gain updates."""
    x = _stereo()
    C, B = 2, 2
    jparams = jln.LoudnormParams(channels=C, max_blocks=256)
    params = tln.LoudnormParams(channels=C, max_blocks=256)
    jfirst, jinner = jln.make_steps(jparams)
    first, inner = tln.make_steps(params)
    flat = x.reshape(-1)
    jst = jln.init_state(jparams, B, offset_db=12.0)
    st = tln.init_state(params, B, offset_db=12.0, device="cpu")
    src = _lanes(flat[:GAIN_LOOKAHEAD * C], B)
    jst, _ = jfirst(jst, jnp.asarray(src))
    st, _ = first(st, torch.from_numpy(src))
    for k in range(2):
        off = (GAIN_LOOKAHEAD + k * FRAME) * C
        src = _lanes(flat[off:off + FRAME * C], B)
        jst, _ = jinner(jst, jnp.asarray(src))
        st, _ = inner(st, torch.from_numpy(src))
    off = (GAIN_LOOKAHEAD + 2 * FRAME) * C
    tail = np.zeros(FRAME * C)
    tail[:n_valid * C] = flat[off:off + n_valid * C]
    src = _lanes(tail, B)
    z_out = [st["z_out1"][:C].numpy(), st["z_out2"][:C].numpy()]
    jst, jout, jvalid = jln.make_final_step(jparams)(
        jst, jnp.asarray(src), n_valid)
    st, out, valid = tln.make_final_step(params)(
        st, torch.from_numpy(src), n_valid)
    assert valid == int(jvalid) == 29 * FRAME + n_valid
    assert torch.equal(out[0], out[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL_VS_GSTPU)
    # the drain's 29 output measurements against lfilter on the same
    # samples: the port's filter states stay within 1e-10 of the exact
    # ones and its frame energies within 1e-9 relative, while gstpu's
    # high-pass state (a double pole near z = 1, ill-conditioned in
    # block form) drifts ~5e-9 and its energies ~2e-8 relative, hence
    # the bounds against gstpu's
    y = out[0, :29 * FRAME * C].numpy().reshape(-1, C).T
    for k, (b, a) in enumerate((jbq.biquad_coeffs_shelving(RATE),
                                jbq.biquad_coeffs_highpass(RATE))):
        y, zf = jbq.biquad_reference(y, b, a, z_out[k])
        np.testing.assert_allclose(st[f"z_out{k + 1}"][:C].numpy(), zf,
                                   rtol=0, atol=1e-10)
    energy = (y * y).reshape(C, 29, FRAME).sum(-1).T
    np.testing.assert_allclose(st["ring_out"][0, 1:].numpy(), energy,
                               rtol=1e-9, atol=0)
    _assert_states_close(st, jst, loose={"z_out2": (0, 1e-8),
                                         "ring_out": (1e-7, 0)})


def test_meter_step_matches_gstpu():
    """The stand-alone ebur128level stage over a 3 s and then 100 ms
    blocks: the gating, the meters and the sample peak."""
    x = _stereo()[:int(4.0 * RATE)]
    C, B = 2, 2
    jparams = jln.LoudnormParams(channels=C, max_blocks=256)
    params = tln.LoudnormParams(channels=C, max_blocks=256)
    jmeter = jln.make_meter_step(jparams)
    meter = tln.make_meter_step(params)
    jst = jln.init_meter_state(jparams, B)
    st = tln.init_meter_state(params, B, device="cpu")
    flat = x.reshape(-1)
    bounds = [0, GAIN_LOOKAHEAD * C] + [
        (GAIN_LOOKAHEAD + (k + 1) * FRAME) * C for k in range(10)]
    for lo, hi in zip(bounds, bounds[1:]):
        src = _lanes(flat[lo:hi], B)
        jst, _, jaux = jmeter(jst, jnp.asarray(src))
        st, passed, aux = meter(st, torch.from_numpy(src))
        assert np.array_equal(passed.numpy(), src)
        for k in ("momentary", "shortterm", "global_",
                  "relative_threshold"):
            np.testing.assert_allclose(aux[k].numpy(),
                                       np.asarray(jaux[k]), rtol=1e-12,
                                       atol=0, err_msg=k)
            assert aux[k][0] == aux[k][1]
        np.testing.assert_array_equal(aux["speak"].numpy(),
                                      np.asarray(jaux["speak"]))
    assert st["nsub_in"] == int(jst["nsub_in"]) == 40
    assert int(st["bcount"][0]) == int(jst["bcount"][0]) > 0
    _assert_states_close(st, jst)


def test_state_round_trips_through_numpy():
    params = tln.LoudnormParams(channels=2, max_blocks=64)
    st = tln.init_state(params, 3, offset_db=-3.0, device="cpu")
    st = dict(st, gidx=17, nsub_in=5)
    back = tln.state_from_numpy(tln.state_to_numpy(st), device="cpu")
    assert back.keys() == st.keys()
    for k, v in st.items():
        if k in tln.HOST_INTS:
            assert back[k] == v and isinstance(back[k], int)
        else:
            assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    jst = jln.init_state(jln.LoudnormParams(channels=2, max_blocks=64), 3,
                         offset_db=-3.0)
    from_jax = tln.state_from_numpy(
        {k: np.asarray(v) for k, v in jst.items()}, device="cpu")
    fresh = tln.init_state(params, 3, offset_db=-3.0, device="cpu")
    for k, v in fresh.items():
        if k in tln.HOST_INTS:
            assert from_jax[k] == v
        else:
            assert from_jax[k].dtype == v.dtype and torch.equal(
                from_jax[k], v), k


# ---------------------------------------------------------------------------
# the measurement's K-weighting (tln.kweight): the plain form on the CPU,
# and the order of operations of the card's kernel (kernels/kweight.cu)
# ---------------------------------------------------------------------------

def _kweight_inputs(B, C, nsub, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nsub * FRAME * C)) * scale
    z1 = rng.standard_normal((B * C, 2)) * scale / 3
    z2 = rng.standard_normal((B * C, 2)) * scale / 3
    return torch.from_numpy(x), torch.from_numpy(z1), torch.from_numpy(z2)


def _composition(z1, z2, x, C):
    """The measurement as `_make_measure` composed it before the kernel:
    both block biquads, the squares, a tree sum over each FRAME."""
    from gstpu_torch.ops import biquad as tbq
    bq1 = tbq.make_block_biquad(*tbq.biquad_coeffs_shelving(RATE), L=64)
    bq2 = tbq.make_block_biquad(*tbq.biquad_coeffs_highpass(RATE), L=64)
    B, n = x.shape[0], x.shape[1] // C
    xt = x.reshape(B, n, C).permute(0, 2, 1).reshape(B * C, n)
    y, z1 = bq1(xt, z1)
    y, z2 = bq2(y, z2)
    e = tbq._tree_sum_last((y * y).reshape(B, C, n // FRAME, FRAME))
    return z1, z2, e.permute(0, 2, 1)


@pytest.mark.parametrize("B,C,nsub,strided", [
    (1, 1, 1, False), (3, 2, 1, False), (2, 1, 3, False), (1, 6, 1, False),
    (2, 2, 2, False), (2, 2, 1, True)])
def test_measure_cpu_route_is_the_composition(B, C, nsub, strided):
    """`measure` on CPU tensors returns the composition's bits; a row-
    strided x is a frame sliced out of a wider block, as the prime
    slices its 3 s."""
    measure, _ = tln._make_measure(tln.LoudnormParams(channels=C))
    x, z1, z2 = _kweight_inputs(B, C, nsub, 40 + 7 * B + C + nsub)
    if strided:
        wide = torch.cat([torch.zeros_like(x), x, torch.ones_like(x)], 1)
        x = wide[:, x.shape[1]:2 * x.shape[1]]
        assert not x.is_contiguous()
    got = measure(z1, z2, x)
    want = _composition(z1, z2, x, C)
    assert got[2].shape == (B, nsub, C)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", [
    "x_f32", "x_columns", "x_one_dim", "partial_frame", "z_f32", "z_shape",
    "z_strided", "meta_device"])
def test_kweight_checks_raise(fault):
    """The wrapper refuses what neither route takes, before it routes."""
    C = 2
    x, z1, z2 = _kweight_inputs(2, C, 1, 3)
    if fault == "x_f32":
        x = x.float()
    elif fault == "x_columns":
        x = torch.cat([x, x], 1)[:, ::2]
    elif fault == "x_one_dim":
        x = x.reshape(-1)
    elif fault == "partial_frame":
        x = x[:, :-C]
    elif fault == "z_f32":
        z1 = z1.float()
    elif fault == "z_shape":
        z2 = z2.reshape(2, C, 2)
    elif fault == "z_strided":
        z1 = torch.cat([z1, z1], 1)[:, ::2]
    elif fault == "meta_device":
        x, z1, z2 = (t.to("meta") for t in (x, z1, z2))
    with pytest.raises(ValueError, match="kweight"):
        tln.kweight(z1, z2, x, C)


def _kernel_order(table, z1, z2, x, C):
    """kernels/kweight.cu's order of operations in numpy, from the
    kernel's own table: each block's increment a halving tree; the block
    states by streaming each frame's 300 blocks through the scan's nodes
    (a node of level j, ending at e, built from its halves; block k the
    left fold, largest first, of the nodes making up [0, k + 1)), the
    nodes before the frame carried one a level; the FIR over ascending
    m, then s0 O0, then s1 O1; a frame's energy the tree over its 300
    block sums padded to 512."""
    FB, L, LV = FRAME // 64, 64, tln.KWEIGHT_LEVELS
    stages = []
    for s in range(2):
        u = table[452 * s:452 * (s + 1)]
        stages.append(dict(b0=u[0], h=u[1:64], O=u[64:192].reshape(2, L),
                           W=u[192:320].reshape(2, L), M=u[320:324],
                           node=u[324:452].reshape(LV, 4)))

    def tree(p):
        while p.shape[-1] > 1:
            p = p[..., 0::2] + p[..., 1::2]
        return p[..., 0]

    def fold(m, acc, v):
        return ((m[0] * acc[0] + m[1] * acc[1]) + v[0],
                (m[2] * acc[0] + m[3] * acc[1]) + v[1])

    B, n = x.shape[0], x.shape[1] // C
    rows = x.reshape(B, n, C).transpose(0, 2, 1).reshape(B * C, n)
    z = [z1.copy(), z2.copy()]
    carry = [[None] * LV, [None] * LV]
    e = np.empty((B * C, n // FRAME))
    for f in range(n // FRAME):
        P = f * FB
        X = rows[:, f * FRAME:(f + 1) * FRAME].reshape(-1, FB, L)
        for s, t in enumerate(stages):
            u = [tree(X * t["W"][0]), tree(X * t["W"][1])]
            if P == 0:
                for i in range(2):
                    u[i][:, 0] = u[i][:, 0] + (t["M"][2 * i] * z[s][:, 0]
                                               + t["M"][2 * i + 1]
                                               * z[s][:, 1])
            node = [u[0].copy(), u[1].copy()]

            def at(e_, j):
                return ((node[0][:, e_ - 1 - P], node[1][:, e_ - 1 - P])
                        if e_ > P else carry[s][j])

            j = 1
            while 1 << j <= P + FB:
                w = 1 << j
                for q in range(P // w + 1, (P + FB) // w + 1):
                    e_ = q * w
                    v = fold(t["node"][j - 1], at(e_ - w // 2, j - 1),
                             at(e_, j - 1))
                    node[0][:, e_ - 1 - P], node[1][:, e_ - 1 - P] = v
                j += 1
            S = np.empty((2, B * C, FB + 1))
            S[:, :, 0] = z[s].T
            for k in range(FB):
                Q = P + k + 1
                acc = None
                for j in range(Q.bit_length() - 1, -1, -1):
                    if (Q >> j) & 1:
                        v = at(Q >> j << j, j)
                        acc = v if acc is None else fold(t["node"][j], acc,
                                                         v)
                S[:, :, k + 1] = acc
            P2 = P + FB
            for j in range(P2.bit_length()):
                if (P2 >> j) & 1 and P2 >> j << j > P:
                    carry[s][j] = at(P2 >> j << j, j)
            Y = np.empty_like(X)
            for i in range(L):
                y = t["b0"] * X[:, :, i]
                for m in range(i):
                    y = y + t["h"][m] * X[:, :, i - 1 - m]
                y = y + S[0, :, :FB] * t["O"][0][i]
                Y[:, :, i] = y + S[1, :, :FB] * t["O"][1][i]
            X = Y
            z[s] = S[:, :, FB].T.copy()
        sums = np.zeros((B * C, 512))
        sums[:, :FB] = tree(X * X)
        e[:, f] = tree(sums)
    return z[0], z[1], e.reshape(B, C, -1).transpose(0, 2, 1)


@pytest.mark.parametrize("B,C,nsub,scale", [
    (2, 2, 1, 0.3), (1, 1, 3, 0.3), (1, 1, 30, 0.3), (1, 2, 3, 3e-308)])
def test_kernel_order_is_the_plain_form(B, C, nsub, scale):
    """The kernel's order of operations, emulated, gives the plain
    form's bits: one frame, frames carried through the scan (30 is a
    priming fire's x), and an input whose samples and products are
    subnormal. The card holds the kernel itself to the plain form
    (chip_smoke.py)."""
    x, z1, z2 = _kweight_inputs(B, C, nsub, 90 + nsub, scale)
    table = tln._kweight_table(torch.device("cpu")).numpy()
    got = _kernel_order(table, z1.numpy(), z2.numpy(), x.numpy(), C)
    want = tln.kweight(z1, z2, x, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# the true-peak limiter (tln._limiter_frame): the plain form on the CPU,
# and the order of operations of the card's kernel (kernels/limiter.cu)
# ---------------------------------------------------------------------------

LIM, NPEAK, LOOKAHEAD = tln.LIM, tln.NPEAK, tln.LOOKAHEAD
ATTACK, RELEASE = tln.ATTACK, tln.RELEASE
OUT, ATT, SUS, REL = tln.OUT, tln.ATT, tln.SUS, tln.REL
_LIMITER_CU = (Path(tln.__file__).resolve().parents[1] / "kernels"
               / "limiter.cu").read_text()
# the kernel's range list and its threads, read from its source
KSEGS = int(re.search(r"constexpr int kSegs = (\d+);", _LIMITER_CU)[1])
NWORDS = (NPEAK + 31) // 32


def _true_div(x, c):
    """The CPU's `tensor / number`: an IEEE division."""
    return x / c


def _reciprocal_product(x, c):
    """CUDA's `tensor / number`: a product with the number's reciprocal,
    as the kernel's wrapper passes it."""
    return x * (1.0 / c)


def _peak_words(a, tp):
    """detect_peak's candidates of one lane as the kernel's bitmask
    words: a (ABSW, C) |x|; bit p of the mask for position p."""
    p = np.arange(1, NPEAK)
    t = a[p]
    ok = (a[p - 1] <= t) & (t >= a[p + 1]) & (t > tp)
    for k in range(2, 12):
        ok &= a[p + k] <= t
    hit = np.zeros(NWORDS * 32, bool)
    hit[1:NPEAK] = ok.any(axis=1)
    bits = hit.reshape(NWORDS, 32).astype(object) * [1 << i for i in
                                                      range(32)]
    return [int(w) for w in bits.sum(axis=1)]


def _detect(words, lo, hi):
    """The first set bit in [lo, hi), 32 words at a time as the warp
    reads them; None where there is none."""
    if lo >= hi:
        return None
    wl, wh = lo >> 5, (hi - 1) >> 5
    for w0 in range(wl, wh + 1, 32):
        for w in range(w0, min(w0 + 32, wh + 1)):
            m = words[w]
            if w == wl:
                m &= (0xFFFFFFFF << (lo & 31)) & 0xFFFFFFFF
            if w == wh and hi - 32 * w < 32:
                m &= (1 << (hi - 32 * w)) - 1
            if m:
                return 32 * w + (m & -m).bit_length() - 1
    return None


def _limiter_kernel_order(tp, C, lim, gr0, gr1, ls, env, sus, nb,
                          div_number=_true_div):
    """kernels/limiter.cu's steps for one lane, in Python floats (IEEE
    doubles, each operation rounded once): the peak bitmask, the scalar
    segment machine with its range list flushed into the gain G every
    KSEGS ranges, and the product and clip. `div_number` is the device's
    rule for a tensor divided by a Python number in the plain form.
    Returns (lim, out, gr0, gr1, ls, env, sus, iterations, trace), the
    trace one (smp, new smp, ranges, branch) an iteration."""
    x = np.asarray(lim, np.float64)
    a = np.abs(x[:tln.ABSW * C]).reshape(-1, C)
    words = _peak_words(a, tp)
    G = np.ones(FRAME)
    segs, trace = [], []
    smp = iters = 0
    cap = 4 * nb + 4

    def flush():
        for s0, s1, ref, linear, t0, denom, diff, base in segs:
            for i in range(s0, s1):
                G[i] = base - ((t0 + float(i - ref)) / denom) * diff \
                    if linear else base
        segs.clear()

    while smp < nb and iters < cap and OUT <= ls <= REL:
        q = _detect(words, smp + LOOKAHEAD + 1, nb + LOOKAHEAD)
        found = q is not None
        np_smp = (q if found else 0) - LOOKAHEAD
        pv = 1.0
        if found:
            pv = float(a[q, 0])
            for c in range(1, C):
                v = float(a[q, c])
                if not math.isnan(pv) and (math.isnan(v) or v > pv):
                    pv = v
        gnew = (1.0 / pv) * tp
        envf = float(env)
        n_ls, n_env, n_sus, n_smp, n_gr0, n_gr1 = ls, env, sus, smp, gr0, gr1
        lin = cst = (0, 0)
        lin_denom, lin_diff = ATTACK - 1.0, gr0 - gr1
        if ls == OUT:
            branch = "out_found" if found else "out_none"
            n_smp = smp + LOOKAHEAD + np_smp - smp - ATTACK if found else nb
            if found:
                n_ls, n_env, n_sus, n_gr0, n_gr1 = ATT, 0, -1, 1.0, gnew
        elif ls == ATT:
            k = min(ATTACK - env, nb - smp)
            if found:
                k = min(k, np_smp - smp)
            k = max(k, 0)
            lin = (smp, k)
            smp1, env1 = smp + k, env + k
            cst = (smp1, np_smp - smp1 if found else 0)
            smp2 = np_smp if found else smp1
            lower = found and gnew < gr1
            current = gr0 - div_number(float(env1), ATTACK - 1.0) \
                * (gr0 - gr1)
            old_slope = -(gr0 - gr1)
            new_slope = -(current - gnew)
            steeper = new_slope <= old_slope
            safe = old_slope if old_slope != 0.0 else 1.0
            new_end = (gnew - gr0) / safe
            if not math.isnan(new_end):
                new_end = max(new_end, 1.0)
            new_start = new_end - 1.0
            sh_gr0 = gr0 + new_start * old_slope
            cur_pos = (current - sh_gr0) / safe
            if not math.isnan(cur_pos):
                cur_pos = min(max(cur_pos, 0.0), 1.0)
            sh_env = int((ATTACK - 1.0) * cur_pos)
            if lower:
                branch = "att_steeper" if steeper else "att_shallower"
                n_gr0 = current if steeper else sh_gr0
                n_gr1 = gnew
                n_env = 0 if steeper else sh_env
                n_sus = -1 if steeper else sh_env
                n_ls = ATT
            else:
                n_env = env1
                if found and env1 < ATTACK:
                    n_sus = env1
                if env1 == ATTACK and smp2 < nb:
                    n_ls = SUS
                branch = "att_to_sus" if n_ls == SUS else \
                    "att_found" if found else "att_run"
            n_smp = smp2
        elif ls == SUS:
            sc = np_smp - smp if found else sus
            have = found or sus >= 0
            s = max(min(sc, nb - smp), 0)
            cst = (smp, s if have else 0)
            n_smp = smp + s if have else smp
            s_lower = found and gnew < gr1
            n_gr0 = gr1 if s_lower else (gr0 if have else gr1)
            n_gr1 = gnew if s_lower else (gr1 if have else 1.0)
            sus_dec = sus - s
            n_sus = ((-1 if s_lower else LOOKAHEAD) if found
                     else (-1 if sus_dec == 0 else sus_dec)) if have else sus
            n_env = 0 if (s_lower or not have) else env
            n_ls = ATT if s_lower else (ls if have else REL)
            branch = "sus_lower" if s_lower else "sus_found" if found else \
                "sus_count" if have else "sus_to_rel"
        else:
            r_current = gr0 - div_number(envf, RELEASE - 1.0) * (gr1 - gr0)
            r_lower = found and gnew < r_current
            cst = (smp, max(np_smp - smp, 0) if r_lower else 0)
            rk = max(min(RELEASE - env, nb - smp), 0)
            lin = (smp, 0 if found else rk)
            lin_denom, lin_diff = RELEASE - 1.0, gr1 - gr0
            n_smp = np_smp if r_lower else (smp if found else smp + rk)
            n_env = 0 if r_lower else (env if found else env + rk)
            n_gr0 = r_current if r_lower else gr0
            n_gr1 = gnew if r_lower else (r_current if found else gr1)
            n_ls = ATT if r_lower else (SUS if found else
                                        (OUT if smp + rk < nb else ls))
            n_sus = -1 if r_lower else sus
            branch = "rel_lower" if r_lower else "rel_found" if found else \
                "rel_to_out" if n_ls == OUT else "rel_run"
        ranges = []
        l0, l1 = max(lin[0], 0), min(lin[0] + lin[1], FRAME)
        if l1 > l0:
            ranges.append((l0, l1, lin[0], True, envf, lin_denom, lin_diff,
                           gr0))
        c0, c1 = max(cst[0], 0), min(cst[0] + cst[1], FRAME)
        if c1 > c0:
            ranges.append((c0, c1, c0, False, 0.0, 1.0, 0.0, gr1))
        segs.extend(ranges)
        trace.append((smp, n_smp, ranges, branch))
        gr0, gr1, ls, env, sus, smp = n_gr0, n_gr1, n_ls, n_env, n_sus, n_smp
        iters += 1
        if len(segs) + 2 > KSEGS:
            flush()
    flush()
    head = x[:FRAME * C] * np.repeat(G, C)
    out = np.minimum(np.maximum(head, -tp), tp)
    return (np.concatenate([head, x[FRAME * C:]]), out, gr0, gr1, ls, env,
            sus, iters, trace)


def _limiter_window(B, C, spikes, seed, level=0.01):
    """(B, LIM*C) windows: a quiet sine of each lane's own phase plus
    noise, and `spikes[b]` a list of (position, height, channel or None
    for every channel) one-sample spikes in lane b."""
    rng = np.random.default_rng(seed)
    n = np.arange(LIM)
    x = np.empty((B, LIM, C))
    for b in range(B):
        x[b] = (level * np.sin(2 * np.pi * 300.0 * n / RATE
                               + rng.uniform(0, 6.3)))[:, None] \
            + 1e-4 * rng.standard_normal((LIM, C))
        for pos, h, ch in spikes[b]:
            if ch is None:
                x[b, pos, :] = h
            else:
                x[b, pos, ch % C] = h
    return x.reshape(B, LIM * C)


# each case: lanes of (state (ls, env, sus, gr0, gr1), spikes), nb, and
# the branches the machine must take in it
_LIMITER_CASES = {
    "no_peak": ([((OUT, 0, -1, 1.0, 1.0), [])], FRAME, {"out_none"}),
    "one_peak_out": ([((OUT, 0, -1, 1.0, 1.0), [(6000, 0.95, None)])],
                     FRAME, {"out_found", "att_to_sus", "sus_to_rel",
                             "rel_run"}),
    "attack_steeper": ([((OUT, 0, -1, 1.0, 1.0),
                         [(6000, 0.85, None), (6500, 0.99, 1)])],
                       FRAME, {"att_steeper"}),
    "attack_shallower": ([((OUT, 0, -1, 1.0, 1.0),
                           [(6000, 0.99, 0), (6100, 0.995, None)])],
                         FRAME, {"att_shallower"}),
    "sustain_to_release": ([((SUS, 700, 1000, 0.8, 0.8), [])], FRAME,
                           {"sus_count", "sus_to_rel", "rel_run"}),
    "release_to_out": ([((REL, 18000, -1, 0.8, 1.0), [])], FRAME,
                       {"rel_to_out", "out_none"}),
    "release_peaks": ([((REL, 5000, -1, 0.8, 1.0), [(4000, 0.99, None)]),
                       ((REL, 0, -1, 0.8, 1.0), [(4000, 0.999, None)])],
                      FRAME, {"rel_found", "sus_found", "rel_lower"}),
    "lookahead_at_frame_end": ([((OUT, 0, -1, 1.0, 1.0),
                                 [(20500, 0.9, None)])],
                               FRAME, {"out_found", "att_run"}),
    "nb_short": ([((OUT, 0, -1, 1.0, 1.0),
                   [(8000, 0.9, None), (9500, 0.99, None)])],
                 7000, {"out_found", "att_run"}),
    "done_beside_many": ([((OUT, 0, -1, 1.0, 1.0), []),
                          ((OUT, 0, -1, 1.0, 1.0),
                           [(2500 + 700 * i, 0.8 + 0.01 * i, i % 2)
                            for i in range(18)])],
                         FRAME, {"out_none", "att_steeper", "att_shallower",
                                 "att_to_sus"}),
}


def _limiter_inputs(lanes, C, seed):
    spikes = [sp for _, sp in lanes]
    x = torch.from_numpy(_limiter_window(len(lanes), C, spikes, seed))
    ls, env, sus, gr0, gr1 = (list(v) for v in zip(*[s for s, _ in lanes]))
    return (x, torch.tensor(gr0, dtype=torch.float64),
            torch.tensor(gr1, dtype=torch.float64),
            torch.tensor(ls, dtype=torch.int32),
            torch.tensor(env, dtype=torch.int32),
            torch.tensor(sus, dtype=torch.int32))


def _plain_with_iterations(params, args, nb):
    from gstpu_torch.utils import tracing
    spans = tracing.ProgramSpans()
    spans.install()
    try:
        got = tln._limiter_frame(params, *args, nb)
    finally:
        spans.uninstall()
    return got, spans.snapshot()["counters"].get("limiter.iterations", 0)


def _order_check(params, args, nb):
    """The kernel's order lane by lane against the plain form, bit for
    bit; returns each lane's trace."""
    want, iters = _plain_with_iterations(params, args, nb)
    x, gr0, gr1, ls, env, sus = args
    lanes = [_limiter_kernel_order(
        params.target_tp, params.channels, x[b].numpy(), float(gr0[b]),
        float(gr1[b]), int(ls[b]), int(env[b]), int(sus[b]), nb)
        for b in range(x.shape[0])]
    got = [torch.from_numpy(np.stack([r[0] for r in lanes])),
           torch.from_numpy(np.stack([r[1] for r in lanes]))]
    got += [torch.tensor([r[k] for r in lanes], dtype=dt) for k, dt in
            ((2, torch.float64), (3, torch.float64), (4, torch.int32),
             (5, torch.int32), (6, torch.int32))]
    for name, g, w in zip(("lim", "out", "gr0", "gr1", "lstate", "env_cnt",
                           "sus"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert max(r[7] for r in lanes) == iters
    return [r[8] for r in lanes]


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", sorted(_LIMITER_CASES))
def test_limiter_kernel_order(case, C):
    """kernels/limiter.cu's steps, emulated lane by lane, give the plain
    form's bits on every output and state and its iteration count, in
    each branch of the machine: no peak; a peak found in OUT; a higher
    peak during ATTACK (a steeper and a shallower slope, the second
    spike in one channel); SUSTAIN counting down into RELEASE; RELEASE
    back to OUT; peaks in RELEASE, lower and not; a peak in the look-
    ahead past the frame's end; nb < FRAME with a peak past it; a lane
    done after one iteration beside one that needs many. The card holds
    the kernel itself to the plain form (chip_smoke.py)."""
    lanes, nb, branches = _LIMITER_CASES[case]
    params = tln.LoudnormParams(channels=C)
    traces = _order_check(params, _limiter_inputs(lanes, C, 11 + C), nb)
    seen = {t[3] for tr in traces for t in tr}
    assert branches <= seen, (branches, seen)
    if case == "done_beside_many":
        assert len(traces[0]) == 1 and len(traces[1]) > 10


def _check_ranges(trace, nb):
    """What the kernel's range list rests on: each iteration writes
    inside [smp, its new smp) and smp never falls, so ranges are
    disjoint; at most three iterations in a row leave smp where it is,
    so a frame takes at most 4 nb iterations."""
    still = 0
    for smp, n_smp, ranges, _ in trace:
        assert n_smp >= smp
        for s0, s1, *_ in ranges:
            assert smp <= s0 < s1 <= n_smp
        still = still + 1 if n_smp == smp else 0
        assert still <= 3
    assert len(trace) <= 4 * nb


def _random_lanes(rng, B, C):
    lanes = []
    for _ in range(B):
        ls = int(rng.integers(0, 4))
        env = int(rng.integers(0, (RELEASE if ls == REL else ATTACK) + 1))
        sus = int(rng.choice([-1, 0, int(rng.integers(0, LOOKAHEAD + 1))]))
        gr = sorted(rng.uniform(0.5, 1.0, 2))
        spikes = [(int(rng.integers(1, tln.ABSW - 1)),
                   float(rng.uniform(0.5, 1.2)),
                   None if rng.random() < 0.5 else int(rng.integers(C)))
                  for _ in range(int(rng.integers(0, 40)))]
        if rng.random() < 0.3:       # a short plateau above the ceiling
            p = int(rng.integers(1, tln.ABSW - 200))
            spikes += [(p + i, 0.9, None) for i in range(60)]
        lanes.append(((ls, env, sus, float(gr[0]), float(gr[1])), spikes))
    return lanes


@pytest.mark.parametrize("seed", range(4))
def test_limiter_kernel_ranges_on_random_frames(seed):
    """Seeded random frames: random states, spikes and short plateaus,
    nb anywhere in [0, FRAME]; the kernel's order gives the plain form's
    bits and every lane keeps the bound the range list rests on."""
    rng = np.random.default_rng(1000 + seed)
    C = 1 + seed % 2
    nb = int(rng.integers(0, FRAME + 1)) if seed else FRAME
    lanes = _random_lanes(rng, 6, C)
    params = tln.LoudnormParams(channels=C)
    for trace in _order_check(params, _limiter_inputs(lanes, C, seed), nb):
        _check_ranges(trace, nb)


def test_limiter_kernel_plateau_bound():
    """A plateau above the ceiling over the whole frame makes every
    position a peak: the machine advances one sample an iteration, about
    nb iterations, more than the range list holds at once, and still
    within the bound. (The emulation alone: the plain form would take
    minutes.)"""
    x = _limiter_window(1, 2, [[(p, 0.9, None) for p in range(LIM)]], 3)
    *_, iters, trace = _limiter_kernel_order(
        tln.LoudnormParams(channels=2).target_tp, 2, x[0], 1.0, 1.0, OUT,
        0, -1, FRAME)
    _check_ranges(trace, FRAME)
    assert FRAME - LOOKAHEAD <= iters <= 4 * FRAME
    assert sum(len(t[2]) for t in trace) > KSEGS


@pytest.mark.parametrize("fault", [
    "lim_f32", "lim_width", "lim_columns", "gr0_f32", "lstate_i64",
    "sus_shape", "nb_past_frame", "nb_negative", "meta_device"])
def test_limiter_checks_raise(fault):
    """The limiter refuses what neither route takes, before it routes."""
    C = 2
    params = tln.LoudnormParams(channels=C)
    lim, gr0, gr1, ls, env, sus = _limiter_inputs(
        [((OUT, 0, -1, 1.0, 1.0), [])] * 2, C, 5)
    nb = FRAME
    if fault == "lim_f32":
        lim = lim.float()
    elif fault == "lim_width":
        lim = lim[:, :-C]
    elif fault == "lim_columns":
        lim = torch.cat([lim, lim], 1)[:, ::2]
    elif fault == "gr0_f32":
        gr0 = gr0.float()
    elif fault == "lstate_i64":
        ls = ls.long()
    elif fault == "sus_shape":
        sus = sus[:1]
    elif fault == "nb_past_frame":
        nb = FRAME + 1
    elif fault == "nb_negative":
        nb = -1
    elif fault == "meta_device":
        lim, gr0, gr1, ls, env, sus = (t.to("meta") for t in (
            lim, gr0, gr1, ls, env, sus))
    with pytest.raises(ValueError, match="_limiter_frame"):
        tln._limiter_frame(params, lim, gr0, gr1, ls, env, sus, nb)


@pytest.mark.parametrize("kind", ["steps", "meter"])
def test_gating_history_grows_instead_of_dropping(kind):
    """A history 16 blocks wide doubles before it could fill: the prime
    and six steps (the meter: 36 frames) give the bits of a history
    wide enough from the start, 33 blocks kept, none dropped."""
    x = _sine(GAIN_LOOKAHEAD + 6 * FRAME, amp=0.1)[None, :]
    x = torch.from_numpy(np.concatenate([x, 0.5 * x]))
    runs = []
    for width in (16, 64):
        params = tln.LoudnormParams(channels=1, max_blocks=width)
        if kind == "meter":
            st = tln.init_meter_state(params, 2, device="cpu")
            st, _, aux = tln.make_meter_step(params)(st, x)
            outs = [aux["global_"], aux["relative_threshold"]]
        else:
            first, inner = tln.make_steps(params)
            st = tln.init_state(params, 2, device="cpu")
            st, out = first(st, x[:, :GAIN_LOOKAHEAD])
            outs = [out]
            for k in range(6):
                off = GAIN_LOOKAHEAD + k * FRAME
                st, out = inner(st, x[:, off:off + FRAME])
                outs.append(out)
        runs.append((st, outs))
    (st, outs), (wide, wide_outs) = runs
    assert st["blocks"].shape == (2, 64)
    assert st["bcount"].tolist() == [33, 33]
    for a, b in zip(outs, wide_outs):
        assert torch.equal(a, b)
    for k, v in st.items():
        assert (torch.equal(v, wide[k]) if isinstance(v, torch.Tensor)
                else v == wide[k]), k
