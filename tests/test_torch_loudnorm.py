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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.core.audio import AudioInfo
from gstpu.elements.audio.loudnorm import _LoudNormState
from gstpu.ops import biquad as jbq
from gstpu.ops import loudnorm_dev as jln
from gstpu_torch.ops import loudnorm_dev as tln

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
