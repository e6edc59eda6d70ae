"""The port's RNNoise core (gstpu_torch.ops.rnnoise) against gstpu's, on
the CPU.

- The host numpy part (window, band tables, SpectralGate, GruModel,
  FeatureExtractor, DenoiseState) is gstpu's code and gives gstpu's
  bits on seeded frames.
- TorchGruModel against the numpy GruModel: 1e-12 in f64, 2e-4 in f32
  (tests/test_rnnoise.py:173-175); its batch lanes equal single streams
  bit for bit.
- make_device_gru_denoiser and make_device_denoiser against the numpy
  oracle (output < 1e-9 * 32767, VAD < 1e-12; f32 output < 8.0, all on
  the +-32767 scale) and against gstpu's JAX twins on the same inputs
  (f64: output < 1e-9 * 32767, VAD < 1e-12; f32: output < 8.0).
- gstpu's state after one block, carried into the port
  (state_from_numpy), goes on as gstpu does.
- Lane 0 of a 1-stream run equals lane 0 of a 3-stream run bit for bit.
"""

import numpy as np
import pytest
import torch

from gstpu.ops import rnnoise as jax_rn
from gstpu_torch.ops import rnnoise as rn
from gstpu_torch.ops.rnnoise import (FRAME_SIZE, DenoiseState, GruModel,
                                     TorchGruModel, gru_from_numpy,
                                     make_device_denoiser,
                                     make_device_gru_denoiser,
                                     state_from_numpy, state_to_numpy)

SCALE = 32767.0
F64_TOL = 1e-9 * SCALE
F32_TOL = 8.0


def gru_weights(rng):
    """Seeded weights at the published RNNoise shapes
    (tests/test_rnnoise_device.py:83-99)."""
    def gru(inputs, units):
        return {"W": rng.normal(0, 0.1, (3 * units, inputs)),
                "U": rng.normal(0, 0.1, (3 * units, units)),
                "b": rng.normal(0, 0.1, 3 * units)}
    w = {"input_dense_W": rng.normal(0, 0.1, (24, 42)),
         "input_dense_b": rng.normal(0, 0.1, 24),
         "denoise_output_W": rng.normal(0, 0.1, (22, 96)),
         "denoise_output_b": rng.normal(0, 0.1, 22),
         "vad_output_W": rng.normal(0, 0.1, (1, 24)),
         "vad_output_b": rng.normal(0, 0.1, 1)}
    for name, d in (("vad_gru", gru(24, 24)),
                    ("noise_gru", gru(90, 48)),
                    ("denoise_gru", gru(114, 96))):
        for k, v in d.items():
            w[f"{name}_{k}"] = v
    return w


def voiced_signal(rng, B, F, base=200.0, step=60.0):
    """B streams of tones plus noise, on the +-32767 scale."""
    t = np.arange(F * FRAME_SIZE) / 48000
    return np.stack([0.3 * np.sin(2 * np.pi * (base + step * b) * t)
                     + 0.05 * rng.standard_normal(F * FRAME_SIZE)
                     for b in range(B)]) * SCALE


def oracle(x, weights=None):
    """The numpy DenoiseState per stream: (out (B, n), vad (B, F))."""
    B, n = x.shape
    F = n // FRAME_SIZE
    out, vad = np.zeros_like(x), np.zeros((B, F))
    for b in range(B):
        ds = DenoiseState(GruModel(weights) if weights else None)
        for f in range(F):
            sl = slice(f * FRAME_SIZE, (f + 1) * FRAME_SIZE)
            out[b, sl], vad[b, f] = ds.process_frame(x[b, sl])
    return out, vad


# -- the host numpy part, bit for bit with gstpu's ---------------------

def test_tables_match_gstpu():
    assert np.array_equal(rn.BAND_EDGES, jax_rn.BAND_EDGES)
    for name in ("FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE", "NB_BANDS",
                 "CEPS_MEM", "PITCH_MIN", "PITCH_MAX"):
        assert getattr(rn, name) == getattr(jax_rn, name)
    assert np.array_equal(rn.vorbis_window(), jax_rn.vorbis_window())
    assert np.array_equal(rn._dct_matrix(), jax_rn._dct_matrix())
    assert np.array_equal(rn._band_matrix(), jax_rn._band_matrix())
    assert np.array_equal(rn._interp_matrix(), jax_rn._interp_matrix())
    rng = np.random.default_rng(1)
    a = np.fft.rfft(rng.standard_normal((3, 960)))
    b = np.fft.rfft(rng.standard_normal((3, 960)))
    g = rng.uniform(0, 1, (3, rn.NB_BANDS))
    assert np.array_equal(rn.band_energies(a), jax_rn.band_energies(a))
    assert np.array_equal(rn.band_energies_cross(a, b),
                          jax_rn.band_energies_cross(a, b))
    assert np.array_equal(rn.interp_band_gain(g), jax_rn.interp_band_gain(g))


@pytest.mark.parametrize("engine", ["spectral", "gru"])
def test_denoise_state_matches_gstpu(engine):
    """DenoiseState (SpectralGate or GruModel + FeatureExtractor) gives
    gstpu's samples, VAD, features and model state bit for bit."""
    rng = np.random.default_rng(3)
    w = gru_weights(np.random.default_rng(4)) if engine == "gru" else None
    port = DenoiseState(GruModel(w) if w else None)
    ref = jax_rn.DenoiseState(jax_rn.GruModel(w) if w else None)
    x = voiced_signal(rng, 1, 14)[0]
    for f in range(14):
        frame = x[f * FRAME_SIZE:(f + 1) * FRAME_SIZE]
        (y, v), (yj, vj) = port.process_frame(frame), \
            ref.process_frame(frame)
        assert np.array_equal(y, yj) and v == vj
    for a in ("analysis_mem", "synthesis_mem"):
        assert np.array_equal(getattr(port, a), getattr(ref, a))
    assert np.array_equal(port.feat.ceps_hist, ref.feat.ceps_hist)
    assert np.array_equal(port.feat.pitch_buf, ref.feat.pitch_buf)
    assert port.feat.hist_pos == ref.feat.hist_pos
    if w:
        for h in ("h_vad", "h_noise", "h_denoise"):
            assert np.array_equal(getattr(port.model, h),
                                  getattr(ref.model, h))
    else:
        assert np.array_equal(port.model.noise, ref.model.noise)
        assert np.array_equal(port.model.smoothed, ref.model.smoothed)
    port.reset()
    assert port.feat.hist_pos == 0 and not port.synthesis_mem.any()


def test_feature_extractor_matches_gstpu():
    """The 42 features (incl. the host pitch search) bit for bit."""
    port, ref = rn.FeatureExtractor(), jax_rn.FeatureExtractor()
    win = rn.vorbis_window()
    rng = np.random.default_rng(5)
    t = np.arange(FRAME_SIZE * 8) / 48000.0
    sig = 5000 * np.sin(2 * np.pi * 200.0 * t) \
        + 300 * rng.standard_normal(t.size)
    prev = np.zeros(FRAME_SIZE)
    for k in range(8):
        x = sig[k * FRAME_SIZE:(k + 1) * FRAME_SIZE]
        spec = np.fft.rfft(np.concatenate([prev, x]) * win)
        prev = x
        eb = rn.band_energies(spec)
        f, fj = port.features(spec, eb, x), ref.features(spec, eb, x)
        assert f.shape == (42,) and np.array_equal(f, fj)
    assert abs(f[40] / 0.01 + 300 - 240) < 8     # the 200 Hz period


# -- the network in torch --------------------------------------------

def test_torch_gru_matches_numpy_oracle():
    """f64: 1e-12 on gains and VAD; f32: 2e-4 on gains and the same VAD
    decisions (tests/test_rnnoise.py:157-176)."""
    rng = np.random.default_rng(3)
    w = gru_weights(rng)
    oracle_m = GruModel(w)
    dev64 = TorchGruModel(w, dtype=torch.float64, device="cpu")
    dev32 = TorchGruModel(w, dtype=torch.float32, device="cpu")
    for t in range(25):
        feats = rng.normal(0, 1.0, 42)
        g_ref, v_ref = oracle_m.frame_gains(feats)
        g_64, v_64 = dev64.frame_gains(feats)
        g_32, v_32 = dev32.frame_gains(feats)
        assert g_64.dtype == np.float64 and isinstance(v_64, float)
        np.testing.assert_allclose(g_64, g_ref, rtol=0, atol=1e-12)
        assert abs(v_64 - v_ref) < 1e-12
        np.testing.assert_allclose(g_32, g_ref, rtol=0, atol=2e-4)
        assert (v_32 > 0.5) == (v_ref > 0.5)


def test_torch_gru_batch_lanes_equal_single_streams(tmp_path):
    """batch_step's lanes equal independent single-stream models bit
    for bit (gstpu's JAX twin agrees to 1e-5 only: XLA picks matmul
    kernels by shape; the port sums in a fixed order)."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "w.npz")
    np.savez(path, **gru_weights(rng))
    feats = rng.normal(0, 1.0, (12, 3, 42)).astype(np.float32)
    batch = TorchGruModel.load(path, device="cpu")
    batch.reset(batch=3)
    singles = [TorchGruModel.load(path, device="cpu") for _ in range(3)]
    for t in range(feats.shape[0]):
        gb, vb = batch.batch_step(torch.from_numpy(feats[t]))
        for i, s in enumerate(singles):
            gs, vs = s.frame_gains(feats[t, i])
            assert np.array_equal(gb[i].double().numpy(), gs)
            assert float(vb[i]) == vs


def test_gru_from_numpy_holds_the_weight_groups():
    w = gru_weights(np.random.default_rng(6))
    net = gru_from_numpy(w, torch.float32, "cpu")
    assert isinstance(net, torch.nn.Module)
    assert net.sizes() == (24, 48, 96)
    bufs = dict(net.named_buffers())
    assert set(bufs) == set(w)
    for k, v in w.items():
        assert bufs[k].dtype == torch.float32
        assert np.array_equal(bufs[k].numpy(), v.astype(np.float32))


# -- the device denoisers -------------------------------------------

B, F = 3, 12


@pytest.fixture(scope="module")
def case():
    """Seeded weights and input (tests/test_rnnoise_device.py:102-132),
    the numpy oracle's output, the port's at B=3 and B=1 and gstpu's,
    in both precisions and for both denoisers."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    w = gru_weights(rng)
    x = voiced_signal(rng, B, F)
    res = {"w": w, "x": x, "oracle_gru": oracle(x, w),
           "oracle_spectral": oracle(x)}
    xt = torch.from_numpy(x)
    for name, dt, jdt in (("f64", torch.float64, jnp.float64),
                          ("f32", torch.float32, jnp.float32)):
        step, init = make_device_gru_denoiser(w, F, dtype=dt)
        res[f"gru_{name}"] = step(init(B, "cpu"), xt)
        res[f"gru_{name}_b1"] = step(init(1, "cpu"), xt[:1])
        jstep, jinit = jax_rn.make_device_gru_denoiser(w, F, dtype=jdt)
        res[f"jax_gru_{name}"] = jstep(jinit(B), jnp.asarray(x, jdt))
    step, init = make_device_denoiser(F)
    res["spectral"] = step(init(B, "cpu"), xt)
    res["spectral_b1"] = step(init(1, "cpu"), xt[:1])
    jstep, jinit = jax_rn.make_device_denoiser(F)
    res["jax_spectral"] = jstep(jinit(B), jnp.asarray(x))
    return res


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("kind", ["gru_f64", "spectral"])
def test_device_twin_matches_host_oracle_f64(case, kind):
    _, out, vads = case[kind]
    want_out, want_vad = case["oracle_" + kind.split("_")[0]]
    assert out.dtype == torch.float64 and out.shape == (B, F * FRAME_SIZE)
    assert vads.shape == (B, F)
    assert _err(out, want_out) < F64_TOL
    assert _err(vads, want_vad) < 1e-12


def test_gru_device_twin_f32_tracks_host_oracle(case):
    _, out, vads = case["gru_f32"]
    assert out.dtype == torch.float32
    assert _err(out, case["oracle_gru"][0]) < F32_TOL


@pytest.mark.parametrize("kind,tol,vad_tol", [
    ("gru_f64", F64_TOL, 1e-12), ("gru_f32", F32_TOL, 1e-3),
    ("spectral", F64_TOL, 1e-12)])
def test_device_twin_matches_gstpu(case, kind, tol, vad_tol):
    st, out, vads = case[kind]
    jst, jout, jvads = case["jax_" + kind]
    assert _err(out, jout) < tol
    assert _err(vads, jvads) < vad_tol
    got = state_to_numpy(st)
    assert set(got) == set(jst)
    for k, v in jst.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert np.array_equal(got.get("hist_pos", 0),
                          np.asarray(jst.get("hist_pos", 0)))


@pytest.mark.parametrize("kind", ["gru_f64", "gru_f32", "spectral"])
def test_lane0_of_one_stream_equals_three_streams(case, kind):
    st, out, vads = case[kind]
    st1, out1, vads1 = case[kind + "_b1"]
    assert torch.equal(out1[0], out[0]) and torch.equal(vads1[0], vads[0])
    for k in st:
        assert torch.equal(st1[k][0], st[k][0]), k


@pytest.mark.parametrize("kind", ["gru", "spectral"])
def test_state_carried_from_gstpu(kind):
    """gstpu runs one 4-frame block; its state, carried into the port,
    continues through the next block as gstpu's does."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    w = gru_weights(rng)
    x = voiced_signal(rng, 2, 8, base=150.0, step=90.0)
    if kind == "gru":
        jstep, jinit = jax_rn.make_device_gru_denoiser(w, 4)
        step, init = make_device_gru_denoiser(w, 4)
    else:
        jstep, jinit = jax_rn.make_device_denoiser(4)
        step, init = make_device_denoiser(4)
    half = 4 * FRAME_SIZE
    jst, _, _ = jstep(jinit(2), jnp.asarray(x[:, :half]))
    jst2, jout, jvad = jstep(jst, jnp.asarray(x[:, half:]))
    st = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                          "cpu")
    assert {k: v.dtype for k, v in state_to_numpy(st).items()} == \
        {k: np.asarray(v).dtype for k, v in jst.items()}
    st2, out, vad = step(st, torch.from_numpy(x[:, half:]))
    assert _err(out, jout) < F64_TOL
    assert _err(vad, jvad) < 1e-12
    for k, v in state_to_numpy(st2).items():     # band energies ~1e12
        ref = np.asarray(jst2[k], np.float64)
        assert _err(v, ref) <= 1e-12 * max(1.0, np.abs(ref).max()), k
    # and the whole run against the oracle
    want_out, _ = oracle(x, w if kind == "gru" else None)
    assert _err(out, want_out[:, half:]) < F64_TOL


def test_device_twin_does_not_keep_a_view_of_the_input():
    """The carried state holds the block's own frames: writing into the
    caller's tensor afterwards does not reach it."""
    step, init = make_device_denoiser(2)
    x = torch.from_numpy(voiced_signal(np.random.default_rng(1), 2, 2))
    st, _, _ = step(init(2, "cpu"), x)
    before = st["analysis"].clone()
    x.zero_()
    assert torch.equal(st["analysis"], before)


def test_window_sums_match_a_direct_sum():
    v = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (3, 1728)))
    got = rn._window_sums(v, 960)
    want = v.unfold(1, 960, 1).sum(-1)
    assert got.shape == (3, 769)
    assert float((got - want).abs().max()) < 1e-11
    assert torch.equal(rn._window_sums(v[:1], 960)[0], got[0])
