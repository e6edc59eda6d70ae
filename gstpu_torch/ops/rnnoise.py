"""RNNoise-style denoiser core: band-gain spectral suppression.

The port of gstpu/ops/rnnoise.py. The host part (the frame machinery,
`SpectralGate`, `GruModel`, `FeatureExtractor`, `DenoiseState`) is
gstpu's numpy code as it stands, bit for bit: it is the oracle that both
packages' device paths are held to. The device part is torch:
`RnnoiseGru` (the network as an nn.Module, made by `gru_from_numpy`
from the same .npz dict), `TorchGruModel` (the per-element engine),
and the batched twins of `DenoiseState`, `make_device_denoiser` (the
spectral gate) and `make_device_gru_denoiser` (the whole RNNoise chain),
whose `lax.scan` over frames is a Python loop over a block's frames with
no host sync inside.

Lanes are bitwise independent on every device: a stream's output at B
streams equals its output at B=1. Every sum over a feature, band or tap
axis is `_tree_sum_last` (a fixed halving order of elementwise adds),
never a matmul or a torch reduction, whose order cuBLAS, CPU BLAS and
the CUDA reduction kernels pick by shape; the FFTs are torch.fft, whose
960-point transforms keep each lane's bits at every batch size on the
CPU and the H100.

Engine background (gstpu's): 480-sample frames at 48 kHz, 960-point
Vorbis-windowed STFT with 50% overlap-add, 22 triangular bands (the
RNNoise eband5ms layout), per-band gains interpolated to bins, and a
voice-activity estimate. The published RNNoise weights are not
redistributable inside this repo; any weight set with the matching
shapes loads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gstpu_torch.ops.biquad import _tree_sum_last

FRAME_SIZE = 480
WINDOW_SIZE = 2 * FRAME_SIZE
FREQ_SIZE = FRAME_SIZE + 1
NB_BANDS = 22

# RNNoise band edges in FFT bins (eband5ms << 2)
_EBAND5MS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24,
                      28, 34, 40, 48, 60, 78, 100])
BAND_EDGES = _EBAND5MS * 4  # bins into the 481-bin half spectrum


def vorbis_window() -> np.ndarray:
    """sin(pi/2 * sin^2) window used by RNNoise's analysis/synthesis."""
    i = np.arange(WINDOW_SIZE)
    inner = np.sin(0.5 * np.pi * (i + 0.5) / FRAME_SIZE)
    # first half ascends, second half descends (symmetric)
    half = np.sin(0.5 * np.pi * np.sin(
        0.5 * np.pi * (np.arange(FRAME_SIZE) + 0.5) / FRAME_SIZE) ** 2)
    return np.concatenate([half, half[::-1]])


def band_energies(spec: np.ndarray) -> np.ndarray:
    """Triangular-interpolated band energies (compute_band_energy)."""
    e = np.zeros(spec.shape[:-1] + (NB_BANDS,))
    p = np.abs(spec) ** 2
    for b in range(NB_BANDS - 1):
        lo, hi = BAND_EDGES[b], BAND_EDGES[b + 1]
        size = hi - lo
        frac = np.arange(size) / size
        seg = p[..., lo:hi]
        e[..., b] += np.sum(seg * (1 - frac), axis=-1)
        e[..., b + 1] += np.sum(seg * frac, axis=-1)
    e[..., 0] *= 2
    e[..., -1] *= 2
    return e


def interp_band_gain(gains: np.ndarray) -> np.ndarray:
    """Expand per-band gains to per-bin gains (interp_band_gain)."""
    out = np.zeros(gains.shape[:-1] + (FREQ_SIZE,))
    for b in range(NB_BANDS - 1):
        lo, hi = BAND_EDGES[b], BAND_EDGES[b + 1]
        size = hi - lo
        frac = np.arange(size) / size
        out[..., lo:hi] = (gains[..., b, None] * (1 - frac)
                           + gains[..., b + 1, None] * frac)
    out[..., BAND_EDGES[-1]:] = gains[..., -1, None]
    return out


class SpectralGate:
    """Minimum-statistics noise tracker + Wiener gain (classical
    fallback model; stateful per stream)."""

    def __init__(self, alpha: float = 0.95, floor_track: float = 0.9995,
                 min_gain: float = 0.05):
        self.alpha = alpha
        self.floor_track = floor_track
        self.min_gain = min_gain
        self.noise = None
        self.smoothed = None

    def frame_gains(self, eb: np.ndarray) -> tuple[np.ndarray, float]:
        if self.noise is None:
            self.noise = eb.copy() + 1e-10
            self.smoothed = eb.copy()
            return np.ones(NB_BANDS), 0.0
        self.smoothed = (self.alpha * self.smoothed
                         + (1 - self.alpha) * eb)
        # noise floor: fast decay down, very slow rise
        self.noise = np.where(self.smoothed < self.noise, self.smoothed,
                              self.noise / self.floor_track)
        snr = self.smoothed / (self.noise + 1e-10)
        # Wiener-style gain with oversubtraction: bands at the noise
        # floor (snr ~ 1) collapse to min_gain, strong bands pass
        gains = np.clip(1.0 - 2.0 / np.maximum(snr, 1e-3),
                        self.min_gain, 1.0)
        # VAD heuristic: energy of mid bands well above the floor
        voiced_snr = float(np.mean(snr[2:16]))
        vad = float(np.clip((voiced_snr - 1.5) / 8.0, 0.0, 1.0))
        return gains, vad

    def reset(self):
        self.noise = None
        self.smoothed = None


@dataclass
class GruLayer:
    """RNNoise GRU cell weights (input, recurrent, bias) with the
    rnnoise activation layout."""

    W: np.ndarray   # (3*units, inputs)
    U: np.ndarray   # (3*units, units)
    b: np.ndarray   # (3*units,)
    activation: str = "relu"

    @property
    def units(self) -> int:
        return self.U.shape[1]

    def step(self, h: np.ndarray, x: np.ndarray) -> np.ndarray:
        n = self.units
        zrh = self.W @ x + self.b
        rec = self.U @ h
        z = _sigmoid(zrh[:n] + rec[:n])
        r = _sigmoid(zrh[n:2 * n] + rec[n:2 * n])
        hh = zrh[2 * n:] + r * rec[2 * n:]
        hh = np.tanh(hh) if self.activation == "tanh" else np.maximum(hh, 0)
        return z * h + (1 - z) * hh


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class GruModel:
    """RNNoise network: input dense(24, tanh) -> vad GRU(24) ->
    noise GRU(48) -> denoise GRU(96) -> gains dense(22, sigmoid),
    vad dense(1, sigmoid). Weights from an .npz with keys
    input_dense_{W,b}, vad_gru_{W,U,b}, noise_gru_{W,U,b},
    denoise_gru_{W,U,b}, denoise_output_{W,b}, vad_output_{W,b}."""

    N_FEATURES = 42

    def __init__(self, weights: dict):
        w = weights
        self.dense_W = w["input_dense_W"]
        self.dense_b = w["input_dense_b"]
        self.vad_gru = GruLayer(w["vad_gru_W"], w["vad_gru_U"],
                                w["vad_gru_b"])
        self.noise_gru = GruLayer(w["noise_gru_W"], w["noise_gru_U"],
                                  w["noise_gru_b"])
        self.denoise_gru = GruLayer(w["denoise_gru_W"], w["denoise_gru_U"],
                                    w["denoise_gru_b"])
        self.out_W = w["denoise_output_W"]
        self.out_b = w["denoise_output_b"]
        self.vad_W = w["vad_output_W"]
        self.vad_b = w["vad_output_b"]
        self.reset()

    @classmethod
    def load(cls, path: str) -> "GruModel":
        return cls(dict(np.load(path)))

    def reset(self):
        self.h_vad = np.zeros(self.vad_gru.units)
        self.h_noise = np.zeros(self.noise_gru.units)
        self.h_denoise = np.zeros(self.denoise_gru.units)

    def frame_gains(self, features: np.ndarray) -> tuple[np.ndarray, float]:
        d = np.tanh(self.dense_W @ features + self.dense_b)
        self.h_vad = self.vad_gru.step(self.h_vad, d)
        vad = float(_sigmoid(self.vad_W @ self.h_vad + self.vad_b)[0])
        noise_in = np.concatenate([d, self.h_vad, features])
        self.h_noise = self.noise_gru.step(self.h_noise, noise_in)
        dn_in = np.concatenate([self.h_vad, self.h_noise, features])
        self.h_denoise = self.denoise_gru.step(self.h_denoise, dn_in)
        gains = _sigmoid(self.out_W @ self.h_denoise + self.out_b)
        return gains, vad


_DCT22 = None


def _dct_matrix(n: int = NB_BANDS) -> np.ndarray:
    """Orthonormal DCT-II (rnnoise's dct() over band energies)."""
    global _DCT22
    if _DCT22 is None or _DCT22.shape[0] != n:
        k = np.arange(n)[:, None]
        i = np.arange(n)[None, :]
        m = np.cos(np.pi * k * (i + 0.5) / n) * np.sqrt(2.0 / n)
        m[0] *= 1.0 / np.sqrt(2.0)
        _DCT22 = m
    return _DCT22


CEPS_MEM = 8
PITCH_MIN = 60            # ~800 Hz
PITCH_MAX = 768           # ~62 Hz (rnnoise PITCH_MAX_PERIOD)


class FeatureExtractor:
    """The RNNoise 42-feature frontend layout
    (audio/audiofx/src/audiornnoise via the nnnoiseless crate):

      [0..21]  BFCC — DCT-II of log10 band energies (cepstrum)
      [22..27] first temporal derivative of BFCC 0..5
      [28..33] second temporal derivative of BFCC 0..5
      [34..39] DCT of the per-band pitch correlation, first 6
      [40]     pitch period (normalized)
      [41]     spectral variability over the cepstral history

    Deviation note: the pitch estimator here is a plain normalized
    autocorrelation search over [PITCH_MIN, PITCH_MAX) instead of the
    reference's two-pass downsampled search with comb rejection —
    published rnnoise weights therefore need the matching frontend;
    the architecture (shapes, feature semantics) is exact and any
    weight set trained against THIS frontend is plug-in.
    """

    def __init__(self):
        self.ceps_hist = np.zeros((CEPS_MEM, NB_BANDS))
        self.hist_pos = 0
        self.pitch_buf = np.zeros(PITCH_MAX + WINDOW_SIZE)
        self.window = vorbis_window()

    def _pitch(self, frame: np.ndarray) -> tuple[int, float]:
        buf = self.pitch_buf
        buf[:-FRAME_SIZE] = buf[FRAME_SIZE:]
        buf[-FRAME_SIZE:] = frame
        x = buf[-WINDOW_SIZE:]
        xe = float(np.dot(x, x)) + 1e-6

        def score(t):
            y = buf[-WINDOW_SIZE - t:-t]
            c = float(np.dot(x, y))
            ye = float(np.dot(y, y)) + 1e-6
            return c / np.sqrt(xe * ye)

        best_t, best_c = PITCH_MIN, 0.0
        for t in range(PITCH_MIN, PITCH_MAX, 4):
            s = score(t)
            if s > best_c:
                best_c, best_t = s, t
        # submultiple check: a periodic signal correlates equally at
        # k*T; prefer the shortest lag that explains the signal
        for k in (4, 3, 2):
            t2 = best_t // k
            if t2 >= PITCH_MIN:
                s2 = score(t2)
                if s2 > 0.85 * best_c:
                    best_c, best_t = s2, t2
                    break
        return best_t, best_c

    def features(self, spec: np.ndarray, eb: np.ndarray,
                 frame: np.ndarray) -> np.ndarray:
        logs = np.log10(eb + 1e-2)
        ceps = _dct_matrix() @ logs
        hist = self.ceps_hist
        prev1 = hist[(self.hist_pos - 1) % CEPS_MEM]
        prev2 = hist[(self.hist_pos - 2) % CEPS_MEM]
        d1 = ceps[:6] - prev1[:6]
        d2 = ceps[:6] - 2 * prev1[:6] + prev2[:6]
        hist[self.hist_pos % CEPS_MEM] = ceps
        self.hist_pos += 1

        # pitch correlation per band: correlate the spectrum with the
        # pitch-delayed window's spectrum
        period, corr = self._pitch(frame)
        delayed = self.pitch_buf[-WINDOW_SIZE - period:-period]
        pspec = np.fft.rfft(delayed * self.window)
        num = band_energies_cross(spec, pspec)
        den = np.sqrt(band_energies(spec)
                      * band_energies(pspec)) + 1e-6
        band_corr = np.clip(num / den, -1.0, 1.0)
        pitch_dct = (_dct_matrix() @ band_corr)[:6]

        # spectral variability: mean over history of the min distance
        # to other history entries (rnnoise spec_variability)
        n = min(self.hist_pos, CEPS_MEM)
        var = 0.0
        if n > 1:
            h = hist[:n]
            d = ((h[:, None, :] - h[None, :, :]) ** 2).sum(-1)
            d += np.eye(n) * 1e9
            var = float(np.mean(d.min(axis=1)))

        feat = np.concatenate([
            ceps, d1, d2, pitch_dct,
            [0.01 * (period - 300), var / 100.0]])
        assert feat.shape[0] == 42, feat.shape
        return feat

    def reset(self):
        self.ceps_hist[:] = 0
        self.hist_pos = 0
        self.pitch_buf[:] = 0


def band_energies_cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cross band energies Re(a * conj(b)) (compute_band_corr)."""
    e = np.zeros(a.shape[:-1] + (NB_BANDS,))
    p = (a * np.conj(b)).real
    for band in range(NB_BANDS - 1):
        lo, hi = BAND_EDGES[band], BAND_EDGES[band + 1]
        size = hi - lo
        frac = np.arange(size) / size
        seg = p[..., lo:hi]
        e[..., band] += np.sum(seg * (1 - frac), axis=-1)
        e[..., band + 1] += np.sum(seg * frac, axis=-1)
    e[..., 0] *= 2
    e[..., -1] *= 2
    return e


class DenoiseState:
    """Streaming per-channel denoiser (nnnoiseless DenoiseState
    analogue): feed 480-sample frames, get denoised frames + VAD."""

    def __init__(self, model=None):
        self.window = vorbis_window()
        self.model = model if model is not None else SpectralGate()
        self.analysis_mem = np.zeros(FRAME_SIZE)   # previous input half
        self.synthesis_mem = np.zeros(FRAME_SIZE)  # overlap-add tail
        self.feat = FeatureExtractor()

    def process_frame(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        """x: (480,) float in [-1, 1]; returns (denoised, vad)."""
        buf = np.concatenate([self.analysis_mem, x])
        self.analysis_mem = x.copy()
        spec = np.fft.rfft(buf * self.window)
        eb = band_energies(spec)

        if isinstance(self.model, SpectralGate):
            gains, vad = self.model.frame_gains(eb)
        else:
            feats = self.feat.features(spec, eb, x)
            gains, vad = self.model.frame_gains(feats)

        g = interp_band_gain(gains)
        out_spec = spec * g
        frame = np.fft.irfft(out_spec) * self.window
        out = frame[:FRAME_SIZE] + self.synthesis_mem
        self.synthesis_mem = frame[FRAME_SIZE:]
        return out, vad

    def reset(self):
        self.analysis_mem[:] = 0
        self.synthesis_mem[:] = 0
        self.feat.reset()
        if hasattr(self.model, "reset"):
            self.model.reset()


# ---------------------------------------------------------------------------
# the network in torch (the device engine)
# ---------------------------------------------------------------------------

def _lanewise(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for a transcendental (sigmoid, tanh, log10) with the same
    bits in every lane at every batch size. Torch's CPU kernels evaluate
    these one way in their vector loop and another in its scalar tail,
    so the last dim is padded with ones to a multiple of 64: every
    element then lies in the vector loop. On the card every element
    takes the same code anyway."""
    n = x.shape[-1]
    pad = -n % 64
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=1.0)
    return fn(x)[..., :n]


def _matvec(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """x @ W.T over the last dim of x, as a broadcast product summed by
    _tree_sum_last: the same bits for a lane at every batch size."""
    return _tree_sum_last(x[..., None, :] * W)


class RnnoiseGru(torch.nn.Module):
    """The RNNoise network of GruModel: input dense(24, tanh) -> vad
    GRU(24) -> noise GRU(48) -> denoise GRU(96) -> gains dense(22,
    sigmoid), vad dense(1, sigmoid). Its buffers are the six weight
    groups under the .npz keys (input_dense_{W,b}, vad_gru_{W,U,b},
    noise_gru_{W,U,b}, denoise_gru_{W,U,b}, denoise_output_{W,b},
    vad_output_{W,b}). forward(hs, feats (..., 42)) -> (hs, gains
    (..., 22), vad (...)), hs = (h_vad, h_noise, h_den)."""

    def __init__(self, weights: dict):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k, v)

    def sizes(self) -> tuple:
        return tuple(getattr(self, f"{n}_U").shape[1]
                     for n in ("vad_gru", "noise_gru", "denoise_gru"))

    def _gru(self, name: str, h, x):
        W = getattr(self, f"{name}_W")
        U = getattr(self, f"{name}_U")
        b = getattr(self, f"{name}_b")
        n = U.shape[1]
        zrh = _matvec(x, W) + b
        rec = _matvec(h, U)
        z = _lanewise(torch.sigmoid, zrh[..., :n] + rec[..., :n])
        r = _lanewise(torch.sigmoid,
                      zrh[..., n:2 * n] + rec[..., n:2 * n])
        hh = zrh[..., 2 * n:] + r * rec[..., 2 * n:]
        hh = torch.clamp(hh, min=0.0)
        return z * h + (1 - z) * hh

    def forward(self, hs, feats):
        h_vad, h_noise, h_den = hs
        d = _lanewise(torch.tanh, _matvec(feats, self.input_dense_W)
                      + self.input_dense_b)
        h_vad = self._gru("vad_gru", h_vad, d)
        vad = _lanewise(torch.sigmoid, _matvec(h_vad, self.vad_output_W)
                        + self.vad_output_b)[..., 0]
        noise_in = torch.cat([d, h_vad, feats], dim=-1)
        h_noise = self._gru("noise_gru", h_noise, noise_in)
        dn_in = torch.cat([h_vad, h_noise, feats], dim=-1)
        h_den = self._gru("denoise_gru", h_den, dn_in)
        gains = _lanewise(torch.sigmoid,
                          _matvec(h_den, self.denoise_output_W)
                          + self.denoise_output_b)
        return (h_vad, h_noise, h_den), gains, vad


def gru_from_numpy(weights: dict, dtype=torch.float32,
                   device="cuda") -> RnnoiseGru:
    """RnnoiseGru from the .npz dict that GruModel and gstpu load, each
    array rounded once to `dtype`, on `device`."""
    return RnnoiseGru({k: torch.from_numpy(np.array(v, np.float64))
                       .to(device=device, dtype=dtype)
                       for k, v in weights.items()})


class TorchGruModel:
    """The same RNNoise network as GruModel, as torch ops on `device` in
    `dtype`: the device engine of one element (B=1, frame_gains) or of a
    batch (batch_step). Agrees with the numpy oracle to the reduction
    order in f64 (tests/test_torch_rnnoise.py)."""

    def __init__(self, weights: dict, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.net = gru_from_numpy(weights, dtype, self.device)
        self.reset()

    @classmethod
    def load(cls, path: str, dtype=torch.float32,
             device="cuda") -> "TorchGruModel":
        return cls(dict(np.load(path)), dtype, device)

    def reset(self, batch: int = 1):
        self._h = tuple(torch.zeros((batch, n), dtype=self.dtype,
                                    device=self.device)
                        for n in self.net.sizes())

    def frame_gains(self, features: np.ndarray):
        """Streaming single-stream API (GruModel-compatible)."""
        x = torch.from_numpy(np.asarray(features, np.float64)[None]) \
            .to(device=self.device, dtype=self.dtype)
        self._h, gains, vad = self.net(self._h, x)
        return (gains[0].to(torch.float64).cpu().numpy(),
                float(vad[0]))

    def batch_step(self, feats_b: torch.Tensor):
        """(B, 42) batched step; returns (gains (B, 22), vad (B,))."""
        self._h, gains, vad = self.net(self._h, feats_b)
        return gains, vad


# ---------------------------------------------------------------------------
# fully-device denoisers (DeviceContext execution path)
# ---------------------------------------------------------------------------

def _band_matrix() -> np.ndarray:
    """(FREQ_SIZE, NB_BANDS) triangular weights: band_energies(p) ==
    p @ W (the loops above as one product)."""
    W = np.zeros((FREQ_SIZE, NB_BANDS))
    for b in range(NB_BANDS - 1):
        lo, hi = BAND_EDGES[b], BAND_EDGES[b + 1]
        frac = np.arange(hi - lo) / (hi - lo)
        W[lo:hi, b] += 1 - frac
        W[lo:hi, b + 1] += frac
    W[:, 0] *= 2
    W[:, -1] *= 2
    return W


def _interp_matrix() -> np.ndarray:
    """(NB_BANDS, FREQ_SIZE): interp_band_gain as a product."""
    G = np.zeros((NB_BANDS, FREQ_SIZE))
    for b in range(NB_BANDS - 1):
        lo, hi = BAND_EDGES[b], BAND_EDGES[b + 1]
        frac = np.arange(hi - lo) / (hi - lo)
        G[b, lo:hi] = 1 - frac
        G[b + 1, lo:hi] = frac
    G[-1, BAND_EDGES[-1]:] = 1.0
    return G


def _tables(arrays: dict, dtype):
    """device -> {name: tensor}: `arrays` uploaded once per device, the
    float ones in `dtype`, the integer ones as int64."""
    cache = {}

    def on(device) -> dict:
        t = cache.get(device)
        if t is None:
            t = cache[device] = {
                k: torch.from_numpy(np.array(v)).to(
                    device=device,
                    dtype=dtype if np.asarray(v).dtype.kind == "f"
                    else torch.int64)
                for k, v in arrays.items()}
        return t
    return on


def _power(spec: torch.Tensor) -> torch.Tensor:
    """|spec|^2 as re^2 + im^2."""
    return spec.real * spec.real + spec.imag * spec.imag


def _frames(xb: torch.Tensor, dtype) -> torch.Tensor:
    """(B, F*480) -> a (B, F, 480) copy in `dtype`: the state keeps
    views of a block's frames, never of the caller's tensor."""
    return xb.to(dtype, copy=True).reshape(xb.shape[0], -1, FRAME_SIZE)


def make_device_denoiser(frames_per_block: int = 10,
                         alpha: float = 0.95,
                         floor_track: float = 0.9995,
                         min_gain: float = 0.05):
    """Batched device twin of DenoiseState with the SpectralGate model
    (the element's default engine): STFT -> band energies -> noise-floor
    tracking -> Wiener band gains -> gain interpolation -> iSTFT
    overlap-add, frame by frame over the block (f64).

    init(batch, device="cuda") -> state;  step(state, x (B, F*480))
        -> (state, out (B, F*480), vads (B, F))
    Math follows SpectralGate.frame_gains / DenoiseState.process_frame
    operation for operation; the step runs on the device of x (F is
    x's, as in gstpu; `frames_per_block` names the element's block).
    """
    f64 = torch.float64
    tables = _tables(dict(win=vorbis_window(), Wb=_band_matrix().T,
                          Gi=_interp_matrix().T), f64)

    def init(batch: int, device="cuda") -> dict:
        z = lambda *s: torch.zeros(s, dtype=f64, device=device)  # noqa: E731
        return dict(analysis=z(batch, FRAME_SIZE),
                    synth=z(batch, FRAME_SIZE),
                    noise=z(batch, NB_BANDS),
                    smoothed=z(batch, NB_BANDS),
                    started=torch.zeros(batch, dtype=torch.bool,
                                        device=device),
                    vad=z(batch))

    def frame(st, x, c):
        buf = torch.cat([st["analysis"], x], dim=1)
        spec = torch.fft.rfft(buf * c["win"])
        eb = _matvec(_power(spec), c["Wb"])
        started = st["started"][:, None]
        # init frame: noise := eb + 1e-10, smoothed := eb, NO floor
        # update (SpectralGate.frame_gains first-call semantics)
        sm_upd = alpha * st["smoothed"] + (1 - alpha) * eb
        smoothed = torch.where(started, sm_upd, eb)
        noise_upd = torch.where(sm_upd < st["noise"], sm_upd,
                                st["noise"] / floor_track)
        noise = torch.where(started, noise_upd, eb + 1e-10)
        snr = smoothed / (noise + 1e-10)
        gains = torch.clamp(1.0 - 2.0 / torch.clamp(snr, min=1e-3),
                            min_gain, 1.0)
        gains = torch.where(started, gains, 1.0)
        voiced = _tree_sum_last(snr[:, 2:16]) / 14
        vad = torch.where(st["started"],
                          torch.clamp((voiced - 1.5) / 8.0, 0.0, 1.0), 0.0)
        fr = torch.fft.irfft(spec * _matvec(gains, c["Gi"])) * c["win"]
        out = fr[:, :FRAME_SIZE] + st["synth"]
        st = dict(st, analysis=x, synth=fr[:, FRAME_SIZE:],
                  noise=noise, smoothed=smoothed,
                  started=torch.ones_like(st["started"]), vad=vad)
        return st, out

    def step(st, xb):
        c = tables(xb.device)
        xs = _frames(xb, f64)
        outs, vads = [], []
        for k in range(xs.shape[1]):
            st, out = frame(st, xs[:, k], c)
            outs.append(out)
            vads.append(st["vad"])
        return (st, torch.stack(outs, 1).reshape(xb.shape[0], -1),
                torch.stack(vads, 1))

    return step, init


def _window_sums(v: torch.Tensor, w: int) -> torch.Tensor:
    """out[..., s] = sum(v[..., s:s+w]) for every full window, as sums
    of power-of-two windows (elementwise adds in a fixed order)."""
    n = v.shape[-1] - w + 1
    parts, p, size = {}, v, 1
    while True:
        parts[size] = p
        if 2 * size > w:
            break
        p = p[..., :-size] + p[..., size:]
        size *= 2
    out, off = None, 0
    for size in sorted(parts, reverse=True):
        if w & size:
            seg = parts[size][..., off:off + n]
            out = seg if out is None else out + seg
            off += size
    return out


def make_device_gru_denoiser(weights: dict, frames_per_block: int = 10,
                             dtype=torch.float64):
    """Batched device twin of DenoiseState with the RNNoise GRU model:
    the WHOLE per-frame chain — STFT, band energies, 42-feature
    frontend (BFCC + deltas, pitch search/correlation, spectral
    variability), GRU stack, band-gain interpolation, iSTFT overlap-add
    — frame by frame over the block, N streams per call.

    Math mirrors gstpu's make_device_gru_denoiser operation for
    operation (and so FeatureExtractor/DenoiseState/GruModel above,
    except where gstpu's device function differs from the host
    `_pitch`: its grid argmax may keep a negative best score). Where
    gstpu sums with a matmul, a grouped convolution or a cumsum, the
    port sums in a fixed order: the pitch correlation is the (B, 769,
    960) product of the buffer's windows with the frame, summed by
    _tree_sum_last, and the window energies are _window_sums.

    init(batch, device="cuda") -> state;  step(state, x (B, F*480)
    SCALED [-32767, 32767]) -> (state, out (B, F*480), vads (B, F))

    dtype: torch.float64 (default; tight parity with the host oracle)
    or torch.float32 (the reference RNNoise pipeline is itself f32).
    """
    L = PITCH_MAX + WINDOW_SIZE          # pitch buffer length (1728)
    lags = np.arange(PITCH_MIN, PITCH_MAX)          # all t, full res
    n_vad, n_noise, n_den = (np.asarray(weights[f"{n}_U"]).shape[1]
                             for n in ("vad_gru", "noise_gru",
                                       "denoise_gru"))
    # c_all[s] = dot(buf[s:s+960], x); lag t starts at s = L-960-t
    tables = _tables(dict(win=vorbis_window(), Wb=_band_matrix().T,
                          Gi=_interp_matrix().T, Dct=_dct_matrix(),
                          eye=np.eye(CEPS_MEM) * 1e9,
                          s_idx=PITCH_MAX - lags,
                          taps=np.arange(WINDOW_SIZE),
                          rows=np.arange(CEPS_MEM)), dtype)
    nets = {}

    def net_on(device) -> RnnoiseGru:
        if device not in nets:
            nets[device] = gru_from_numpy(weights, dtype, device)
        return nets[device]

    def init(batch: int, device="cuda") -> dict:
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        return dict(analysis=z(batch, FRAME_SIZE),
                    synth=z(batch, FRAME_SIZE),
                    pitch=z(batch, L),
                    ceps_hist=z(batch, CEPS_MEM, NB_BANDS),
                    hist_pos=torch.zeros(batch, dtype=torch.int32,
                                         device=device),
                    h_vad=z(batch, n_vad),
                    h_noise=z(batch, n_noise),
                    h_den=z(batch, n_den),
                    vad=z(batch))

    def pitch_search(pbuf, c):
        """FeatureExtractor._pitch, batched: grid argmax over
        normalized autocorrelation + submultiple preference."""
        x = pbuf[:, -WINDOW_SIZE:]
        xe = _tree_sum_last(x * x) + 1e-6
        c_all = _tree_sum_last(pbuf.unfold(1, WINDOW_SIZE, 1)
                               * x[:, None, :])          # (B, L-960+1)
        ye_all = _window_sums(pbuf * pbuf, WINDOW_SIZE) + 1e-6
        c_t = c_all[:, c["s_idx"]]                       # by lag t
        ye_t = ye_all[:, c["s_idx"]]
        scores = c_t / torch.sqrt(xe[:, None] * ye_t)
        grid = scores[:, ::4]                            # t = 60, 64, ...
        gi = torch.argmax(grid, dim=1)
        bt0 = PITCH_MIN + 4 * gi
        bc0 = grid.gather(1, gi[:, None])[:, 0]
        bt = bt0
        taken = torch.zeros_like(bt0, dtype=torch.bool)
        for k in (4, 3, 2):                # first success wins (host)
            t2 = bt0 // k
            idx = torch.clamp(t2 - PITCH_MIN, 0, len(lags) - 1)
            s2 = scores.gather(1, idx[:, None])[:, 0]
            cond = (t2 >= PITCH_MIN) & ~taken & (s2 > 0.85 * bc0)
            bt = torch.where(cond, t2, bt)
            taken = taken | cond
        return bt

    def features(st, spec, eb, pbuf, c):
        logs = _lanewise(torch.log10, eb + 1e-2)
        ceps = _matvec(logs, c["Dct"])
        pos = st["hist_pos"]
        hist = st["ceps_hist"]

        def take(p):
            idx = (p % CEPS_MEM).long()[:, None, None] \
                .expand(-1, 1, NB_BANDS)
            return hist.gather(1, idx)[:, 0]

        prev1 = take(pos - 1)
        prev2 = take(pos - 2)
        d1 = ceps[:, :6] - prev1[:, :6]
        d2 = ceps[:, :6] - 2 * prev1[:, :6] + prev2[:, :6]
        slot = (c["rows"][None, :] == (pos % CEPS_MEM)[:, None]) \
            .to(dtype)
        hist = (hist * (1 - slot[:, :, None])
                + slot[:, :, None] * ceps[:, None, :])
        pos = pos + 1

        period = pitch_search(pbuf, c)
        start = L - WINDOW_SIZE - period
        delayed = pbuf.gather(1, start[:, None] + c["taps"][None, :])
        pspec = torch.fft.rfft(delayed * c["win"])
        # Re(spec * conj(pspec)) and |pspec|^2 in real ops: torch's CPU
        # complex product and abs round apart in the vector loop's tail
        num = _matvec(spec.real * pspec.real + spec.imag * pspec.imag,
                      c["Wb"])
        den = torch.sqrt(eb * _matvec(_power(pspec), c["Wb"])) + 1e-6
        band_corr = torch.clamp(num / den, -1.0, 1.0)
        pitch_dct = _matvec(band_corr, c["Dct"])[:, :6]

        # spectral variability over the valid history rows
        n = torch.clamp(pos, max=CEPS_MEM)              # (B,)
        valid = c["rows"][None, :] < n[:, None]         # (B, 8)
        diff = hist[:, :, None, :] - hist[:, None, :, :]
        d = _tree_sum_last(diff * diff)                 # (B, 8, 8)
        pair_ok = valid[:, :, None] & valid[:, None, :]
        d = torch.where(pair_ok, d, 1e9)
        d = d + c["eye"]
        mins = torch.amin(d, dim=2)                     # (B, 8)
        var = _tree_sum_last(torch.where(valid, mins, 0.0)) \
            / torch.clamp(n, min=1)
        var = torch.where(n > 1, var, 0.0)

        feat = torch.cat([
            ceps, d1, d2, pitch_dct,
            (0.01 * (period - 300).to(torch.float64))[:, None].to(dtype),
            (var / 100.0)[:, None]], dim=1)             # (B, 42)
        return dict(st, ceps_hist=hist, hist_pos=pos), feat

    def frame(st, x, c, net):
        buf = torch.cat([st["analysis"], x], dim=1)
        spec = torch.fft.rfft(buf * c["win"])
        eb = _matvec(_power(spec), c["Wb"])
        pbuf = torch.cat([st["pitch"][:, FRAME_SIZE:], x], dim=1)
        st, feat = features(st, spec, eb, pbuf, c)
        (h_vad, h_noise, h_den), gains, vad = net(
            (st["h_vad"], st["h_noise"], st["h_den"]), feat)
        fr = torch.fft.irfft(spec * _matvec(gains, c["Gi"])) * c["win"]
        out = fr[:, :FRAME_SIZE] + st["synth"]
        return dict(st, analysis=x, synth=fr[:, FRAME_SIZE:],
                    pitch=pbuf, h_vad=h_vad, h_noise=h_noise,
                    h_den=h_den, vad=vad), out

    def step(st, xb):
        c, net = tables(xb.device), net_on(xb.device)
        xs = _frames(xb, dtype)     # device rows may arrive f64/f32
        outs, vads = [], []
        for k in range(xs.shape[1]):
            st, out = frame(st, xs[:, k], c, net)
            outs.append(out)
            vads.append(st["vad"])
        return (st, torch.stack(outs, 1).reshape(xb.shape[0], -1),
                torch.stack(vads, 1))

    return step, init


def state_from_numpy(d: dict, device="cuda") -> dict:
    """A denoiser state from numpy leaves (gstpu's state with each leaf
    taken through np.asarray), on `device`, dtypes kept."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in d.items()}


def state_to_numpy(st: dict) -> dict:
    """A denoiser state as numpy leaves with gstpu's dtypes."""
    return {k: v.cpu().numpy() for k, v in st.items()}
