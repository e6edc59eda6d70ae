"""AV1 intra analysis and the device transform pass as torch ops.

The port of gstpu/ops/av1_intra.py, which BASELINE config 5 (audiornnoise
feeding a 1080p AV1 intra encode) runs through `rav1enc`:

* `make_intra_analyzer`: per 8x8 block of the Y plane, intra mode
  decision (DC_PRED / V_PRED / H_PRED from the source row above and
  column left, 128/129 at frame edges, best of 3 by SAD), the forward
  8x8 DCT-II of the chosen residual, and quantisation on the 16-step
  `Q_GRID` with a bits proxy per step: the rate curve that `rav1enc
  rc-mode=device` steers the engine's quantizer with;
* `make_intra_transform`: the same for all three I420 planes at one
  `qstep`, then dequantisation, the inverse DCT and the clipped
  reconstruction that `rav1enc device-transform=true` hands to a
  lossless engine as the bitstream layer.

`BLOCK`, `N_Q`, `Q_GRID`, `_dct_matrix`, `QstepRateControl` and
`DeviceRateControl` are numpy and copied as they stand.

Against gstpu's functions as XLA's CPU code runs them:
- the SADs are sums of at most 64 multiples of 1/16 below 256, exact in
  f32 in any order, so the mode decision, its first-index tie rule and
  `mode_counts` are bit for bit;
- the DCT is summed in another order than XLA's dots, so coefficients
  differ by ulps and a rounding of `coef / qstep` can land on the other
  side of .5: the reconstruction differs in a few bytes and the bits
  proxy by a small relative amount (tests/test_torch_av1.py states both);
- the analyzer's division by the constant grid is a product with the f32
  reciprocal, and `a * (1/q) + 0.5` and `log(.) * (1/ln 2) + 2` are
  contracted to FMAs, as XLA does; `coef / qstep` stays an IEEE division.

The DCT is written as elementwise f32 products and adds in a fixed order
(`_dct_left`), with no matmul: it never uses TF32, whatever the global
`allow_tf32` flags say, and gives the same bits on the CPU and the card.
Every function runs on the `device` it is built for and returns tensors
there without a sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gstpu_torch.ops import fma_f32

BLOCK = 8

# quantizer-step grid: an exponential ladder covering crf 0..63
# territory.  Absolute scale is irrelevant (closed-loop corrected);
# only monotone coverage matters.
N_Q = 16
Q_GRID = np.asarray([0.5 * 2.0 ** (i / 2.0) for i in range(N_Q)],
                    np.float32)                     # 0.5 .. ~91
_INV_Q_GRID = (np.float32(1.0) / Q_GRID).astype(np.float32)
_INV_LN2 = float(np.float32(1.0 / math.log(2.0)))


def _dct_matrix(n: int = BLOCK) -> np.ndarray:
    k = np.arange(n)
    D = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    D *= np.sqrt(2.0 / n)
    D[0] *= 1.0 / np.sqrt(2.0)
    return D.astype(np.float32)


def _dct_left(M: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """out[..., i, l] = sum_j M[i, j] a[..., j, l] for 8x8 M: the 8
    products in f32, summed by halves ((j, j+4), then (j, j+2), then
    (0, 1)), each an f32 elementwise op."""
    lead = (1,) * (a.dim() - 2)
    p = M.t().reshape(BLOCK, *lead, BLOCK, 1) \
        * a.movedim(-2, 0).unsqueeze(-2)
    while p.shape[0] > 1:
        h = p.shape[0] // 2
        p = p[:h] + p[h:]
    return p[0]


def _dct_right(a: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """out[..., i, l] = sum_k a[..., i, k] M[l, k], as `_dct_left`."""
    return _dct_left(M, a.transpose(-1, -2)).transpose(-1, -2)


def _log2_cost(x: torch.Tensor) -> torch.Tensor:
    """2 + log2(x) as XLA's CPU code computes it: log(x) times the f32
    1/ln 2, contracted with the + 2."""
    return fma_f32(torch.log(x), _INV_LN2, 2.0)


def _predict(x: torch.Tensor) -> tuple:
    """The 8x8 blocks of an (H, W) f32 plane (H, W multiples of 8), the
    (3, by, bx, 8, 8) DC/V/H predictions from the source row above and
    column left (128 above the frame, 129 left of it), and the mode of
    each block by least SAD (first on ties)."""
    H, W = x.shape
    by, bx = H // BLOCK, W // BLOCK
    blk = x.reshape(by, BLOCK, bx, BLOCK).permute(0, 2, 1, 3)
    above = torch.cat([x.new_full((1, W), 128.0),
                       x[BLOCK - 1::BLOCK][:-1]], 0).reshape(by, bx, BLOCK)
    left = torch.cat([x.new_full((H, 1), 129.0),
                      x[:, BLOCK - 1::BLOCK][:, :-1]], 1)
    left = left.reshape(by, BLOCK, bx).permute(0, 2, 1)
    dc = ((above.mean(-1) + left.mean(-1)) * 0.5)[..., None, None]
    preds = torch.stack([dc.expand(blk.shape),
                         above[:, :, None, :].expand(blk.shape),
                         left[:, :, :, None].expand(blk.shape)])
    sad = (blk[None] - preds).abs().sum(dim=(-1, -2))
    mode = sad.argmin(0)                                # (by, bx)
    pred = preds.gather(0, mode[None, :, :, None, None]
                        .expand(1, by, bx, BLOCK, BLOCK))[0]
    return blk, pred, mode


def make_intra_analyzer(height: int, width: int, device):
    """Build `analyze(y_plane (H, W) uint8) -> (bits (N_Q,) f32,
    mode_counts (3,) int32)` on `device` for one frame size (H and W
    multiples of 8, as 1080p is). A host plane is uploaded to `device`;
    the results stay there (callers fetch them lazily)."""
    if height % BLOCK or width % BLOCK:
        raise ValueError(f"plane {width}x{height} not /{BLOCK}")
    device = torch.device(device)
    D = torch.from_numpy(_dct_matrix()).to(device)
    inv_qg = torch.from_numpy(_INV_Q_GRID).to(device)[:, None, None, None,
                                                      None]

    def analyze(y):
        x = torch.as_tensor(y, device=device).to(torch.float32)
        blk, pred, mode = _predict(x)
        mode_counts = torch.bincount(mode.reshape(-1), minlength=3) \
            .to(torch.int32)
        # forward 8x8 DCT-II of every residual block: D @ R @ D.T
        coef = _dct_right(_dct_left(D, blk - pred), D)
        # quantize on the grid; bits proxy per level:
        #   nonzero flag (sign+eob overhead) + log2 magnitude
        lvl = torch.floor(fma_f32(coef.abs()[None], inv_qg, 0.5))
        bits = torch.where(lvl > 0, _log2_cost(1.0 + lvl),
                           0.0).sum(dim=(1, 2, 3, 4))
        return bits, mode_counts

    return analyze


def _plane_pass(x_u8: torch.Tensor, qstep: torch.Tensor,
                D: torch.Tensor) -> tuple:
    H, W = x_u8.shape
    ph, pw = (-H) % BLOCK, (-W) % BLOCK
    x = x_u8.to(torch.float32)
    if ph or pw:
        x = F.pad(x[None, None], (0, pw, 0, ph), mode="replicate")[0, 0]
    Hp, Wp = H + ph, W + pw
    blk, pred, _ = _predict(x)
    coef = _dct_right(_dct_left(D, blk - pred), D)
    lvl = torch.round(coef / qstep)
    bits = torch.where(lvl != 0, _log2_cost(1.0 + lvl.abs()), 0.0).sum()
    rec = pred + _dct_right(_dct_left(D.t(), lvl * qstep), D.t())
    rec = torch.round(rec).clamp(0.0, 255.0).to(torch.uint8)
    rec = rec.permute(0, 2, 1, 3).reshape(Hp, Wp)
    return rec[:H, :W], bits


def make_intra_transform(height: int, width: int, device):
    """The device transform pass of `rav1enc device-transform=true`: for
    every 8x8 block of all three I420 planes, intra mode decision, the
    forward DCT of the chosen residual, uniform quantisation at `qstep`,
    dequantisation, the inverse DCT and the clipped reconstruction.

    Returns encode(y, u, v, qstep) -> (ry, ru, rv, bits): uint8 planes of
    the I420 geometry for (height, width) and the bits proxy, tensors on
    `device`; planes that are not /8 are edge-padded and cropped back.
    The lossless engine that codes the reconstruction makes no lossy
    decision of its own, so its decoded output is exactly `ry, ru, rv`."""
    device = torch.device(device)
    D = torch.from_numpy(_dct_matrix()).to(device)

    def encode(y, u, v, qstep):
        q = torch.as_tensor(qstep, dtype=torch.float32, device=device) \
            .clamp_min(1e-3)
        outs = [_plane_pass(torch.as_tensor(p, device=device), q, D)
                for p in (y, u, v)]
        (ry, b0), (ru, b1), (rv, b2) = outs
        return ry, ru, rv, b0 + b1 + b2

    return encode


class QstepRateControl:
    """Closed-loop quantizer-step control for device-transform mode:
    the device qstep decides the reconstruction's information content,
    the lossless entropy layer's observed output bits feed back
    multiplicatively (bits ~ qstep^-gamma locally)."""

    def __init__(self, target_bps: float, fps: float,
                 qmin: float = 0.5, qmax: float = 256.0):
        self.target = max(1.0, target_bps / max(fps, 1e-6))
        self.qmin, self.qmax = qmin, qmax
        self.qstep = 16.0

    def observe(self, actual_bits: float) -> float:
        if actual_bits > 0:
            ratio = actual_bits / self.target
            # damped exponential correction; gamma ~ 1 in the
            # operating range of transform coding rate curves
            self.qstep *= ratio ** 0.5
            self.qstep = min(self.qmax, max(self.qmin, self.qstep))
        return self.qstep


class DeviceRateControl:
    """Closed-loop per-frame quantizer from the device rate curve.

    pick(bits_curve, actual from the last encode) -> crf int in
    [min_crf, max_crf].  A multiplicative EWMA correction maps the
    proxy-bit scale onto the engine's real output, so the analyzer
    needs no AV1 qindex tables."""

    def __init__(self, target_bps: float, fps: float,
                 min_crf: int = 8, max_crf: int = 63):
        self.target = max(1.0, target_bps / max(fps, 1e-6))
        self.min_crf, self.max_crf = min_crf, max_crf
        self.scale = 1.0            # actual_bits / proxy_bits

    @staticmethod
    def proxy_at(bits_curve: np.ndarray, crf: int) -> float:
        """UNSCALED proxy bits the curve predicts at a given crf —
        log-log interpolation over the Q_GRID.  observe() must compare
        the engine's actual bits against the proxy at the crf that was
        IN FORCE for those bits: comparing against the unrounded pick
        instead biases the EWMA by exactly the rounding/deadband gap
        and parks the loop at a stable off-target equilibrium."""
        est = np.maximum(np.asarray(bits_curve, np.float64), 1e-3)
        q = 0.125 * 2.0 ** (crf / 6.0)
        lq = np.log(np.asarray(Q_GRID, np.float64))
        x = math.log(max(q, 1e-6))
        i = int(np.clip(np.searchsorted(lq, x), 1, N_Q - 1))
        t = (x - lq[i - 1]) / (lq[i] - lq[i - 1])
        t = min(1.0, max(0.0, t))
        b0, b1 = math.log(est[i - 1]), math.log(est[i])
        return float(math.exp(b0 * (1 - t) + b1 * t))

    def observe(self, actual_bits: float, proxy_bits: float) -> None:
        if proxy_bits > 0 and actual_bits:
            r = actual_bits / proxy_bits
            # gain 0.5: starved windows are filtered upstream
            # (rav1enc accumulates until the packet count is
            # representative), so the remaining observations are
            # trustworthy and a slow EWMA only delays convergence.
            # The clamp stops runaway collapse when windows are
            # bimodal (keyframe-bearing vs keyframe-free GOP spans).
            self.scale = min(50.0, max(
                0.02, 0.5 * self.scale + 0.5 * r))

    def pick(self, bits_curve: np.ndarray) -> int:
        est = np.maximum(np.asarray(bits_curve, np.float64)
                         * self.scale, 1.0)
        want = self.target
        # monotone-decreasing curve over Q_GRID; log-interp the step
        i = int(np.searchsorted(-est, -want))
        if i <= 0:
            # target above the finest step's cost: floor quantizer
            return self.min_crf
        elif i >= N_Q:
            # target below even the coarsest step: ceiling quantizer
            return self.max_crf
        b0, b1 = math.log(est[i - 1]), math.log(est[i])
        t = 0.0 if b1 == b0 else (math.log(want) - b0) / (b1 - b0)
        q = float(Q_GRID[i - 1] ** (1 - t) * Q_GRID[i] ** t)
        # qstep -> crf: crf = 6*log2(qstep/0.125), the same
        # exponential family as the grid (closed loop absorbs offset)
        crf = int(round(6.0 * math.log2(max(q, 1e-3) / 0.125)))
        return max(self.min_crf, min(self.max_crf, crf))
