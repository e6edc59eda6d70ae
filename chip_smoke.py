#!/usr/bin/env python3
"""Drive the gstpu_torch port on one CUDA card, end to end.

Run from the repository root:  python3 chip_smoke.py
(`python3 chip_smoke.py --sass DIR` prints the SASS instruction counts
of every kernel library in DIR and needs no card.)

1. builds the port's CUDA kernels from the sources in the checkout and
   prints each kernel's static SASS instruction counts, and per pixel
   (sass_counts);
2. holds each kernel against its plain PyTorch version on the same
   inputs: hsv_filter_u8 bit for bit over a 4096x4096 frame holding
   every 24-bit colour once, for 7 parameter sets (hue shifts up to
   |360| and past it) x 4 layouts, out of place and in place, and its
   division against IEEE division on every operand pair a pixel gives;
   the u8 lut3d_trilinear bit for bit over the same colours, the u16
   one within 1 LSB on a seeded 4K RGBA64 frame; both kernels on
   1921x1081 frames, aligned and one pixel off 16 bytes; and the plain
   emulation of the packed-table addressing against the LUT kernel;
3. runs the main path, the 4K `videotestsrc ! hsvfilter ! colorlut !
   appsink` pipeline, through parse_launch on the card with every
   kernel's launch count set to 0 just before, and checks every frame
   against the same pipeline run on the CPU with the plain versions,
   then times the source alone and the upload of one frame;
4. runs four device-resident `appsrc ! hsvfilter ! colorlut ! appsink`
   pipelines fed CUDA tensors, their frames pulled every round;
5. times each kernel per 4K frame (median of 30 launches, CUDA events,
   L2 flushed before each) on a uniform random frame and on a smooth
   one (a gradient plus low-frequency noise, like graded footage),
   beside its plain version, the bytes bound and, for the LUT,
   torch.nn.functional.grid_sample as a yardstick;
6. runs the audio flagship chain `rsaudioecho ! audioloudnorm !
   ebur128level` (make_audiofx_exact_chain) at full width on the card:
   96 streams of 192 kHz F64 stereo, a 0.25 s echo, primed with 3 s,
   then 6 settling and 20 timed 100 ms steps over a 12-frame input
   bank made on the card; prints the realtime multiple, the device and
   host time of each stage of a step, the limiter's loop iterations, a
   profiler window's kernel launches, busy share and kernel time by
   stage, and the fused meter's loudness. It checks lane 0 of a
   1-stream run against the 96-stream run bit for bit, 2 streams on
   the card against the same 2 on the CPU (samples within 1e-12,
   identical decisions, over 10 steps; one stream's spikes drive the
   limiter out of its rest state), and an `audiotestsrc ! rsaudioecho !
   appsink` pipeline on the card against the CPU bit for bit; and times each
   main-path jit kernel (echo, block biquad, limiter) alone beside its
   bytes bound;
7. runs the element form through DeviceContext: (a) 96 parse_launch
   pipelines of `appsrc ! rsaudioecho ! audioloudnorm ! ebur128level !
   appsink` sharing one context (depth 2), fed DeviceRow rows of phase
   6's banks: prime, 6 settling and 20 timed rounds, 3 more under the
   profiler; prints the realtime multiple, the host ms a round inside
   the context's submit/_fire/_distribute, the kernels a round, beside
   phase 6's hand-fused step; checks every lane's output against
   make_audiofx_exact_chain at B=96 bit for bit and each lane's last
   short-term loudness within 1 LU of -24 LUFS; tears the pipelines
   down without EOS; then runs 2 pipelines (one stream driving the
   limiter) to EOS through a partial last frame on the card and on the
   CPU: samples within 1e-12, decisions identical; (b) four 4K
   `appsrc ! hsvfilter ! colorlut ! appsink` pipelines sharing one
   context, fed CUDA tensors: every fire launches each kernel once,
   each frame equals the unbatched wrappers' output bit for bit; fps;
8. runs audiornnoise at full width (the published RNNoise widths,
   weights made from SEED, 96 mono streams of 48 kHz, context-block 4800
   = 10 frames): (a) make_device_gru_denoiser in f64 and f32 and
   make_device_denoiser on banks made on the card, each with lane 0 of
   a 1-stream run bit for bit against the 96-stream run, 2 streams
   against the numpy oracle (DenoiseState) over 20 frames (f64 within
   1e-9 x 32767 and VAD within 1e-12; f32 within 8.0), and a block's
   kernels, device time and bound; (b) 96 `appsrc ! audiornnoise
   model-location=W context=R context-block=4800 ! appsink` pipelines in
   one context (depth 2) fed DeviceRow rows: a first round, settling,
   timed and profiled rounds, every lane bit for bit against the f64
   step at B=96; the realtime multiple, the host ms a round inside the
   context, kernels and busy share a round; (c) one engine=device
   pipeline on the card against engine=host, within 1e-6;
9. runs the binaural render at bench_hrtf.py's and bench_sofa.py's
   configurations: (a) `appsrc ! hrtfrender ! appsink` on the card (16
   channels, block 512, 8 steps, IR 512, directions and gains changed
   mid-stream) within 1e-5 of the CPU; (b) 32 streams through ols_block
   as bench_hrtf.make_step, lane 0 within 4e-6 of the element on the
   card, and its realtime multiple; (c) upc_block at 48 streams x 6
   channels, block 256, partition 64, IR 512, a 24-point ring and a yaw
   step with crossfade every 16 blocks: within 1e-5 of the output's peak
   of the CPU, the blockwise run against partition-sized calls and one
   call (reported, within the same), and its realtime multiple. No
   h5py: the sofalizer element reads a SOFA file, so its ops run here
   and the element in the CPU tests;
10. runs hsvdetector and the codec device legs: (a) hsv_detect_frame
   over the 2^24-colour cube in each RGBA-family layout for the CPU
   tests' five parameter sets, bit for bit against the CPU, then four
   4K `appsrc ! hsvdetector context= ! appsink` pipelines fed CUDA
   tensors, the checked frames bit for bit against the unbatched
   element, with fps and kernels a fire; (b) FFV1 at BASELINE config
   5's 1080p I420: the residual fields of 8 seeded frames bit for bit
   against the CPU and the numpy spec model, their time, and `ffv1enc`
   fed CUDA tensors and host
   frames, each stream byte for byte the CPU's, from the native coder,
   with a small frame decoded back by the spec model; (c) the AV1
   analyzer and transform on 8 frames at 1080p against the CPU (mode
   maps and counts bit for bit, the reconstruction's differing bytes
   counted, the bits within 1e-3) and their times, then `rav1enc
   device-transform=true ! dav1ddec` on 4 frames where the codec shim
   builds (one line says so where it does not);
11. runs the analytics path and the rest of the video device path: (a)
   `videotestsrc ! 1280x720 RGB ! videoscale ! 640x640 ! yoloxinference
   model-size=s num-classes=80 ! yoloxtensordec ! appsink` through
   parse_launch on the card (YOLOX-S at its published depth and width,
   seeded parameters): each of 4 frames' forward within 1e-3 of the
   output's peak of the port's CPU forward on the same frame (f32, TF32
   off), the detections' count and classes equal at the element's
   threshold and at one set in the widest gap of the scores; the
   forward's time (CUDA events), kernels and busy time a frame beside its
   FLOP bound, the decode's host time, the string's fps, and the forward
   with TF32 allowed (not on the element's path); (b) videoscale, 4K
   RGBA to 1080p linear, and 1080p I420 to 720p and 720p RGBA64BE to
   640x360 in both methods, on the card against the CPU (nearest bit for
   bit, linear within 1 LSB with the differing bytes counted) and their
   times against the bytes bound; (c) the compositor's 2x2 multiview of
   1280x720 RGB inputs at 960x540 with a 640x360 I420 picture-in-picture
   on a 1920x1080 canvas: `_blend` and the GRAY8 and I420 conversions to
   RGB bit for bit against the CPU, the resized layers' and the canvas's
   differing bytes counted, the canvas fed CUDA tensors equal to the one
   fed host frames, fps fed each, and `_blend`'s time for one quadrant
   against its bytes bound;
12. runs the port of gstpu's parallel layer at the flagship's width (192
   lanes of 192 kHz f64, 100 ms blocks, 20 of them): (a) on a one-rank
   NCCL group (FileStore, device_id) and make_mesh(1, 1), the
   stream-sharded echo equal to echo_block on the card and the CPU, the
   seq-sharded FIR echo equal to echo_block without feedback, the
   seq-sharded K-weighting within 1e-8 of kweight_unsharded, and
   make_audiofx_exact_chain's checkpoint restored onto the mesh mid-stream
   equal to the uninterrupted run in every lane; event ms and kernels a
   block of each; the group torn down; (b) make_audiofx_chain on the card
   against the CPU within the CPU tests' bounds, a mid-stream checkpoint
   resumed bit for bit, its event ms, busy ms and kernels a step against
   its bytes bound; (c) the 4K `videotestsrc ! hsvfilter ! queue !
   colorlut ! appsink` string twice, each pipeline driven by a streaming
   thread of its own, under the torch-profiler tracer: the Chrome trace
   holds pad_push spans from both threads and every launch of both CUDA
   kernels inside one, with their device time.

It prints one JSON line each of the audio chain, of the element form, of
audiornnoise, of the binaural render, of hsvdetector, of the codec legs,
of the analytics path and of the parallel layer, the card's name and
power limit, one JSON line of kernels and last `{"ok": true, "device":
{...}}`. Any failed phase raises, and the script then exits non-zero
without that last line; so does a machine without CUDA or a directory
without the gstpu_torch package.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
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
              (200.0, 1.5, -0.2, 0.7, 0.1),
              # the edges of the kernel's fmod_near variant and past it
              (-360.0, 1.1, 0.0, 0.9, 0.02),
              (360.0, 0.8, 0.05, 1.3, -0.1),
              (359.99997, 1.5, -0.2, 0.7, 0.1),
              (725.5, 1.2, -0.1, 0.9, 0.05)]
LAYOUTS = {"RGBA": (0, 1, 2), "BGRA": (2, 1, 0), "ARGB": (1, 2, 3),
           "RGB": (0, 1, 2)}
LUT_DOMAIN = (np.array([0.9, 1.1, 1.05], np.float32),
              np.array([0.02, -0.03, 0.01], np.float32))
ODD_W, ODD_H = 1921, 1081
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
# the audio chain as bench.py runs it: 96 streams of 192 kHz F64
# stereo, echo delay = max delay = 0.25 s (96,000 flattened samples)
AUDIO_STREAMS = 96
AUDIO_CHANNELS = 2
AUDIO_DELAY = 96_000
AUDIO_INTENSITY, AUDIO_FEEDBACK = 0.4, 0.3
AUDIO_BANK, AUDIO_SETTLE, AUDIO_TIMED = 12, 6, 20
AUDIO_CHECK_STEPS = 3
AUDIO_LIMITER_STEPS = 10     # the card-vs-CPU check, limiter stream
AUDIO_PROFILED = 3           # element form: rounds under the profiler
AUDIO_EOS_STEPS = 4          # element form: the EOS pair's full frames
# the f64 rate outside the tensor cores (NVIDIA's H100 SXM data sheet);
# the device denoisers' products and sums run there
F64_OPS_PER_S = 34e12
# audiornnoise (phase 8): 96 mono streams at 48 kHz, context-block 4800
# (10 frames of 480, 100 ms), the published RNNoise widths with weights
# made from SEED
RN_STREAMS = 96
RN_FRAMES = 10
RN_BANK, RN_SETTLE, RN_TIMED, RN_PROFILED = 8, 3, 20, 3
RN_CHECK_BLOCKS = 2          # 20 frames: lanes, oracle and engine checks
# binaural render (phase 9): bench_hrtf.py's and bench_sofa.py's
# configurations
HRTF_RATE, HRTF_BLOCK, HRTF_STEPS, HRTF_IR = 44_100, 512, 8, 512
HRTF_CHANNELS, HRTF_STREAMS, HRTF_TIMED = 16, 32, 100
SOFA_BLOCK, SOFA_PART, SOFA_IR, SOFA_CHANNELS = 256, 64, 512, 6
SOFA_RING, SOFA_ROT_EVERY, SOFA_STREAMS, SOFA_TIMED = 24, 16, 48, 200
# hsvdetector (phase 10a): the CPU tests' parameter sets (hue_ref, hue_var,
# sat_ref, sat_var, val_ref, val_var) and the RGBA-family layouts as
# (r, g, b) and alpha offsets
DETECT_PARAMS = [(0.0, 10.0, 0.0, 0.15, 0.0, 0.3),
                 (359.9, 20.0, 0.5, 0.5, 0.5, 0.5),
                 (0.1, 180.0, 1.0, 0.3, 1.0, 0.3),
                 (120.0, 60.0, 0.0, 0.15, 0.0, 0.3),
                 (200.5, 33.3, 0.7, 0.2, 0.4, 0.35)]
DETECT_LAYOUTS = {"RGBA": ((0, 1, 2), 3), "BGRA": ((2, 1, 0), 3),
                  "ARGB": ((1, 2, 3), 0), "ABGR": ((3, 2, 1), 0)}
DETECT_ROUNDS = 100
# the codec legs (phases 10b, 10c): BASELINE config 5's 1080p I420
CODEC_W, CODEC_H, CODEC_FRAMES = 1920, 1080, 8
AV1_QUANTIZER = 100          # rav1enc's default quantizer
AV1_ELEMENT_FRAMES = 4
# Hopper issues 64 INT32 lanes per SM and clock beside 128 FP32 (NVIDIA's
# H100 architecture paper): half the f32 rate, for FFV1's integer fields
I32_OPS_PER_S = F32_OPS_PER_S / 2
# operations per sample or pixel, counted from the torch ops: the FFV1
# field (neighbours 6, three gradients and their byte masks 6, three
# table loads and their sum 5, median 6, fold and wrap 7); the
# detector (RGB->HSV ~30, the window ~15); the AV1 analyzer (SADs 9,
# the DCT's two passes 32, 16 grid steps of 6) and transform (both DCTs
# 64, quantise, rebuild and round 10)
OPS_PER_SAMPLE = {"ffv1_field": 30, "hsv_detect_frame": 45,
                  "make_intra_analyzer": 137, "make_intra_transform": 74}
# the analytics path (phase 11a): YOLOX-S (depth 0.33, width 0.50, 80
# classes) at 640x640 from a 1280x720 RGB source, seeded parameters
YOLOX_SIZE, YOLOX_CLASSES, YOLOX_IN = "s", 80, 640
YOLOX_SRC_W, YOLOX_SRC_H = 1280, 720
YOLOX_CHECKED, YOLOX_FPS_FRAMES = 4, 30
# the card against the CPU: the forward within this share of the
# output's peak (f32 on both, cuDNN's TF32 off)
YOLOX_TOL = 1e-3
# the compositor (phase 11c): a 2x2 multiview of 1280x720 RGB inputs at
# 960x540 on a 1920x1080 canvas, alphas per quadrant, and a 640x360 I420
# picture-in-picture at 0.5 over the centre
COMP_W, COMP_H = 1920, 1080
COMP_ALPHAS = (1.0, 0.75, 0.5, 1.0)
COMP_ROUNDS = 30
# the mesh (phase 12a): the flagship's width as 192 mono lanes (96 stereo
# streams) of 192 kHz f64, 100 ms blocks, the 0.25 s echo (in lane
# samples), 20 blocks, on a one-rank NCCL group; the seq-sharded FIR
# echo needs a delay of at most its segment
RATE_192K = 192_000
MESH_LANES = 2 * AUDIO_STREAMS
MESH_BLOCK, MESH_DELAY, MESH_FIR_DELAY = 19_200, 48_000, 9_600
MESH_BLOCKS = 20
MESH_RESUME = 2              # exact chain: steps before and after a restore
# the seq-sharded K-weighting against the unsharded one: gstpu's bound
# (tests/test_seq_sharding.py); f64 operations a sample and stage of the
# block biquad: the in-block FIR's 63 multiply-adds, b0 x, the state
# increments (2 products, 2 sums) and the observation (2 and 2)
KWEIGHT_TOL = 1e-8
KWEIGHT_OPS = 2 * 63 + 1 + 4 + 4
# make_audiofx_chain (phase 12b): the gain's target, and the card against
# the CPU within the CPU tests' bounds against gstpu
# (tests/test_torch_parallel_chain.py)
LIGHT_TARGET = 0.1
LIGHT_OUT_TOL, LIGHT_LOUD_TOL_DB, LIGHT_GAIN_RTOL = 2.4e-7, 1e-5, 1e-6
# the traced string (phase 12c): frames a pipeline
TRACE_FRAMES = 8


def log(*args) -> None:
    print(*args, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.cpu().to(torch.int32) - b.cpu().to(torch.int32))
               .abs().max())


def colour_cube(layout: str, device, rgb_idx=None) -> torch.Tensor:
    """4096x4096 frame holding every 24-bit colour once, in `layout`
    (its (r, g, b) offsets `rgb_idx`, LAYOUTS' by default); the fourth
    channel, where there is one, holds a byte pattern."""
    p = torch.arange(1 << 24, device=device, dtype=torch.int32)
    rgb = [p & 255, (p >> 8) & 255, p >> 16]
    C = len(layout)
    chans = [(p * 7 + 3) & 255] * C
    for k, i in enumerate(rgb_idx or LAYOUTS[layout]):
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


SASS_CLASSES = ("I2F", "F2I", "FRND", "MUFU", "CALL", "BRA", "LDG", "LDS",
                "STG")
# The kernel function each wrapper launches for the timed RGBA8 frame.
MAIN_FUNCTION = {"hsv_filter_u8": "hsv_filter_kernel<Li4ELb1",
                 "lut3d_trilinear": "lut3d_kernel<hLi4"}


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of each kernel in a built library
    (cuobjdump -sass): the total without NOPs, a few classes, and
    `per_pixel`, the instructions one pixel costs on the main path:
    - a kernel with a vector loop: the instructions of its largest loop
      that stores 16 bytes and holds no WARPSYNC (the divergent copy the
      compiler keeps beside a loop with shuffles is never run), over the
      pixels one pass moves, 4 for an RGBA8 frame;
    - a kernel without a loop (one pixel a thread): every instruction
      before its last EXIT, the slow paths it calls lying after it."""
    cuda_bin = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    tool = shutil.which("cuobjdump") or str(cuda_bin / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    code, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            code[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9]*)(.*)", line)
        if fn and m and m.group(2) != "NOP":
            code[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for fn, ins in code.items():
        c = {"total": len(ins), **{k: 0 for k in SASS_CLASSES}}
        for _, op, _ in ins:
            if op in SASS_CLASSES:
                c[op] += 1
        loops = []
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and m and int(m.group(1), 16) < addr:
                body = [(o, r) for a, o, r in ins
                        if int(m.group(1), 16) <= a <= addr]
                if any(o == "STG" and ".128" in r for o, r in body) \
                        and not any(o == "WARPSYNC" for o, _ in body):
                    loops.append(len(body))
        if loops:
            c["per_pixel"] = max(loops) / 4
        else:
            exits = [i for i, (_, op, _) in enumerate(ins) if op == "EXIT"]
            c["per_pixel"] = float(exits[-1] + 1 if exits else len(ins))
        out[fn] = c
    return out


def kernel_name(mangled: str) -> str:
    """`name<template args>` of a mangled kernel symbol, or the symbol:
    the name is the `_kernel` identifier whose length prefix fits."""
    head, sep, rest = mangled.partition("_kernelI")
    for i in range(len(head)):
        m = re.fullmatch(r"(\d+)([A-Za-z_]\w*)", head[i:])
        if sep and m and int(m.group(1)) == len(m.group(2)) + 7:
            return f"{m.group(2)}_kernel<{rest.split('EEv')[0]}>"
    return mangled


def log_sass(libs) -> dict:
    counts = {}
    for lib in libs:
        for fn, c in sass_counts(lib).items():
            counts[f"{lib.name}:{fn}"] = c
            log(f"[sass] {lib.name} {fn}: " + ", ".join(
                f"{k} {v}" for k, v in c.items()))
    return counts


def skewed(host: np.ndarray, skew_px: int, dev) -> torch.Tensor:
    """`host` on the card as a contiguous view that starts skew_px
    pixels into its buffer (a 16-byte aligned allocation)."""
    C = host.shape[-1]
    flat = torch.empty((host.size + 8 * C,), dtype=torch.from_numpy(
        host[:0]).dtype, device=dev)
    view = flat[skew_px * C:skew_px * C + host.size].view(host.shape)
    view.copy_(torch.from_numpy(host).to(dev))
    return view


def smooth_frame(dev, gen) -> torch.Tensor:
    """A 4K RGBA frame like graded footage: gradients plus bicubic
    low-frequency noise, made on the card from `gen`."""
    y = torch.linspace(0.0, 1.0, H, device=dev)[:, None]
    x = torch.linspace(0.0, 1.0, W, device=dev)[None, :]
    coarse = torch.rand((1, 3, 9, 16), generator=gen, device=dev)
    noise = torch.nn.functional.interpolate(coarse, size=(H, W),
                                            mode="bicubic")[0]
    rgb = torch.stack([0.6 * x + 0.4 * noise[0], 0.6 * y + 0.4 * noise[1],
                       0.3 * (x + y) + 0.4 * noise[2]], -1)
    rgb = (rgb.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    alpha = torch.full((H, W, 1), 255, dtype=torch.uint8, device=dev)
    return torch.cat([rgb, alpha], -1).contiguous()


def run_pipeline(gstpu_torch, launch: str, device: str) -> list:
    gstpu_torch.init(device=device)
    p = gstpu_torch.parse_launch(launch)
    p.set_state(gstpu_torch.State.PLAYING)
    p.run(timeout=600)
    out = p.get_by_name("out").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    return out


def check_lut(name, got, want, max_val) -> int:
    """Raise unless got equals want (u8) or is within 1 LSB of it with
    the alpha channel untouched (u16); return the max error."""
    e = max_abs_err(got, want)
    log(f"[check] lut3d_trilinear {name}: max |err| {e}")
    alpha_ok = got.shape[-1] < 4 or torch.equal(got[..., 3:].cpu(),
                                                want[..., 3:].cpu())
    if e > (0 if max_val == 255 else 1) or not alpha_ok:
        raise AssertionError(f"lut3d_trilinear {name} differs from its "
                             f"plain version")
    return e


def audio_signal(n_flat: int, freq: float, gen, dev) -> torch.Tensor:
    """bench.py's input for every stream: a `freq` sine at 0.15 plus a
    97 Hz sine at 0.05, the same in both channels, plus 1e-3 gaussian
    noise of each stream's own; made on the card."""
    C = AUDIO_CHANNELS
    t = torch.arange(n_flat // C, dtype=torch.float64, device=dev) \
        / 192_000.0
    base = 0.15 * torch.sin(2 * np.pi * freq * t) \
        + 0.05 * torch.sin(2 * np.pi * 97.0 * t)
    sig = base[:, None].expand(-1, C).reshape(-1)
    noise = 1e-3 * torch.randn((AUDIO_STREAMS, n_flat), generator=gen,
                               dtype=torch.float64, device=dev)
    return sig[None, :] + noise


def limiter_signal(n_flat: int, freq: float, dev) -> torch.Tensor:
    """One stream that drives the true-peak limiter: a `freq` sine at
    0.003 and, every 0.3 s, 3 one-sample spikes 5 ms apart, each of its
    own height in [0.6, 0.95) (no two equal, so no decision rests on a
    tie); the same in both channels. Its loudness stays far below the
    target, so the gain lifts the spikes past the ceiling and the
    limiter attacks, sustains, releases and rests, several loop
    iterations a frame."""
    C = AUDIO_CHANNELS
    i = torch.arange(n_flat // C, device=dev)
    t = i.to(torch.float64) / 192_000.0
    phase = i % 57_600
    n = (i // 57_600) * 3 + phase // 960
    height = 0.6 + 0.35 * torch.frac(n.to(torch.float64) * 0.6180339887)
    x = 0.003 * torch.sin(2 * np.pi * freq * t) \
        + torch.where((phase % 960 == 0) & (phase < 3 * 960), height,
                      torch.zeros_like(t))
    return x[:, None].expand(-1, C).reshape(1, -1)


def decisions(st) -> list:
    """The loudnorm state's control-flow entries, per stream."""
    ln = st["ln"]
    return [ln["gidx"]] + [ln[k].cpu().tolist() for k in
                           ("lstate", "env_cnt", "sus", "above", "bcount")]


def audio_bounds(B: int, C: int) -> dict:
    """Least bytes each main-path jit kernel must move per 100 ms step
    at B streams, each input read once and each output written once,
    over the card's memory rate (ms). echo_block: the block in and out,
    the delayed samples read and the new ones written (the frame is
    shorter than the delay); make_block_biquad: one channel-frame in
    and out per call (4 calls a step); _limiter_frame with the gain
    machine: the |x| window it scans, the enveloped head and the
    clipped output written, and the 4096-block gating history read."""
    from gstpu_torch.ops.loudnorm_dev import ABSW, FRAME
    n = FRAME * C
    by = {"echo_block": 4 * B * n * 8,
          "make_block_biquad": 2 * B * n * 8,
          "_limiter_frame": B * (ABSW * C + 2 * n + 4096) * 8}
    return {k: (v, v / HBM_BYTES_PER_S * 1e3) for k, v in by.items()}


def device_events(fn, n: int):
    """Run fn n times under torch.profiler. Returns the device-side
    events (kernels, copies, and the ranges that are mirrored on the
    device) and the wall time of the n runs in seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall


def audio_banks(dev):
    """The audio inputs of phases 6 and 7, made on the card from SEED:
    the 3 s priming bank (B, 30 frames) and the AUDIO_BANK one-frame
    banks (B, 1 frame) of every stream, flattened interleaved."""
    from gstpu_torch.ops.loudnorm_dev import FRAME, GAIN_LOOKAHEAD
    C = AUDIO_CHANNELS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = audio_signal(GAIN_LOOKAHEAD * C, 440.0, gen, dev)
    bank = [audio_signal(FRAME * C, 300.0 + 40 * k, gen, dev)
            for k in range(AUDIO_BANK)]
    torch.cuda.synchronize()
    return x0, bank


def pair_inputs(x0, bank, steps: int, dev) -> list:
    """The card-vs-CPU pair: stream 0 of the bench input and a stream
    that drives the limiter; the priming block, then `steps` frames."""
    n_prime, n_step = x0.shape[1], bank[0].shape[1]
    x = [torch.cat([x0[:1], limiter_signal(n_prime, 440.0, dev)])]
    return x + [torch.cat([bank[k][:1], limiter_signal(
        n_step, 300.0 + 40 * k, dev)]) for k in range(steps)]


def audio_phase(gstpu_torch, dev, smi, x0, bank) -> dict:
    """6. The audio flagship chain at full width, its checks and its
    per-stage and per-kernel times."""
    from gstpu_torch.ops import loudnorm_dev as ln
    from gstpu_torch.ops.biquad import (biquad_coeffs_shelving,
                                        make_block_biquad)
    from gstpu_torch.ops.echo import echo_block
    from gstpu_torch.parallel.chains import (STAGES,
                                             make_audiofx_exact_chain)
    B, C = AUDIO_STREAMS, AUDIO_CHANNELS
    args = (AUDIO_INTENSITY, AUDIO_FEEDBACK)
    prime, step, init, n_prime, n_step = make_audiofx_exact_chain(
        channels=C, echo_delay=AUDIO_DELAY, max_delay=AUDIO_DELAY)

    t0 = time.perf_counter()
    state, out = prime(init(B, device=dev), x0, *args)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    lane0 = [out[0].clone()]
    for k in range(AUDIO_SETTLE):
        state, out, meters = step(state, bank[k % AUDIO_BANK], *args)
        if k < AUDIO_CHECK_STEPS:
            lane0.append(out[0].clone())
    torch.cuda.synchronize()

    ln.LIMITER_LOOP.iterations = 0
    t0 = time.perf_counter()
    for i in range(AUDIO_TIMED):
        state, out, meters = step(state, bank[i % AUDIO_BANK], *args)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rt = B * AUDIO_TIMED * 0.1 / wall
    loops = ln.LIMITER_LOOP.iterations / AUDIO_TIMED
    shortterm = meters["shortterm"]
    if out.shape != (B, n_step) or not bool(torch.isfinite(out).all()) \
            or not bool(torch.isfinite(shortterm).all()):
        raise AssertionError("audio chain output or meter not finite")
    st_mean = float(shortterm.double().mean())
    log(f"[audio] {B} streams x {AUDIO_TIMED} steps of 100 ms in "
        f"{wall * 1e3:.3f} ms: {rt:.2f}x realtime; the host enqueued "
        f"them in {enqueue * 1e3:.3f} ms; prime {prime_s:.3f} s; limiter "
        f"loop {loops} iterations a step; fused meter mean short-term "
        f"{st_mean:.4f} LUFS (target -24)  [{smi}]")

    # each stage of a step: CUDA events and the host clock at the
    # stage marks, over 5 steps (medians)
    dev_ms = {k: [] for k in STAGES}
    host_ms = {k: [] for k in STAGES}
    for i in range(5):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e, time.perf_counter()))

        mark("start")
        state, out, meters = step(state, bank[i % AUDIO_BANK], *args,
                                  mark=mark)
        torch.cuda.synchronize()
        for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
            dev_ms[name].append(e0.elapsed_time(e1))
            host_ms[name].append((h1 - h0) * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in dev_ms.items()}
    stage_host_ms = {k: statistics.median(v) for k, v in host_ms.items()}
    log("[audio] stage ms a step, device (host): " + ", ".join(
        f"{k} {stage_ms[k]:.3f} ({stage_host_ms[k]:.3f})" for k in STAGES))

    # a profiler window of 3 steps: the kernels launched, the device's
    # busy share, and each stage's kernel time (a profiler range per
    # stage, closed and the next opened at each mark; the ranges are
    # mirrored on the device, where they bound each stage's kernels)
    frames = itertools.cycle(bank)

    def profiled_step():
        nonlocal state
        ranges = [torch.profiler.record_function(
            f"audio_stage_{STAGES[0]}")]
        ranges[0].__enter__()

        def pmark(name):
            ranges[-1].__exit__(None, None, None)
            if len(ranges) < len(STAGES):
                ranges.append(torch.profiler.record_function(
                    f"audio_stage_{STAGES[len(ranges)]}"))
                ranges[-1].__enter__()

        state = step(state, next(frames), *args, mark=pmark)[0]

    on_dev, window = device_events(profiled_step, 3)
    spans = [e for e in on_dev if e.name.startswith("audio_stage_")]
    kern = [e for e in on_dev if not e.name.startswith("audio_stage_")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    stage_busy = {}
    for k in STAGES:
        mine = [(r.time_range.start, r.time_range.end)
                for r in spans if r.name == f"audio_stage_{k}"]
        stage_busy[k] = sum(
            e.time_range.elapsed_us() for e in kern
            if any(a <= e.time_range.start < b for a, b in mine)) / 3e3 \
            if mine else None
    profile = {"kernels_per_step": len(kern) / 3,
               "busy_ms_per_step": busy_ms / 3 if kern else None,
               "wall_ms_per_step": window * 1e3 / 3,
               "busy_share": busy_ms / (window * 1e3) if kern else None,
               "stage_busy_ms": stage_busy}
    log(f"[audio] profiler, 3 steps: {profile}")

    # lane 0 of a 1-stream run equals the 96-stream run bit for bit
    st1, o1 = prime(init(1, device=dev), x0[:1], *args)
    lane_diff = float((o1[0] - lane0[0]).abs().max())
    for k in range(AUDIO_CHECK_STEPS):
        st1, o1, _ = step(st1, bank[k][:1], *args)
        lane_diff = max(lane_diff, float((o1[0] - lane0[k + 1]).abs().max()))
    log(f"[audio] B=1 vs B={B} lane 0, prime + {AUDIO_CHECK_STEPS} steps: "
        f"max |diff| {lane_diff}")
    if lane_diff != 0.0:
        raise AssertionError("lane 0 of the 1-stream run differs from the "
                             f"{B}-stream run")

    # 2 streams on the card against the same 2 on the CPU: stream 0 of
    # the bench input, and a stream that drives the limiter
    x2 = pair_inputs(x0, bank, AUDIO_LIMITER_STEPS, dev)
    runs = []
    for where in (dev, torch.device("cpu")):
        st2, o = prime(init(2, device=where), x2[0].to(where), *args)
        outs, trace = [o.cpu()], [decisions(st2)]
        ln.LIMITER_LOOP.iterations = 0
        for k in range(AUDIO_LIMITER_STEPS):
            st2, o, _ = step(st2, x2[k + 1].to(where), *args)
            outs.append(o.cpu())
            trace.append(decisions(st2))
        runs.append((outs, trace, ln.LIMITER_LOOP.iterations))
    (card_outs, card_trace, card_loops), (cpu_outs, cpu_trace, _) = runs
    cpu_diff = max(float((a - b).abs().max())
                   for a, b in zip(card_outs, cpu_outs))
    same_trace = card_trace == cpu_trace
    lim_trace = [d[1][1] for d in card_trace]
    log(f"[audio] 2 streams, card vs CPU, prime + {AUDIO_LIMITER_STEPS} "
        f"steps: max |diff| {cpu_diff}, decisions "
        f"{'identical' if same_trace else 'DIFFER'}; the limiter stream's "
        f"state after each (0 out, 1 attack, 2 sustain, 3 release) "
        f"{lim_trace}, {card_loops} loop iterations in "
        f"{AUDIO_LIMITER_STEPS} steps")
    if not cpu_diff <= 1e-12 or not same_trace:
        raise AssertionError("the card's audio chain differs from the CPU")
    if set(lim_trace) == {ln.OUT} or card_loops <= AUDIO_LIMITER_STEPS:
        raise AssertionError("the card-vs-CPU check did not drive the "
                             "limiter")

    # the rsaudioecho element through parse_launch, card and CPU
    launch = ("audiotestsrc num-buffers=20 samplesperbuffer=19200 "
              "wave=ticks ! audio/x-raw, format=F64LE, rate=192000, "
              "channels=2 ! rsaudioecho delay=250000000 "
              "max-delay=500000000 intensity=0.5 feedback=0.3 ! "
              "appsink name=out")
    card = run_pipeline(gstpu_torch, launch, dev)
    plain = run_pipeline(gstpu_torch, launch, "cpu")
    if len(card) != 20 or len(plain) != 20:
        raise AssertionError("rsaudioecho pipeline lost buffers")
    echo_diff = 0.0
    for a, b in zip(card, plain):
        if a.data.device != dev or a.data.shape != (19200, 2):
            raise AssertionError("rsaudioecho output is not on the card")
        echo_diff = max(echo_diff,
                        float((a.data.cpu() - b.data).abs().max()))
    log(f"[audio] audiotestsrc ! rsaudioecho ! appsink, 20 x 19200 "
        f"frames on the card vs the CPU: max |diff| {echo_diff}")
    if echo_diff != 0.0:
        raise AssertionError("rsaudioecho on the card differs from the CPU")
    gstpu_torch.init(device=dev)

    # each main-path jit kernel alone at the step's shapes
    bounds = audio_bounds(B, C)
    y = bank[0]
    tail = state["tail"]
    xt = y.reshape(B, -1, C).permute(0, 2, 1).reshape(B * C, -1) \
        .contiguous()
    biquad = make_block_biquad(*biquad_coeffs_shelving(ln.RATE), L=64)
    z = state["ln"]["z_in1"]
    lst = state["ln"]
    jit_kernels = {
        "echo_block": (lambda: echo_block(tail, y, *args,
                                          delay=AUDIO_DELAY), 1,
                       "gstpu/ops/echo.py:34"),
        "make_block_biquad": (lambda: biquad(xt, z), 4,
                              "gstpu/ops/biquad.py:188"),
        "_limiter_frame": (lambda: ln._limiter_frame(
            ln.LoudnormParams(channels=C), lst["lim"], lst["gr0"],
            lst["gr1"], lst["lstate"], lst["env_cnt"], lst["sus"],
            ln.FRAME), 1, "gstpu/ops/loudnorm_dev.py:270"),
    }
    rows = {}
    for name, (fn, calls, src) in jit_kernels.items():
        fn()
        kern, w = device_events(fn, 5)
        busy = sum(e.time_range.elapsed_us() for e in kern) / 5e3
        rows[name] = {"replaces": src, "calls_per_step": calls,
                      "kernels_per_call": len(kern) / 5, "busy_ms": busy,
                      "wall_ms": w * 1e3 / 5, "bound_ms": bounds[name][1],
                      "bytes": bounds[name][0]}
        log(f"[audio] {name} alone (B={B}), a call: {len(kern) / 5} "
            f"kernels, {busy:.4f} ms busy on the device, {w * 200:.4f} ms "
            f"wall; {calls} a step; bytes bound {bounds[name][1]:.4f} ms "
            f"({bounds[name][0]} B)  [{smi}]")
    return {"B": B, "channels": C, "rt": rt, "wall_ms": wall * 1e3,
            "enqueue_ms": enqueue * 1e3, "prime_s": prime_s,
            "stage_ms": stage_ms, "stage_host_ms": stage_host_ms,
            "limiter_iterations_per_step": loops, "profile": profile,
            "shortterm_mean_lufs": st_mean,
            "lane0_b1_vs_b96_max_abs_diff": lane_diff,
            "card_vs_cpu_max_abs_diff": cpu_diff,
            "check_limiter_states": lim_trace,
            "check_limiter_iterations": card_loops,
            "echo_pipeline_max_abs_diff": echo_diff,
            "jit_kernels": rows}


def timed(fn, key: str, acc: dict):
    """fn, adding the host seconds of each call to acc[key]."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        acc[key] += time.perf_counter() - t0
        return r
    return wrapper


def element_launch(ctx: str, block: int) -> str:
    """The flagship chain as users write it: every element a member of
    DeviceContext `ctx` (bench_batch.py's string)."""
    caps = (f"audio/x-raw, format=F64LE, rate=192000, "
            f"channels={AUDIO_CHANNELS}, layout=interleaved")
    return (f'appsrc name=src caps="{caps}" ! '
            f'rsaudioecho delay=250000000 max-delay=250000000 '
            f'intensity={AUDIO_INTENSITY} feedback={AUDIO_FEEDBACK} '
            f'context={ctx} context-block={block} ! '
            f'audioloudnorm context={ctx} ! '
            f'ebur128level context={ctx} mode=momentary,short-term ! '
            f'appsink name=sink')


def run_eos_pair(gstpu_torch, where, xs: list, tail) -> tuple:
    """Two element-form pipelines in one context on `where`, fed the
    rows of xs (the priming block, then frames) and a partial frame
    `tail`, then EOS: each stream's output (the EOS drain included) and
    the loudnorm decisions after every round and after EOS."""
    from gstpu_torch.runtime.device_batch import DeviceContext
    gstpu_torch.init(device=where)
    name = "chip-smoke-eos"
    DeviceContext.release(name)
    block = xs[1].shape[1]
    ctx = DeviceContext.acquire(name, block)
    pipes = [gstpu_torch.parse_launch(element_launch(name, block))
             for _ in range(2)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)

    def fused_decisions(ln):
        return [ln["gidx"]] + [ln[k].cpu().tolist() for k in (
            "lstate", "env_cnt", "sus", "above", "bcount")]

    trace = []
    for k, x in enumerate(xs + [tail]):
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                x[i].to(where), pts=(0 if k == 0 else 29 + k) * 100_000_000))
            while p.iterate():
                pass
        if k < len(xs):
            # the fused loudnorm stage's batched state after this round
            trace.append(fused_decisions(ctx._batched[1][1]))
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run()
    # after EOS each chain holds its own state: the same entries, one
    # list over the two streams as the batched ones above
    lns = [c.stages[1].owner.state for c in ctx.chains]
    trace.append([[ln["gidx"] for ln in lns]] + [
        [ln[k].item() for ln in lns]
        for k in ("lstate", "env_cnt", "sus", "above", "bcount")])
    outs = [np.concatenate([np.asarray(b.array).reshape(-1)
                            for b in p.get_by_name("sink").pull_all()])
            for p in pipes]
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(name)
    return outs, trace


def element_audio_phase(gstpu_torch, dev, smi, x0, bank, hand) -> dict:
    """7a. The flagship chain in its element form: AUDIO_STREAMS
    parse_launch pipelines of `rsaudioecho ! audioloudnorm !
    ebur128level` sharing one DeviceContext (depth 2), fed DeviceRow
    rows of phase 6's banks. Checks every lane against
    make_audiofx_exact_chain bit for bit, the fused meter, and an EOS
    pair on the card against the CPU; times the rounds and the host
    time inside the context beside phase 6's hand-fused step (`hand`)."""
    from gstpu_torch.ops import loudnorm_dev as ln
    from gstpu_torch.parallel.chains import make_audiofx_exact_chain
    from gstpu_torch.runtime.device_batch import DeviceContext, DeviceRow
    B, C = AUDIO_STREAMS, AUDIO_CHANNELS
    block = ln.FRAME * C
    args = (AUDIO_INTENSITY, AUDIO_FEEDBACK)
    n_rounds = AUDIO_SETTLE + AUDIO_TIMED + AUDIO_PROFILED
    frames = [bank[k % AUDIO_BANK] for k in range(n_rounds)]

    # the reference: the hand-fused chain at B=96 on the same banks
    prime, step, init, _, _ = make_audiofx_exact_chain(
        channels=C, echo_delay=AUDIO_DELAY, max_delay=AUDIO_DELAY)
    st, out = prime(init(B, device=dev), x0, *args)
    ref = [out]
    for k, x in enumerate(frames):
        if k == AUDIO_SETTLE:            # its timed steps, as phase 6's
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        st, out, _ = step(st, x, *args)
        ref.append(out)
        if k == AUDIO_SETTLE + AUDIO_TIMED - 1:
            torch.cuda.synchronize()
            direct_ms = (time.perf_counter() - t0) * 1e3 / AUDIO_TIMED
    del st
    torch.cuda.synchronize()

    gstpu_torch.init(device=dev)
    name = "chip-smoke-audio"
    DeviceContext.release(name)
    ctx = DeviceContext.acquire(name, block, depth=2)
    pipes = [gstpu_torch.parse_launch(element_launch(name, block))
             for _ in range(B)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
    srcs = [p.get_by_name("src") for p in pipes]
    sinks = [p.get_by_name("sink") for p in pipes]

    # host seconds inside the context's entry points (inclusive: submit
    # holds the fire, a fire the composed step and the distribution of
    # the batch before it)
    host = {"submit": 0.0, "_fire": 0.0, "_distribute": 0.0, "step": 0.0}
    for key in ("submit", "_fire", "_distribute"):
        setattr(ctx, key, timed(getattr(ctx, key), key, host))
    rounds = iter(range(n_rounds))

    def push_round(x=None):
        k = None if x is not None else next(rounds)
        for i, p in enumerate(pipes):
            srcs[i].push_buffer(gstpu_torch.Buffer(
                DeviceRow(frames[k] if x is None else x, i),
                pts=(0 if x is not None else 30 + k) * 100_000_000))
            while p.iterate():
                pass

    t0 = time.perf_counter()
    push_round(x0)                       # the 3 s priming round
    for _ in range(AUDIO_SETTLE):
        push_round()
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    # the chains are built: time the composed step inside each fire
    step_fn, prime_fn, n_stages, final_fn = ctx._fused
    ctx._fused = (timed(step_fn, "step", host), prime_fn, n_stages,
                  final_fn)
    for key in host:
        host[key] = 0.0
    t0 = time.perf_counter()
    for _ in range(AUDIO_TIMED):
        push_round()
    enqueue = time.perf_counter() - t0
    ctx.flush_pending()                  # hand out the last round
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host_ms = {k: v * 1e3 / AUDIO_TIMED for k, v in host.items()}
    rt = B * AUDIO_TIMED * 0.1 / wall
    on_dev, window = device_events(push_round, AUDIO_PROFILED)
    ctx.flush_pending()
    busy_ms = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3
    profile = {"kernels_per_round": len(on_dev) / AUDIO_PROFILED,
               "busy_ms_per_round": busy_ms / AUDIO_PROFILED,
               "wall_ms_per_round": window * 1e3 / AUDIO_PROFILED,
               "busy_share": busy_ms / (window * 1e3)}
    log(f"[element] {B} parse_launch pipelines in one DeviceContext "
        f"(depth 2), {AUDIO_TIMED} rounds of 100 ms in {wall * 1e3:.3f} "
        f"ms: {rt:.2f}x realtime; enqueued in {enqueue * 1e3:.3f} ms; "
        f"host ms a round inside submit {host_ms['submit']:.3f}, _fire "
        f"{host_ms['_fire']:.3f}, its step {host_ms['step']:.3f}, "
        f"_distribute {host_ms['_distribute']:.3f} of "
        f"{wall * 1e3 / AUDIO_TIMED:.3f} wall; the same {AUDIO_TIMED} "
        f"steps of make_audiofx_exact_chain just before: {direct_ms:.3f} "
        f"ms a step; priming + settling {settle_s:.3f} s  [{smi}]")
    log(f"[element] profiler, {AUDIO_PROFILED} rounds: {profile}; phase "
        f"6's hand-fused step: {hand['rt']:.2f}x, "
        f"{hand['wall_ms'] / AUDIO_TIMED:.3f} ms a step, "
        f"{hand['profile']['kernels_per_step']} kernels a step")

    # every lane, prime and every round, against the hand-fused chain
    lane_bad = 0
    for i, s in enumerate(sinks):
        if len(s.samples) != n_rounds + 1 or not all(
                isinstance(b.data, DeviceRow) and b.data.idx == i
                for b in s.samples):
            raise AssertionError(f"element lane {i} gave {len(s.samples)} "
                                 f"buffers, not {n_rounds + 1} batch rows")
    for r in range(n_rounds + 1):
        got = torch.stack([s.samples[r].data.tensor() for s in sinks])
        lane_bad += int((got != ref[r]).any(dim=1).sum())
    log(f"[element] {B} lanes x (prime + {n_rounds} rounds) against "
        f"make_audiofx_exact_chain at B={B}: {lane_bad} lane outputs "
        f"differ")
    if lane_bad:
        raise AssertionError("the element form differs from the "
                             "hand-fused chain")
    levels = [[m.fields["shortterm-loudness"] for m in p.bus.drain()
               if getattr(m, "name", "") == "ebur128-level"]
              for p in pipes]
    last_st = [lv[-1] for lv in levels if lv]
    if len(last_st) != B or max(abs(v + 24.0) for v in last_st) > 1.0:
        raise AssertionError(f"fused meter: last short-term loudness "
                             f"{min(last_st, default=None)} .. "
                             f"{max(last_st, default=None)} LUFS")
    log(f"[element] fused meter, last short-term of each lane: "
        f"{min(last_st):.4f} .. {max(last_st):.4f} LUFS (target -24)")
    # torn down without EOS, as bench_batch.py does: a B=1 drain of
    # every stream is not the path under test here
    t0 = time.perf_counter()
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    teardown_s = time.perf_counter() - t0
    DeviceContext.release(name)
    del ref, pipes, srcs, sinks

    # two streams to EOS, card against CPU, one driving the limiter
    xs = pair_inputs(x0, bank, AUDIO_EOS_STEPS, dev)
    tail = xs[1][:, : block // 2]        # a partial last frame
    (card_outs, card_trace), (cpu_outs, cpu_trace) = (
        run_eos_pair(gstpu_torch, where, xs, tail)
        for where in (dev, torch.device("cpu")))
    gstpu_torch.init(device=dev)
    n_flat = xs[0].shape[1] + AUDIO_EOS_STEPS * block + block // 2
    eos_diff = max(float(np.abs(a - b).max())
                   for a, b in zip(card_outs, cpu_outs))
    lim_states = [t[1][1] for t in card_trace]
    log(f"[element] EOS pair, card vs CPU, prime + {AUDIO_EOS_STEPS} "
        f"frames + half a frame + the EOS drain ({card_outs[0].size} "
        f"samples a stream): max |diff| {eos_diff}, decisions "
        f"{'identical' if card_trace == cpu_trace else 'DIFFER'}; the "
        f"limiter stream's state after each round and after EOS "
        f"{lim_states}")
    if any(o.size != n_flat for o in card_outs + cpu_outs) \
            or not eos_diff <= 1e-12 or card_trace != cpu_trace:
        raise AssertionError("the element form's EOS pair differs between "
                             "the card and the CPU")
    if set(lim_states) == {ln.OUT}:
        raise AssertionError("the EOS pair did not drive the limiter")
    return {"B": B, "rt": rt, "wall_ms_per_round": wall * 1e3 / AUDIO_TIMED,
            "enqueue_ms_per_round": enqueue * 1e3 / AUDIO_TIMED,
            "host_ms_per_round": host_ms, "profile": profile,
            "direct_ms_per_step": direct_ms,
            "settle_s": settle_s, "teardown_s": teardown_s,
            "lanes_differing": lane_bad,
            "last_shortterm_lufs": [min(last_st), max(last_st)],
            "eos_pair_max_abs_diff": eos_diff,
            "eos_pair_limiter_states": lim_states,
            "hand_fused": {"rt": hand["rt"],
                           "wall_ms_per_step": hand["wall_ms"] / AUDIO_TIMED,
                           "enqueue_ms_per_step":
                               hand["enqueue_ms"] / AUDIO_TIMED,
                           "kernels_per_step":
                               hand["profile"]["kernels_per_step"]}}


def element_video_phase(gstpu_torch, dev, smi, lut, bank, kernels,
                        hsv: str) -> dict:
    """7b. Four `appsrc ! hsvfilter ! colorlut ! appsink` pipelines
    sharing one DeviceContext at 4K RGBA, fed CUDA tensors: one launch of
    each kernel a fire, every frame equal to the unbatched wrappers'
    output (phase 4's path) bit for bit; frames a second."""
    from gstpu_torch.ops.hsv import hsv_filter_frame
    from gstpu_torch.ops.lut import apply_lut_3d
    from gstpu_torch.runtime.device_batch import DeviceContext
    want = [apply_lut_3d(hsv_filter_frame(f, (0, 1, 2), *HSV_PARAMS[0]),
                         lut.table, *LUT_DOMAIN, packed=lut.packed)
            for f in bank]
    gstpu_torch.init(device=dev)
    name = "chip-smoke-video"
    DeviceContext.release(name)
    caps = f"video/x-raw, format=RGBA, width={W}, height={H}, framerate=30/1"
    pipes = []
    for _ in range(4):
        p = gstpu_torch.parse_launch(
            f'appsrc name=src caps="{caps}" ! hsvfilter {hsv} '
            f'context={name} ! colorlut name=cl context={name} ! '
            f'appsink name=sink')
        p.get_by_name("cl").set_lut(lut)
        p.set_state(gstpu_torch.State.PLAYING)
        pipes.append(p)
    sinks = [p.get_by_name("sink") for p in pipes]

    def push_round(k: int) -> list:
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                bank[(k + i) % 4], pts=k * 33_333_333))
            while p.iterate():
                pass
        return [s.pull_all() for s in sinks]

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    ctx = DeviceContext.acquire(name)
    checked = 0
    for k in range(4):                   # every frame checked
        for i, bufs in enumerate(push_round(k)):
            if len(bufs) != 1 or not torch.equal(
                    bufs[0].data.tensor(), want[(k + i) % 4]):
                raise AssertionError(f"batched 4K frame, round {k} lane "
                                     f"{i}, differs from the unbatched "
                                     f"chain")
            checked += 1
    rounds = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sum(len(b) for k in range(4, 4 + rounds) for b in push_round(k))
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fires = ctx.fire_count
    launches = {k.name: k.launches for k in kernels}
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(name)
    fps = got / dt
    log(f"[element] 4 x `hsvfilter ! colorlut` in one DeviceContext, 4K "
        f"RGBA tensors: {checked} frames equal the unbatched chain; "
        f"{got} frames in {dt * 1e3:.3f} ms: {fps:.2f} fps, enqueued in "
        f"{enqueue * 1e3:.3f} ms; {fires} fires, launches {launches}  "
        f"[{smi}]")
    if got != 4 * rounds or any(n != fires for n in launches.values()):
        raise AssertionError("the batched video chain does not launch "
                             "each kernel once a fire")
    return {"fps": fps, "frames": got, "frames_checked": checked,
            "fires": fires, "launches": launches,
            "enqueue_ms": enqueue * 1e3, "wall_ms": dt * 1e3}


def bound(n_bytes: float, ops: float, ops_per_s: float) -> tuple:
    """The least time (ms) for the work and what bounds it: the bytes
    over the memory rate, or the operations over the peak rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def profile_calls(fn, n: int) -> dict:
    """Kernels launched and device busy ms a call of fn, and its wall ms
    under the profiler, over n calls after one warm call."""
    fn()
    kern, wall = device_events(fn, n)
    return {"kernels_per_call": len(kern) / n,
            "busy_ms": sum(e.time_range.elapsed_us() for e in kern)
            / (1e3 * n),
            "wall_ms": wall * 1e3 / n}


def rnnoise_weights(rng) -> dict:
    """Random weights at the published RNNoise shapes (dense 42->24,
    GRUs of 24, 48 and 96 units, heads of 22 and 1), as
    tests/test_rnnoise_device.py makes them."""
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


def rnnoise_banks(dev) -> list:
    """RN_BANK consecutive 100 ms blocks of RN_STREAMS mono streams in
    [-1, 1], made on the card from SEED: a voiced tone of each stream's
    own pitch (110-300 Hz, 4 harmonics) gated on and off at 2 Hz, plus
    0.03 gaussian noise."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n = RN_FRAMES * 480
    t = torch.arange(RN_BANK * n, dtype=torch.float64, device=dev) / 48_000
    f0 = 110.0 + 2.0 * torch.arange(RN_STREAMS, dtype=torch.float64,
                                    device=dev)[:, None]
    voiced = sum(torch.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    gate = (torch.sin(2 * np.pi * 2.0 * t) > -0.2).to(torch.float64)
    x = 0.25 * voiced * gate + 0.03 * torch.randn(
        (RN_STREAMS, RN_BANK * n), generator=gen, dtype=torch.float64,
        device=dev)
    return [x[:, k * n:(k + 1) * n].contiguous() for k in range(RN_BANK)]


def run_rnnoise_pipeline(gstpu_torch, where, launch: str, x) -> np.ndarray:
    """`launch` (appsrc name=src ... appsink name=sink) on `where`, fed
    the rows of x (host f32) one 100 ms block a buffer, to EOS."""
    gstpu_torch.init(device=where)
    p = gstpu_torch.parse_launch(launch)
    p.set_state(gstpu_torch.State.PLAYING)
    src = p.get_by_name("src")
    for k, row in enumerate(x):
        src.push_buffer(gstpu_torch.Buffer(row.reshape(-1, 1),
                                           pts=k * 100_000_000))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    out = np.concatenate([np.asarray(b.array).reshape(-1)
                          for b in p.get_by_name("sink").pull_all()])
    p.set_state(gstpu_torch.State.NULL)
    return out


def rnnoise_phase(gstpu_torch, dev, smi, tmp: Path) -> dict:
    """8. audiornnoise at full width: (a) the device denoisers on banks
    made on the card, lanes, the numpy oracle and their device time;
    (b) RN_STREAMS pipelines in one DeviceContext fed DeviceRow rows,
    every lane against the step at B=RN_STREAMS bit for bit; (c) one
    engine=device pipeline against engine=host."""
    from gstpu_torch.ops.rnnoise import (DenoiseState, GruModel,
                                         make_device_denoiser,
                                         make_device_gru_denoiser)
    from gstpu_torch.runtime.device_batch import DeviceContext, DeviceRow
    B, n = RN_STREAMS, RN_FRAMES * 480
    weights = rnnoise_weights(np.random.default_rng(SEED))
    wpath = tmp / "rnnoise.npz"
    np.savez(wpath, **weights)
    banks = rnnoise_banks(dev)
    scaled = [b * 32767.0 for b in banks]
    den = {"gru_f64": make_device_gru_denoiser(weights, RN_FRAMES,
                                               torch.float64),
           "gru_f32": make_device_gru_denoiser(weights, RN_FRAMES,
                                               torch.float32),
           "spectral": make_device_denoiser(RN_FRAMES)}
    res = {"streams": B, "block": n, "denoisers": {}}

    # (a) lane 0 of B=1 against B=96, and 2 streams against the oracle
    x2 = torch.cat(scaled[:RN_CHECK_BLOCKS], 1)[:2]
    x2_host = x2.cpu().numpy()
    oracles = {}
    for kind, w in (("gru", weights), ("spectral", None)):
        out, vad = np.zeros_like(x2_host), []
        for s in range(2):
            ds = DenoiseState(GruModel(w) if w else None)
            for f in range(x2_host.shape[1] // 480):
                out[s, f * 480:(f + 1) * 480], v = ds.process_frame(
                    x2_host[s, f * 480:(f + 1) * 480])
                vad.append(v)
        oracles[kind] = (out, np.asarray(vad).reshape(2, -1))
    for kind, (step, init) in den.items():
        lanes = {}
        for b in (B, 1):
            st, outs = init(b, dev), []
            for k in range(RN_CHECK_BLOCKS):
                st, out, vad = step(st, scaled[k][:b])
                outs += [out[0], vad[0]]
            lanes[b] = outs + [v[0] for v in st.values()]
        lane_same = all(torch.equal(a, c) for a, c in zip(lanes[1], lanes[B]))
        _, out2, vad2 = step(init(2, dev), x2)
        want_out, want_vad = oracles[kind.split("_")[0]]
        err = float(np.abs(out2.double().cpu().numpy() - want_out).max())
        verr = float(np.abs(vad2.double().cpu().numpy() - want_vad).max())
        tol = 8.0 if kind == "gru_f32" else 1e-9 * 32767
        st = init(B, dev)
        prof = profile_calls(lambda: step(st, scaled[0]), 3)
        # least work a block: each input sample read and output written
        # once (f64 or f32) and the state read and written once; the
        # GRU chain's operations are counted for its pitch correlation
        # alone (769 x 960 multiply-adds a stream and frame), the gate's
        # for its two 960-point real FFTs (2.5 n log2 n each) and its
        # two 481 x 22 band products
        item = 4 if kind == "gru_f32" else 8
        state_bytes = sum(v.numel() * v.element_size()
                          for v in st.values())
        n_bytes = 2 * B * n * item + 2 * state_bytes
        if kind == "spectral":
            ops = B * RN_FRAMES * (2 * 2.5 * 960 * np.log2(960)
                                   + 2 * 2 * 481 * 22)
        else:
            ops = B * RN_FRAMES * 769 * 960 * 2
        rate = F32_OPS_PER_S if kind == "gru_f32" else F64_OPS_PER_S
        b_ms, b_by = bound(n_bytes, ops, rate)
        row = {"lane0_b1_equals_b96": lane_same, "oracle_max_abs_err": err,
               "oracle_vad_max_abs_err": verr, "oracle_tol": tol,
               **prof, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": n_bytes, "ops": ops}
        res["denoisers"][kind] = row
        log(f"[rnnoise] {kind}: lane 0 of B=1 vs B={B} over "
            f"{RN_CHECK_BLOCKS} blocks "
            f"{'bit for bit' if lane_same else 'DIFFERS'}; "
            f"2 streams x {x2.shape[1] // 480} frames vs the numpy oracle: "
            f"output max |err| {err:.3e} (gate {tol:.3e}, +-32767 scale), "
            f"VAD {verr:.3e}; a block at B={B}: "
            f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms "
            f"busy, {prof['wall_ms']:.4f} ms wall; bound {b_ms:.4f} ms "
            f"({b_by})  [{smi}]")
        if not lane_same:
            raise AssertionError(f"{kind}: lane 0 of the 1-stream run "
                                 f"differs from the {B}-stream run")
        if not err < tol or (kind != "gru_f32" and not verr < 1e-12):
            raise AssertionError(f"{kind} on the card differs from the "
                                 f"numpy oracle")
        del st

    # (b) the element form: B pipelines in one context, DeviceRow rows
    step, init = den["gru_f64"]
    n_rounds = 1 + RN_SETTLE + RN_TIMED + RN_PROFILED
    frames = [banks[k % RN_BANK] for k in range(n_rounds)]
    st, ref = init(B, dev), []
    for x in frames:
        st, out, _ = step(st, x * 32767.0)
        ref.append(out / 32767.0)
    del st
    gstpu_torch.init(device=dev)
    name = "chip-smoke-rnnoise"
    DeviceContext.release(name)
    ctx = DeviceContext.acquire(name, n, depth=2)
    caps = ("audio/x-raw, format=F32LE, rate=48000, channels=1, "
            "layout=interleaved")
    pipes = [gstpu_torch.parse_launch(
        f'appsrc name=src caps="{caps}" ! audiornnoise '
        f'model-location={wpath} context={name} context-block={n} ! '
        f'appsink name=sink') for _ in range(B)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
    srcs = [p.get_by_name("src") for p in pipes]
    sinks = [p.get_by_name("sink") for p in pipes]
    host = {"submit": 0.0, "_fire": 0.0, "_distribute": 0.0}
    for key in host:
        setattr(ctx, key, timed(getattr(ctx, key), key, host))
    rounds = iter(range(n_rounds))

    def push_round():
        k = next(rounds)
        for i, p in enumerate(pipes):
            srcs[i].push_buffer(gstpu_torch.Buffer(
                DeviceRow(frames[k], i), pts=k * 100_000_000))
            while p.iterate():
                pass

    t0 = time.perf_counter()
    for _ in range(1 + RN_SETTLE):           # the first fire, settling
        push_round()
    ctx.flush_pending()
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    for key in host:
        host[key] = 0.0
    t0 = time.perf_counter()
    for _ in range(RN_TIMED):
        push_round()
    enqueue = time.perf_counter() - t0
    ctx.flush_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host_ms = {k: v * 1e3 / RN_TIMED for k, v in host.items()}
    rt = B * RN_TIMED * 0.1 / wall
    on_dev, window = device_events(push_round, RN_PROFILED)
    ctx.flush_pending()
    busy_ms = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3
    profile = {"kernels_per_round": len(on_dev) / RN_PROFILED,
               "busy_ms_per_round": busy_ms / RN_PROFILED,
               "wall_ms_per_round": window * 1e3 / RN_PROFILED,
               "busy_share": busy_ms / (window * 1e3)}
    bad = 0
    for i, s in enumerate(sinks):
        if len(s.samples) != n_rounds or not all(
                isinstance(b.data, DeviceRow) and b.data.idx == i
                for b in s.samples):
            raise AssertionError(f"rnnoise lane {i} gave {len(s.samples)} "
                                 f"buffers, not {n_rounds} batch rows")
    for r in range(n_rounds):
        got = torch.stack([s.samples[r].data.tensor() for s in sinks])
        bad += int((got != ref[r]).any(dim=1).sum())
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(name)
    del ref, pipes, srcs, sinks
    log(f"[rnnoise] {B} `appsrc ! audiornnoise model-location=W context=R "
        f"context-block={n} ! appsink` pipelines (depth 2), {RN_TIMED} "
        f"rounds of 100 ms in {wall * 1e3:.3f} ms: {rt:.2f}x realtime; "
        f"enqueued in {enqueue * 1e3:.3f} ms; host ms a round inside "
        f"submit {host_ms['submit']:.3f}, _fire {host_ms['_fire']:.3f}, "
        f"_distribute {host_ms['_distribute']:.3f}; first fire + settling "
        f"{settle_s:.3f} s; profiler, {RN_PROFILED} rounds: {profile}; "
        f"{bad} lane outputs of {B} x {n_rounds} rounds differ from the "
        f"step at B={B}  [{smi}]")
    if bad:
        raise AssertionError("the audiornnoise element form differs from "
                             "make_device_gru_denoiser at B=96")
    res["context"] = {"rt": rt, "wall_ms_per_round": wall * 1e3 / RN_TIMED,
                      "enqueue_ms_per_round": enqueue * 1e3 / RN_TIMED,
                      "host_ms_per_round": host_ms, "profile": profile,
                      "settle_s": settle_s, "lanes_differing": bad}

    # (c) engine=device on the card against engine=host, stream 0
    x = torch.cat(banks[:RN_CHECK_BLOCKS], 1)[0].reshape(
        RN_CHECK_BLOCKS, -1).float().cpu().numpy()
    launch = (f'appsrc name=src caps="{caps}" ! audiornnoise '
              f'model-location={wpath} engine={{}} ! appsink name=sink')
    t0 = time.perf_counter()
    on_card = run_rnnoise_pipeline(gstpu_torch, dev,
                                   launch.format("device"), x)
    card_s = time.perf_counter() - t0
    on_host = run_rnnoise_pipeline(gstpu_torch, "cpu",
                                   launch.format("host"), x)
    gstpu_torch.init(device=dev)
    eng_err = float(np.abs(on_card - on_host).max())
    log(f"[rnnoise] engine=device on the card vs engine=host, "
        f"{on_card.size} samples: max |diff| {eng_err:.3e} (gate 1e-6); "
        f"{card_s:.3f} s on the card")
    if on_card.size != x.size or not eng_err <= 1e-6:
        raise AssertionError("audiornnoise engine=device differs from "
                             "engine=host")
    res["engine_device_vs_host_max_abs_diff"] = eng_err
    return res


def hrtf_sphere(rng, C: int):
    """bench_hrtf.py's synthetic sphere (6 vertices, 8 faces, HRTF_IR
    taps of decaying noise) as .hrir bytes, and C unit directions."""
    from gstpu_torch.elements.audio.hrtf import HrirSphere
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    decay = np.exp(-np.arange(HRTF_IR) / 80.0)[None, :].astype(np.float32)
    left = rng.standard_normal((6, HRTF_IR)).astype(np.float32) * decay
    right = rng.standard_normal((6, HRTF_IR)).astype(np.float32) * decay
    raw = HrirSphere.to_bytes(verts, faces, left, right, HRTF_RATE)
    dirs = np.array([[np.cos(2 * np.pi * c / C), 0.2,
                      np.sin(2 * np.pi * c / C)] for c in range(C)])
    return raw, dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


def run_hrtf_element(gstpu_torch, where, path: Path, blocks, schedule):
    """`appsrc ! hrtfrender hrir-location=path ! appsink` on `where` at
    bench_hrtf.py's block and steps, fed `blocks` ((HRTF_BLOCK, C) f32)
    with schedule[k] (spatial objects) set before block k; the stereo
    output."""
    gstpu_torch.init(device=where)
    C = blocks[0].shape[1]
    caps = (f"audio/x-raw, format=F32LE, rate={HRTF_RATE}, channels={C}, "
            f"layout=interleaved")
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="{caps}" ! hrtfrender name=r '
        f'hrir-location={path} block-length={HRTF_BLOCK} '
        f'interpolation-steps={HRTF_STEPS} ! appsink name=sink')
    r, src = p.get_by_name("r"), p.get_by_name("src")
    p.set_state(gstpu_torch.State.PLAYING)
    for k, blk in enumerate(blocks):
        if k in schedule:
            r.set_property("spatial_objects", schedule[k])
        src.push_buffer(gstpu_torch.Buffer(blk))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    out = np.concatenate([np.asarray(b.array).reshape(-1, 2)
                          for b in p.get_by_name("sink").pull_all()])
    p.set_state(gstpu_torch.State.NULL)
    return out


def sofa_ring(rng):
    """bench_sofa.py's SOFA content, made here without a file: a
    SOFA_RING-point azimuth ring and decaying-noise HRIRs (M, 2, L)."""
    pos = np.stack([np.arange(SOFA_RING) * (360.0 / SOFA_RING),
                    np.zeros(SOFA_RING), np.full(SOFA_RING, 1.5)], axis=1)
    irs = rng.standard_normal((SOFA_RING, 2, SOFA_IR)).astype(np.float32)
    irs *= np.exp(-np.arange(SOFA_IR) / 100.0)[None, None, :] \
        .astype(np.float32)
    return pos, irs


def sofa_select(pos, yaw: float) -> np.ndarray:
    """Sofalizer._select_irs for SOFA_CHANNELS speakers at listener yaw
    `yaw`: the nearest measurement to each rotated speaker."""
    from gstpu_torch.elements.audio.hrtf import _LAYOUT_AZIMUTHS, _sph_to_vec
    azi, ele = np.radians(pos[:, 0]), np.radians(pos[:, 1])
    vecs = np.stack([np.cos(ele) * np.sin(azi), np.sin(ele),
                     np.cos(ele) * np.cos(azi)], axis=1)
    return np.asarray([int(np.argmax(vecs @ _sph_to_vec(az - yaw, 0.0)))
                       for az in _LAYOUT_AZIMUTHS[SOFA_CHANNELS]])


def binaural_phase(gstpu_torch, dev, smi, tmp: Path) -> dict:
    """9. hrtfrender and the sofalizer's convolution at bench_hrtf.py's
    and bench_sofa.py's configurations: (a) the element on the card
    against the CPU, directions changing mid-stream; (b) HRTF_STREAMS
    streams through ols_block as bench_hrtf.make_step, lane 0 against
    the element; (c) upc_block with a yaw step and crossfade every
    SOFA_ROT_EVERY blocks, against the CPU, blockwise against one call."""
    from gstpu_torch.ops.fftconv import (next_pow2, ols_block, upc_block,
                                         upc_init, upc_ir_rfft)
    res = {}
    rng = np.random.default_rng(SEED + 9)
    C = HRTF_CHANNELS
    raw, dirs = hrtf_sphere(rng, C)
    path = tmp / "bench.hrir"
    path.write_bytes(raw)

    def objects(d, gains):
        return [{"x": float(v[0]), "y": float(v[1]), "z": float(v[2]),
                 "distance-gain": float(g)} for v, g in zip(d, gains)]

    # (a) static, then new directions and gains (interpolated per step)
    blocks = [(rng.standard_normal((HRTF_BLOCK, C)) * 0.3)
              .astype(np.float32) for _ in range(6)]
    turned = dirs[:, [2, 1, 0]] * np.array([1.0, -1.0, 1.0])
    schedule = {0: objects(dirs, np.ones(C)),
                3: objects(turned, np.linspace(0.5, 1.5, C))}
    card = run_hrtf_element(gstpu_torch, dev, path, blocks, schedule)
    plain = run_hrtf_element(gstpu_torch, "cpu", path, blocks, schedule)
    gstpu_torch.init(device=dev)
    el_err = float(np.abs(card - plain).max())
    log(f"[binaural] hrtfrender, {C} channels, block {HRTF_BLOCK}, "
        f"{HRTF_STEPS} steps, IR {HRTF_IR}, 6 blocks (directions change "
        f"at block 3): card vs CPU max |diff| {el_err:.3e} (gate 1e-5)")
    if card.shape != (6 * HRTF_BLOCK, 2) or not el_err < 1e-5:
        raise AssertionError("hrtfrender on the card differs from the CPU")
    res["hrtfrender_card_vs_cpu_max_abs_diff"] = el_err

    # (b) the batched static-direction step, lane 0 against the element
    from gstpu_torch.elements.audio.hrtf import HrirSphere
    sphere = HrirSphere.from_bytes(raw)
    sub = HRTF_BLOCK // HRTF_STEPS
    nfft = next_pow2(sub + HRTF_IR - 1)
    irs = torch.from_numpy(np.stack([sphere.sample(d) for d in dirs])
                           .astype(np.float32)).to(dev)

    def hrtf_step(hist, x):
        """hist (B*C, 1, L-1); x (B, C, N) -> (hist, (B, 2, N))."""
        B = x.shape[0]
        ir_f = torch.fft.rfft(irs, n=nfft, dim=-1).repeat(B, 1, 1)
        xf = x.reshape(B * C, 1, -1)
        segs = []
        for k in range(HRTF_STEPS):
            hist, y = ols_block(hist, xf[..., k * sub:(k + 1) * sub], ir_f,
                                ir_len=HRTF_IR)
            segs.append(torch.sum(y.reshape(B, C, 2, sub), dim=1))
        return hist, torch.cat(segs, dim=-1)

    B = HRTF_STREAMS
    x_par = blocks[:4]
    el = run_hrtf_element(gstpu_torch, dev, path, x_par,
                          {0: objects(dirs, np.ones(C))})
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bank = [0.3 * torch.randn((B, C, HRTF_BLOCK), generator=gen, device=dev)
            for _ in range(8)]
    hist = torch.zeros((B * C, 1, HRTF_IR - 1), device=dev)
    outs = []
    for k, blk in enumerate(x_par):
        x = bank[k].clone()
        x[0] = torch.from_numpy(blk.T).to(dev)
        hist, y = hrtf_step(hist, x)
        outs.append(y[0].T.cpu().numpy())
    lane_err = float(np.abs(np.concatenate(outs) - el).max())
    hist = torch.zeros_like(hist)
    ir_f = torch.fft.rfft(irs, n=nfft).repeat(B, 1, 1)
    seg = bank[0].reshape(B * C, 1, -1)[..., :sub]
    prof = profile_calls(lambda: ols_block(hist, seg, ir_f,
                                           ir_len=HRTF_IR), 5)
    for k in range(4):
        hist, y = hrtf_step(hist, bank[k % 8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(HRTF_TIMED):
        hist, y = hrtf_step(hist, bank[i % 8])
    float(y.sum())
    wall = time.perf_counter() - t0
    rt = B * HRTF_TIMED * HRTF_BLOCK / HRTF_RATE / wall
    F = nfft // 2 + 1
    n_bytes = (B * C * (2 * (HRTF_IR - 1) + sub) * 4 + B * C * 2 * F * 8
               + B * C * 2 * sub * 4)
    ops = B * C * (3 * 2.5 * nfft * np.log2(nfft) + 2 * F * 6)
    b_ms, b_by = bound(n_bytes, ops, F32_OPS_PER_S)
    res["ols_block"] = {"calls_per_block": HRTF_STEPS, **prof,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bytes": n_bytes, "ops": ops}
    res["hrtf_batched"] = {"streams": B, "rt": rt,
                           "lane0_vs_element_max_abs_diff": lane_err}
    log(f"[binaural] {B} streams x {C} channels through ols_block "
        f"(bench_hrtf.make_step): lane 0 vs the element on the card max "
        f"|diff| {lane_err:.3e} "
        f"({'bit for bit' if lane_err == 0 else 'gate 4e-6'}); "
        f"{HRTF_TIMED} blocks in {wall * 1e3:.3f} ms: {rt:.2f}x realtime; "
        f"ols_block a call: {prof['kernels_per_call']} kernels, "
        f"{prof['busy_ms']:.4f} ms busy, bound {b_ms:.5f} ms ({b_by})  "
        f"[{smi}]")
    if not lane_err < 4e-6:
        raise AssertionError("the batched hrtf step differs from the "
                             "element")
    del bank, hist

    # (c) the sofalizer's UPC at bench_sofa.py's configuration
    pos, irs_all = sofa_ring(rng)
    B, C, S, P = SOFA_STREAMS, SOFA_CHANNELS, SOFA_BLOCK, SOFA_PART

    def render(state, x, irs_cur):
        Bx = x.shape[0]
        h_f = upc_ir_rfft(irs_cur, part_len=P).repeat(Bx, 1, 1, 1)
        st, y = upc_block(state, x.reshape(Bx * C, 1, -1), h_f,
                          part_len=P)
        return st, torch.sum(y.reshape(Bx, C, 2, -1), dim=1)

    def render_fade(state, x, irs_old, irs_new):
        _, y_old = render(state, x, irs_old)
        st, y_new = render(state, x, irs_new)
        ramp = torch.linspace(0.0, 1.0, y_new.shape[-1],
                              dtype=torch.float64, device=x.device)
        return st, y_old * (1 - ramp) + y_new * ramp

    yaws = [15.0 * k for k in range(SOFA_RING)]
    sel = [irs_all[sofa_select(pos, y)] for y in yaws]
    n_chk = SOFA_ROT_EVERY + 4
    xs = (rng.standard_normal((n_chk, B, C, S)) * 0.3).astype(np.float32)

    def rotating_run(where):
        ir_bank = [torch.from_numpy(s).to(where) for s in sel]
        state = upc_init((B * C, 1), SOFA_IR, P, device=where)
        rot, outs = 0, []
        for i in range(n_chk):
            x = torch.from_numpy(xs[i]).to(where)
            if i % SOFA_ROT_EVERY == SOFA_ROT_EVERY - 1:
                rot += 1
                state, y = render_fade(state, x, ir_bank[rot - 1],
                                       ir_bank[rot])
            else:
                state, y = render(state, x, ir_bank[rot])
            outs.append(y.cpu().numpy())
        return outs

    card_outs = rotating_run(dev)
    cpu_outs = rotating_run(torch.device("cpu"))
    upc_err = max(float(np.abs(a - b).max())
                  for a, b in zip(card_outs, cpu_outs))
    # the outputs sum 6 channels of 512-tap convolutions and peak near
    # 25, where an f32 ulp is 1.9e-6: the gate is 1e-5 of the peak
    peak = max(float(np.abs(b).max()) for b in cpu_outs)
    # blockwise (S a call, as the element) against the partition
    # granularity (P a call) and one call over 4 blocks, static filter
    irs0 = torch.from_numpy(sel[0]).to(dev)
    x4 = torch.from_numpy(np.concatenate(xs[:4], axis=-1)).to(dev)

    def static(blk):
        state = upc_init((B * C, 1), SOFA_IR, P, device=dev)
        outs = []
        for j in range(x4.shape[-1] // blk):
            state, y = render(state, x4[..., j * blk:(j + 1) * blk], irs0)
            outs.append(y)
        return torch.cat(outs, dim=-1)

    y_blk = static(S)
    gran = {"partition": float((static(P) - y_blk).abs().max()),
            "one_call": float((static(4 * S) - y_blk).abs().max())}
    h_f0 = upc_ir_rfft(irs0, part_len=P).repeat(B, 1, 1, 1)
    state = upc_init((B * C, 1), SOFA_IR, P, device=dev)
    x0 = x4[..., :S].reshape(B * C, 1, S)
    prof = profile_calls(lambda: upc_block(state, x0, h_f0, part_len=P), 5)
    ir_bank = [torch.from_numpy(s).to(dev) for s in sel]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bank = [0.3 * torch.randn((B, C, S), generator=gen, device=dev)
            for _ in range(8)]
    for k in range(4):
        state, y = render(state, bank[k], ir_bank[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rot = 0
    for i in range(SOFA_TIMED):
        if i % SOFA_ROT_EVERY == SOFA_ROT_EVERY - 1:
            rot += 1
            state, y = render_fade(state, bank[i % 8],
                                   ir_bank[(rot - 1) % SOFA_RING],
                                   ir_bank[rot % SOFA_RING])
        else:
            state, y = render(state, bank[i % 8], ir_bank[rot % SOFA_RING])
    float(y.sum())
    wall = time.perf_counter() - t0
    rt = B * SOFA_TIMED * S / HRTF_RATE / wall
    K, F = -(-SOFA_IR // P), P + 1
    n_bytes = (B * C * (2 * (K - 1) * F * 8 + 2 * P * 4 + S * 4)
               + B * C * 2 * K * F * 8 + B * C * 2 * S * 4)
    n_fr = S // P
    ops = B * C * (n_fr * 2.5 * 2 * P * np.log2(2 * P)
                   + 2 * n_fr * (K * F * 8 + 2.5 * 2 * P * np.log2(2 * P)))
    b_ms, b_by = bound(n_bytes, ops, F32_OPS_PER_S)
    res["upc_block"] = {"calls_per_block": 1, **prof, "bound_ms": b_ms,
                        "bound_by": b_by, "bytes": n_bytes, "ops": ops}
    res["sofa"] = {"streams": B, "rt": rt, "card_vs_cpu_max_abs_diff":
                   upc_err, "output_peak": peak,
                   "granularity_max_abs_diff": gran}
    log(f"[binaural] upc_block at bench_sofa.py's configuration ({B} "
        f"streams x {C} channels, block {S}, partition {P}, IR {SOFA_IR}, "
        f"a {SOFA_RING}-point ring, yaw step + crossfade every "
        f"{SOFA_ROT_EVERY} blocks): card vs CPU over {n_chk} blocks max "
        f"|diff| {upc_err:.3e} on outputs of peak {peak:.4f} (gate 1e-5 "
        f"of the peak); against 4 blocks in S-sample "
        f"calls, P-sample calls max |diff| {gran['partition']}, one call "
        f"{gran['one_call']}; {SOFA_TIMED} blocks in {wall * 1e3:.3f} ms: "
        f"{rt:.2f}x realtime; upc_block a call: "
        f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms "
        f"busy, bound {b_ms:.5f} ms ({b_by})  [{smi}]")
    if not upc_err < 1e-5 * max(1.0, peak) \
            or not max(gran.values()) < 1e-5 * max(1.0, peak):
        raise AssertionError("upc_block on the card differs from the CPU "
                             "or from its own one-call run")
    return res


def detector_phase(gstpu_torch, dev, smi, bank, flush) -> dict:
    """10a. hsvdetector: the 2^24-colour cube in each RGBA-family layout
    for every parameter set of the CPU tests, the card against the
    plain version on the CPU bit for bit; four 4K `appsrc ! hsvdetector
    context= ! appsink` pipelines fed CUDA tensors, every checked frame
    bit for bit against the unbatched element; fps, kernels a fire, and
    the function's time against its bound."""
    from gstpu_torch.ops.hsv import hsv_detect_frame
    from gstpu_torch.runtime.device_batch import DeviceContext
    res = {}
    checked = 0
    for params in DETECT_PARAMS:
        ref = hsv_detect_frame(colour_cube("RGBA", "cpu"), (0, 1, 2),
                               (0, 1, 2, 3), *params)
        for layout, (rgb, a) in DETECT_LAYOUTS.items():
            got = hsv_detect_frame(colour_cube(layout, dev, rgb), rgb,
                                   (*rgb, a), *params).cpu()
            want = torch.empty_like(ref)
            for k, i in enumerate((*rgb, a)):
                want[..., i] = ref[..., k]
            if not torch.equal(got, want):
                raise AssertionError(f"hsv_detect_frame {layout} {params} "
                                     f"differs on the card")
            checked += 1
        log(f"[detector] hsv_detect_frame {params}: every colour in "
            f"{', '.join(DETECT_LAYOUTS)} equals the CPU; "
            f"{int((ref[..., 3] == 255).sum())} colours match")
    res["cube_runs_bit_for_bit"] = checked

    # four 4K pipelines in one context, against the unbatched element
    params = DETECT_PARAMS[1]
    keys = ("hue_ref", "hue_var", "saturation_ref", "saturation_var",
            "value_ref", "value_var")
    props = " ".join(f"{k}={v}" for k, v in zip(keys, params))
    caps = f"video/x-raw, format=RGBA, width={W}, height={H}, framerate=30/1"
    gstpu_torch.init(device=dev)

    def pipes_for(ctx: str):
        extra = f" context={ctx}" if ctx else ""
        out = []
        for _ in range(4):
            p = gstpu_torch.parse_launch(
                f'appsrc name=src caps="{caps}" ! hsvdetector {props}'
                f'{extra} ! appsink name=sink')
            p.set_state(gstpu_torch.State.PLAYING)
            out.append(p)
        return out

    def push_round(pipes, k: int) -> list:
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                bank[(k + i) % 4], pts=k * 33_333_333))
            while p.iterate():
                pass
        return [p.get_by_name("sink").pull_all() for p in pipes]

    def tensor(buf):
        d = buf.data
        return d if isinstance(d, torch.Tensor) else d.tensor()

    single = pipes_for("")
    unbatched = [tensor(b[0]) for b in push_round(single, 0)]
    for p in single:
        p.set_state(gstpu_torch.State.NULL)
    name = "chip-smoke-detector"
    DeviceContext.release(name)
    pipes = pipes_for(name)
    ctx = DeviceContext.acquire(name)
    frames_checked = 0
    for k in range(4):
        for i, bufs in enumerate(push_round(pipes, k)):
            want = hsv_detect_frame(bank[(k + i) % 4], (0, 1, 2),
                                    (0, 1, 2, 3), *params)
            if len(bufs) != 1 or not torch.equal(tensor(bufs[0]), want) \
                    or (k == 0 and not torch.equal(want, unbatched[i])):
                raise AssertionError(f"batched hsvdetector frame, round {k} "
                                     f"lane {i}, differs from the unbatched "
                                     f"element")
            frames_checked += 1
    fires0 = ctx.fire_count
    kern, _ = device_events(lambda: push_round(pipes, 4), 5)
    kernels_per_fire = len(kern) / (ctx.fire_count - fires0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sum(len(b) for k in range(DETECT_ROUNDS) for b in
              push_round(pipes, 10 + k))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for p in pipes:
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release(name)
    if got != 4 * DETECT_ROUNDS:
        raise AssertionError(f"the batched detector gave {got} frames")
    fps = got / dt
    frame = bank[0]
    prof = profile_calls(lambda: hsv_detect_frame(
        frame, (0, 1, 2), (0, 1, 2, 3), *params), 5)
    ms = time_ms(lambda: hsv_detect_frame(frame, (0, 1, 2), (0, 1, 2, 3),
                                          *params), flush)
    n_bytes = 2 * frame.numel()
    b_ms, b_by = bound(n_bytes, OPS_PER_SAMPLE["hsv_detect_frame"] * H * W,
                       F32_OPS_PER_S)
    res.update({"frames_checked": frames_checked, "fps": fps,
                "frames": got, "kernels_per_fire": kernels_per_fire,
                "hsv_detect_frame": {**prof, "ms": ms, "bound_ms": b_ms,
                                     "bound_by": b_by, "bytes": n_bytes}})
    log(f"[detector] 4 x `hsvdetector context=` at 4K RGBA, CUDA tensors: "
        f"{frames_checked} frames equal the unbatched element; {got} frames "
        f"in {dt * 1e3:.3f} ms: {fps:.2f} fps; {kernels_per_fire} kernels a "
        f"fire; hsv_detect_frame a 4K frame: {ms:.4f} ms, "
        f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms busy, "
        f"bound {b_ms:.4f} ms ({b_by})  [{smi}]")
    return res


def codec_frames(rng, n: int, w: int, h: int) -> list:
    """Natural-ish I420 frames: a gradient with texture and a moving box,
    smooth chroma with noise (flat uint8, made from the seeded rng)."""
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    base = 50 + 140 * gx / w + 40 * gy / h + 12 * np.sin(gx / 7.0) \
        * np.cos(gy / 11.0)
    cw, ch = -(-w // 2), -(-h // 2)
    out = []
    for i in range(n):
        y = base + 4 * rng.standard_normal((h, w))
        x0 = (37 * i) % max(1, w - h // 4)
        y[h // 4:h // 2, x0:x0 + h // 4] = 220 - 3 * i
        u = 128 + 40 * np.sin((gx[:ch, :cw] + 9 * i) / 50.0) \
            + 2 * rng.standard_normal((ch, cw))
        v = 120 + 30 * np.cos(gy[:ch, :cw] / 40.0) \
            + 2 * rng.standard_normal((ch, cw))
        out.append(np.concatenate([np.clip(a, 0, 255).astype(np.uint8)
                                   .ravel() for a in (y, u, v)]))
    return out


def i420_planes(flat: np.ndarray, w: int, h: int) -> list:
    cw, ch = -(-w // 2), -(-h // 2)
    return [flat[:w * h].reshape(h, w),
            flat[w * h:w * h + cw * ch].reshape(ch, cw),
            flat[w * h + cw * ch:].reshape(ch, cw)]


def run_ffv1enc(gstpu_torch, where, payloads, w: int, h: int) -> tuple:
    """`appsrc ! ffv1enc ! appsink` on `where`: the bitstream, the wall
    seconds and whether the native coder ran."""
    gstpu_torch.init(device=where)
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={w}, '
        f'height={h}, framerate=30/1" ! ffv1enc name=enc ! appsink '
        f'name=sink')
    src, enc = p.get_by_name("src"), p.get_by_name("enc")
    p.set_state(gstpu_torch.State.PLAYING)
    t0 = time.perf_counter()
    native = None
    for i, f in enumerate(payloads):
        src.push_buffer(gstpu_torch.Buffer(f, pts=i * 33_333_333))
        while p.iterate():
            pass
        native = enc._coder is not None and enc._model is None
    src.end_of_stream()
    p.run()
    dt = time.perf_counter() - t0
    out = [b.to_bytes() for b in p.get_by_name("sink").pull_all()]
    p.set_state(gstpu_torch.State.NULL)
    return out, dt, native


def ffv1_phase(gstpu_torch, dev, smi, flush) -> dict:
    """10b. FFV1 at 1080p I420: the residual fields of seeded frames on
    the card against the plain version on the CPU and the numpy spec
    model, with their time; then
    ffv1enc fed CUDA tensors and fed host frames, each stream byte for
    byte the CPU's, from the native coder; a small frame round-trips
    through the spec model's decoder."""
    from gstpu_torch.codecs import ffv1
    from gstpu_torch.ops.ffv1_pred import Predictor, to_numpy
    w, h = CODEC_W, CODEC_H
    rng = np.random.default_rng(SEED + 12)
    frames = codec_frames(rng, CODEC_FRAMES, w, h)
    quant = ffv1.Params(w, h).quant
    card, plain = Predictor(quant, dev), Predictor(quant, "cpu")
    for i, flat in enumerate(frames):
        flat_dev = torch.from_numpy(flat).to(dev)
        got = to_numpy(card.dispatch_diff_i420(flat_dev, w, h), np.int8)
        want = to_numpy(plain.dispatch_diff_i420(flat, w, h), np.int8)
        spec = np.concatenate([ffv1.predict_plane(q, quant)[1]
                               .astype(np.int8).ravel()
                               for q in i420_planes(flat, w, h)])
        if not (np.array_equal(got, want) and np.array_equal(got, spec)):
            raise AssertionError(f"FFV1 fields of frame {i} differ on the "
                                 f"card")
    y = i420_planes(frames[0], w, h)[0]
    ctx = card(y)[0]
    if not np.array_equal(ctx, ffv1.predict_plane(y, quant)[0]):
        raise AssertionError("FFV1 contexts differ on the card")
    log(f"[ffv1] {CODEC_FRAMES} frames {w}x{h} I420: the fields on the card "
        f"equal the CPU and predict_plane bit for bit; Y contexts too (max "
        f"{int(ctx.max())})")
    res = {"frames_checked": CODEC_FRAMES}
    flat_dev = torch.from_numpy(frames[0]).to(dev)
    n = flat_dev.numel()
    b_ms, b_by = bound(2 * n, OPS_PER_SAMPLE["ffv1_field"] * n,
                       I32_OPS_PER_S)

    def fields():
        return card.dispatch_diff_i420(flat_dev, w, h)

    prof = profile_calls(fields, 5)
    ms = time_ms(fields, flush)
    res["dispatch_diff_i420"] = {**prof, "ms": ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "bytes": 2 * n}
    log(f"[ffv1] dispatch_diff_i420 a 1080p frame: {ms:.4f} ms, "
        f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms "
        f"busy, bound {b_ms:.5f} ms ({b_by})  [{smi}]")

    dev_frames = [torch.from_numpy(f).to(dev) for f in frames]
    want, cpu_s, cpu_native = run_ffv1enc(gstpu_torch, "cpu", frames, w, h)
    runs = {"cuda tensors": run_ffv1enc(gstpu_torch, dev, dev_frames, w, h),
            "host frames": run_ffv1enc(gstpu_torch, dev, frames, w, h)}
    for how, (got, dt, native) in runs.items():
        log(f"[ffv1] ffv1enc on the card fed {how}: {len(got)} frames, "
            f"{sum(map(len, got))} bytes, {'equal to' if got == want else 'DIFFERENT FROM'} "
            f"the CPU's stream; {len(got) / dt:.2f} fps "
            f"(native coder: {native})")
        if got != want or len(got) != CODEC_FRAMES or not native:
            raise AssertionError(f"ffv1enc fed {how} differs from the CPU "
                                 f"or did not run the native coder")
        res[f"element_fps_{how.replace(' ', '_')}"] = len(got) / dt
    if not cpu_native:
        raise AssertionError("ffv1enc on the CPU did not run the native "
                             "coder")
    res["bytes_per_frame"] = sum(map(len, want)) / len(want)
    res["ratio"] = frames[0].size / res["bytes_per_frame"]
    # lossless: a small frame through the spec model's decoder
    sw, sh = 176, 144
    small = codec_frames(rng, 1, sw, sh)[0]
    pkt = run_ffv1enc(gstpu_torch, dev, [torch.from_numpy(small).to(dev)],
                      sw, sh)[0]
    back = ffv1.ModelDecoder(sw, sh).decode(pkt[0])
    if not np.array_equal(np.concatenate([q.ravel() for q in back]), small):
        raise AssertionError("the card's FFV1 stream does not decode to its "
                             "source")
    log(f"[ffv1] a {sw}x{sh} frame encoded on the card decodes through the "
        f"spec model's decoder to its source; 1080p stream "
        f"{res['bytes_per_frame']:.0f} B a frame ({res['ratio']:.3f}:1)")
    gstpu_torch.init(device=dev)
    return res


def av1_phase(gstpu_torch, dev, smi, flush) -> dict:
    """10c. The AV1 device legs at 1080p: make_intra_analyzer and
    make_intra_transform on the card against the CPU (the mode map and
    mode_counts bit for bit, the reconstruction's differing bytes
    counted, the bits proxy within 1e-3), their times against the
    bound; then `rav1enc device-transform=true ! dav1ddec` where the
    codec shim builds, its decoded planes equal to the card's
    reconstruction."""
    from gstpu_torch import native_codec
    from gstpu_torch.ops import av1_intra
    from gstpu_torch.ops.av1_intra import (make_intra_analyzer,
                                           make_intra_transform)
    w, h = CODEC_W, CODEC_H
    rng = np.random.default_rng(SEED + 13)
    frames = [i420_planes(f, w, h)
              for f in codec_frames(rng, CODEC_FRAMES, w, h)]
    qstep = np.float32(0.125 * 2.0 ** (min(63, AV1_QUANTIZER // 4) / 6.0))
    an_card, an_cpu = make_intra_analyzer(h, w, dev), \
        make_intra_analyzer(h, w, "cpu")
    xf_card, xf_cpu = make_intra_transform(h, w, dev), \
        make_intra_transform(h, w, "cpu")
    differ = worst = n_rec = 0
    bits_rel = curve_rel = 0.0
    counts = None
    for i, (y, u, v) in enumerate(frames):
        y_dev = torch.from_numpy(y).to(dev)
        modes = [av1_intra._predict(t.to(torch.float32))[2].cpu()
                 for t in (y_dev, torch.from_numpy(y))]
        curve, counts = (t.cpu() for t in an_card(y_dev))
        curve_c, counts_c = an_cpu(y)
        got = [t.cpu() for t in xf_card(y, u, v, qstep)]
        want = xf_cpu(y, u, v, qstep)
        if not torch.equal(modes[0], modes[1]) \
                or not torch.equal(counts, counts_c):
            raise AssertionError(f"AV1 modes of frame {i} differ on the card")
        for a, b in zip(got[:3], want[:3]):
            d = (a.to(torch.int32) - b.to(torch.int32)).abs()
            differ += int((d != 0).sum())
            worst = max(worst, int(d.max()))
            n_rec += d.numel()
        bits_rel = max(bits_rel, abs(float(got[3]) / float(want[3]) - 1))
        curve_rel = max(curve_rel, float((curve - curve_c).abs().max()
                                         / curve_c[0]))
    log(f"[av1] {CODEC_FRAMES} frames {w}x{h}: mode maps and mode_counts "
        f"equal the CPU (last {counts.tolist()}); reconstruction at qstep "
        f"{float(qstep):.4f}: {differ} of {n_rec} bytes differ (max "
        f"{worst}); transform bits within {bits_rel:.3e}, analyzer curve "
        f"within {curve_rel:.3e} of its finest step (gate 1e-3)")
    if differ > 0.03 * n_rec or worst > 2 or bits_rel > 1e-3 \
            or curve_rel > 1e-3:
        raise AssertionError("the AV1 transform on the card is too far from "
                             "the CPU")
    res = {"frames_checked": CODEC_FRAMES, "rec_bytes_differ": differ,
           "rec_bytes": n_rec, "rec_max_abs_diff": worst,
           "bits_max_rel_diff": bits_rel, "curve_max_rel_diff": curve_rel}
    y, u, v = (torch.from_numpy(p).to(dev) for p in frames[0])
    px = w * h
    for name, fn, n_bytes, n_px in (
            ("make_intra_analyzer", lambda: an_card(y), px + 16 * 4 + 12,
             px),
            ("make_intra_transform", lambda: xf_card(y, u, v, qstep),
             3 * px, 3 * px // 2)):
        prof = profile_calls(fn, 5)
        ms = time_ms(fn, flush)
        b_ms, b_by = bound(n_bytes, OPS_PER_SAMPLE[name] * n_px,
                           F32_OPS_PER_S)
        res[name] = {**prof, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": n_bytes}
        log(f"[av1] {name} a 1080p frame: {ms:.4f} ms, "
            f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms "
            f"busy, bound {b_ms:.5f} ms ({b_by})  [{smi}]")

    if native_codec.load() is None:
        log("[av1] rav1enc ! dav1ddec not run: the codec shim "
            "(native/gstpu_codec.cpp with libavcodec) does not build on "
            "this machine")
        res["element"] = "codec shim absent"
        return res
    gstpu_torch.init(device=dev)
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={w}, '
        f'height={h}, framerate=30/1" ! rav1enc device-transform=true '
        f'quantizer={AV1_QUANTIZER} ! dav1ddec ! appsink name=sink')
    src = p.get_by_name("src")
    p.set_state(gstpu_torch.State.PLAYING)
    t0 = time.perf_counter()
    for i, planes in enumerate(frames[:AV1_ELEMENT_FRAMES]):
        src.push_buffer(gstpu_torch.Buffer(
            np.concatenate([q.ravel() for q in planes]),
            pts=i * 33_333_333))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    dt = time.perf_counter() - t0
    out = p.get_by_name("sink").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    if len(out) != AV1_ELEMENT_FRAMES:
        raise AssertionError(f"rav1enc ! dav1ddec gave {len(out)} frames")
    for i, (b, planes) in enumerate(zip(out, frames)):
        rec = torch.cat([t.reshape(-1) for t in
                         xf_card(*planes, qstep)[:3]]).cpu().numpy()
        if not np.array_equal(np.frombuffer(b.to_bytes(), np.uint8), rec):
            raise AssertionError(f"decoded frame {i} differs from the "
                                 f"card's reconstruction")
    res["element"] = {"frames": len(out), "fps": len(out) / dt}
    log(f"[av1] rav1enc device-transform=true ! dav1ddec: {len(out)} 1080p "
        f"frames decode to the card's reconstruction byte for byte; "
        f"{len(out) / dt:.2f} fps")
    return res


def conv_flops(model, x) -> int:
    """The operations of every convolution of one forward on x: the sum
    of 2 * H_out * W_out * k^2 * C_in / groups * C_out."""
    total = [0]

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        total[0] += 2 * out.shape[-2] * out.shape[-1] * k \
            * (m.in_channels // m.groups) * m.out_channels * out.shape[0]
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def detections_key(dets) -> tuple:
    return len(dets), sorted(d.class_id for d in dets)


def analytics_phase(gstpu_torch, dev, smi, flush) -> dict:
    """11a. The analytics string `videotestsrc ! videoscale !
    yoloxinference ! yoloxtensordec ! appsink`, YOLOX-S at 640x640 with
    seeded parameters, through parse_launch on the card: each checked
    frame's forward within YOLOX_TOL of the output's peak of the port's
    CPU forward on the same frame, and the detections' count and classes
    equal at the element's threshold and at a threshold set in the widest
    gap of the scores; the forward's time, kernels, busy time and FLOP
    bound, the decode's host time, the string's fps, and the forward with
    TF32 allowed (not on the element's path)."""
    from gstpu_torch.elements.analytics.analytics import (
        AnalyticsRelationMeta, TensorMeta)
    from gstpu_torch.ops.detection import _sigmoid, yolox_decode
    from gstpu_torch.ops.yolox import build_model, forward, init_params
    launch = (f"videotestsrc num-buffers={YOLOX_CHECKED} pattern=gradient ! "
              f"video/x-raw,format=RGB,width={YOLOX_SRC_W},height="
              f"{YOLOX_SRC_H} ! videoscale ! video/x-raw,width={YOLOX_IN},"
              f"height={YOLOX_IN} ! yoloxinference name=inf model-size="
              f"{YOLOX_SIZE} num-classes={YOLOX_CLASSES} ! yoloxtensordec "
              f"num-classes={YOLOX_CLASSES} ! appsink name=out")
    out = run_pipeline(gstpu_torch, launch, dev)
    if len(out) != YOLOX_CHECKED:
        raise AssertionError(f"the analytics string gave {len(out)} frames")
    cpu_model = build_model(init_params(YOLOX_CLASSES, size=YOLOX_SIZE),
                            "cpu")
    n_anchors = sum((YOLOX_IN // s) ** 2 for s in (8, 16, 32))
    worst = peak = 0.0
    gap_checks = []
    for i, b in enumerate(out):
        frame = b.data
        pred = b.get_meta(TensorMeta).data
        if frame.device.type != "cuda" \
                or tuple(frame.shape) != (YOLOX_IN, YOLOX_IN, 3) \
                or pred.shape != (n_anchors, 5 + YOLOX_CLASSES) \
                or not np.isfinite(pred).all():
            raise AssertionError(f"analytics frame {i}: frame "
                                 f"{tuple(frame.shape)} on "
                                 f"{frame.device}, prediction {pred.shape}")
        x = frame.cpu().to(torch.float32) / torch.tensor(255.0)
        want = forward(cpu_model, x).numpy()
        worst = max(worst, float(np.abs(pred - want).max()))
        peak = max(peak, float(np.abs(want).max()))
        dets = b.get_meta(AnalyticsRelationMeta).detections
        if detections_key(dets) != detections_key(
                yolox_decode(want, YOLOX_IN, YOLOX_IN)):
            raise AssertionError(f"analytics frame {i}: detections differ "
                                 f"from the CPU's at the element's threshold")
        # a threshold in the widest gap of the CPU's top 2% of scores
        # that leaves at least 10 anchors above it, so NMS has work
        sc = np.sort((_sigmoid(want[:, 4])[:, None]
                      * _sigmoid(want[:, 5:])).max(1))[-n_anchors // 50:]
        k = int(np.argmax(np.diff(sc[:-9])))
        thr = float(sc[k] + sc[k + 1]) / 2
        got = yolox_decode(pred, YOLOX_IN, YOLOX_IN, score_threshold=thr)
        ref = yolox_decode(want, YOLOX_IN, YOLOX_IN, score_threshold=thr)
        gap_checks.append({"threshold": thr, "gap": float(sc[k + 1] - sc[k]),
                           "detections": len(ref)})
        if detections_key(got) != detections_key(ref) or not ref:
            raise AssertionError(f"analytics frame {i}: detections differ "
                                 f"from the CPU's at threshold {thr}")
    log(f"[analytics] YOLOX-{YOLOX_SIZE} {YOLOX_IN}x{YOLOX_IN} through "
        f"parse_launch on the card, {YOLOX_CHECKED} frames: forward max "
        f"|card - CPU| {worst:.3e} on outputs of peak {peak:.4e} (gate "
        f"{YOLOX_TOL:g} of the peak); detections equal at the element's "
        f"threshold 0.3 ({len(out[0].get_meta(AnalyticsRelationMeta).detections)}"
        f" on frame 0) and in the scores' widest gap {gap_checks}")
    if not worst <= YOLOX_TOL * peak:
        raise AssertionError("the YOLOX forward on the card is too far from "
                             "the CPU")
    res = {"frames_checked": YOLOX_CHECKED, "forward_max_abs_diff": worst,
           "forward_peak": peak, "tolerance_of_peak": YOLOX_TOL,
           "gap_checks": gap_checks}

    model = build_model(init_params(YOLOX_CLASSES, size=YOLOX_SIZE), dev)
    x = out[0].data.to(torch.float32) / torch.tensor(255.0, device=dev)
    flops = conv_flops(model, x.permute(2, 0, 1)[None].contiguous())
    n_params = sum(t.numel() for t in model.state_dict().values())
    n_bytes = 4 * (n_params + x.numel() + n_anchors * (5 + YOLOX_CLASSES))
    b_ms, b_by = bound(n_bytes, flops, F32_OPS_PER_S)
    prof = profile_calls(lambda: forward(model, x), 5)
    ms = time_ms(lambda: forward(model, x), flush)

    def forward_tf32():
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=False,
                allow_tf32=True):
            return model(x.permute(2, 0, 1)[None].contiguous())[0]
    tf32_ms = time_ms(forward_tf32, flush)
    tf32_diff = float((forward_tf32() - forward(model, x)).abs().max())
    pred = out[0].get_meta(TensorMeta).data
    decode = []
    for _ in range(7):
        t0 = time.perf_counter()
        yolox_decode(pred, YOLOX_IN, YOLOX_IN)
        decode.append(time.perf_counter() - t0)
    decode_ms = statistics.median(decode) * 1e3
    res["forward"] = {**prof, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "flops": flops, "bytes": n_bytes, "params": n_params}
    res["forward_tf32_ms"] = tf32_ms
    res["forward_tf32_max_abs_diff"] = tf32_diff
    res["decode_host_ms"] = decode_ms
    log(f"[analytics] yolox forward a frame: {ms:.4f} ms (CUDA events), "
        f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms busy, "
        f"bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} GFLOP of "
        f"convolutions, {n_params} parameters); yolox_decode on the host "
        f"{decode_ms:.3f} ms; not on the element's path: the forward with "
        f"TF32 allowed {tf32_ms:.4f} ms, max |diff| {tf32_diff:.3e}  [{smi}]")

    fps_launch = launch.replace(f"num-buffers={YOLOX_CHECKED}",
                                f"num-buffers={YOLOX_FPS_FRAMES}")
    t0 = time.perf_counter()
    n = len(run_pipeline(gstpu_torch, fps_launch, dev))
    dt = time.perf_counter() - t0
    if n != YOLOX_FPS_FRAMES:
        raise AssertionError(f"the analytics string gave {n} frames")
    res["fps"] = n / dt
    log(f"[analytics] the string, {n} frames: {n / dt:.2f} fps  [{smi}]")
    return res


def scale_phase(gstpu_torch, dev, smi, flush) -> dict:
    """11b. videoscale on the card against the CPU: a 4K RGBA frame to
    1920x1080 linear (an antialiased downscale) through `_resize`, a
    1080p I420 frame to 1280x720 and a 720p RGBA64BE frame (read in its
    byte order) to 640x360, nearest and linear, through the element;
    nearest bit for bit, linear within 1 LSB with the differing bytes
    counted; each one's time a frame against its bytes bound."""
    from gstpu_torch.elements.video.scale import _resize
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    big = smooth_frame(dev, gen)
    got = _resize(big, 1080, 1920, "linear").cpu()
    want = _resize(big.cpu(), 1080, 1920, "linear")
    res = {}

    def count(name, got, want, exact):
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        res[name] = {"bytes_differ": int((d != 0).sum()),
                     "bytes": d.numel(), "max_abs_diff": int(d.max())}
        log(f"[videoscale] {name}: {res[name]['bytes_differ']} of "
            f"{d.numel()} bytes differ from the CPU (max {int(d.max())})")
        if int(d.max()) > (0 if exact else 1):
            raise AssertionError(f"videoscale {name} on the card differs "
                                 f"from the CPU")

    count("4K RGBA -> 1920x1080 linear", got, want, False)
    rng = np.random.default_rng(SEED + 21)
    frame = codec_frames(rng, 1, CODEC_W, CODEC_H)[0]
    # 16-bit values around the u8 range, so byte order and clipping show
    deep = rng.integers(0, 320, (720, 1280, 4)).astype(">u2")
    for fmt, (w, h), (ow, oh), payload in (
            ("I420", (CODEC_W, CODEC_H), (1280, 720), frame),
            ("RGBA64BE", (1280, 720), (640, 360),
             deep.view(np.uint8).reshape(-1))):
        for method in ("nearest", "bilinear"):
            outs = []
            for where in (dev, "cpu"):
                gstpu_torch.init(device=where)
                p = gstpu_torch.parse_launch(
                    f'appsrc name=src caps="video/x-raw, format={fmt}, '
                    f'width={w}, height={h}, framerate=30/1" ! videoscale '
                    f'method={method} ! video/x-raw,width={ow},height={oh} '
                    f'! appsink name=sink')
                p.set_state(gstpu_torch.State.PLAYING)
                p.get_by_name("src").push_buffer(
                    gstpu_torch.Buffer(payload, pts=0))
                p.get_by_name("src").end_of_stream()
                p.run()
                outs.append(p.get_by_name("sink").pull_all()[0].data)
                p.set_state(gstpu_torch.State.NULL)
            n_out = ow * oh * 3 // 2 if fmt == "I420" else ow * oh * 8
            if outs[0].device.type != "cuda" or outs[0].numel() != n_out:
                raise AssertionError(f"videoscale {method} {fmt} gave "
                                     f"{outs[0].shape} on {outs[0].device}")
            if fmt == "RGBA64BE":
                # the values, not the bytes: the zero high bytes of the
                # widened u8 would dilute the count
                outs = [o.cpu().reshape(-1, 2)[:, 1] for o in outs]
            count(f"{h}p {fmt} -> {ow}x{oh} {method}", outs[0].cpu(),
                  outs[1], method == "nearest")
    gstpu_torch.init(device=dev)
    planes = [torch.from_numpy(q).to(dev)
              for q in i420_planes(frame, CODEC_W, CODEC_H)]

    def i420(m):
        return [_resize(q[..., None], h, w, m) for q, (h, w) in
                zip(planes, ((720, 1280), (360, 640), (360, 640)))]

    for name, fn, n_bytes in (
            ("4K RGBA linear", lambda: _resize(big, 1080, 1920, "linear"),
             big.numel() + 1920 * 1080 * 4),
            ("1080p I420 nearest", lambda: i420("nearest"),
             frame.size + 1280 * 720 * 3 // 2),
            ("1080p I420 linear", lambda: i420("linear"),
             frame.size + 1280 * 720 * 3 // 2)):
        prof = profile_calls(fn, 5)
        ms = time_ms(fn, flush)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        res[name] = {**prof, "ms": ms, "bound_ms": b_ms, "bound_by": "bytes",
                     "bytes": n_bytes}
        log(f"[videoscale] {name} a frame: {ms:.4f} ms, "
            f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms "
            f"busy, bytes bound {b_ms:.5f} ms  [{smi}]")
    return res


def run_compositor(gstpu_torch, where, layers, rounds: int):
    """compositor on `where`: the 2x2 multiview and the PiP from `layers`
    ((format, width, height, payload) each), `rounds` output frames from
    the same layers; the frames and the seconds."""
    from gstpu_torch.core.caps import parse_caps
    gstpu_torch.init(device=where)
    comp = gstpu_torch.make("compositor", width=COMP_W, height=COMP_H)
    out = []
    cap = gstpu_torch.Pad("cap", gstpu_torch.PadDirection.SINK,
                          gstpu_torch.PadTemplate(
                              "sink", gstpu_torch.PadDirection.SINK,
                              gstpu_torch.PadPresence.ALWAYS,
                              gstpu_torch.Caps.any()))
    cap.chain_function = lambda p, b: (out.append(b)
                                       or gstpu_torch.FlowReturn.OK)
    cap.event_function = lambda p, e: True
    comp.static_pad("src").link(cap)
    comp.set_state(gstpu_torch.State.PLAYING)
    feeders = []
    places = [(0, 0), (960, 0), (0, 540), (960, 540)]
    for i, (fmt, w, h, _) in enumerate(layers):
        pad = comp.request_pad()
        if i < 4:
            pad.xpos, pad.ypos = places[i]
            pad.width, pad.height, pad.alpha = 960, 540, COMP_ALPHAS[i]
        else:
            pad.xpos, pad.ypos, pad.alpha = (COMP_W - w) // 2, \
                (COMP_H - h) // 2, 0.5
        f = gstpu_torch.Pad(f"f{i}", gstpu_torch.PadDirection.SRC,
                            gstpu_torch.PadTemplate(
                                "src", gstpu_torch.PadDirection.SRC,
                                gstpu_torch.PadPresence.ALWAYS,
                                gstpu_torch.Caps.any()))
        f.link(pad)
        f.push_event(gstpu_torch.StreamStartEvent(f"s{i}"))
        f.push_event(gstpu_torch.CapsEvent(parse_caps(
            f"video/x-raw, format={fmt}, width={w}, height={h}, "
            f"framerate=30/1")))
        f.push_event(gstpu_torch.SegmentEvent(gstpu_torch.Segment()))
        feeders.append(f)
    t0 = time.perf_counter()
    for k in range(rounds):
        for f, (_, _, _, layer) in zip(feeders, layers):
            f.push(gstpu_torch.Buffer(layer, pts=k * 33_333_333))
    if where != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for f in feeders:
        f.push_event(gstpu_torch.EosEvent())
    comp.set_state(gstpu_torch.State.NULL)
    return out, dt


def compositor_phase(gstpu_torch, dev, smi, flush) -> dict:
    """11c. The compositor's 2x2 multiview with a picture-in-picture on a
    1920x1080 canvas, fed host frames and CUDA tensors, on the card
    against the CPU: `_blend` bit for bit, the resized layers' and the
    canvases' differing bytes counted; frames a second; `_blend`'s time
    for one quadrant against its bytes bound."""
    from gstpu_torch.elements.video.compositor import _blend
    from gstpu_torch.elements.video.scale import _resize
    rng = np.random.default_rng(SEED + 22)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    from gstpu_torch.core.video import VideoInfo
    from gstpu_torch.elements.video.convert import to_rgb_tensor
    layers = [("RGB", 1280, 720, np.ascontiguousarray(
        smooth_frame(dev, gen)[:720, :1280, :3].cpu().numpy()))
        for _ in range(4)]
    layers.append(("I420", 640, 360, codec_frames(rng, 1, 640, 360)[0]))
    on_card = [(f, w, h, torch.from_numpy(x).to(dev))
               for f, w, h, x in layers]
    want, _ = run_compositor(gstpu_torch, "cpu", layers, 1)
    got, _ = run_compositor(gstpu_torch, dev, layers, 1)
    got_t, _ = run_compositor(gstpu_torch, dev, on_card, 1)
    res = {}
    d = (got[0].data.cpu().to(torch.int32)
         - want[0].data.to(torch.int32)).abs()
    tensors_equal = torch.equal(got_t[0].data, got[0].data)
    # the layers' conversions to RGB, card against CPU, at 1080p
    convert_equal = True
    for fmt, x in (("I420", codec_frames(rng, 1, COMP_W, COMP_H)[0]),
                   ("GRAY8", rng.integers(0, 256, COMP_W * COMP_H,
                                          dtype=np.uint8))):
        info = VideoInfo(fmt, COMP_W, COMP_H)
        a = to_rgb_tensor(info, gstpu_torch.Buffer(torch.from_numpy(x)
                                                   .to(dev)), dev)
        b = to_rgb_tensor(info, gstpu_torch.Buffer(x), torch.device("cpu"))
        convert_equal = convert_equal and a.device.type == "cuda" \
            and torch.equal(a.cpu(), b)
    resized = 0
    for _, _, _, layer in layers[:4]:
        t = torch.from_numpy(layer)
        e = (_resize(t.to(dev), 540, 960, "linear").cpu().to(torch.int32)
             - _resize(t, 540, 960, "linear").to(torch.int32)).abs()
        resized += int((e != 0).sum())
        if int(e.max()) > 1:
            raise AssertionError("a resized layer differs by more than 1 "
                                 "on the card")
    # _blend alone, on the same canvas and layer on both sides
    canvas = torch.from_numpy(rng.integers(0, 256, (COMP_H, COMP_W, 3),
                                           dtype=np.uint8))
    layer = torch.from_numpy(rng.integers(0, 256, (540, 960, 4),
                                          dtype=np.uint8))
    blend_equal = all(torch.equal(
        _blend(canvas.to(dev), layer.to(dev), y0, x0, a).cpu(),
        _blend(canvas.clone(), layer, y0, x0, a))
        for (x0, y0), a in zip(((0, 0), (960, 0), (0, 540), (960, 540),
                                (640, 360)), COMP_ALPHAS + (0.5,)))
    # and a layer over the whole canvas (the FMA on the canvas's product)
    full = torch.from_numpy(rng.integers(0, 256, (COMP_H, COMP_W, 4),
                                         dtype=np.uint8))
    blend_equal = blend_equal and torch.equal(
        _blend(canvas.to(dev), full.to(dev), 0, 0, 0.6).cpu(),
        _blend(canvas.clone(), full, 0, 0, 0.6))
    res.update({"canvas_bytes_differ": int((d != 0).sum()),
                "canvas_max_abs_diff": int(d.max()),
                "resized_bytes_differ": resized,
                "resized_bytes": 4 * 540 * 960 * 3,
                "blend_bit_for_bit": blend_equal,
                "to_rgb_bit_for_bit": convert_equal,
                "tensors_equal_host_frames": tensors_equal})
    log(f"[compositor] 2x2 multiview + I420 PiP at {COMP_W}x{COMP_H}: _blend "
        f"on the card {'equals' if blend_equal else 'DIFFERS FROM'} the CPU "
        f"bit for bit, I420/GRAY8 to RGB "
        f"{'equal' if convert_equal else 'DIFFER'}; the four resized layers "
        f"differ in {resized} of {4 * 540 * 960 * 3} bytes, the canvas in "
        f"{res['canvas_bytes_differ']} of {d.numel()} (max {int(d.max())}); "
        f"fed CUDA tensors the canvas "
        f"{'equals' if tensors_equal else 'DIFFERS FROM'} the one fed host "
        f"frames")
    if not (blend_equal and convert_equal and tensors_equal) \
            or int(d.max()) > 1 or got_t[0].data.device.type != "cuda":
        raise AssertionError("the compositor on the card differs from the "
                             "CPU")
    canvas, layer = canvas.to(dev), layer.to(dev)

    def quadrant():
        return _blend(canvas, layer, 540, 960, COMP_ALPHAS[1])
    prof = profile_calls(quadrant, 5)
    ms = time_ms(quadrant, flush)
    # the region read and written, the layer read
    n_bytes = 540 * 960 * (3 + 4 + 3)
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res["_blend"] = {**prof, "ms": ms, "bound_ms": b_ms, "bound_by": "bytes",
                     "bytes": n_bytes}
    log(f"[compositor] _blend of a 960x540 RGBA layer: {ms:.4f} ms, "
        f"{prof['kernels_per_call']} kernels, {prof['busy_ms']:.4f} ms busy, "
        f"bytes bound {b_ms:.5f} ms  [{smi}]")
    for how, ls in (("host frames", layers), ("cuda tensors", on_card)):
        run_compositor(gstpu_torch, dev, ls, 2)
        frames, dt = run_compositor(gstpu_torch, dev, ls, COMP_ROUNDS)
        if len(frames) < COMP_ROUNDS:
            raise AssertionError(f"the compositor gave {len(frames)} frames")
        res[f"fps_{how.replace(' ', '_')}"] = COMP_ROUNDS / dt
        log(f"[compositor] fed {how}: {COMP_ROUNDS} frames in "
            f"{dt * 1e3:.3f} ms: {COMP_ROUNDS / dt:.2f} fps  [{smi}]")
    return res


def event_ms(fn, *args):
    """fn(*args) on the card: its CUDA-event ms and its result."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    result = fn(*args)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), result


def step_stats(name: str, ms: list, prof: dict, smi: str, n_bytes: float,
               ops: float, ops_per_s: float, tag: str = "mesh") -> dict:
    """A step's event ms a block (median), its profiler window and its
    bound: n_bytes over the memory rate or ops over ops_per_s."""
    b_ms, by = bound(n_bytes, ops, ops_per_s)
    res = {"ms": statistics.median(ms), **prof, "bound_ms": b_ms,
           "bound_by": by, "bytes": n_bytes, "ops": ops}
    log(f"[{tag}] {name}: {res['ms']:.4f} ms a block (events, median of "
        f"{len(ms)}), {prof['kernels_per_call']} kernels and "
        f"{prof['busy_ms']:.4f} ms busy a block; bound {b_ms:.5f} ms "
        f"({by})  [{smi}]")
    return res


def mesh_blocks(dev) -> list:
    """Phase 12's input: MESH_BLOCKS blocks of (MESH_LANES, MESH_BLOCK)
    f64 samples in [-0.3, 0.3), made on the card from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = (torch.rand((MESH_LANES, MESH_BLOCKS * MESH_BLOCK), generator=gen,
                    device=dev, dtype=torch.float64) - 0.5) * 0.6
    return list(x.split(MESH_BLOCK, dim=1))


def mesh_phase(gstpu_torch, dev, smi, tmp: Path) -> dict:
    """12a. gstpu_torch.parallel.streams on a one-rank NCCL group at the
    flagship's width, against the unsharded ops, and a checkpoint of the
    exact chain restored onto the mesh mid-stream."""
    import torch.distributed as dist

    from gstpu_torch.ops.echo import echo_block, make_state
    from gstpu_torch.parallel import streams
    from gstpu_torch.parallel.chains import make_audiofx_exact_chain
    from gstpu_torch.parallel.checkpoint import checkpoint, restore
    gstpu_torch.init(device="cuda")
    # the rank's card, as a launcher would select it before the mesh
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp / "nccl-store"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        mesh = streams.make_mesh(1, 1)
        res = {"mesh": str(mesh), "backend": dist.get_backend(),
               "lanes": MESH_LANES, "block": MESH_BLOCK,
               "blocks": MESH_BLOCKS}
        log(f"[mesh] {mesh} on {dist.get_backend()}: {MESH_LANES} lanes x "
            f"{MESH_BLOCKS} blocks of {MESH_BLOCK} f64 samples")
        blocks = mesh_blocks(dev)
        args = (AUDIO_INTENSITY, AUDIO_FEEDBACK)
        block_bytes = MESH_LANES * MESH_BLOCK * 8
        samples = MESH_LANES * MESH_BLOCK

        # the stream-sharded echo against echo_block, on the card and on
        # the CPU
        step, dims = streams.make_stream_sharded_echo(mesh, MESH_DELAY)
        rows = streams.shard_slice(MESH_LANES, mesh, dims)
        tail = make_state((rows.stop - rows.start,), MESH_DELAY, device=dev)
        tail_u = make_state((MESH_LANES,), MESH_DELAY, device=dev)
        tail_c = make_state((MESH_LANES,), MESH_DELAY, device="cpu")
        ms = []
        for blk in blocks:
            t, (tail, out) = event_ms(
                step, tail, streams.shard_rows(blk, mesh, dims), *args)
            ms.append(t)
            tail_u, want = echo_block(tail_u, blk, *args, delay=MESH_DELAY)
            tail_c, want_c = echo_block(tail_c, blk.cpu(), *args,
                                        delay=MESH_DELAY)
            if not torch.equal(out, want[rows]) \
                    or not torch.equal(out.cpu(), want_c[rows]):
                raise AssertionError("the stream-sharded echo differs from "
                                     "echo_block")
        # the block read and the output written, the delayed samples
        # read and the new ones written (the block is shorter than the
        # delay; audio_bounds' echo_block); two multiplies and two adds a
        # sample
        res["stream_echo"] = step_stats(
            "stream-sharded echo (equals echo_block on the card and the "
            "CPU, every block)", ms, profile_calls(
                lambda: step(tail, blocks[0][rows], *args), 5), smi,
            4 * block_bytes, 4 * samples, F64_OPS_PER_S)

        # the seq-sharded FIR echo against echo_block without feedback;
        # its output feeds the K-weighting
        fir = streams.make_seq_sharded_fir_echo(mesh, MESH_FIR_DELAY,
                                                MESH_BLOCK)
        rows = streams.shard_slice(MESH_LANES, mesh, ("stream",))
        f64 = dict(dtype=torch.float64, device=dev)
        tail = torch.zeros((rows.stop - rows.start, MESH_FIR_DELAY), **f64)
        tail_u = make_state((MESH_LANES,), MESH_FIR_DELAY, device=dev)
        ms, mids = [], []
        for blk in blocks:
            local = streams.shard_rows(streams.shard_rows(
                blk, mesh, ("stream",)), mesh, ("seq",), dim=1)
            t, (tail, mid) = event_ms(fir, tail, local, AUDIO_INTENSITY)
            ms.append(t)
            tail_u, want = echo_block(tail_u, blk, AUDIO_INTENSITY, 0.0,
                                      delay=MESH_FIR_DELAY)
            if not torch.equal(mid, want[rows]):
                raise AssertionError("the seq-sharded FIR echo differs from "
                                     "echo_block with feedback 0")
            mids.append(mid)
        # the block read, the output written, the carry read and written;
        # a multiply and an add a sample
        res["seq_fir_echo"] = step_stats(
            f"seq-sharded FIR echo, delay {MESH_FIR_DELAY} (equals "
            f"echo_block with feedback 0, every block)", ms, profile_calls(
                lambda: fir(tail, mids[0], AUDIO_INTENSITY), 5), smi,
            2 * block_bytes + 2 * MESH_LANES * MESH_FIR_DELAY * 8,
            2 * samples, F64_OPS_PER_S)

        # the seq-sharded K-weighting against kweight_unsharded, carried
        # over the blocks
        kw = streams.make_seq_sharded_kweight(mesh, RATE_192K, MESH_BLOCK)
        gold = streams.kweight_unsharded(RATE_192K)
        z = torch.zeros((rows.stop - rows.start, 2, 2), **f64)
        z_u = torch.zeros((MESH_LANES, 2, 2), **f64)
        ms, ms_u, err, peak = [], [], 0.0, 0.0
        for mid in mids:
            t, (z, y) = event_ms(kw, z, mid)
            ms.append(t)
            t, (z_u, y_u) = event_ms(gold, z_u, mid)
            ms_u.append(t)
            err = max(err, float((y - y_u[rows]).abs().max()))
            peak = max(peak, float(y_u.abs().max()))
        z_err = float((z - z_u[rows]).abs().max())
        log(f"[mesh] seq-sharded K-weighting against kweight_unsharded over "
            f"{MESH_BLOCKS} blocks: max |diff| {err:.4e} on outputs of peak "
            f"{peak:.4f}, the carried state {z_err:.4e} (bound "
            f"{KWEIGHT_TOL})")
        if not err < KWEIGHT_TOL or not z_err < KWEIGHT_TOL:
            raise AssertionError("the seq-sharded K-weighting is past its "
                                 "bound")
        # the block read and the output written; KWEIGHT_OPS a sample in
        # each of the two stages, the sharded form 4 more for the
        # incoming state's correction
        kw_bytes = 2 * block_bytes
        res["kweight"] = {
            "max_abs_diff": err, "state_max_abs_diff": z_err, "peak": peak,
            "sharded": step_stats(
                "seq-sharded K-weighting", ms,
                profile_calls(lambda: kw(z, mids[0]), 3), smi, kw_bytes,
                2 * (KWEIGHT_OPS + 4) * samples, F64_OPS_PER_S),
            "unsharded": step_stats(
                "kweight_unsharded", ms_u,
                profile_calls(lambda: gold(z_u, mids[0]), 3), smi, kw_bytes,
                2 * KWEIGHT_OPS * samples, F64_OPS_PER_S)}
        del blocks, mids

        # the exact chain's checkpoint restored onto the mesh mid-stream
        x0, bank = audio_banks(dev)
        prime, cstep, init, _, _ = make_audiofx_exact_chain(
            channels=AUDIO_CHANNELS, echo_delay=AUDIO_DELAY,
            max_delay=AUDIO_DELAY)
        st, _ = prime(init(AUDIO_STREAMS, device=dev), x0, *args)
        for k in range(MESH_RESUME):
            st, _, _ = cstep(st, bank[k], *args)
        ck = tmp / "exact.npz"
        t0 = time.perf_counter()
        checkpoint(str(ck), st, step=MESH_RESUME)
        ck_s = time.perf_counter() - t0
        want = []
        for k in range(MESH_RESUME, 2 * MESH_RESUME):
            st, out, meters = cstep(st, bank[k], *args)
            want.append((out, meters))
        rows = streams.shard_slice(AUDIO_STREAMS, mesh, ("stream",))
        t0 = time.perf_counter()
        rst, n = restore(str(ck), init(rows.stop - rows.start, device=dev),
                         mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ms = []
        for k, (w_out, w_m) in zip(range(MESH_RESUME, 2 * MESH_RESUME),
                                   want):
            t, (rst, out, meters) = event_ms(
                cstep, rst, streams.shard_rows(bank[k], mesh, ("stream",)),
                *args)
            ms.append(t)
            if n != MESH_RESUME or not torch.equal(out, w_out[rows]) or \
                    not all(torch.equal(meters[m], w_m[m][rows])
                            for m in w_m):
                raise AssertionError("the exact chain restored onto the mesh "
                                     "differs from the uninterrupted run")
        # the bytes of the step's main-path functions (audio_bounds)
        step_bytes = sum(
            v * (4 if k == "make_block_biquad" else 1) for k, (v, _) in
            audio_bounds(AUDIO_STREAMS, AUDIO_CHANNELS).items())
        res["exact_chain_resume"] = {
            "streams": AUDIO_STREAMS, "checkpoint_bytes": ck.stat().st_size,
            "checkpoint_s": ck_s, "restore_s": restore_s, **step_stats(
                "exact chain step after the restore", ms, profile_calls(
                    lambda: cstep(rst, bank[0], *args), 2), smi,
                step_bytes, 0, F64_OPS_PER_S)}
        log(f"[mesh] exact chain, {AUDIO_STREAMS} streams: checkpoint after "
            f"{MESH_RESUME} steps ({ck.stat().st_size} B, {ck_s:.3f} s), "
            f"restored onto the mesh ({restore_s:.3f} s): {MESH_RESUME} "
            f"steps on equal the uninterrupted run bit for bit, every lane")
        return res
    finally:
        dist.destroy_process_group()


def light_chain_phase(gstpu_torch, dev, smi, tmp: Path) -> dict:
    """12b. make_audiofx_chain at phase 12a's width on the card against
    the CPU, a mid-stream checkpoint and resume, its time and bound."""
    from gstpu_torch.ops.fftconv import next_pow2
    from gstpu_torch.parallel.chains import make_audiofx_chain
    from gstpu_torch.parallel.checkpoint import checkpoint, restore
    gstpu_torch.init(device="cuda")
    B, N = MESH_LANES, MESH_BLOCK
    step, init_state = make_audiofx_chain(RATE_192K, MESH_DELAY, MESH_DELAY,
                                          block=N)
    args = (AUDIO_INTENSITY, AUDIO_FEEDBACK, LIGHT_TARGET)
    blocks = mesh_blocks(dev)
    st = init_state(B)
    st_c = tuple(a.cpu() for a in st)
    half = MESH_BLOCKS // 2
    ck = tmp / "light.npz"
    ms, outs, err = [], [], {"out": 0.0, "loudness_db": 0.0, "gain": 0.0}
    for k, blk in enumerate(blocks):
        if k == half:
            checkpoint(str(ck), st, step=k)
        t, (st, out, loud) = event_ms(step, st, blk, *args)
        ms.append(t)
        outs.append(out)
        st_c, out_c, loud_c = step(st_c, blk.cpu(), *args)
        err["out"] = max(err["out"], float((out.cpu() - out_c).abs().max()))
        err["loudness_db"] = max(err["loudness_db"],
                                 float((loud.cpu() - loud_c).abs().max()))
        err["gain"] = max(err["gain"], float(
            ((st[2].cpu() - st_c[2]) / st_c[2]).abs().max()))
        if not torch.equal(st[0].cpu(), st_c[0]) \
                or not torch.equal(st[1].cpu(), st_c[1]):
            raise AssertionError("make_audiofx_chain's echo tail or FIR "
                                 "history differs between the card and "
                                 "the CPU")
    if not bool(torch.isfinite(torch.cat(outs)).all()):
        raise AssertionError("make_audiofx_chain's output is not finite")
    log(f"[chain] make_audiofx_chain, {B} lanes x {MESH_BLOCKS} blocks: the "
        f"card against the CPU: output {err['out']:.4e} (bound "
        f"{LIGHT_OUT_TOL}), loudness {err['loudness_db']:.4e} dB (bound "
        f"{LIGHT_LOUD_TOL_DB}), gain {err['gain']:.4e} relative (bound "
        f"{LIGHT_GAIN_RTOL}); echo tail and FIR history bit for bit")
    if not (err["out"] <= LIGHT_OUT_TOL
            and err["loudness_db"] <= LIGHT_LOUD_TOL_DB
            and err["gain"] <= LIGHT_GAIN_RTOL):
        raise AssertionError("make_audiofx_chain on the card is past its "
                             "bounds against the CPU")
    rst, n = restore(str(ck), init_state(B))
    for k in range(n, MESH_BLOCKS):
        rst, out, _ = step(rst, blocks[k], *args)
        if not torch.equal(out, outs[k]):
            raise AssertionError("make_audiofx_chain resumed from its "
                                 "checkpoint differs from the "
                                 "uninterrupted run")
    log(f"[chain] checkpoint at block {half}, restored: blocks {half}-"
        f"{MESH_BLOCKS - 1} equal the uninterrupted run bit for bit")
    # the echo's bytes as in 12a (block in and out, delayed samples read,
    # new ones written: f64), the FIR history and the gain read and
    # written, the loudness written (f32); the f32 work: the forward and
    # inverse real FFTs (5 n log2 n each) and the spectral product a
    # lane, and about 16 operations a sample around them (echo, square,
    # sum, gain, tanh)
    L1 = 510
    nfft = next_pow2(N + L1)
    n_bytes = 4 * B * N * 8 + 2 * B * L1 * 4 + 2 * B * 4 + B * 4
    ops = B * (2 * 5 * nfft * int(np.log2(nfft)) + 6 * (nfft // 2 + 1)
               + 16 * N)
    res = {"max_abs_err": err, **step_stats(
        "make_audiofx_chain step", ms,
        profile_calls(lambda: step(st, blocks[0], *args), 5), smi, n_bytes,
        ops, F32_OPS_PER_S, "chain")}
    res["realtime_lanes"] = B * 0.1 / (res["ms"] / 1e3)
    log(f"[chain] make_audiofx_chain by events: {res['realtime_lanes']:.2f}"
        f"x realtime over the {B} lanes  [{smi}]")
    return res


def trace_phase(gstpu_torch, dev, smi, tmp: Path, kernels) -> dict:
    """12c. The 4K `hsvfilter ! queue ! colorlut` string under the
    torch-profiler tracer, two pipelines each driven by a streaming
    thread of its own: the Chrome trace holds pad_push spans from both
    threads, and every launch of both kernels inside one."""
    from gstpu_torch.utils.tracing import TorchProfilerTracer
    gstpu_torch.init(device="cuda")
    cube = tmp / "trace.cube"
    write_cube(cube, np.random.default_rng(SEED))
    launch = (f"videotestsrc num-buffers={TRACE_FRAMES} ! video/x-raw, "
              f"format=RGBA, width={W}, height={H}, framerate=30/1 ! "
              f"hsvfilter hue_shift=12 saturation_mul=1.1 value_mul=0.9 "
              f"value_off=0.02 ! queue ! colorlut location={cube} ! "
              f"appsink name=out")
    plain = run_pipeline(gstpu_torch, launch.replace(
        f"num-buffers={TRACE_FRAMES}", "num-buffers=1"), "cpu")[0].data
    gstpu_torch.init(device="cuda")
    for k in kernels:
        k.launches = 0
    tracer = TorchProfilerTracer(logdir=str(tmp / "trace"))
    tracer.install()
    try:
        pipes = [gstpu_torch.parse_launch(launch) for _ in range(2)]
        for p in pipes:
            p.set_state(gstpu_torch.State.PLAYING)
        t0 = time.monotonic()
        threads = [p.run_async() for p in pipes]
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("a traced pipeline did not end")
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
    finally:
        tracer.flush()
        tracer.uninstall()
    launches = {k.name: k.launches for k in kernels}
    for p in pipes:
        frames = p.get_by_name("out").pull_all()
        p.set_state(gstpu_torch.State.NULL)
        if len(frames) != TRACE_FRAMES or any(
                f.data.device.type != "cuda"
                or not torch.equal(f.data.cpu(), plain) for f in frames):
            raise AssertionError("a traced pipeline's frames differ from "
                                 "the plain chain")
    with open(tracer.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("pad_push:")]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    span_tids = sorted({str(e["tid"]) for e in spans})

    def inside(k) -> bool:
        rt = runtime.get(k["args"].get("correlation"))
        return rt is not None and any(
            s["tid"] == rt["tid"] and s["ts"] <= rt["ts"]
            and rt["ts"] + rt["dur"] <= s["ts"] + s["dur"] for s in spans)

    res = {"trace_bytes": os.path.getsize(tracer.trace_path),
           "span_threads": len(span_tids), "spans": len(spans),
           "frames_per_s": 2 * TRACE_FRAMES / dt, "kernels": {}}
    for k in kernels:
        fn = MAIN_FUNCTION[k.name].split("<")[0]
        evs = [e for e in events if e.get("cat") == "kernel"
               and fn in e.get("name", "")]
        n_in = sum(map(inside, evs))
        res["kernels"][k.name] = {
            "launches": launches[k.name], "in_trace": len(evs),
            "inside_pad_push": n_in,
            "device_ms": sum(e["dur"] for e in evs) / 1e3}
        log(f"[trace] {k.name}: {launches[k.name]} launches, {len(evs)} "
            f"`{fn}` kernels in the trace, {n_in} launched inside a "
            f"pad_push span, {res['kernels'][k.name]['device_ms']:.4f} ms "
            f"of device time summed  [{smi}]")
        if not (launches[k.name] == len(evs) == n_in == 2 * TRACE_FRAMES) \
                or not all(e["dur"] > 0 for e in evs):
            raise AssertionError(f"the trace does not hold every {k.name} "
                                 f"launch inside a pad_push span")
    log(f"[trace] {len(spans)} pad_push spans from {len(span_tids)} "
        f"threads, {res['trace_bytes']} B of Chrome trace; 2 x "
        f"{TRACE_FRAMES} 4K frames at {res['frames_per_s']:.2f} fps traced")
    if len(span_tids) < 2:
        raise AssertionError("the trace lacks a streaming thread's "
                             "pad_push spans")
    return res


def main() -> int:
    if sys.argv[1:2] == ["--sass"]:
        for d in sys.argv[2:]:
            log_sass(sorted(Path(d).glob("*.so")))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import gstpu_torch
    from gstpu_torch.kernels import build_all, stream_handle
    from gstpu_torch.ops.hsv import (_INV_255, HSV_KERNEL, hsv_filter_frame,
                                     hsv_filter_frame_ref)
    from gstpu_torch.ops.lut import (LUT_KERNEL, apply_lut_3d,
                                     apply_lut_3d_packed_ref,
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
    sass = log_sass([k.library_path for k in kernels])

    # 2. kernels against their plain versions
    err = {k.name: 0 for k in kernels}
    for layout, rgb_idx in LAYOUTS.items():
        cube = colour_cube(layout, dev)
        cube_cpu = cube.cpu()
        for params in HSV_PARAMS:
            got = hsv_filter_frame(cube, rgb_idx, *params)
            want = hsv_filter_frame_ref(cube_cpu, rgb_idx, *params)
            e = max_abs_err(got, want)
            inplace = cube.clone()
            hsv_filter_frame(inplace, rgb_idx, *params, out=inplace)
            same = torch.equal(inplace, got)
            log(f"[check] hsv_filter_u8 {layout} {params}: max |err| {e}, "
                f"in place {'equal' if same else 'DIFFERS'}")
            if e != 0 or not same:
                raise AssertionError("hsv_filter_u8 differs from its "
                                     "plain version")
    torch.cuda.synchronize()

    # odd sizes, and frames one pixel off 16 bytes: in place, out of
    # place into a buffer as skewed as the frame (the wrapper's) and
    # into an aligned one
    odd_rng = np.random.default_rng(SEED + 1)
    for layout in ("RGBA", "RGB"):
        host = odd_rng.integers(0, 256, (ODD_H, ODD_W, len(layout)),
                                dtype=np.uint8)
        for skew in (0, 1):
            for params in (HSV_PARAMS[1], HSV_PARAMS[6]):
                want = hsv_filter_frame_ref(torch.from_numpy(host),
                                            LAYOUTS[layout], *params)
                frame = skewed(host, skew, dev)
                outs = {"out of place": hsv_filter_frame(
                    frame, LAYOUTS[layout], *params)}
                aligned = torch.empty(host.shape, dtype=torch.uint8,
                                      device=dev)
                outs["into an aligned buffer"] = hsv_filter_frame(
                    frame, LAYOUTS[layout], *params, out=aligned)
                outs["in place"] = hsv_filter_frame(
                    frame, LAYOUTS[layout], *params, out=frame)
                for how, got in outs.items():
                    e = max_abs_err(got, want)
                    log(f"[check] hsv_filter_u8 {layout} {ODD_W}x{ODD_H} "
                        f"skew {skew} px, {how}, hue_shift {params[0]}: "
                        f"max |err| {e}")
                    if e != 0:
                        raise AssertionError("hsv_filter_u8 differs on an "
                                             "odd or unaligned frame")

    # the kernel's division against IEEE division on every pair it can
    # form: numerators x_i - x_j, denominators a chroma, a value or 1,
    # with x_k = k * f32(1 / 255)
    x = torch.arange(256, dtype=torch.float32, device=dev) * _INV_255
    num = (x[:, None] - x[None, :]).reshape(-1).contiguous()
    den = torch.cat([num[num > 0], x[x > 0],
                     torch.ones(1, device=dev)]).unique().contiguous()
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = HSV_KERNEL.load().hsv_div_rn_mismatches(
        num.data_ptr(), num.numel(), den.data_ptr(), den.numel(),
        bad.data_ptr(), stream_handle(dev))
    torch.cuda.synchronize()
    log(f"[check] hsv_filter_u8 division: {num.numel()} x {den.numel()} "
        f"operand pairs, {int(bad.item())} differ from IEEE division")
    if rc != 0 or int(bad.item()) != 0:
        raise AssertionError("hsv_filter_u8's division differs from IEEE "
                             "division")

    rng = np.random.default_rng(SEED)
    table_np = seeded_table(rng)
    lut_dev = lut_from_numpy(table_np, *LUT_DOMAIN, dev)
    lut_cpu = lut_from_numpy(table_np, *LUT_DOMAIN, "cpu")
    cube = colour_cube("RGBA", dev)
    got = apply_lut_3d(cube, lut_dev.table, *LUT_DOMAIN,
                       packed=lut_dev.packed)
    want = apply_lut_3d_ref(cube.cpu(), lut_cpu.table, *LUT_DOMAIN)
    errs = [check_lut("u8 colour cube, 33^3", got, want, 255)]
    emulated = apply_lut_3d_packed_ref(cube, lut_dev.packed, *LUT_DOMAIN)
    errs.append(check_lut("u8 colour cube against the packed-table "
                          "emulation on the card", got, emulated, 255))
    deep_np = rng.integers(0, 65536, (H, W, 4), dtype=np.uint16)
    deep = torch.from_numpy(deep_np).to(dev)
    got = apply_lut_3d(deep, lut_dev.table, *LUT_DOMAIN, max_val=65535,
                       packed=lut_dev.packed)
    want = apply_lut_3d_ref(torch.from_numpy(deep_np), lut_cpu.table,
                            *LUT_DOMAIN, max_val=65535)
    errs.append(check_lut("u16 4K RGBA64", got, want, 65535))
    emulated = apply_lut_3d_packed_ref(torch.from_numpy(deep_np),
                                       lut_cpu.packed, *LUT_DOMAIN,
                                       max_val=65535)
    errs.append(check_lut("u16 4K RGBA64 against the packed-table "
                          "emulation", got, emulated, 65535))
    for dtype, max_val, C in ((np.uint8, 255, 4), (np.uint16, 65535, 4),
                              (np.uint8, 255, 3), (np.uint16, 65535, 3)):
        host = odd_rng.integers(0, max_val + 1, (ODD_H, ODD_W, C),
                                dtype=dtype)
        want = apply_lut_3d_ref(torch.from_numpy(host), lut_cpu.table,
                                *LUT_DOMAIN, max_val=max_val)
        for skew in (0, 1):
            got = apply_lut_3d(skewed(host, skew, dev), lut_dev.table,
                               *LUT_DOMAIN, max_val=max_val,
                               packed=lut_dev.packed)
            errs.append(check_lut(
                f"{np.dtype(dtype).name} C={C} {ODD_W}x{ODD_H} skew "
                f"{skew} px", got, want, max_val))
    err["lut3d_trilinear"] = max(errs)
    del cube, deep, got, want, emulated

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

    # 5. timings per 4K frame, on a uniform random frame (the LUT's
    # worst case: its gathers spread over the whole table) and on a
    # smooth one
    frames = {"random": bank[0], "smooth": smooth_frame(dev, gen)}
    table, packed = lut_dev.table, lut_dev.packed
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    hsv_args = ((0, 1, 2), *HSV_PARAMS[0])
    frame = frames["random"]
    xyz = (frame[..., :3].float() / 255.0 * torch.from_numpy(
        LUT_DOMAIN[0]).to(dev) + torch.from_numpy(LUT_DOMAIN[1]).to(dev)
           ).clamp(0.0, 1.0)
    grid = (xyz * 2.0 - 1.0).reshape(1, 1, H, W, 3).contiguous()
    volume = table.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    frame_bytes = frame.numel() * frame.element_size()
    rows = []
    for k, fn, plain_fn, library_fn, extra_bytes in (
            (HSV_KERNEL,
             lambda f: hsv_filter_frame(f, *hsv_args),
             lambda f: hsv_filter_frame_ref(f, *hsv_args),
             None, 0),
            (LUT_KERNEL,
             lambda f: apply_lut_3d(f, table, *LUT_DOMAIN, packed=packed),
             lambda f: apply_lut_3d_ref(f, table, *LUT_DOMAIN),
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
            "ms": time_ms(lambda: fn(frame), flush),
            "ms_smooth": time_ms(lambda: fn(frames["smooth"]), flush),
            "plain_ms": time_ms(lambda: plain_fn(frame), flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(library_fn, flush) if library_fn else None,
            "bytes_moved": moved,
        }
        # the function this frame runs: RGBA8 (and |hue_shift| <= 360)
        fn_name, row["sass"] = next(
            (f, c) for f, c in sass.items()
            if f.startswith(f"{k.library_path.name}:{MAIN_FUNCTION[k.name]}"))
        row["sass_function"] = fn_name.split(":", 1)[1]
        if k is HSV_KERNEL:
            row["also_replaces"] = "gstpu/ops/hsv_pallas.py:63"
        log(f"[time] {k.name} per 4K frame: {row['ms']:.4f} ms random, "
            f"{row['ms_smooth']:.4f} ms smooth, "
            f"{row['sass']['per_pixel']} SASS instructions a pixel, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {moved} B), library "
            f"{row['library_ms']} ms  [{smi}]")
        rows.append(row)

    # 6. the audio flagship chain
    t6 = time.monotonic()
    x0, audio_bank = audio_banks(dev)
    audio = audio_phase(gstpu_torch, dev, smi, x0, audio_bank)

    # 7. the element form through DeviceContext: the audio chain as 96
    # parse_launch pipelines, the 4K chain batched through both kernels
    t7 = time.monotonic()
    element = {"audio": element_audio_phase(gstpu_torch, dev, smi, x0,
                                            audio_bank, audio)}
    del x0, audio_bank
    element["video"] = element_video_phase(gstpu_torch, dev, smi, lut_dev,
                                           bank, kernels, hsv)
    element["phase_s"] = {"6": t7 - t6, "7": time.monotonic() - t7}
    for row in rows:
        row["launches_context"] = element["video"]["launches"][row["name"]]

    # 8. audiornnoise at full width; 9. the binaural render
    t8 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        rnnoise = rnnoise_phase(gstpu_torch, dev, smi, Path(tmp))
        t9 = time.monotonic()
        binaural = binaural_phase(gstpu_torch, dev, smi, Path(tmp))
    # 10. hsvdetector and the codec device legs
    t10 = time.monotonic()
    detector = detector_phase(gstpu_torch, dev, smi, bank, flush)
    codec = {"ffv1": ffv1_phase(gstpu_torch, dev, smi, flush),
             "av1": av1_phase(gstpu_torch, dev, smi, flush)}
    # 11. the analytics path, videoscale and the compositor
    t11 = time.monotonic()
    analytics = {"yolox": analytics_phase(gstpu_torch, dev, smi, flush),
                 "videoscale": scale_phase(gstpu_torch, dev, smi, flush),
                 "compositor": compositor_phase(gstpu_torch, dev, smi,
                                                flush)}
    # 12. the mesh on the card, make_audiofx_chain, the profiler tracer
    t12 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        parallel = {"mesh": mesh_phase(gstpu_torch, dev, smi, Path(tmp)),
                    "chain": light_chain_phase(gstpu_torch, dev, smi,
                                               Path(tmp)),
                    "trace": trace_phase(gstpu_torch, dev, smi, Path(tmp),
                                         kernels)}
    for row in rows:
        row["launches_traced"] = \
            parallel["trace"]["kernels"][row["name"]]["launches"]
    element["phase_s"].update({"8": t9 - t8, "9": t10 - t9, "10": t11 - t10,
                               "11": t12 - t11,
                               "12": time.monotonic() - t12})
    log("[time] " + ", ".join(f"phase {k} {v:.1f} s"
                              for k, v in element["phase_s"].items()))

    log(json.dumps({"audio": audio}))
    log(json.dumps({"element": element}))
    log(json.dumps({"rnnoise": rnnoise}))
    log(json.dumps({"binaural": binaural}))
    log(json.dumps({"hsvdetector": detector}))
    log(json.dumps({"codec": codec}))
    log(json.dumps({"analytics": analytics}))
    log(json.dumps({"parallel": parallel}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
