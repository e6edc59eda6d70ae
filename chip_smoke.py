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
   kernels inside one, with their device time;
13. runs the host edge, files through the device chains into files: (a)
   a seeded 4 s 48 kHz S16 stereo FLAC file (the port's encode_verbatim)
   through `filesrc ! claxondec ! audioconvert ! F64LE ! audioresample !
   192 kHz ! rsaudioecho ! audioloudnorm ! ebur128level ! isomp4mux !
   filesink` with the flagship's settings on the card, under a pad-push
   tracer and the profiler: the echo's output a CUDA tensor, the host ms
   per second of audio for the decode, with the convert, with the
   resampler and for the whole string, the device's busy ms, the host ms
   of one download of a chain buffer; then the same string on the CPU:
   every box but mdat byte for byte, mdat's F64 samples within 1e-12, 4 n
   - 35 samples for n input frames; (b) BASELINE config 4's 1080p RGBA
   through `videotestsrc ! hsvfilter ! colorlut ! isomp4mux ! filesink`
   (a seeded 33^3 LUT, phase 3's settings), 16 frames with the kernels'
   counts set to 0 just before: 16 launches of each, the file byte for
   byte the CPU's through the plain versions, an RGBA uncC sample entry,
   fps beside the same string into fakesink; (c) `rsflvdemux` on an FLV
   from the port's FlvWriter, `mpegtsmux ! filesink` on seeded H.264
   access units and 13a's output through `isofmp4mux ! filesink`, each
   byte for byte between the card's default device and the CPU;
14. runs the host codecs and images behind the card's chains, after
   checking that the C++ G.711 library builds and loads (a gate) and
   whether PIL imports and the codec shim builds (what either stops is
   named on a line, not run): (a) 13b's grade on 8 frames of 1080p RGBA
   `videotestsrc pattern=snow ! hsvfilter ! colorlut ! colordetect ! tee`
   into `videoconvert ! I420 ! roundedcorners border-radius-px=64 !
   appsink`, `viuersink width=160 file=...` and `rspngenc ! filesink`
   under the pad-push tracer: each kernel once a frame, the A420 frames,
   the terminal text, the PNG file and the colordetect messages equal to
   the CPU run's, fps and each element's host ms a frame; then
   `videocompare` fed the card's graded frames and the CPU's posts
   distance 0 for every frame; (b) the flagship's settings on 4 s of
   192 kHz F64 stereo (the echo's output a CUDA tensor) `! audioloudnorm
   ! rsagingradio ! audioconvert ! S16LE ! alawenc ! alawdec ! mulawenc !
   mulawdec ! filesink`, and a 1 s telephony leg resampled to 8 kHz mono
   before `alawenc`: each file the CPU's (else its differing codes
   counted), the F64 samples before `audioconvert` within 1e-12, host ms
   per second of audio by stage; (c) a seeded 2 s CD+G file through
   `cdgparse ! cdgdec ! queue ! videoconvert ! RGBA ! hsvfilter !
   colorlut`: each kernel once a frame, every frame the CPU's; (d) where
   the codec shim builds, VP8, VP9 and Opus behind the chains, byte for
   byte the CPU's.
15. runs captions on the card's 1080p grade and the PIL image elements
   behind it: (a) BASELINE config 4's 1080p RGBA, 16 frames, through
   13b's grade into `cccombiner`, its caption pad fed by `appsrc !
   tttocea608`, then `cea608overlay ! appsink`; into `cccombiner` fed
   `tttocea708 ! cea708mux` CDP, then `cea708overlay`; and into
   `st2038combiner` fed that CDP through `cctost2038anc`, then
   `st2038extractor`, its anc pad into `st2038anctocc ! appsink`: every
   output's bytes, times and metas and the element messages equal the
   CPU run's, each kernel once a frame, the combiners calling
   `Buffer.array` on no frame and the overlays once on each frame whose
   caption metas put a caption on it (those frames go on as host arrays,
   the others as CUDA tensors), fps and each element's host ms a frame
   under the pad-push tracer; (b) the graded frames through `rspngenc !
   imagedecoder`, `gifenc ! gifdec` and `imageoverlay`, and a graded
   frame written as a lossless WebP through `filesrc ! image/webp !
   rswebpdec` (named, not run, where PIL lacks WebP), each byte for byte
   the CPU's.
16. runs the plumbing, supervisors and host consumers of Queue D item 3
   around the card's grade: (a) bench_video.py's 4K RGBA, 16 frames,
   through the grade into `intersink`, read by a second pipeline's
   `intersrc` on its own thread, into `ts-blocking-adapter ! ts-queue`,
   and between `originalbuffersave` and `originalbufferrestore` (fed
   videotestsrc's host frames, and those frames on the card): every frame
   out of a bridge the direct string's bit for bit on the card, the
   restored frames the source's where they came in, no `Buffer.array`
   call by a new element, each kernel once a frame, fps, host ms a frame
   by element, and the device ms of the save's clone of a 4K frame beside
   its bytes bound; (b) the 4K grade stepped into `fallbackswitch
   timeout=1s` (a feeder pad of solid blue host frames on its second pad,
   2 s without a main frame) and into `togglerecord` (a GOP of 4, record
   toggled three times) under a TestClock: outputs (source, pts, flags)
   and messages equal to the same sequence at 64x48 on the CPU, the main
   frames leaving as the CUDA tensors that came in, no read; (c)
   BASELINE config 4's 1080p, 8 frames, through the grade into
   `flatecompress`, `brotlicompress quality=5` and `sodiumencrypter`
   (fixed keys and nonce), each teed into its decoder: the encoded
   stream byte for byte what the encoder writes fed the same frames as
   host arrays through appsrc, the round trip exact, one `Buffer.array`
   call a frame by the encoder and none by the decoder (a string whose
   library is missing is named, not run); (d) `python -m
   gstpu_torch.tools.launch` on 4 frames of the 4K chain with no
   --device exits 0, and non-zero with core/device.py's error when
   CUDA_VISIBLE_DEVICES hides the card; `python -m
   gstpu_torch.tools.inspect intersrc` exits 0.
17. runs the RTP stack, UDP, TCP and ONVIF metadata of Queue D item 4
   between the card's chains and the network, all on 127.0.0.1: (a) 1 s
   of the flagship's 192 kHz stereo (the echo's output a CUDA tensor)
   `! audioloudnorm`, 14b's telephony conversion to 8 kHz S16 mono,
   `alawenc ! rtppcmapay2 mtu=172 ! rtpsend ! raptorqenc ! udpsink`, a
   probe dropping seeded source packets (at most the repair packets of a
   block) before the socket, received by `udpsrc ! raptorqdec ! rtprecv
   latency=0 ! rtppcmadepay2 ! alawdec ! appsink`: the native recvmmsg
   path received every datagram, every source packet comes out of
   raptorqdec, the RTP payloads are what alawenc wrote and the samples
   the CPU run's bit for bit; (b) BASELINE config 4's 1080p grade, 4
   frames, `! rtpvrawpay2 mtu=1400 ! udpsink` into `udpsrc !
   rtpvrawdepay2 ! appsink`, the receiver driven from a probe on udpsink
   every 32 datagrams: each frame the direct string's byte for byte, 0
   packets lost by sequence number, one `Buffer.array` call a frame by
   the payloader and none by any other element, each kernel once a frame;
   (c) the grade on 8 frames into `onvifmetadatacombiner`, seeded ONVIF
   boxes on frames 1 and 5 through `onvifmetadatapay ! onvifmetadatadepay
   ! onvifmetadataparse` into its meta pad, then `onvifmetadataoverlay`:
   frames and metas equal to the same elements fed the direct string's
   frames as host arrays, one read on each boxed frame and none
   elsewhere, the other frames the CUDA tensors that went in; (d) the
   grade on 4 frames into `tcpserversink`, read by `tcpclientsrc` in a
   receiving pipeline on its own thread: the bytes the direct string's,
   one read a frame. fps, packets a frame and losses, and host ms a frame
   (or a second of audio) by element under the pad-push tracer.
   `rtspsrc2`, `mpegtslivesrc` and `rtpgccbwe` are named, not run.
18. runs the HLS/DASH sinks, the HTTP source and QUIC of Queue D item 5
   between the card's chains and their audience, all on 127.0.0.1: (a)
   BASELINE config 4's 1080p grade, 4 frames, `! cmafmux` in 2-frame
   fragments teed into `hlscmafsink`, `dashsink2` and the video variant
   of an `hlsmultivariantsink`, 1 s of the flagship's 192 kHz F64
   stereo through a second `cmafmux` into its audio rendition, and 15a's
   caption texts as CEA-608 through `cea608tojson ! jsontovtt !
   hlswebvttsink`: every playlist, MPD, init and media segment byte for
   byte the CPU run's (the audio segments' boxes but mdat byte for byte,
   their samples within 1e-12), one `Buffer.array` call a frame by the
   video cmafmux (two on the first, which gstpu's cmafmux keeps) and
   none by a sink, each kernel once a frame; (b) 13a's
   FLAC served by an in-process HTTP server through `reqwesthttpsrc`
   into 13a's string on the card: the MP4 byte for byte 13a's filesrc
   MP4, host ms per second of audio by element and of each source alone;
   `fallbacksrc` with an http uri and `uriplaylistbin` with an http and
   a file item into the flagship, the samples within 1e-12 of the CPU
   run's; (c) where `cryptography` imports: the grade, 2 frames, as RFC
   4175 RTP at mtu 1200 through `quinnroqmux ! quinnquicsink
   use-datagram=true` into `quinnquicsrc ! quinnroqdemux !
   rtpvrawdepay2` (0 RTP packets lost, the frames the CPU run's), 1 s
   of 17a's telephony RTP and 1 graded frame's RTP on two QUIC streams
   through `quinnquicmux ! quinnquicsink` into `quinnquicsrc !
   quinnquicdemux` (each stream what its payloader sent, and the CPU
   run's), and the telephony RTP through `quinnwtserversink` into
   `quinnwtclientsrc ! rtppcmadepay2 ! alawdec` (the samples the CPU
   run's); a probe on the QUIC sink connects both ends, drives the
   receiver every 32 buffers and, at EOS, until every packet is acked.
   QUIC packets a frame, losses and probes, fps and host ms by element.
   `icecastsink` is named, not run.
19. runs the WebRTC elements of Queue D item 6 between the card's chains
   and their peers, all on 127.0.0.1 (webrtc_phase says what each leg
   holds against the CPU run): (a) the telephony leg in a live
   `webrtcsink`/`webrtcsrc` session over the sink's own signalling
   server; (b) the 1080p grade over SRTP keyed by a DTLS handshake; (c)
   the telephony RTP through WHIP and WHEP; (d) the grade into
   webrtcsink's encoder chain, only where the codec shim links.
20. runs the cloud and model elements of Queue D items 7-8 behind the
   card's chains, all on 127.0.0.1: (a) 5.5 s of the flagship through
   `audioconvert ! audioresample` to 44.1 kHz F32 into `demucs
   segment=5.0`, the model a seeded TorchScript separator moved to the
   card (every parameter there), a full segment and the tail drained at
   EOS on each stem, each within SEPARATE_TOL of the CPU run's; (b), (c)
   only where `transformers` imports: the telephony leg at 16 kHz into
   `whispertranscriber`, a random Whisper at whisper-tiny's widths, its
   encoder's last hidden state within WHISPER_TOL of the CPU's, and two
   prompts into `llamatexttransform` (a tiny GPT-2, greedy), its first
   step's logits within LM_TOL, the texts printed with the first token
   where card and CPU part; (d) the grade on 2 frames through `cmafmux`
   into `awss3hlssink` against an S3 stand-in that takes only
   SigV4-signed requests, and the telephony leg at 16 kHz S16 into
   `deepgramtranscriber` against a WebSocket stand-in: objects, audio
   frames and texts the CPU run's byte for byte, the grade read only by
   `cmafmux`; (e) `python -m gstpu_torch.tools.docs_cache` lists 268
   elements, its output the checked-in file.

It prints one JSON line each of the audio chain, of the element form, of
audiornnoise, of the binaural render, of hsvdetector, of the codec legs,
of the analytics path, of the parallel layer, of the host edge, of the
host codecs, of the captions, of the plumbing, of the network edge, of
the distribution edge, of WebRTC and of the cloud and model elements,
the card's name and power limit, one JSON line of kernels and last
`{"ok": true, "device": {...}}`. Any failed
phase raises, and the script then exits non-zero without that last line;
so does a machine without CUDA or a directory without the gstpu_torch
package.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the host edge (phase 13a): a seeded 4 s 48 kHz S16 stereo FLAC file
# resampled to 192 kHz F64 for the flagship chain (audioloudnorm's first
# frame is 3 s), into an MP4; the card against the CPU within the
# flagship's gate. audioresample's 16-tap window ends 9 inputs before
# the end of the stream, so an up-by-4 stream of n inputs gives
# 4 * (n - 9) + 1 = 4 n - 35 outputs.
EDGE_RATE, EDGE_SECONDS = 48_000, 4.0
EDGE_TOL = 1e-12
EDGE_RESAMPLER_EDGE = 35
EDGE_DOWNLOADS = 20          # timed downloads of one chain buffer
# 13b: BASELINE config 4's 1080p RGBA through both kernels into an MP4
EDGE_W, EDGE_H, EDGE_FRAMES = 1920, 1080, 16
# the host codecs and images (phase 14): 13b's grade and frame size into
# the new video elements (14a), the flagship's 192 kHz output into G.711
# and a telephony leg at 8 kHz mono (14b), a seeded CD+G file of 2 s
# (300 packets a second) through both kernels (14c); the codec shim's
# strings (14d) where libavcodec links
GRADE_HSV = "hue_shift=12 saturation_mul=1.1 value_mul=0.9 value_off=0.02"
CODECS_FRAMES, CODECS_RADIUS, VIUER_WIDTH = 8, 64, 160
G711_SECONDS, PHONE_SECONDS, PHONE_RATE = 4.0, 1.0, 8_000
CDG_PACKETS = 600
VPX_FRAMES = 4
OPUS_RATE, OPUS_SECONDS = 48_000, 1.0
# the captions on the card (phase 15): 13b's grade and frame size with a
# caption stream combined onto the frames as metas (cccombiner,
# st2038combiner) and burned in (cea608overlay, cea708overlay), each
# text at a frame index; the 608 stream is erased by an empty text; then
# the PIL image elements behind the grade (15b)
CAPTION_FRAMES = 16
CAPTIONS_608 = (("GRADED ON CARD", 1), ("", 12))
CAPTIONS_708 = (("CEA-708 CAPTION", 2), ("SECOND WINDOW", 9))
IMAGE_FRAMES = 2
# the plumbing, supervisors and host consumers behind the card (phase 16):
# bench_video.py's 4K RGBA with the seeded 33^3 LUT and 13b's grade through
# the bridges (16a) and the supervisors (16b, stepped under a TestClock and
# held against the same sequence at 64x48 on the CPU), BASELINE config 4's
# 1080p into the compressors and sodium (16c), the launch tool on the 4K
# chain (16d). fallbackswitch (timeout=1s) loses its main pad for 2 s after
# 6 frames, while 4 backup frames go out; togglerecord sees a GOP of 4 and
# its record flag set before the frames named. Brotli at quality 5: its
# default 11 is far slower on incompressible frames.
PLUMBING_FRAMES, PLUMBING_HOST_FRAMES, PLUMBING_LAUNCH_FRAMES = 16, 8, 4
PLUMBING_CHECK_W, PLUMBING_CHECK_H = 64, 48
SWITCH_TIMEOUT, SWITCH_OUTAGE_NS = 10 ** 9, 2 * 10 ** 9
SWITCH_HEALTHY, SWITCH_BACKUP = 6, 4
RECORD_GOP, RECORD_TOGGLES = 4, {2: True, 9: False, 11: True}
BROTLI_QUALITY = 5
SODIUM_NONCE = bytes(range(24))

# the network edge behind the card (phase 17), all on 127.0.0.1: 14b's
# telephony leg as A-law RTP of 20 ms packets (mtu 172: 160 B of payload)
# through rtpsend and raptorqenc (8 source packets a block, 2 repair
# packets of payload type 97) into udpsink, seeded source packets dropped
# before the socket (17a); BASELINE config 4's 1080p grade as RFC 4175 raw
# video at mtu 1400 (17b), with ONVIF boxes on frames 1 and 5 (17c), and
# over TCP in 1 MiB reads (17d). The sender's probe on udpsink drives the
# receiving pipeline every RTP_PACE datagrams, so that the receiver's
# socket (Linux's default buffer holds about 90 datagrams of 1400 B) never
# holds more than that.
RTP_FRAMES, ONVIF_FRAMES, ONVIF_BOXES = 4, 8, (1, 5)
RTP_MTU, RTP_RECV_MTU, PHONE_MTU = 1400, 1500, 172
RTP_FEC_K, RTP_FEC_REPAIR, RTP_FEC_PT = 8, 2, 97
RTP_PACE, RTP_SSRC, TCP_BLOCK = 32, 0x17A, 1 << 20
ONVIF_NS = "http://www.onvif.org/ver10/schema"
NOT_ON_THE_CARD = {
    "rtspsrc2": "a control protocol whose canned servers live in the "
                "tests; no device payload crosses it (tests/"
                "test_torch_net.py holds it against gstpu's)",
    "mpegtslivesrc": "a PCR clock slaved to a TS source; no device payload "
                     "crosses it (tests/test_torch_net.py)",
    "rtpgccbwe": "needs TWCC feedback (net/rtp/twcc.py, Queue D item 6); "
                 "the estimator is held against gstpu's in "
                 "tests/test_torch_rtp.py"}

# the distribution edge behind the card (phase 18), all on 127.0.0.1: 18a
# BASELINE config 4's 1080p grade on HLS_FRAMES frames through one cmafmux
# cutting fragments of HLS_FRAGMENT_FRAMES, teed into hlscmafsink,
# dashsink2 and an hlsmultivariantsink variant, with HLS_AUDIO_SECONDS of
# the flagship at 192 kHz F64 stereo through a second cmafmux as the
# variant's audio rendition and 15a's caption texts as WebVTT segments;
# 18b 13a's FLAC served over HTTP into the flagship, and HTTP_CLIP_SECONDS
# clips through fallbacksrc and uriplaylistbin; 18c the grade as RFC 4175
# RTP at QUIC_MTU in RoQ datagrams over QUIC, 17a's telephony RTP and the
# grade's on two QUIC streams, and the telephony RTP over WebTransport.
# The sender's probe on its QUIC sink drives the receiving pipeline every
# RTP_PACE buffers, and at EOS until every packet in flight is acked.
HLS_FRAMES, HLS_FRAGMENT_FRAMES, HLS_AUDIO_SECONDS = 4, 2, 1.0
HLS_AUDIO_FRAGMENT = 500_000_000
HLS_CAPTIONS = tuple(t for t, _ in CAPTIONS_608 + CAPTIONS_708 if t)
HTTP_CLIP_SECONDS = 0.25
QUIC_FRAMES, QUIC_STREAM_FRAMES, QUIC_MTU = 2, 1, 1200
NOT_ON_THE_CARD_18 = {
    "icecastsink": "takes only audio/mpeg, Ogg or AAC, and no element of "
                   "the port makes any of them from the card's audio; "
                   "tests/test_torch_hls.py holds it against gstpu's "
                   "behind a stand-in server"}

# the WebRTC edge behind the card (phase 19), all on 127.0.0.1: 19a
# PHONE_SECONDS of 17a's telephony leg as A-law into a request pad of
# webrtcsink (its own signalling server, ICE, DTLS, SRTP and SCTP data
# channels, GCC from TWCC feedback), negotiated by webrtcsrc over that
# server; 19b the grade on WEBRTC_FRAMES 1080p frames as RFC 4175 RTP at
# mtu RTP_MTU through webrtcsend and webrtcrecv, keyed by a DTLS
# handshake between two DtlsEndpoints; 19c the telephony RTP through
# whipclientsink into whipserversrc, and through whepserversink to
# WHEP_CLIENTS whepclientsrc; 19d the grade on WEBRTC_VIDEO_FRAMES raw
# frames into webrtcsink's encoder chain, only where the codec shim links
# (the encoder holds frames back, and webrtcsink takes EOS in without
# draining it). WEBRTC_LIMIT is a deadline in seconds that only a fault
# reaches.
WEBRTC_FRAMES, WEBRTC_VIDEO_FRAMES, WHEP_CLIENTS = 2, 8, 2
WEBRTC_LIMIT = 60.0
# 19c's SDP offer (its direction filled in), which the WHIP and WHEP
# servers answer
WHIP_OFFER = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
              "m=audio 9 UDP/TLS/RTP/SAVPF 8\r\na=rtpmap:8 PCMA/8000\r\n"
              "a={}\r\n")
NOT_ON_THE_CARD_19 = {
    "janusvrwebrtcsink, janusvrwebrtcsrc": "speak Janus VideoRoom's JSON "
        "API to a gateway; tests/test_torch_webrtcsink.py holds them "
        "against gstpu's behind a stand-in gateway",
    "uepswebrtcsink": "speaks to an Unreal Engine Pixel Streaming "
        "signalling server; tests/test_torch_webrtcsink.py holds it "
        "against gstpu's behind a stand-in server",
    "awskvswebrtcsink": "needs AWS Kinesis Video Streams endpoints; "
        "tests/test_torch_webrtcsink.py holds it against gstpu's behind "
        "stand-in endpoints",
    "TURN relay and STUN srflx candidates": "need a TURN or STUN server; "
        "tests/test_torch_webrtc.py holds both against gstpu's behind "
        "stand-in servers on 127.0.0.1",
    "NtpClock (RFC 7273 ts-refclk)": "needs an SNTP server; "
        "tests/test_torch_signalling.py holds it against gstpu's behind "
        "a stand-in server"}


# the cloud and model elements behind the card (phase 20), all on
# 127.0.0.1 and made from SEED: 20a SEPARATE_SECONDS of the flagship at
# 192 kHz F64 stereo through audioconvert and audioresample to 44.1 kHz
# F32 stereo into demucs (segment SEPARATE_SEGMENT s, its four stems
# linked), the model a TorchScript StemSeparator (SEPARATOR_WIDTH
# channels, SEPARATOR_TAPS taps); 20b 17a's telephony leg at 16 kHz mono
# F32 into whispertranscriber, a random Whisper at whisper-tiny's published
# widths (d_model, layers, heads, ffn); 20c LM_PROMPTS into
# llamatexttransform, tests/test_viuer_compositor_llm.py's GPT-2, greedy;
# 20d the grade on CLOUD_FRAMES 1080p frames through cmafmux (a fragment
# a frame) into awss3hlssink, and 17a's telephony leg at 16 kHz S16 mono
# into deepgramtranscriber, each against a stand-in service that answers
# each STT_RESULT_BYTES of audio; 20e the docs cache tool. The
# tolerances hold the card against the CPU, TF32 off, at about ten times
# the largest gap measured on an H100: 1.5e-8 on a stem (peak 0.05),
# 2.9e-6 on Whisper's encoder state (peak 3.56), 4.5e-8 on GPT-2's first
# logits (peak 0.49).
SEPARATE_SECONDS, SEPARATE_SEGMENT, SEPARATE_RATE = 5.5, 5.0, 44_100
SEPARATE_STEMS = ("drums", "bass", "other", "vocals")
SEPARATOR_WIDTH, SEPARATOR_TAPS = 32, 15
SEPARATE_TOL = 2e-7
SPEECH_RATE = 16_000
WHISPER_WIDTHS = (384, 4, 6, 1536)
WHISPER_TOL = 2e-5
LM_PROMPTS, LM_TOKENS, LM_TOL = ("GRADED ON CARD", "SECOND WINDOW"), 8, 5e-7
CLOUD_FRAMES, STT_RESULT_BYTES = 2, 16_000
CLOUD_REGION, CLOUD_ACCESS, CLOUD_SECRET = ("eu-central-1", "CARDACCESSKEY",
                                            "card/secret+key")
FACTORIES = 268


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


def profiled(fn, n: int):
    """Run fn n times under torch.profiler; the profile and the wall
    time of the n runs in seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def device_events(fn, n: int):
    """Run fn n times under torch.profiler. Returns the device-side
    events (kernels, copies, and the ranges that are mirrored on the
    device) and the wall time of the n runs in seconds."""
    prof, wall = profiled(fn, n)
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall


@contextlib.contextmanager
def program_spans(device: bool = False):
    """The program's span tracer (gstpu_torch.utils.tracing.ProgramSpans)
    installed and keeping intervals for the block; `device` adds each
    device span's interval on the card."""
    from gstpu_torch.utils import tracing
    spans = tracing.ProgramSpans(device=device)
    spans.install()
    spans.keep(True)
    try:
        yield spans
    finally:
        spans.uninstall()


def stage_busy_ms(prof, spans, n: int) -> dict:
    """Device busy ms a step inside each device span's interval of the
    tracer, from the profiler's kernels and copies: the tracer's
    perf_counter times go onto the profiler's (wall) clock by one
    offset."""
    off = time.time_ns() - time.perf_counter_ns()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation()]
    busy: dict = {}
    for a, b, name, _id, _req in spans.device_intervals():
        a, b = a + off, b + off
        busy[name] = busy.get(name, 0) + sum(
            max(0, min(e1, b) - max(e0, a)) for e0, e1 in ops)
    return {k.removeprefix("chain."): v / 1e6 / n for k, v in busy.items()}


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

    t0 = time.perf_counter()
    for i in range(AUDIO_TIMED):
        state, out, meters = step(state, bank[i % AUDIO_BANK], *args)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rt = B * AUDIO_TIMED * 0.1 / wall
    shortterm = meters["shortterm"]
    if out.shape != (B, n_step) or not bool(torch.isfinite(out).all()) \
            or not bool(torch.isfinite(shortterm).all()):
        raise AssertionError("audio chain output or meter not finite")
    st_mean = float(shortterm.double().mean())
    log(f"[audio] {B} streams x {AUDIO_TIMED} steps of 100 ms in "
        f"{wall * 1e3:.3f} ms: {rt:.2f}x realtime; the host enqueued "
        f"them in {enqueue * 1e3:.3f} ms; prime {prime_s:.3f} s; fused "
        f"meter mean short-term {st_mean:.4f} LUFS (target -24)  [{smi}]")

    # each stage of a step on the program's tracer, over 5 steps
    # (medians): the card's time between the events recorded where its
    # span opens and closes, the host's in the span; and the limiter
    # loop's iterations a step
    with program_spans(device=True) as spans:
        for i in range(5):
            state, out, meters = step(state, bank[i % AUDIO_BANK], *args)
        torch.cuda.synchronize()
    dev_ms = {k: [] for k in STAGES}
    host_ms = {k: [] for k in STAGES}
    for a, b, name, _id, _req in spans.device_intervals():
        dev_ms[name.removeprefix("chain.")].append((b - a) / 1e6)
    for a, b, name, *_ in spans.intervals():
        if name.removeprefix("chain.") in host_ms:
            host_ms[name.removeprefix("chain.")].append((b - a) / 1e6)
    stage_ms = {k: statistics.median(v) for k, v in dev_ms.items()}
    stage_host_ms = {k: statistics.median(v) for k, v in host_ms.items()}
    sums = spans.snapshot()
    loops = sums["counters"]["limiter.iterations"] / 5
    wait_ms = sums["total_ns"]["limiter.wait"] / 5e6
    log("[audio] stage ms a step, device (host): " + ", ".join(
        f"{k} {stage_ms[k]:.3f} ({stage_host_ms[k]:.3f})" for k in STAGES)
        + f"; limiter loop {loops} iterations a step, the host waiting "
        f"{wait_ms:.3f} ms a step on its tests")

    # a profiler window of 3 steps: the kernels launched, the device's
    # busy share, and each stage's kernel time (the profiler's device
    # operations inside the tracer's device intervals of the stage)
    frames = itertools.cycle(bank)

    def profiled_step():
        nonlocal state
        state = step(state, next(frames), *args)[0]

    with program_spans(device=True) as spans:
        prof, window = profiled(profiled_step, 3)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    stage_busy = stage_busy_ms(prof, spans, 3)
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
        with program_spans() as spans:
            for k in range(AUDIO_LIMITER_STEPS):
                st2, o, _ = step(st2, x2[k + 1].to(where), *args)
                outs.append(o.cpu())
                trace.append(decisions(st2))
        runs.append((outs, trace,
                     spans.snapshot()["counters"]["limiter.iterations"]))
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
            "limiter_iterations_per_step": loops,
            "limiter_wait_ms_per_step": wait_ms, "profile": profile,
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


def edge_signal(seconds: float, rate: int) -> np.ndarray:
    """Seeded S16 stereo: two tones whose level steps every second, plus
    noise, so the loudness normaliser moves its gain."""
    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * rate)) / rate
    level = 0.15 + 0.5 * (np.floor(t) % 2)
    x = np.stack([level * np.sin(2 * np.pi * 440 * t),
                  0.7 * level * np.sin(2 * np.pi * 660 * t + 0.3)], 1)
    x += 0.01 * rng.standard_normal(x.shape)
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)


def run_string(gstpu_torch, device: str, launch: str, sinks=(), feed=None,
               build=None):
    """Run a launch string to its end on `device`, `build(p)` adding to
    the parsed pipeline and `feed(p)` pushing any appsrc input first: the
    pipeline (in NULL), its wall seconds, each named appsink's buffers and
    the element messages of its bus."""
    from gstpu_torch.core.element import MessageType
    gstpu_torch.init(device=device)
    p = gstpu_torch.parse_launch(launch)
    if build is not None:
        build(p)
    p.set_state(gstpu_torch.State.PLAYING)
    t0 = time.perf_counter()
    if feed is not None:
        feed(p)
    p.run(timeout=600)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {s: p.get_by_name(s).pull_all() for s in sinks}
    msgs = [(m.name, m.fields) for m in p.bus.drain()
            if m.type is MessageType.ELEMENT]
    p.set_state(gstpu_torch.State.NULL)
    return p, dt, out, msgs


def mp4_boxes(data: bytes) -> dict:
    """The top-level boxes of a non-fragmented MP4, which must be ftyp,
    mdat and moov."""
    from gstpu_torch.mux.boxes import parse_boxes
    tree = parse_boxes(data)
    if [b.fourcc for b in tree] != ["ftyp", "mdat", "moov"]:
        raise AssertionError(f"not an ftyp/mdat/moov file: "
                             f"{[b.fourcc for b in tree]}")
    return {b.fourcc: b for b in tree}


def mp4_stsd(moov) -> bytes:
    from gstpu_torch.mux.boxes import parse_boxes
    stbl = moov.find("trak.mdia.minf.stbl")
    return next(c for c in parse_boxes(stbl.data) if c.fourcc == "stsd").data


def mp4_sample_bytes(moov) -> int:
    """The bytes of every sample the moov's sample table lists."""
    from gstpu_torch.mux.boxes import parse_boxes
    stbl = moov.find("trak.mdia.minf.stbl")
    stsz = next(c for c in parse_boxes(stbl.data) if c.fourcc == "stsz")
    count = int.from_bytes(stsz.data[8:12], "big")
    return int(np.frombuffer(stsz.data[12:12 + 4 * count], ">u4")
               .astype(np.int64).sum())


def payload_kind(d) -> str:
    """Where a buffer's payload lies: "tensor on cuda", "ndarray", ..."""
    return (f"tensor on {d.device.type}" if isinstance(d, torch.Tensor)
            else type(d).__name__)


def push_tracer():
    """A tracer on the port's pad-push hooks: per pad, the host seconds
    inside its buffer pushes (inclusive of everything downstream), the
    same less the pushes nested in them (exclusive: the receiving
    element's own work on the buffer), the pushes, and where its first
    payload lay. Nested pushes are kept a stack per thread, and a pad's
    start times a stack per pad (a pad may push again inside its own
    push: webrtcsink's GCC feedback re-encodes inside the payloader's)."""
    from gstpu_torch.utils.tracing import Tracer

    class PushTimes(Tracer):
        HOOKS = {"pad-push-pre": "pre", "pad-push-post": "post"}

        def __init__(self):
            super().__init__()
            self.t0: dict = {}
            self.seconds: dict = {}
            self.exclusive: dict = {}
            self.nested: dict = {}
            self.pushes: dict = {}
            self.payload: dict = {}

        def pre(self, pad, buf) -> None:
            self.t0.setdefault(pad, []).append(time.perf_counter())
            self.nested.setdefault(threading.get_ident(), []).append(0.0)
            self.payload.setdefault(pad, payload_kind(buf.data))

        def post(self, pad, buf) -> None:
            dt = time.perf_counter() - self.t0[pad].pop()
            nested = self.nested[threading.get_ident()]
            inner = nested.pop()
            if nested:
                nested[-1] += dt
            self.seconds[pad] = self.seconds.get(pad, 0.0) + dt
            self.exclusive[pad] = self.exclusive.get(pad, 0.0) + dt - inner
            self.pushes[pad] = self.pushes.get(pad, 0) + 1

    return PushTimes()


def edge_audio_phase(gstpu_torch, dev, smi, tmp: Path) -> dict:
    """13a. A seeded 48 kHz S16 stereo FLAC file through `filesrc !
    claxondec ! audioconvert ! F64LE ! audioresample ! 192 kHz !
    rsaudioecho ! audioloudnorm ! ebur128level ! isomp4mux ! filesink` on
    the card (the flagship's settings) and on the CPU: the echo's output a
    CUDA tensor, every box but mdat byte for byte, mdat's F64 samples
    within the flagship's gate, 4 n - 35 samples; host ms per second of
    audio by stage, the downloads' host ms and the device's busy ms."""
    from gstpu_torch.codecs.flac import encode_verbatim
    from gstpu_torch.core.buffer import Buffer
    x = edge_signal(EDGE_SECONDS, EDGE_RATE)
    src = tmp / "in.flac"
    src.write_bytes(encode_verbatim(x, EDGE_RATE))

    def launch(dst: Path) -> str:
        return (f"filesrc location={src} ! claxondec name=dec ! "
                f"audioconvert name=conv ! audio/x-raw, format=F64LE ! "
                f"audioresample name=res ! audio/x-raw, rate={RATE_192K} ! "
                f"rsaudioecho name=echo delay=250000000 intensity="
                f"{AUDIO_INTENSITY} feedback={AUDIO_FEEDBACK} ! "
                f"audioloudnorm name=norm ! ebur128level ! isomp4mux ! "
                f"filesink location={dst}")

    tracer = push_tracer()
    tracer.install()
    try:
        holder = {}

        def card_run():
            holder["p"], holder["dt"], _, _ = run_string(
                gstpu_torch, "cuda", launch(tmp / "card.mp4"))

        kern, _ = device_events(card_run, 1)
    finally:
        tracer.uninstall()
    p, wall = holder["p"], holder["dt"]
    filesrc = next(e for e in p.children if e.ELEMENT_NAME == "filesrc")
    pads = {"src": filesrc.static_pad("src")}
    for n in ("dec", "conv", "res", "echo", "norm"):
        pads[n] = p.get_by_name(n).static_pad("src")
    pads["res_in"] = p.get_by_name("res").static_pad("sink").peer
    pads["echo_in"] = p.get_by_name("echo").static_pad("sink").peer
    t = {k: tracer.seconds.get(v, 0.0) for k, v in pads.items()}
    echo_payload = tracer.payload.get(pads["echo"])
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    per_s = 1e3 / EDGE_SECONDS
    stages = {
        "decode": (t["src"] - t["dec"]) * per_s,
        "decode_convert": (t["src"] - t["conv"]) * per_s,
        "decode_convert_resample": (t["src"] - t["res"]) * per_s,
        "whole_string": wall * per_s,
    }
    own = {"convert": (t["dec"] - t["conv"]) * per_s,
           "resample": (t["res_in"] - t["res"]) * per_s,
           "echo": (t["echo_in"] - t["echo"]) * per_s,
           "loudnorm_and_after": t["echo"] * per_s}
    log(f"[edge] the FLAC string on the card: {EDGE_SECONDS} s of "
        f"{EDGE_RATE} Hz stereo in {wall:.3f} s (tracer and profiler on); "
        f"host ms per second of audio: "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
        + "; each stage's own: "
        + ", ".join(f"{k} {v:.1f}" for k, v in own.items())
        + f"; the device busy {busy_ms:.4f} ms in {len(kern)} kernels and "
        f"copies; the echo's output: {echo_payload}  [{smi}]")
    if echo_payload != "tensor on cuda":
        raise AssertionError(f"the echo's output lies on {echo_payload}, "
                             f"not the card")

    # the downloads: audioloudnorm reads each echo buffer through
    # Buffer.array, one device-to-host copy and sync a buffer
    n_buf = tracer.pushes.get(pads["echo"], 0)
    frames = 4 * 4096                   # a FLAC frame of 4096, resampled
    y = torch.randn(frames, 2, dtype=torch.float64, device=dev)
    dl = []
    for _ in range(EDGE_DOWNLOADS):
        b = Buffer(y * 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.array
        dl.append(time.perf_counter() - t0)
    download_ms = statistics.median(dl) * 1e3
    log(f"[edge] a download of one {frames}-frame F64 stereo buffer: "
        f"{download_ms:.4f} ms on the host (median of {EDGE_DOWNLOADS}); "
        f"{n_buf} echo buffers in the run, ~{n_buf * download_ms:.2f} ms "
        f"in all")

    _, cpu_wall, _, _ = run_string(gstpu_torch, "cpu",
                                   launch(tmp / "cpu.mp4"))
    card, cpu = (mp4_boxes((tmp / f).read_bytes())
                 for f in ("card.mp4", "cpu.mp4"))
    for name in ("ftyp", "moov"):
        if card[name].data != cpu[name].data:
            raise AssertionError(f"the card's MP4 {name} differs from the "
                                 f"CPU's")
    got = np.frombuffer(card["mdat"].data, "<f8").reshape(-1, 2)
    want = np.frombuffer(cpu["mdat"].data, "<f8").reshape(-1, 2)
    err = float(np.abs(got - want).max())
    n_out = mp4_sample_bytes(card["moov"]) // 16
    expect = 4 * x.shape[0] - EDGE_RESAMPLER_EDGE
    stsd = mp4_stsd(card["moov"])
    log(f"[edge] card vs CPU: ftyp and moov equal, mdat max |err| {err:.3e} "
        f"(gate {EDGE_TOL}); {n_out} samples of 192 kHz stereo (4 x "
        f"{x.shape[0]} - {EDGE_RESAMPLER_EDGE} = {expect}); the CPU string "
        f"{cpu_wall:.3f} s")
    if not np.isfinite(got).all() or err > EDGE_TOL:
        raise AssertionError("the card's samples are not within the gate")
    if got.shape[0] != n_out or n_out != expect:
        raise AssertionError(f"{n_out} samples in the MP4, {expect} "
                             f"expected")
    if b"fpcm" not in stsd or b"pcmC" not in stsd:
        raise AssertionError("the MP4's sample entry is not fpcm")
    return {"seconds_of_audio": EDGE_SECONDS, "wall_s": wall,
            "cpu_wall_s": cpu_wall, "host_ms_per_s": stages,
            "own_host_ms_per_s": own, "busy_ms": busy_ms,
            "device_events": len(kern), "echo_buffers": n_buf,
            "download_ms_a_buffer": download_ms, "max_abs_err": err,
            "samples": n_out, "echo_output": echo_payload}


def edge_video_phase(gstpu_torch, dev, smi, tmp: Path, kernels) -> dict:
    """13b. BASELINE config 4's 1080p RGBA through `videotestsrc !
    hsvfilter ! colorlut ! isomp4mux ! filesink` on the card: each
    kernel launched once a frame, the file byte for byte the one the same
    string writes on the CPU through the plain versions, the uncC sample
    entry RGBA; fps beside the same string into fakesink."""
    cube = tmp / "edge.cube"
    write_cube(cube, np.random.default_rng(SEED))

    def launch(n: int, tail: str) -> str:
        return (f"videotestsrc num-buffers={n} pattern=snow ! video/x-raw, "
                f"format=RGBA, width={EDGE_W}, height={EDGE_H}, "
                f"framerate=30/1 ! hsvfilter {GRADE_HSV} ! colorlut "
                f"location={cube} ! {tail}")

    mp4 = f"isomp4mux ! filesink location={tmp / 'card_video.mp4'}"
    run_string(gstpu_torch, "cuda", launch(1, mp4))
    for k in kernels:
        k.launches = 0
    _, dt, _, _ = run_string(gstpu_torch, "cuda", launch(EDGE_FRAMES, mp4))
    launches = {k.name: k.launches for k in kernels}
    _, dt_fake, _, _ = run_string(gstpu_torch, "cuda",
                                 launch(EDGE_FRAMES, "fakesink"))
    run_string(gstpu_torch, "cpu", launch(
        EDGE_FRAMES, f"isomp4mux ! filesink location={tmp / 'cpu_video.mp4'}"))
    card = (tmp / "card_video.mp4").read_bytes()
    same = card == (tmp / "cpu_video.mp4").read_bytes()
    boxes = mp4_boxes(card)
    stsd = mp4_stsd(boxes["moov"])
    i = stsd.find(b"uncC")
    rgba = (b"uncv" in stsd and i >= 0 and stsd[i + 4] == 1
            and stsd[i + 8:i + 12] == b"rgba")
    n_bytes = mp4_sample_bytes(boxes["moov"])
    res = {"frames": EDGE_FRAMES, "fps_mp4": EDGE_FRAMES / dt,
           "fps_fakesink": EDGE_FRAMES / dt_fake, "launches": launches,
           "file_bytes": len(card), "equal_to_cpu": same, "uncC_rgba": rgba}
    log(f"[edge] {EDGE_FRAMES} frames of {EDGE_W}x{EDGE_H} RGBA through "
        f"`hsvfilter ! colorlut ! isomp4mux ! filesink`: "
        f"{res['fps_mp4']:.2f} fps; into fakesink {res['fps_fakesink']:.2f}"
        f" fps; launches {launches}; the {len(card)} B file "
        f"{'equals' if same else 'DIFFERS FROM'} the CPU's; uncC RGBA "
        f"{rgba}  [{smi}]")
    if not same or not rgba or n_bytes != EDGE_FRAMES * EDGE_W * EDGE_H * 4:
        raise AssertionError("the 1080p MP4 differs from the CPU's or is "
                             "not RGBA uncv")
    if any(n != EDGE_FRAMES for n in launches.values()):
        raise AssertionError(f"the kernels launched {launches} times, not "
                             f"once a frame")
    return res


def edge_container_phase(gstpu_torch, smi, tmp: Path) -> dict:
    """13c. The containers in the card's Python, on the card's default
    device and on the CPU, byte for byte: `rsflvdemux` on an FLV from the
    port's FlvWriter, `mpegtsmux ! filesink` on seeded H.264 access
    units (the mux takes coded streams only), and 13a's 192 kHz output
    through `isofmp4mux ! filesink` (read from 13a's CPU file in
    `tmp`)."""
    from gstpu_torch.mux.flv import FlvWriter
    w = FlvWriter()
    w.video_tag(0, b"\x01seqhdr", codec=7, keyframe=True,
                avc_packet_type=0)
    rng = np.random.default_rng(SEED)
    for i in range(30):
        w.video_tag(i * 40, rng.integers(0, 256, 500, np.uint8).tobytes(),
                    codec=7, keyframe=(i % 10 == 0))
        w.audio_tag(i * 40, rng.integers(0, 256, 200, np.uint8).tobytes(),
                    sound_format=2)
    flv = tmp / "in.flv"
    flv.write_bytes(w.to_bytes())
    aus = [(b"\x00\x00\x00\x01" + (b"\x65" if i % 10 == 0 else b"\x41")
            + rng.integers(0, 256, 2000 + 97 * i, np.uint8).tobytes())
           for i in range(30)]
    pcm = np.frombuffer(mp4_boxes((tmp / "cpu.mp4").read_bytes())["mdat"]
                        .data, "<f8")
    res = {}
    for device in ("cuda", "cpu"):
        gstpu_torch.init(device=device)
        p = gstpu_torch.parse_launch(f"filesrc location={flv} ! "
                                     f"rsflvdemux name=d")
        sinks = {"audio": gstpu_torch.make("appsink"),
                 "video": gstpu_torch.make("appsink")}
        p.add(*sinks.values())
        p.get_by_name("d").connect("pad-added", lambda el, pad: pad.link(
            sinks["audio" if pad.name == "audio" else "video"]
            .static_pad("sink")))
        p.set_state(gstpu_torch.State.PLAYING)
        p.run(timeout=600)
        demuxed = {k: (repr(s.caps), [(b.to_bytes(), b.pts, b.duration)
                                      for b in s.pull_all()])
                   for k, s in sinks.items()}
        p.set_state(gstpu_torch.State.NULL)
        ts = tmp / f"{device}.ts"
        p = gstpu_torch.parse_launch(
            f'appsrc name=src caps="video/x-h264, stream-format=byte-stream,'
            f' width={EDGE_W}, height={EDGE_H}" ! mpegtsmux ! filesink '
            f'location={ts}')
        p.set_state(gstpu_torch.State.PLAYING)
        s = p.get_by_name("src")
        for i, au in enumerate(aus):
            b = gstpu_torch.Buffer(au, pts=i * 33_333_333,
                                   duration=33_333_333)
            if i % 10:
                b.set_flag(gstpu_torch.BufferFlags.DELTA_UNIT)
            s.push_buffer(b)
        s.end_of_stream()
        p.run(timeout=600)
        p.set_state(gstpu_torch.State.NULL)
        frag = tmp / f"{device}.fmp4"
        p = gstpu_torch.parse_launch(
            f'appsrc name=src caps="audio/x-raw, format=F64LE, rate='
            f'{RATE_192K}, channels=2, layout=interleaved" ! isofmp4mux '
            f'fragment-duration=1000000000 ! filesink location={frag}')
        p.set_state(gstpu_torch.State.PLAYING)
        s = p.get_by_name("src")
        block = 2 * RATE_192K // 10                 # 100 ms of stereo
        for i, off in enumerate(range(0, pcm.size, block)):
            s.push_buffer(gstpu_torch.Buffer(
                pcm[off:off + block].reshape(-1, 2).copy(),
                pts=i * 100_000_000, duration=100_000_000))
        s.end_of_stream()
        p.run(timeout=600)
        p.set_state(gstpu_torch.State.NULL)
        res[device] = (demuxed, ts.read_bytes(), frag.read_bytes())
    card, cpu = res["cuda"], res["cpu"]
    out = {"flv_buffers": {k: len(v[1]) for k, v in card[0].items()},
           "ts_bytes": len(card[1]), "fmp4_bytes": len(card[2]),
           "equal": [card[i] == cpu[i] for i in range(3)]}
    log(f"[edge] containers on the card's default device vs the CPU: "
        f"rsflvdemux {out['flv_buffers']} buffers, mpegtsmux "
        f"{out['ts_bytes']} B, isofmp4mux of 13a's samples "
        f"{out['fmp4_bytes']} B; equal {out['equal']}  [{smi}]")
    if not all(out["equal"]) or out["flv_buffers"] != {"audio": 30,
                                                        "video": 30} \
            or out["ts_bytes"] % 188 or not pcm.size:
        raise AssertionError("a container differs between the card's "
                             "default device and the CPU")
    return out


def own_ms(tracer, p, names: list, per: float) -> dict:
    """Each named element's own host ms on the buffers pushed into it, per
    `per` unit: the exclusive time of the pushes into its sink pads. Work
    an element does at EOS (a drain) falls outside every buffer push."""
    return {n: sum(tracer.exclusive.get(pad.peer, 0.0)
                   for pad in p.get_by_name(n).sink_pads()) * 1e3 / per
            for n in names}


def codec_libraries(gstpu_torch) -> dict:
    """14. The libraries phase 14 needs beside the card: the C++ G.711
    library (a gate: it must build and load), PIL and the codec shim
    (what they stop is named, not run)."""
    import ctypes
    import importlib.util
    from gstpu_torch import native, native_codec
    lib = native.load()
    if not isinstance(lib, ctypes.CDLL):
        raise AssertionError("the C++ G.711 library did not build or load")
    have = {"PIL": importlib.util.find_spec("PIL") is not None,
            "libavcodec": native_codec.load() is not None}
    log(f"[codecs] G.711 through the C++ library {Path(lib._name).name}; "
        f"PIL {'present' if have['PIL'] else 'MISSING'}; the codec shim "
        + ("builds" if have["libavcodec"]
           else "does not build (no libavcodec)"))
    return {"g711_library": Path(lib._name).name, **have}


def codecs_video_phase(gstpu_torch, smi, tmp: Path, kernels,
                       have_pil: bool) -> dict:
    """14a. BASELINE config 4's 1080p RGBA through 13b's grade on the card,
    then `colordetect ! tee` into `videoconvert ! I420 ! roundedcorners`,
    `viuersink` and (with PIL) `rspngenc ! filesink`: each kernel once a
    frame, every output byte and colordetect message the CPU's; then
    `videocompare` fed the card's graded frames and the CPU's posts
    distance 0 for each. fps and each new element's host ms a frame."""
    cube = tmp / "codecs.cube"
    write_cube(cube, np.random.default_rng(SEED))

    def launch(where: str, n: int) -> str:
        d = tmp / where
        d.mkdir(exist_ok=True)
        s = (f"videotestsrc num-buffers={n} pattern=snow ! video/x-raw, "
             f"format=RGBA, width={EDGE_W}, height={EDGE_H}, framerate=30/1 "
             f"! hsvfilter name=hsv {GRADE_HSV} ! colorlut name=lut "
             f"location={cube} ! colordetect name=cd ! tee name=t ! "
             f"videoconvert name=conv ! video/x-raw, format=I420 ! "
             f"roundedcorners name=rc border-radius-px={CODECS_RADIUS} ! "
             f"appsink name=a420 ! t. ! viuersink name=viuer "
             f"width={VIUER_WIDTH} file={d / 'viuer.txt'} ! t. ! "
             f"appsink name=rgba")
        if have_pil:
            s += (f" ! t. ! rspngenc name=png ! filesink name=pngfile "
                  f"location={d / 'frames.png'}")
        return s

    sinks = ("a420", "rgba")
    run_string(gstpu_torch, "cuda", launch("warm", 1), sinks)
    tracer = push_tracer()
    for k in kernels:
        k.launches = 0
    tracer.install()
    try:
        p, dt, card_out, card_msgs = run_string(
            gstpu_torch, "cuda", launch("card", CODECS_FRAMES), sinks)
    finally:
        tracer.uninstall()
    launches = {k.name: k.launches for k in kernels}
    names = ["hsv", "lut", "cd", "conv", "rc", "viuer"] \
        + (["png", "pngfile"] if have_pil else [])
    per_frame = own_ms(tracer, p, names, CODECS_FRAMES)
    graded = tracer.payload.get(p.get_by_name("lut").static_pad("src"))
    _, cpu_dt, cpu_out, cpu_msgs = run_string(
        gstpu_torch, "cpu", launch("cpu", CODECS_FRAMES), sinks)

    def a420(out):
        return [(b.to_bytes(), b.pts, b.duration) for b in out["a420"]]

    files = ["viuer.txt"] + (["frames.png"] if have_pil else [])
    same = {"a420": a420(card_out) == a420(cpu_out),
            "messages": card_msgs == cpu_msgs}
    for f in files:
        same[f] = ((tmp / "card" / f).read_bytes()
                   == (tmp / "cpu" / f).read_bytes())

    # videocompare: the card's graded frames on the reference pad, the
    # CPU's on the secondary, secondary frame i before reference frame i
    from gstpu_torch.core.caps import parse_caps
    from gstpu_torch.core.element import MessageType
    gstpu_torch.init(device="cuda")
    caps = (f"video/x-raw, format=RGBA, width={EDGE_W}, height={EDGE_H}, "
            f"framerate=30/1")
    vp = gstpu_torch.parse_launch(
        f'appsrc name=ref caps="{caps}" ! videocompare name=vc ! fakesink')
    sec = gstpu_torch.make("appsrc", element_name="sec")
    sec.set_property("caps", parse_caps(caps))
    vp.add(sec)
    sec.static_pad("src").link(vp.get_by_name("vc").static_pad(
        "sink_secondary"))
    vp.set_state(gstpu_torch.State.PLAYING)
    ref = vp.get_by_name("ref")
    t0 = time.perf_counter()
    for a, b in zip(card_out["rgba"], cpu_out["rgba"]):
        sec.push_buffer(b)
        while vp.iterate():
            pass
        ref.push_buffer(a)
        while vp.iterate():
            pass
    ref.end_of_stream()
    sec.end_of_stream()
    vp.run(timeout=600)
    compare_ms = (time.perf_counter() - t0) * 1e3 / CODECS_FRAMES
    posted = [m.fields for m in vp.bus.drain()
              if m.type is MessageType.ELEMENT and m.name == "videocompare"]
    vp.set_state(gstpu_torch.State.NULL)
    ref_kinds = {payload_kind(b.data) for b in card_out["rgba"]}
    distances = [(m["distance"], m["pts"], m["secondary_pts"]) for m in posted]

    res = {"frames": CODECS_FRAMES, "fps": CODECS_FRAMES / dt,
           "cpu_fps": CODECS_FRAMES / cpu_dt, "launches": launches,
           "host_ms_a_frame": per_frame, "videocompare_ms_a_frame": compare_ms,
           "graded_payload": graded, "reference_payload": sorted(ref_kinds),
           "equal_to_cpu": same, "colordetect_messages": len(card_msgs),
           "videocompare_distances": [d[0] for d in distances]}
    log(f"[codecs] {CODECS_FRAMES} frames of {EDGE_W}x{EDGE_H} RGBA through "
        f"`hsvfilter ! colorlut ! colordetect ! tee` into roundedcorners, "
        f"viuersink{' and rspngenc' if have_pil else ''}: {res['fps']:.3f} "
        f"fps on the card (tracer on), {res['cpu_fps']:.3f} on the CPU; "
        f"launches {launches}; the graded frames: {graded}; host ms a frame: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items())
        + f"; equal to the CPU: {same}; {len(card_msgs)} colordetect "
        f"messages; videocompare (fed {sorted(ref_kinds)} and host frames) "
        f"{compare_ms:.3f} ms a frame, distances "
        f"{res['videocompare_distances']}  [{smi}]")
    if not all(same.values()) or len(card_out["a420"]) != CODECS_FRAMES \
            or "A420" not in repr(p.get_by_name("a420").caps):
        raise AssertionError(f"phase 14a's outputs differ from the CPU's: "
                             f"{same}")
    if not card_msgs:
        raise AssertionError("colordetect posted no message")
    if len(distances) != CODECS_FRAMES or any(
            d != 0 or pts != sp for d, pts, sp in distances):
        raise AssertionError(f"videocompare did not post distance 0 for every "
                             f"frame: {distances}")
    if graded != "tensor on cuda":
        raise AssertionError(f"the graded frames lie on {graded}, not the "
                             f"card")
    if any(n != CODECS_FRAMES for n in launches.values()):
        raise AssertionError(f"the kernels launched {launches} times, not "
                             f"once a frame")
    return res


def feed_blocks(gstpu_torch, x: np.ndarray, rate: int):
    """An appsrc feeder: `x` (frames, channels) in 100 ms host blocks."""
    def feed(p) -> None:
        src = p.get_by_name("src")
        for i, off in enumerate(range(0, len(x), rate // 10)):
            src.push_buffer(gstpu_torch.Buffer(
                x[off:off + rate // 10].copy(), pts=i * 100_000_000,
                duration=100_000_000))
        src.end_of_stream()
    return feed


def codecs_audio_phase(gstpu_torch, smi, tmp: Path) -> dict:
    """14b. The flagship at one stream of 192 kHz F64 stereo (its settings,
    the echo's output a CUDA tensor) `! audioloudnorm ! rsagingradio !
    audioconvert ! S16LE ! alawenc ! alawdec ! mulawenc ! mulawdec !
    filesink`, on the card and the CPU: the files equal (else the
    differing codes counted), the F64 samples before audioconvert within
    EDGE_TOL; then a 1 s telephony leg resampled to 8 kHz mono before
    alawenc, its file the CPU's. Host ms per second of audio by stage."""
    caps = (f"audio/x-raw, format=F64LE, rate={RATE_192K}, channels=2, "
            f"layout=interleaved")
    stages = ["echo", "norm", "aging", "conv", "ae", "ad", "me", "md", "out"]

    def launch(dst: Path, phone: bool) -> str:
        to_s16 = (f"audioresample name=res ! audio/x-raw, rate={PHONE_RATE} "
                  f"! audioconvert name=conv ! audio/x-raw, format=S16LE, "
                  f"channels=1" if phone else
                  "audioconvert name=conv ! audio/x-raw, format=S16LE")
        return (f'appsrc name=src caps="{caps}" ! rsaudioecho name=echo '
                f'delay=250000000 intensity={AUDIO_INTENSITY} '
                f'feedback={AUDIO_FEEDBACK} ! audioloudnorm name=norm ! '
                f'rsagingradio name=aging ! tee name=t ! {to_s16} ! '
                f'alawenc name=ae ! alawdec name=ad ! mulawenc name=me ! '
                f'mulawdec name=md ! filesink name=out location={dst} ! t. ! '
                f'appsink name=f64')

    res = {}
    for leg, seconds, phone in (("g711", G711_SECONDS, False),
                                ("telephony", PHONE_SECONDS, True)):
        x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
        feed = feed_blocks(gstpu_torch, x, RATE_192K)
        tracer = push_tracer()
        tracer.install()
        try:
            p, dt, card_out, _ = run_string(
                gstpu_torch, "cuda", launch(tmp / f"{leg}_card.raw", phone),
                ("f64",), feed)
        finally:
            tracer.uninstall()
        names = stages[:3] + (["res"] if phone else []) + stages[3:]
        own = own_ms(tracer, p, names, seconds)
        echo_payload = tracer.payload.get(p.get_by_name("echo")
                                          .static_pad("src"))
        aging_in = tracer.payload.get(p.get_by_name("aging")
                                      .static_pad("sink").peer)
        _, cpu_dt, cpu_out, _ = run_string(
            gstpu_torch, "cpu", launch(tmp / f"{leg}_cpu.raw", phone),
            ("f64",), feed)
        got, want = ((tmp / f"{leg}_{w}.raw").read_bytes()
                     for w in ("card", "cpu"))
        codes = np.frombuffer(got, "<i2"), np.frombuffer(want, "<i2")
        differ = (int(np.count_nonzero(codes[0] != codes[1]))
                  if codes[0].shape == codes[1].shape else -1)
        f64 = [np.concatenate([b.array.view(np.float64).reshape(-1)
                               for b in out["f64"]])
               for out in (card_out, cpu_out)]
        err = float(np.abs(f64[0] - f64[1]).max())
        rate, ch = (PHONE_RATE, 1) if phone else (RATE_192K, 2)
        res[leg] = {"seconds_of_audio": seconds, "wall_s": dt,
                    "cpu_wall_s": cpu_dt, "host_ms_per_s": own,
                    "whole_string_ms_per_s": dt * 1e3 / seconds,
                    "file_bytes": len(got), "equal_to_cpu": got == want,
                    "differing_codes": differ, "f64_max_abs_err": err,
                    "echo_output": echo_payload, "aging_input": aging_in}
        log(f"[codecs] {leg}: {seconds} s of 192 kHz stereo through the "
            f"flagship, rsagingradio and G.711 into a {len(got)} B file of "
            f"{rate} Hz x {ch} S16 codes "
            f"({'equal to' if got == want else 'DIFFERS FROM'} the CPU's, "
            f"{differ} codes differ; F64 before audioconvert max "
            f"|err| {err:.3e}, gate {EDGE_TOL}); {dt:.3f} s on the card "
            f"(tracer on), the CPU {cpu_dt:.3f} s; host ms per second of "
            f"audio: " + ", ".join(f"{k} {v:.2f}" for k, v in own.items())
            + f", the whole string {dt * 1e3 / seconds:.1f}; the echo's "
            f"output: {echo_payload}; rsagingradio fed: {aging_in}  [{smi}]")
        if echo_payload != "tensor on cuda":
            raise AssertionError(f"the echo's output lies on {echo_payload}, "
                                 f"not the card")
        if len(got) != 2 * ch * round(seconds * rate) or not np.isfinite(
                f64[0]).all() or err > EDGE_TOL:
            raise AssertionError(f"{leg}: {len(got)} B of codes or the F64 "
                                 f"samples outside the gate")
        if got != want:
            raise AssertionError(f"{leg}: the card's G.711 file differs from "
                                 f"the CPU's in {differ} codes")

    # the in-place path on a card payload: the echo hands rsagingradio a
    # CUDA tensor, which it reads through AudioInfo.view and replaces
    # with a host array
    x = edge_signal(PHONE_SECONDS, RATE_192K).astype(np.float64) / 32768.0
    launch = (f'appsrc name=src caps="{caps}" ! rsaudioecho name=echo '
              f'delay=250000000 intensity={AUDIO_INTENSITY} '
              f'feedback={AUDIO_FEEDBACK} ! rsagingradio ! appsink name=out')
    tracer = push_tracer()
    tracer.install()
    try:
        p, _, card_out, _ = run_string(gstpu_torch, "cuda", launch, ("out",),
                                       feed_blocks(gstpu_torch, x, RATE_192K))
    finally:
        tracer.uninstall()
    fed = tracer.payload.get(p.get_by_name("echo").static_pad("src"))
    _, _, cpu_out, _ = run_string(gstpu_torch, "cpu", launch, ("out",),
                                  feed_blocks(gstpu_torch, x, RATE_192K))
    same = [b.to_bytes() for b in card_out["out"]] == \
        [b.to_bytes() for b in cpu_out["out"]]
    res["in_place"] = {"fed": fed, "equal_to_cpu": same}
    log(f"[codecs] `rsaudioecho ! rsagingradio`: the filter fed {fed}, its "
        f"output {'equal to' if same else 'DIFFERS FROM'} the CPU's")
    if not same or fed != "tensor on cuda":
        raise AssertionError("rsagingradio on the echo's card payload")
    return res


def cdg_packets(rng, n: int) -> bytes:
    """`n` seeded CD+G packets as tests/test_cdg.py builds them: both
    colour tables, memory and border presets, normal and XOR tiles,
    scrolls, and packets that are not CD+G commands."""
    from gstpu_torch.codecs import cdg

    def pkt(insn: int, data: bytes) -> bytes:
        return bytes([cdg.CMD_CDG, insn, 0, 0]) + data.ljust(16, b"\0") \
            + bytes(4)

    def table(insn: int) -> bytes:
        rgb = rng.integers(0, 16, (8, 3))
        data = bytearray()
        for r, g, b in rgb:
            data += bytes([((r << 2) | (g >> 2)) & 0x3F,
                           (((g & 3) << 4) | b) & 0x3F])
        return pkt(insn, bytes(data))

    out = [table(cdg.INSN_COLORS_LOW), table(cdg.INSN_COLORS_HIGH),
           pkt(cdg.INSN_MEMORY_PRESET, bytes([3, 0]))]
    while len(out) < n:
        k = rng.random()
        if k < 0.6:
            insn = (cdg.INSN_TILE_XOR if rng.random() < 0.4
                    else cdg.INSN_TILE_NORMAL)
            out.append(pkt(insn, bytes(
                [*rng.integers(0, 16, 2), rng.integers(0, 18),
                 rng.integers(0, 50), *rng.integers(0, 64, 12)])))
        elif k < 0.7:
            insn = (cdg.INSN_SCROLL_COPY if rng.random() < 0.5
                    else cdg.INSN_SCROLL_PRESET)
            out.append(pkt(insn, bytes(
                [rng.integers(0, 16),
                 (rng.integers(0, 3) << 4) | rng.integers(0, 6),
                 (rng.integers(0, 3) << 4) | rng.integers(0, 12)])))
        elif k < 0.75:
            out.append(table(cdg.INSN_COLORS_LOW if rng.random() < 0.5
                             else cdg.INSN_COLORS_HIGH))
        elif k < 0.8:
            out.append(pkt(cdg.INSN_MEMORY_PRESET, bytes(
                [rng.integers(0, 16), rng.integers(0, 2)])))
        elif k < 0.85:
            out.append(pkt(cdg.INSN_BORDER_PRESET,
                           bytes([rng.integers(0, 16)])))
        else:
            out.append(bytes(24))
    return b"".join(out)


def codecs_cdg_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """14c. A seeded CD+G file through `filesrc ! cdgparse ! cdgdec ! queue
    ! videoconvert ! RGBA ! hsvfilter ! colorlut ! appsink` (13b's grade)
    on the card: each kernel once a decoded frame, every frame the CPU's.
    The queue: without it `cdgdec`'s caps query (gstpu's, as it stands)
    refuses raw video downstream."""
    f = tmp / "karaoke.cdg"
    f.write_bytes(cdg_packets(np.random.default_rng(SEED), CDG_PACKETS))
    cube = tmp / "cdg.cube"
    write_cube(cube, np.random.default_rng(SEED))
    launch = (f"filesrc location={f} ! video/x-cdg ! cdgparse ! cdgdec ! "
              f"queue ! videoconvert ! video/x-raw, format=RGBA ! hsvfilter "
              f"{GRADE_HSV} ! colorlut location={cube} ! appsink name=out")
    for k in kernels:
        k.launches = 0
    _, dt, card_out, _ = run_string(gstpu_torch, "cuda", launch, ("out",))
    launches = {k.name: k.launches for k in kernels}
    _, cpu_dt, cpu_out, _ = run_string(gstpu_torch, "cpu", launch, ("out",))
    frames = [(b.to_bytes(), b.pts) for b in card_out["out"]]
    same = frames == [(b.to_bytes(), b.pts) for b in cpu_out["out"]]
    kinds = sorted({payload_kind(b.data) for b in card_out["out"]})
    res = {"packets": CDG_PACKETS, "frames": len(frames), "wall_s": dt,
           "cpu_wall_s": cpu_dt, "fps": len(frames) / dt,
           "launches": launches, "equal_to_cpu": same, "output": kinds}
    log(f"[codecs] CD+G: {CDG_PACKETS} seeded packets into {len(frames)} "
        f"frames of 300x216 through both kernels in {dt:.3f} s "
        f"({res['fps']:.2f} fps; the CPU {cpu_dt:.3f} s); launches "
        f"{launches}; {kinds}; {'equal to' if same else 'DIFFER FROM'} the "
        f"CPU's  [{smi}]")
    if not same or len(frames) < CDG_PACKETS // 4:
        raise AssertionError("the CD+G frames differ from the CPU's")
    if kinds != ["tensor on cuda"]:
        raise AssertionError(f"the graded CD+G frames lie on {kinds}")
    if any(n != len(frames) for n in launches.values()):
        raise AssertionError(f"the kernels launched {launches} times for "
                             f"{len(frames)} frames")
    return res


def codecs_shim_phase(gstpu_torch, smi, tmp: Path) -> dict:
    """14d, where the codec shim links libavcodec: `vp8enc ! vp8dec` and
    `vp9enc ! vp9dec` behind 13b's grade at 1080p, and `opusenc ! opusdec`
    behind the echo at 48 kHz, the card's packets and frames byte for
    byte the CPU's."""
    cube = tmp / "vpx.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res = {}
    for codec in ("vp8", "vp9"):
        launch = (f"videotestsrc num-buffers={VPX_FRAMES} pattern=snow ! "
                  f"video/x-raw, format=RGBA, width={EDGE_W}, height={EDGE_H},"
                  f" framerate=30/1 ! hsvfilter {GRADE_HSV} ! colorlut "
                  f"location={cube} ! videoconvert ! video/x-raw, format=I420 "
                  f"! {codec}enc deadline=1 cpu-used=8 ! tee name=t ! "
                  f"{codec}dec ! appsink name=frames ! t. ! appsink name=pkts")
        runs = [run_string(gstpu_torch, d, launch, ("pkts", "frames"))
                for d in ("cuda", "cpu")]
        outs = [{k: [(b.to_bytes(), b.pts, int(b.flags)) for b in v]
                 for k, v in r[2].items()} for r in runs]
        res[codec] = {"frames": VPX_FRAMES, "fps": VPX_FRAMES / runs[0][1],
                      "equal_to_cpu": outs[0] == outs[1],
                      "bytes": sum(len(b[0]) for b in outs[0]["pkts"])}
    x = edge_signal(OPUS_SECONDS, OPUS_RATE).astype(np.float64) / 32768.0
    launch = (f'appsrc name=src caps="audio/x-raw, format=F64LE, rate='
              f'{OPUS_RATE}, channels=2, layout=interleaved" ! rsaudioecho '
              f'delay=250000000 intensity={AUDIO_INTENSITY} feedback='
              f'{AUDIO_FEEDBACK} ! audioconvert ! audio/x-raw, format=F32LE ! '
              f'opusenc ! tee name=t ! opusdec ! appsink name=pcm ! t. ! '
              f'appsink name=pkts')
    runs = [run_string(gstpu_torch, d, launch, ("pkts", "pcm"),
                       feed_blocks(gstpu_torch, x, OPUS_RATE))
            for d in ("cuda", "cpu")]
    outs = [{k: [(b.to_bytes(), b.pts) for b in v] for k, v in r[2].items()}
            for r in runs]
    res["opus"] = {"seconds": OPUS_SECONDS, "equal_to_cpu": outs[0] == outs[1],
                   "packets": len(outs[0]["pkts"])}
    log(f"[codecs] the codec shim's strings, card vs CPU: {res}  [{smi}]")
    if not all(v["equal_to_cpu"] for v in res.values()):
        raise AssertionError("a VP8, VP9 or Opus stream differs from the "
                             "CPU's")
    return res


def codecs_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """14. The host codecs and images behind the card's chains. Strings a
    missing library stops are named, not run."""
    libs = codec_libraries(gstpu_torch)
    skipped = []
    if not libs["PIL"]:
        skipped.append(("14a `... ! tee ! rspngenc ! filesink`", "PIL"))
    if not libs["libavcodec"]:
        skipped += [(f"14d `... ! {s}`", "libavcodec, which the codec "
                     "shim links")
                    for s in ("vp8enc ! vp8dec", "vp9enc ! vp9dec",
                              "opusenc ! opusdec")]
    res = {"libraries": libs,
           "video": codecs_video_phase(gstpu_torch, smi, tmp, kernels,
                                       libs["PIL"]),
           "audio": codecs_audio_phase(gstpu_torch, smi, tmp),
           "cdg": codecs_cdg_phase(gstpu_torch, smi, tmp, kernels)}
    if libs["libavcodec"]:
        res["shim"] = codecs_shim_phase(gstpu_torch, smi, tmp)
    for string, lib in skipped:
        log(f"[codecs] not run: {string}, for want of {lib}")
    res["not_run"] = [f"{s}: no {lib}" for s, lib in skipped]
    return res


def on_pad_added(element, name: str, sinkpad) -> None:
    """Link `element`'s sometimes pad `name` to `sinkpad` the moment the
    element adds it, before anything is pushed through it (the port's
    elements emit no pad-added signal)."""
    add = element.add_pad

    def add_and_link(pad):
        add(pad)
        if pad.name == name:
            pad.link(sinkpad)
        return pad

    element.add_pad = add_and_link


class ArrayCalls:
    """Counts the port's `Buffer.array` calls by the element whose method
    made the call and the buffer's pts while the `with` block runs, and
    apart those on a tensor payload (a download where it lies on a
    card)."""

    def __enter__(self):
        from gstpu_torch.core.buffer import Buffer
        from gstpu_torch.core.element import Element
        self.counts: dict = {}
        self.tensor_calls: dict = {}
        self._prop = Buffer.__dict__["array"]
        getter = self._prop.fget

        def array(buf):
            f = sys._getframe(1)
            while f is not None and not isinstance(f.f_locals.get("self"),
                                                   Element):
                f = f.f_back
            el = f.f_locals["self"].name if f is not None else None
            self.counts[el, buf.pts] = self.counts.get((el, buf.pts), 0) + 1
            if isinstance(buf.data, torch.Tensor):
                self.tensor_calls[el] = self.tensor_calls.get(el, 0) + 1
            return getter(buf)

        Buffer.array = property(array)
        return self

    def __exit__(self, *exc) -> None:
        from gstpu_torch.core.buffer import Buffer
        Buffer.array = self._prop

    def by_element(self) -> dict:
        out: dict = {}
        for (el, _), n in self.counts.items():
            out[el] = out.get(el, 0) + n
        return out

    def of(self, element: str, pts) -> int:
        return self.counts.get((element, pts), 0)


def caption_string(gstpu_torch, kind: str, cube: Path, n: int, texts):
    """One of 15a's strings at BASELINE config 4's 1080p RGBA through 13b's
    grade, for `run_string`: the video string into the combiner `comb`;
    `build`, which adds the caption branch from `appsrc name=src` and
    links its last element into `comb` (and, for ST 2038, the
    extractor's anc pad into `st2038anctocc`); and `feed`, which pushes
    the texts at their frames' pts, then EOS."""
    video = (f"videotestsrc num-buffers={n} pattern=snow ! video/x-raw, "
             f"format=RGBA, width={EDGE_W}, height={EDGE_H}, framerate=30/1 "
             f"! hsvfilter name=hsv {GRADE_HSV} ! colorlut name=lut "
             f"location={cube}")
    text = 'appsrc name=src caps="text/x-raw, format=utf8"'
    cdp = (f'{text} ! tttocea708 name=tt ! cea708mux name=mux '
           f'framerate-code=5 ! capsfilter name=cdp caps="closedcaption/'
           f'x-cea-708, format=cdp"')
    branch, last = {"608": (f"{text} ! tttocea608 name=tt", "tt"),
                    "708": (cdp, "cdp"),
                    "st2038": (f"{cdp} ! cctost2038anc name=anc", "anc")}[kind]
    tail = {"608": "cea608overlay name=ov ! appsink name=out",
            "708": "cea708overlay name=ov ! appsink name=out",
            "st2038": "st2038extractor name=ex ! appsink name=out"}[kind]
    combiner = "st2038combiner" if kind == "st2038" else "cccombiner"
    dur = 10 ** 9 // 30

    def build(p) -> None:
        gstpu_torch.parse_launch(branch, pipeline=p)
        p.get_by_name(last).link(p.get_by_name("comb"))
        if kind == "st2038":
            gstpu_torch.parse_launch("st2038anctocc name=a2c ! appsink "
                                     "name=cc", pipeline=p)
            on_pad_added(p.get_by_name("ex"), "anc",
                         p.get_by_name("a2c").static_pad("sink"))

    def feed(p) -> None:
        src = p.get_by_name("src")
        for t, frame in texts:
            src.push_buffer(gstpu_torch.Buffer(t.encode(), pts=frame * dur,
                                               duration=dur))
        src.end_of_stream()

    return f"{video} ! {combiner} name=comb ! {tail}", build, feed


def buffer_record(b) -> tuple:
    """A buffer's bytes, times and metas, the metas as plain values."""
    return (b.to_bytes(), b.pts, b.duration,
            [(type(m).__name__, dict(vars(m))) for m in b.metas])


def strip_frames(kind: str, frames) -> list:
    """Which output frames carry a burned-in caption, read from their
    caption metas alone: a 608 strip from the last text its pairs decode
    to until an empty one erases it, a 708 window while one is visible."""
    from gstpu_torch.codecs.cea608 import Cea608Decoder
    from gstpu_torch.codecs.cea708 import parse_cdp
    from gstpu_torch.codecs.dtvcc import DtvccDecoder
    from gstpu_torch.core.video import VideoCaptionMeta
    dec, dtvcc, text, out = Cea608Decoder(), DtvccDecoder(), None, []
    for b in frames:
        for m in b.metas:
            if not isinstance(m, VideoCaptionMeta):
                continue
            if kind == "608":
                for i in range(0, len(m.data) - 1, 2):
                    t = dec.push_pair(m.data[i:i + 2])
                    text = t if t is not None else text
            else:
                dtvcc.feed_cc_data(parse_cdp(m.data).cc_data)
        out.append(bool(text) if kind == "608"
                   else bool(dtvcc.visible_windows(1)))
    return out


def captions_video_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """15a. BASELINE config 4's 1080p RGBA, 16 frames, through 13b's grade
    on the card into `cccombiner` fed `appsrc ! tttocea608` and
    `cea608overlay`; into `cccombiner` fed `tttocea708 ! cea708mux` CDP
    and `cea708overlay`; and into `st2038combiner` fed that CDP through
    `cctost2038anc`, then `st2038extractor`, its anc pad into
    `st2038anctocc`. Each string's outputs, metas and messages equal the
    CPU run's, each kernel launches once a frame, the combiners call
    `Buffer.array` on no frame and an overlay once on each frame that
    its metas put a caption on (those frames leave it as host arrays,
    the others as CUDA tensors). fps, and each element's host ms a frame
    under the pad-push tracer."""
    cube = tmp / "captions.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res = {}
    for kind, texts in (("608", CAPTIONS_608), ("708", CAPTIONS_708),
                        ("st2038", CAPTIONS_708)):
        sinks = ("out", "cc") if kind == "st2038" else ("out",)
        warm, build, feed = caption_string(gstpu_torch, kind, cube, 1, texts)
        run_string(gstpu_torch, "cuda", warm, sinks, feed, build)
        launch, build, feed = caption_string(gstpu_torch, kind, cube,
                                             CAPTION_FRAMES, texts)
        tracer = push_tracer()
        for k in kernels:
            k.launches = 0
        tracer.install()
        try:
            with ArrayCalls() as calls:
                p, dt, card, card_msgs = run_string(
                    gstpu_torch, "cuda", launch, sinks, feed, build)
        finally:
            tracer.uninstall()
        launches = {k.name: k.launches for k in kernels}
        names = ["hsv", "lut", "comb"] + {
            "608": ["ov", "tt"], "708": ["ov", "tt", "mux"],
            "st2038": ["ex", "a2c", "tt", "mux", "anc"]}[kind]
        per_frame = own_ms(tracer, p, names, CAPTION_FRAMES)
        launch, build, feed = caption_string(gstpu_torch, kind, cube,
                                             CAPTION_FRAMES, texts)
        _, cpu_dt, cpu, cpu_msgs = run_string(gstpu_torch, "cpu", launch,
                                              sinks, feed, build)
        kinds = [payload_kind(b.data) for b in card["out"]]
        same = {s: [buffer_record(b) for b in card[s]]
                == [buffer_record(b) for b in cpu[s]] for s in sinks}
        same["messages"] = card_msgs == cpu_msgs
        frames = card["out"]
        r = {"frames": len(frames), "fps": CAPTION_FRAMES / dt,
             "cpu_fps": CAPTION_FRAMES / cpu_dt, "launches": launches,
             "host_ms_a_frame": per_frame, "equal_to_cpu": same,
             "array_calls": calls.by_element(),
             "array_calls_on_tensors": calls.tensor_calls, "payloads": kinds}
        if kind == "st2038":
            from gstpu_torch.codecs.cea708 import (ccdata_split,
                                                   parse_cdp, parse_dtvcc,
                                                   service_block_text)
            got = []
            for b in card["cc"]:
                for pkt in ccdata_split(parse_cdp(b.to_bytes()).cc_data)[1]:
                    got += [service_block_text(d)
                            for _, d in parse_dtvcc(pkt)[1]]
            r["anc_packets"] = len(card["cc"])
            r["captions_back"] = got
            bad = (got != [t for t, _ in texts] or r["anc_packets"] == 0
                   or kinds != ["tensor on cuda"] * CAPTION_FRAMES)
        else:
            strips = strip_frames(kind, frames)
            r["strip_frames"] = [i for i, s in enumerate(strips) if s]
            r["overlay_calls"] = [calls.of("ov", b.pts) for b in frames]
            bad = (r["overlay_calls"] != [int(s) for s in strips]
                   or not any(strips) or all(strips)
                   or kinds != ["ndarray" if s else "tensor on cuda"
                                for s in strips])
        res[kind] = r
        log(f"[captions] {kind}: {len(frames)} frames of {EDGE_W}x{EDGE_H} "
            f"RGBA, {r['fps']:.3f} fps on the card (tracer on), "
            f"{r['cpu_fps']:.3f} on the CPU; launches {launches}; "
            f"Buffer.array calls {r['array_calls']} (on tensors "
            f"{r['array_calls_on_tensors']})"
            + (f", the overlay's by frame {r['overlay_calls']} (caption on "
               f"frames {r['strip_frames']})" if "strip_frames" in r else
               f"; {r['anc_packets']} ANC packets out of the extractor, "
               f"captions back {r['captions_back']}")
            + f"; host ms a frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items())
            + f"; equal to the CPU: {same}  [{smi}]")
        if not all(same.values()) or len(frames) != CAPTION_FRAMES:
            raise AssertionError(f"phase 15a's {kind} string differs from "
                                 f"the CPU's: {same}")
        if any(n != CAPTION_FRAMES for n in launches.values()):
            raise AssertionError(f"the kernels launched {launches} times, "
                                 f"not once a frame")
        if r["array_calls"].get("comb", 0) != 0:
            raise AssertionError(f"the {kind} combiner read the payload: "
                                 f"{r['array_calls']}")
        if bad:
            raise AssertionError(f"phase 15a's {kind} string: {r}")
    return res


def images_phase(gstpu_torch, smi, tmp: Path, kernels,
                 have_webp: bool) -> dict:
    """15b. The graded 1080p frames through the PIL image elements on the
    card and on the CPU, every output byte equal: `rspngenc !
    imagedecoder`, `gifenc ! gifdec`, `imageoverlay` of a seeded RGBA PNG
    over the card's frames, and (where PIL writes WebP) a graded frame of
    the card's written as a lossless WebP and read back through `filesrc
    ! image/webp ! rswebpdec`, equal to that frame. Each kernel launches
    once a frame."""
    from PIL import Image
    cube = tmp / "images.cube"
    write_cube(cube, np.random.default_rng(SEED))
    rng = np.random.default_rng(SEED + 15)
    overlay = tmp / "overlay.png"
    Image.fromarray(rng.integers(0, 256, (240, 480, 4), np.uint8),
                    "RGBA").save(overlay)
    grade = (f"videotestsrc num-buffers={IMAGE_FRAMES} pattern=snow ! "
             f"video/x-raw, format=RGBA, width={EDGE_W}, height={EDGE_H}, "
             f"framerate=30/1 ! hsvfilter {GRADE_HSV} ! colorlut "
             f"location={cube}")
    strings = {
        "rspngenc ! imagedecoder": (f"{grade} ! rspngenc name=enc ! "
                                    f"imagedecoder name=dec ! appsink "
                                    f"name=out", ["enc", "dec"]),
        "gifenc ! gifdec": (f"{grade} ! gifenc name=enc ! gifdec name=dec ! "
                            f"appsink name=out", ["enc", "dec"]),
        "imageoverlay": (f"{grade} ! imageoverlay name=ov location={overlay}"
                         f" offset-x=1700 offset-y=900 ! appsink name=out",
                         ["ov"]),
    }
    res, launches = {}, {k.name: 0 for k in kernels}
    for name, (launch, elements) in strings.items():
        tracer = push_tracer()
        for k in kernels:
            k.launches = 0
        tracer.install()
        try:
            p, dt, card, _ = run_string(gstpu_torch, "cuda", launch, ("out",))
        finally:
            tracer.uninstall()
        n = {k.name: k.launches for k in kernels}
        _, cpu_dt, cpu, _ = run_string(gstpu_torch, "cpu", launch, ("out",))
        same = ([buffer_record(b) for b in card["out"]]
                == [buffer_record(b) for b in cpu["out"]])
        res[name] = {"frames": len(card["out"]), "wall_s": dt,
                     "cpu_wall_s": cpu_dt, "launches": n,
                     "host_ms_a_frame": own_ms(tracer, p, elements,
                                               IMAGE_FRAMES),
                     "equal_to_cpu": same}
        log(f"[images] {name}: {IMAGE_FRAMES} graded {EDGE_W}x{EDGE_H} "
            f"frames in {dt:.3f} s on the card, {cpu_dt:.3f} s on the CPU; "
            f"launches {n}; host ms a frame "
            f"{res[name]['host_ms_a_frame']}; "
            f"{'equal to' if same else 'DIFFER FROM'} the CPU's  [{smi}]")
        if not same or not card["out"]:
            raise AssertionError(f"15b `{name}` differs from the CPU's")
        if any(v != IMAGE_FRAMES for v in n.values()):
            raise AssertionError(f"the kernels launched {n} times for "
                                 f"{IMAGE_FRAMES} frames")
        for k, v in n.items():
            launches[k] += v
    name = "filesrc ! image/webp ! rswebpdec"
    if have_webp:
        for k in kernels:
            k.launches = 0
        _, _, graded, _ = run_string(gstpu_torch, "cuda", grade.replace(
            f"num-buffers={IMAGE_FRAMES}", "num-buffers=1")
            + " ! appsink name=out", ("out",))
        for k in kernels:
            launches[k.name] += k.launches
        frame = graded["out"][0].array.reshape(EDGE_H, EDGE_W, 4)
        webp = tmp / "graded.webp"
        Image.fromarray(frame, "RGBA").save(webp, format="WEBP",
                                            lossless=True, exact=True)
        launch = (f"filesrc location={webp} ! image/webp ! rswebpdec ! "
                  f"appsink name=out")
        outs = [run_string(gstpu_torch, d, launch, ("out",))
                for d in ("cuda", "cpu")]
        recs = [[buffer_record(b) for b in o[2]["out"]] for o in outs]
        back = bool(recs[0]) and recs[0][0][0] == frame.tobytes()
        same = recs[0] == recs[1]
        res[name] = {"frames": len(recs[0]), "wall_s": outs[0][1],
                     "webp_bytes": webp.stat().st_size,
                     "equal_to_cpu": same, "equal_to_graded_frame": back}
        log(f"[images] {name}: a graded frame of the card's as a "
            f"{res[name]['webp_bytes']} B lossless WebP, decoded in "
            f"{outs[0][1]:.3f} s: {'equal to' if back else 'DIFFERS FROM'} "
            f"the frame, {'equal to' if same else 'DIFFERS FROM'} the CPU's"
            f"  [{smi}]")
        if not back or not same:
            raise AssertionError("15b's WebP frame differs")
    else:
        log(f"[images] not run: {name}, for want of PIL's WebP support")
        res["not_run"] = [f"{name}: PIL without WebP"]
    res["launches"] = launches
    return res


def captions_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """15. Captions on the card's 1080p grade (the overlays draw with PIL),
    and the PIL image elements behind it. The WebP string, where PIL
    lacks WebP, is named and not run."""
    from PIL import features
    return {"video": captions_video_phase(gstpu_torch, smi, tmp, kernels),
            "images": images_phase(gstpu_torch, smi, tmp, kernels,
                                   bool(features.check("webp")))}


def grade_strings(w: int, h: int, n: int, cube: Path) -> tuple:
    """13b's grade at w x h on n snow frames: the source, and the two
    kernels' elements."""
    return (f"videotestsrc num-buffers={n} pattern=snow ! video/x-raw, "
            f"format=RGBA, width={w}, height={h}, framerate=30/1",
            f"hsvfilter name=hsv {GRADE_HSV} ! colorlut name=lut "
            f"location={cube}")


def plumbing_strings(w: int, h: int, n: int, cube: Path) -> dict:
    """16a's strings, each name to (its string, the consumer string of an
    inter bridge or None, the new elements in them). `direct` and `source`
    are the references; `appsrc ! originalbuffersave ...` is fed the
    source's frames on the grade's device."""
    src, grade = grade_strings(w, h, n, cube)
    caps = f"video/x-raw, format=RGBA, width={w}, height={h}, framerate=30/1"
    save = (f"originalbuffersave name=save ! {grade} ! originalbufferrestore "
            f"name=restore ! appsink name=out")
    return {
        "direct": (f"{src} ! {grade} ! appsink name=out", None, []),
        "intersink ! intersrc": (
            f"{src} ! {grade} ! intersink name=isink producer-name=grade",
            "intersrc name=isrc producer-name=grade ! appsink name=out",
            ["isink", "isrc"]),
        "ts-blocking-adapter ! ts-queue": (
            f"{src} ! {grade} ! ts-blocking-adapter name=ba ! ts-queue "
            f"name=q ! appsink name=out", None, ["ba", "q"]),
        "source": (f"{src} ! appsink name=out", None, []),
        "originalbuffersave ! ... ! originalbufferrestore": (
            f"{src} ! {save}", None, ["save", "restore"]),
        "appsrc ! originalbuffersave ! ... ! originalbufferrestore": (
            f'appsrc name=src caps="{caps}" ! {save}', None,
            ["save", "restore"]),
    }


def run_plumbing(gstpu_torch, device: str, launch: str, consumer=None,
                 frames=()) -> tuple:
    """One of 16a's strings to its end on `device`: `frames` pushed into
    its appsrc, an inter bridge's consumer pipeline on a `run_async`
    thread while the producer runs on this one. The pipelines (in NULL),
    the wall seconds and the buffers of the appsink `out`."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    pipes = [gstpu_torch.parse_launch(launch)]
    if consumer is not None:
        pipes.append(gstpu_torch.parse_launch(consumer))
    for p in reversed(pipes):     # the consumer registers first
        p.set_state(State.PLAYING)
    t0 = time.perf_counter()
    thread = pipes[1].run_async() if consumer is not None else None
    src = pipes[0].get_by_name("src")
    for b in frames:
        src.push_buffer(gstpu_torch.Buffer(b.data, pts=b.pts,
                                           duration=b.duration))
    if src is not None:
        src.end_of_stream()
    pipes[0].run(timeout=600)
    if thread is not None:
        thread.join(600)
        if thread.is_alive():
            raise AssertionError(f"the consumer of `{launch}` did not end")
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = pipes[-1].get_by_name("out").pull_all()
    for p in pipes:
        p.set_state(State.NULL)
    return pipes, dt, out


def plumbing_bridge_phase(gstpu_torch, smi, cube: Path, kernels) -> dict:
    """16a. bench_video.py's 4K RGBA, 16 frames, through the grade on the
    card into `intersink`, read by a second pipeline's `intersrc` on its
    own thread; into `ts-blocking-adapter ! ts-queue` (the adapter pushes
    from its thread); and between `originalbuffersave` and
    `originalbufferrestore`, fed by videotestsrc's host frames and by
    those frames on the card. Every frame out of a bridge is the direct
    string's, bit for bit and on the card; the restored frames are the
    source's, bit for bit, where they came in; no new element calls
    `Buffer.array`; each kernel launches once a frame. fps and each
    element's host ms a frame; the device ms of the save's clone of one
    4K frame against its bytes bound."""
    strings = plumbing_strings(W, H, PLUMBING_FRAMES, cube)
    warm = plumbing_strings(W, H, 1, cube)["direct"][0]
    run_plumbing(gstpu_torch, "cuda", warm)
    res, outs, launches = {}, {}, {k.name: 0 for k in kernels}
    for name, (launch, consumer, names) in strings.items():
        feed = ()
        if name.startswith("appsrc"):
            dev = outs["direct"][0].data.device
            feed = [gstpu_torch.Buffer(torch.from_numpy(b.data).to(dev),
                                       pts=b.pts, duration=b.duration)
                    for b in outs["source"]]
        tracer = push_tracer()
        for k in kernels:
            k.launches = 0
        tracer.install()
        try:
            with ArrayCalls() as calls:
                pipes, dt, out = run_plumbing(gstpu_torch, "cuda", launch,
                                              consumer, feed)
        finally:
            tracer.uninstall()
        n = {k.name: k.launches for k in kernels}
        own = {}
        for p in pipes:
            own.update(own_ms(tracer, p, [x for x in names
                                          if p.get_by_name(x) is not None],
                              PLUMBING_FRAMES))
        outs[name] = out
        reads = calls.by_element()
        r = {"frames": len(out), "fps": PLUMBING_FRAMES / dt,
             "launches": n, "host_ms_a_frame": own,
             "array_calls": {x: reads.get(x, 0) for x in names},
             "payloads": sorted({payload_kind(b.data) for b in out})}
        if name in ("direct", "source"):
            want = None
        elif name.startswith("appsrc"):
            want = feed
            r["the input tensor itself"] = sum(
                b.data is f.data for b, f in zip(out, feed))
        elif name.startswith("originalbuffersave"):
            want = outs["source"]
        else:
            want = outs["direct"]
        if want is not None:
            r["equal"] = len(out) == len(want) and all(
                type(b.data) is type(f.data) and b.pts == f.pts
                and (torch.equal(b.data, f.data)
                     if isinstance(b.data, torch.Tensor)
                     else np.array_equal(b.data, f.data))
                for b, f in zip(out, want))
        res[name] = r
        log(f"[plumbing] {name}: {len(out)} frames of {W}x{H} RGBA, "
            f"{r['fps']:.3f} fps (tracer on); launches {n}; payloads "
            f"{r['payloads']}; Buffer.array calls {r['array_calls']}; host "
            f"ms a frame " + ", ".join(f"{k} {v:.4f}" for k, v in own.items())
            + (f"; bit for bit the {'input' if feed else 'reference'}'s: "
               f"{r['equal']}" if "equal" in r else "") + f"  [{smi}]")
        if len(out) != PLUMBING_FRAMES or any(r["array_calls"].values()):
            raise AssertionError(f"16a `{name}`: {r}")
        if name != "source" and any(v != PLUMBING_FRAMES
                                     for v in n.values()):
            raise AssertionError(f"16a `{name}`: the kernels launched {n} "
                                 f"times, not once a frame")
        if "equal" in r and not r["equal"]:
            raise AssertionError(f"16a `{name}` differs from its reference")
        want_kind = ("ndarray" if name.startswith("originalbuffersave")
                     or name == "source" else "tensor on cuda")
        if r["payloads"] != [want_kind]:
            raise AssertionError(f"16a `{name}` gave {r['payloads']}")
        if feed and r["the input tensor itself"]:
            raise AssertionError("16a: originalbufferrestore handed on the "
                                 "input tensor, not the saved copy")
        if name not in ("direct", "source"):
            for k in kernels:
                launches[k.name] += n[k.name]
    frame = outs["direct"][0].data
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=frame.device)
    clone_bytes = 2 * frame.numel() * frame.element_size()
    res["save_clone"] = {"ms": time_ms(lambda: frame.clone(), flush),
                         "bound_ms": clone_bytes / HBM_BYTES_PER_S * 1e3,
                         "bytes": clone_bytes}
    log(f"[plumbing] originalbuffersave's clone of one {W}x{H} RGBA frame on "
        f"the card: {res['save_clone']['ms']:.4f} ms, bound "
        f"{res['save_clone']['bound_ms']:.4f} ms ({clone_bytes} B read and "
        f"written)  [{smi}]")
    res["launches"] = launches
    return res


def supervise_run(gstpu_torch, device: str, w: int, h: int,
                  cube: Path) -> dict:
    """16b on `device` at w x h: the grade's frames as the pipeline makes
    them, one a scheduler round, into `fallbackswitch timeout=1s`, whose
    second pad a feeder pad serves videotestsrc's solid blue host frames,
    under a TestClock: 6 healthy frames (the backup's dropped), 2 s with
    no main frame (4 backup frames go out), then the main pad's 10 more
    (the backup's dropped); and into `togglerecord`, the frames marked a
    GOP of 4 as they enter and `record` toggled before frames 2, 9 and 11.
    Each string's output as (source, input index, pts, flags), the
    switch's messages, whether each output holds the very payload that
    came in, the payloads' kinds and the strings' wall seconds."""
    def mod(name: str):
        return importlib.import_module(f"{gstpu_torch.__name__}.{name}")
    el, ev, bufmod = mod("core.element"), mod("core.event"), mod("core.buffer")
    clk, caps_mod = mod("core.clock"), mod("core.caps")
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    caps = f"video/x-raw, format=RGBA, width={w}, height={h}, framerate=30/1"
    src, grade = grade_strings(w, h, PLUMBING_FRAMES, cube)
    dur = 10 ** 9 // 30
    bp = gstpu_torch.parse_launch(
        f"videotestsrc num-buffers={PLUMBING_FRAMES + SWITCH_BACKUP} "
        f"pattern=blue ! {caps} ! appsink name=out")
    bp.set_state(State.PLAYING)
    bp.run(timeout=600)
    backup = bp.get_by_name("out").pull_all()
    bp.set_state(State.NULL)

    def probe(pad, seen, mark=None):
        orig = pad.chain_function

        def chain(pad_, buf):
            if mark is not None:
                mark(len(seen), buf)
            seen.append(buf.data)
            return orig(pad_, buf)
        pad.chain_function = chain

    def one_frame(p, seen) -> None:
        n = len(seen)
        while len(seen) == n:
            if not p.iterate():
                raise AssertionError("16b: the grade stopped early")

    def records(out, sources) -> list:
        rec = []
        for b in out:
            where = next((name, i) for name, seen in sources.items()
                         for i, d in enumerate(seen) if d is b.data)
            rec.append((*where, b.pts, int(b.flags)))
        return rec

    res, t0 = {}, time.perf_counter()
    clock = clk.TestClock()
    p = gstpu_torch.parse_launch(f"{src} ! {grade} ! fallbackswitch name=sw "
                                 f"timeout={SWITCH_TIMEOUT} ! appsink name=out")
    sw = p.get_by_name("sw")
    sw.clock = clock
    main_in, backup_in = [], []
    probe(sw.pads["sink_0"], main_in)
    feeder = el.Pad("backup", el.PadDirection.SRC, el.PadTemplate(
        "src", el.PadDirection.SRC, el.PadPresence.ALWAYS,
        caps_mod.Caps.any()))
    feeder.link(sw.request_pad())
    probe(sw.pads["sink_1"], backup_in)
    p.set_state(State.PLAYING)
    feeder.push_event(ev.StreamStartEvent("backup"))
    feeder.push_event(ev.CapsEvent(caps_mod.parse_caps(caps)))
    feeder.push_event(ev.SegmentEvent(ev.Segment()))
    k = 0
    for phase, frames in (("healthy", SWITCH_HEALTHY), ("outage", 0),
                          ("recovery", PLUMBING_FRAMES - SWITCH_HEALTHY)):
        if phase == "outage":
            clock.advance(SWITCH_OUTAGE_NS)
            for _ in range(SWITCH_BACKUP):
                clock.advance(dur)
                feeder.push(backup[k])
                k += 1
            continue
        for _ in range(frames):
            clock.advance(dur)
            one_frame(p, main_in)
            feeder.push(backup[k])
            k += 1
    p.run(timeout=600)             # the main pad's EOS waits for the backup's
    feeder.push_event(ev.EosEvent())
    out = p.get_by_name("out").pull_all()
    msgs = [(m.name, dict(m.fields)) for m in p.bus.drain()
            if m.type is el.MessageType.ELEMENT]
    p.set_state(State.NULL)
    res["fallbackswitch"] = {
        "records": records(out, {"main": main_in, "backup": backup_in}),
        "messages": [f.get("pad") for _, f in msgs],
        "payloads": [payload_kind(b.data) for b in out]}

    p = gstpu_torch.parse_launch(f"{src} ! {grade} ! togglerecord name=tr ! "
                                 f"appsink name=out")
    tr = p.get_by_name("tr")
    tr_in = []

    def gop(i, buf):
        if i % RECORD_GOP:
            buf.set_flag(bufmod.BufferFlags.DELTA_UNIT)
    probe(tr.static_pad("sink"), tr_in, gop)
    p.set_state(State.PLAYING)
    for i in range(PLUMBING_FRAMES):
        if i in RECORD_TOGGLES:
            tr.set_property("record", RECORD_TOGGLES[i])
        one_frame(p, tr_in)
    p.run(timeout=600)
    out = p.get_by_name("out").pull_all()
    p.set_state(State.NULL)
    res["togglerecord"] = {"records": records(out, {"main": tr_in}),
                           "payloads": [payload_kind(b.data) for b in out]}
    res["wall_s"] = time.perf_counter() - t0
    return res


def plumbing_supervise_phase(gstpu_torch, smi, cube: Path, kernels) -> dict:
    """16b. The supervisors behind the 4K grade on the card under a
    TestClock: each output's source, pts and flags and the switch's
    messages equal the same sequence at 64x48 on the CPU; every main frame
    leaves as the CUDA tensor that came in; neither element calls
    `Buffer.array`; each kernel launches once a frame of each string."""
    for k in kernels:
        k.launches = 0
    with ArrayCalls() as calls:
        card = supervise_run(gstpu_torch, "cuda", W, H, cube)
    n = {k.name: k.launches for k in kernels}
    cpu = supervise_run(gstpu_torch, "cpu", PLUMBING_CHECK_W,
                        PLUMBING_CHECK_H, cube)
    reads = calls.by_element()
    res = {"launches": n, "wall_s": card["wall_s"],
           "array_calls": {x: reads.get(x, 0) for x in ("sw", "tr")}}
    for name in ("fallbackswitch", "togglerecord"):
        c, ref = card[name], cpu[name]
        kinds = {(src, kind) for (src, *_), kind in zip(c["records"],
                                                       c["payloads"])}
        res[name] = {"outputs": len(c["records"]),
                     "equal_to_cpu": c["records"] == ref["records"]
                     and c.get("messages") == ref.get("messages"),
                     "records": c["records"], "messages": c.get("messages"),
                     "payloads": sorted(kinds)}
        log(f"[plumbing] {name}: {len(c['records'])} of the 4K grade's "
            f"frames out (source, input, pts, flags) {c['records']}; "
            f"messages {c.get('messages')}; payloads {sorted(kinds)}; "
            f"equal to the 64x48 CPU sequence: {res[name]['equal_to_cpu']}"
            f"  [{smi}]")
        if not res[name]["equal_to_cpu"] or not c["records"]:
            raise AssertionError(f"16b {name} differs from the CPU's: {c} "
                                 f"vs {ref}")
        if any(src == "main" and kind != "tensor on cuda"
               for src, kind in kinds):
            raise AssertionError(f"16b {name}: a main frame left as {kinds}")
    log(f"[plumbing] the supervisors: launches {n}; Buffer.array calls "
        f"{res['array_calls']}; {card['wall_s']:.3f} s  [{smi}]")
    if any(v != 2 * PLUMBING_FRAMES for v in n.values()):
        raise AssertionError(f"16b: the kernels launched {n} times for 2 x "
                             f"{PLUMBING_FRAMES} frames")
    if any(res["array_calls"].values()):
        raise AssertionError(f"16b: a supervisor read the payload: {res}")
    return res


def sodium_keys(gstpu_torch, *who: str) -> list:
    """Fixed Curve25519 pairs (public, secret) from libsodium, one for each
    party named in `who` (the receiver and the sender when none is)."""
    import ctypes
    import hashlib
    lib = importlib.import_module(
        f"{gstpu_torch.__name__}.elements.generic.sodium")._SODIUM
    lib.crypto_scalarmult_base.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.crypto_scalarmult_base.restype = ctypes.c_int
    pairs = []
    for name in who or ("receiver", "sender"):
        sk = hashlib.sha256(name.encode()).digest()
        pk = ctypes.create_string_buffer(32)
        if lib.crypto_scalarmult_base(pk, sk) != 0:
            raise AssertionError("crypto_scalarmult_base failed")
        pairs.append((pk.raw, sk))
    return pairs


def host_consumer_strings(w: int, h: int, n: int, cube: Path) -> dict:
    """16c's strings, each name to (the grade into the encoder, a tee to
    `mid` and the decoder into `out`; the encoder fed host frames from
    `appsrc name=src` into `mid`)."""
    src, grade = grade_strings(w, h, n, cube)
    caps = f"video/x-raw, format=RGBA, width={w}, height={h}, framerate=30/1"
    pairs = {"flatecompress ! flatedecompress": (
                 "flatecompress name=enc", "flatedecompress name=dec"),
             "brotlicompress ! brotlidecompress": (
                 f"brotlicompress name=enc quality={BROTLI_QUALITY}",
                 "brotlidecompress name=dec"),
             "sodiumencrypter ! sodiumdecrypter": (
                 "sodiumencrypter name=enc", "sodiumdecrypter name=dec")}
    return {name: (f"{src} ! {grade} ! {enc} ! tee name=t ! {dec} ! appsink "
                   f"name=out ! t. ! appsink name=mid",
                   f'appsrc name=src caps="{caps}" ! {enc} ! appsink name=mid')
            for name, (enc, dec) in pairs.items()}


def keyed(gstpu_torch, p) -> None:
    """Sets sodium's fixed keys and nonce on `enc` and `dec` where the
    pipeline has them."""
    enc, dec = p.get_by_name("enc"), p.get_by_name("dec")
    if enc.ELEMENT_NAME != "sodiumencrypter":
        return
    (rpk, rsk), (spk, ssk) = sodium_keys(gstpu_torch)
    enc.receiver_key, enc.sender_key = rpk, ssk
    enc.nonce = SODIUM_NONCE
    if dec is not None:
        dec.receiver_key, dec.sender_key = rsk, spk


def host_libraries(gstpu_torch) -> dict:
    """Which of 16c's strings this machine can run: the missing library
    of each one it cannot."""
    compress = importlib.import_module(
        f"{gstpu_torch.__name__}.elements.generic.compress")
    sodium = importlib.import_module(
        f"{gstpu_torch.__name__}.elements.generic.sodium")
    return {"brotlicompress ! brotlidecompress":
            None if compress._brotli_backend() is not None
            else "libbrotlienc/libbrotlidec",
            "sodiumencrypter ! sodiumdecrypter":
            None if sodium.sodium_available() else "libsodium"}


def plumbing_host_phase(gstpu_torch, smi, cube: Path, kernels) -> dict:
    """16c. BASELINE config 4's 1080p RGBA, 8 frames, through the grade on
    the card into `flatecompress`, `brotlicompress` and `sodiumencrypter`
    (fixed keys and nonce), each teed to an appsink and into its decoder:
    the encoded stream is byte for byte what the encoder writes fed the
    direct string's frames as host arrays through appsrc, the decoded
    bytes are those frames, the encoder calls `Buffer.array` once a frame
    and the decoder never, each kernel launches once a frame. fps and the
    host ms a frame of the encoder and the decoder. A string whose library
    the machine lacks is named, not run."""
    src, grade = grade_strings(EDGE_W, EDGE_H, PLUMBING_HOST_FRAMES, cube)
    _, _, direct, _ = run_string(gstpu_torch, "cuda",
                                 f"{src} ! {grade} ! appsink name=out",
                                 ("out",))
    frames = [gstpu_torch.Buffer(b.data.cpu().numpy(), pts=b.pts,
                                 duration=b.duration) for b in direct["out"]]
    plain = b"".join(b.data.tobytes() for b in frames)
    missing = host_libraries(gstpu_torch)
    res, launches = {}, {k.name: 0 for k in kernels}
    for name, (launch, fed) in host_consumer_strings(
            EDGE_W, EDGE_H, PLUMBING_HOST_FRAMES, cube).items():
        if missing.get(name):
            log(f"[plumbing] not run: 16c `{name}`, for want of "
                f"{missing[name]}")
            res.setdefault("not_run", []).append(f"{name}: no "
                                                 f"{missing[name]}")
            continue
        build = lambda p: keyed(gstpu_torch, p)
        tracer = push_tracer()
        for k in kernels:
            k.launches = 0
        tracer.install()
        try:
            with ArrayCalls() as calls:
                p, dt, card, _ = run_string(gstpu_torch, "cuda", launch,
                                            ("out", "mid"), build=build)
        finally:
            tracer.uninstall()
        n = {k.name: k.launches for k in kernels}

        def feed(q):
            s = q.get_by_name("src")
            for b in frames:
                s.push_buffer(b)
            s.end_of_stream()
        _, _, host, _ = run_string(gstpu_torch, "cuda", fed, ("mid",), feed,
                                   build)
        wire = [(b.to_bytes(), b.pts) for b in card["mid"]]
        r = {"fps": PLUMBING_HOST_FRAMES / dt, "launches": n,
             "wire_bytes": sum(len(x) for x, _ in wire),
             "wire_equal_to_host_feed": wire == [(b.to_bytes(), b.pts)
                                                 for b in host["mid"]],
             "round_trip": b"".join(b.to_bytes() for b in card["out"])
             == plain,
             "host_ms_a_frame": own_ms(tracer, p, ["enc", "dec"],
                                       PLUMBING_HOST_FRAMES),
             "array_calls": calls.by_element(),
             "enc_calls_by_frame": [calls.of("enc", b.pts) for b in frames]}
        res[name] = r
        log(f"[plumbing] {name}: {PLUMBING_HOST_FRAMES} graded {EDGE_W}x"
            f"{EDGE_H} frames, {r['fps']:.3f} fps (tracer on); launches {n}; "
            f"{r['wire_bytes']} B on the wire of {len(plain)}, "
            f"{'equal to' if r['wire_equal_to_host_feed'] else 'DIFFERS FROM'}"
            f" the host-array feed's; round trip "
            f"{'exact' if r['round_trip'] else 'DIFFERS'}; Buffer.array "
            f"calls {r['array_calls']}; host ms a frame "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        r["host_ms_a_frame"].items()) + f"  [{smi}]")
        if not r["wire_equal_to_host_feed"] or not r["round_trip"]:
            raise AssertionError(f"16c `{name}`: {r}")
        if r["enc_calls_by_frame"] != [1] * PLUMBING_HOST_FRAMES \
                or r["array_calls"].get("dec", 0) != 0:
            raise AssertionError(f"16c `{name}`: reads {r['array_calls']}")
        if any(v != PLUMBING_HOST_FRAMES for v in n.values()):
            raise AssertionError(f"16c `{name}`: the kernels launched {n} "
                                 f"times, not once a frame")
        for k in kernels:
            launches[k.name] += n[k.name]
    res["launches"] = launches
    return res


def launch_tool_phase(smi, cube: Path) -> dict:
    """16d. `python -m gstpu_torch.tools.launch` on 4 frames of the 4K
    chain, with no --device: it exits 0 on the card, and non-zero with
    core/device.py's error where CUDA_VISIBLE_DEVICES hides the card;
    `python -m gstpu_torch.tools.inspect intersrc` exits 0. The three
    processes run at once, each to its end."""
    src, grade = grade_strings(W, H, PLUMBING_LAUNCH_FRAMES, cube)
    launch = [sys.executable, "-m", "gstpu_torch.tools.launch", "-q",
              f"{src} ! {grade} ! fakesink"]
    runs = {"launch on the card": (launch, {}),
            "launch with no GPU visible": (launch,
                                           {"CUDA_VISIBLE_DEVICES": ""}),
            "inspect intersrc": ([sys.executable, "-m",
                                  "gstpu_torch.tools.inspect", "intersrc"],
                                 {})}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **env},
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (cmd, env) in runs.items()}
    res, full = {}, {}
    try:
        for name, proc in procs.items():
            full[name] = proc.communicate(timeout=300)
            out, err = full[name]
            res[name] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                         "stdout_tail": out[-300:], "stderr_tail": err[-300:]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, r in res.items():
        log(f"[plumbing] {name}: exit {r['rc']} after {r['s']:.1f} s; "
            f"stderr {r['stderr_tail'].strip()[-160:]!r}  [{smi}]")
    hidden = res["launch with no GPU visible"]
    if res["launch on the card"]["rc"] != 0:
        raise AssertionError(f"16d: the launch tool failed on the card: "
                             f"{res['launch on the card']}")
    if hidden["rc"] == 0 or "CUDA device requested" not in \
            full["launch with no GPU visible"][1]:
        raise AssertionError(f"16d: the launch tool with no GPU visible: "
                             f"{hidden}")
    inspect = res["inspect intersrc"]
    if inspect["rc"] != 0 or "Name          intersrc" not in \
            full["inspect intersrc"][0]:
        raise AssertionError(f"16d: inspect intersrc: {inspect}")
    return res


def plumbing_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """16. Queue D item 3's elements around the card's grade: the bridges
    (a), the supervisors (b), the host consumers (c), the launch tool
    (d). The launches of each kernel in a-c."""
    cube = tmp / "plumbing.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res = {"bridges": plumbing_bridge_phase(gstpu_torch, smi, cube, kernels),
           "supervisors": plumbing_supervise_phase(gstpu_torch, smi, cube,
                                                   kernels),
           "host": plumbing_host_phase(gstpu_torch, smi, cube, kernels),
           "launch_tool": launch_tool_phase(smi, cube)}
    res["launches"] = {k.name: sum(res[x]["launches"][k.name] for x in
                                   ("bridges", "supervisors", "host"))
                       for k in kernels}
    return res


def drain(p) -> None:
    """Run `p`'s scheduler rounds until a round does no work: a receiving
    pipeline takes every datagram its socket holds."""
    while p.iterate():
        pass


class NativeRecv:
    """Counts the calls of a package's native recvmmsg, and the datagrams
    they returned, while the `with` block runs; `built` is False where
    the library did not build (recv_batch then takes its per-packet
    Python path)."""

    def __init__(self, package):
        self.net = importlib.import_module(f"{package.__name__}.native_net")

    def __enter__(self):
        self.lib = self.net.load()
        self.built = self.lib is not None
        self.calls = self.datagrams = 0
        if self.built:
            self._fn = self.lib.gstpu_net_recvmmsg

            def counted(*args):
                n = self._fn(*args)
                self.calls += 1
                self.datagrams += max(n, 0)
                return n
            self.lib.gstpu_net_recvmmsg = counted
        return self

    def __exit__(self, *exc) -> None:
        if self.built:
            self.lib.gstpu_net_recvmmsg = self._fn


def record_buffers(pad) -> list:
    """The buffers that pass `pad` from now on, in order (a probe)."""
    out = []

    def probe(_, item):
        if hasattr(item, "to_bytes"):
            out.append(item)
    pad.add_probe(probe)
    return out


def udp_pair(gstpu_torch, device: str, send: str, recv: str, taps=(),
             feed=None, drop=None) -> dict:
    """The receiving string `recv` (`udpsrc name=src port=0 ...`) set
    PLAYING, then the sending string `send`, its `{port}` the receiver's,
    run to its end, `feed(p)` pushing its appsrc input; then the receiver
    drained. A probe on the sender's `udp` (udpsink) sink pad drops each
    datagram for which `drop(bytes)` is true and drives the receiver every
    RTP_PACE datagrams sent, so that its socket never holds more than
    that. `taps` names (pipeline, element, pad) whose buffers are recorded
    (record_buffers). The pipelines (in NULL), the wall seconds, the
    probe's counts, the native recvmmsg counts (NativeRecv), the recorded
    buffers by tap and the receiver's appsink `out` buffers."""
    gstpu_torch.init(device=device)
    r = gstpu_torch.parse_launch(recv)
    r.set_state(gstpu_torch.State.PLAYING)
    s = gstpu_torch.parse_launch(send.format(
        port=r.get_by_name("src").bound_port))
    pipes = {"send": s, "recv": r}
    recorded = {t: record_buffers(pipes[t[0]].get_by_name(t[1])
                                  .static_pad(t[2])) for t in taps}
    counts = {"sent": 0, "dropped": 0}

    def pace(_, item):
        if not hasattr(item, "to_bytes"):
            return None
        if drop is not None and drop(item.to_bytes()):
            counts["dropped"] += 1
            return "drop"
        counts["sent"] += 1
        if counts["sent"] % RTP_PACE == 0:
            drain(r)
        return None
    s.get_by_name("udp").static_pad("sink").add_probe(pace)
    s.set_state(gstpu_torch.State.PLAYING)
    with NativeRecv(gstpu_torch) as native:
        t0 = time.perf_counter()
        if feed is not None:
            feed(s)
        s.run(timeout=600)
        drain(r)
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    out = r.get_by_name("out").pull_all()
    for p in (s, r):
        p.set_state(gstpu_torch.State.NULL)
    return {"pipes": pipes, "seconds": dt, "counts": counts,
            "native": {"built": native.built, "calls": native.calls,
                       "datagrams": native.datagrams},
            "taps": recorded, "out": out}


def telephony_strings() -> tuple:
    """17a's strings: the flagship at 192 kHz F64 stereo (fed to appsrc
    `src`) into 8 kHz S16 mono, A-law, 20 ms RTP packets (mtu PHONE_MTU),
    rtpsend and raptorqenc into udpsink; and udpsrc through raptorqdec,
    rtprecv, rtppcmadepay2 and alawdec into an appsink."""
    caps = (f"audio/x-raw, format=F64LE, rate={RATE_192K}, channels=2, "
            f"layout=interleaved")
    send = (f'appsrc name=src caps="{caps}" ! rsaudioecho name=echo '
            f'delay=250000000 intensity={AUDIO_INTENSITY} '
            f'feedback={AUDIO_FEEDBACK} ! audioloudnorm name=norm ! '
            f'audioresample name=res ! audio/x-raw, rate={PHONE_RATE} ! '
            f'audioconvert name=conv ! audio/x-raw, format=S16LE, '
            f'channels=1 ! alawenc name=ae ! rtppcmapay2 name=pay '
            f'mtu={PHONE_MTU} ssrc={RTP_SSRC} seqnum-offset=0 '
            f'timestamp-offset=0 ! rtpsend name=send ! raptorqenc name=fec '
            f'symbols-per-block={RTP_FEC_K} repair-packets={RTP_FEC_REPAIR} '
            f'repair-pt={RTP_FEC_PT} ! udpsink name=udp host=127.0.0.1 '
            f'port={{port}}')
    recv = (f"udpsrc name=src port=0 mtu={RTP_RECV_MTU} ! raptorqdec "
            f"name=fec repair-pt={RTP_FEC_PT} ! application/x-rtp, "
            f"media=audio, clock-rate={PHONE_RATE}, encoding-name=PCMA, "
            f"payload=8 ! rtprecv name=recv latency=0 ! rtppcmadepay2 "
            f"name=depay ! alawdec name=ad ! appsink name=out sync=false")
    return send, recv


def fec_drops(gstpu_torch, seed: int):
    """A `drop` for udp_pair: it drops seeded source packets, 1 to
    RTP_FEC_REPAIR of each block of RTP_FEC_K, and no repair packet; the
    source packets it saw, in order, in its `.seen`."""
    pk = importlib.import_module(f"{gstpu_torch.__name__}.net.rtp.packet")
    rng = np.random.default_rng(seed)
    plan: dict = {}
    seen: list = []

    def drop(data: bytes) -> bool:
        if pk.RtpPacket.parse(data).payload_type == RTP_FEC_PT:
            return False
        i = len(seen)
        seen.append(data)
        block = i // RTP_FEC_K
        if block not in plan:
            m = 1 + int(rng.integers(0, RTP_FEC_REPAIR))
            plan[block] = set(rng.choice(RTP_FEC_K, m, replace=False)
                              .tolist())
        return i % RTP_FEC_K in plan[block]
    drop.seen = seen
    return drop


def telephony_rtp(gstpu_torch, device: str, seconds: float) -> dict:
    """17a on `device`: `seconds` of edge_signal through telephony_strings
    with fec_drops. udp_pair's result, with what alawenc wrote (`alaw`),
    the source packets sent (`sent`, the dropped ones too), those out of
    raptorqdec (`recovered`), the RTP payloads into the depayloader
    (`payloads`), the decoded samples (`samples`) and the decoder's
    stats."""
    send, recv = telephony_strings()
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
    drop = fec_drops(gstpu_torch, SEED)
    res = udp_pair(gstpu_torch, device, send, recv,
                   (("send", "ae", "src"), ("recv", "fec", "src"),
                    ("recv", "depay", "sink")),
                   feed_blocks(gstpu_torch, x, RATE_192K), drop)
    pk = importlib.import_module(f"{gstpu_torch.__name__}.net.rtp.packet")
    taps = res["taps"]
    res.update(
        alaw=b"".join(b.to_bytes() for b in taps["send", "ae", "src"]),
        sent=drop.seen,
        recovered=[b.to_bytes() for b in taps["recv", "fec", "src"]],
        payloads=b"".join(pk.RtpPacket.parse(b.to_bytes()).payload
                          for b in taps["recv", "depay", "sink"]),
        samples=b"".join(b.to_bytes() for b in res["out"]),
        stats=dict(res["pipes"]["recv"].get_by_name("fec").stats))
    return res


def vraw_strings(w: int, h: int, n: int, cube: Path) -> tuple:
    """17b's strings: 13b's grade at w x h on n frames into rtpvrawpay2 at
    mtu RTP_MTU and udpsink; udpsrc into rtpvrawdepay2 and an appsink."""
    src, grade = grade_strings(w, h, n, cube)
    send = (f"{src} ! {grade} ! rtpvrawpay2 name=pay mtu={RTP_MTU} "
            f"ssrc={RTP_SSRC} seqnum-offset=0 timestamp-offset=0 ! udpsink "
            f"name=udp host=127.0.0.1 port={{port}}")
    recv = (f'udpsrc name=src port=0 mtu={RTP_RECV_MTU} caps="application/'
            f'x-rtp, media=video, encoding-name=RAW, clock-rate=90000, '
            f'payload=96, sampling=RGBA, width=(string){w}, height=(string)'
            f'{h}, depth=(string)8" ! rtpvrawdepay2 name=depay ! appsink '
            f'name=out sync=false')
    return send, recv


def vraw_rtp(gstpu_torch, device: str, w: int, h: int, n: int,
             cube: Path) -> dict:
    """17b on `device`: udp_pair's result for vraw_strings, with the
    frames received (`frames`, bytes), the packets a frame, the RTP
    sequence numbers into the depayloader and those lost (`lost`: missing
    between the first and the last, and after the last sent)."""
    send, recv = vraw_strings(w, h, n, cube)
    res = udp_pair(gstpu_torch, device, send, recv,
                   (("recv", "depay", "sink"),))
    pk = importlib.import_module(f"{gstpu_torch.__name__}.net.rtp.packet")
    seqs = [pk.RtpPacket.parse(b.to_bytes()).seqnum
            for b in res["taps"]["recv", "depay", "sink"]]
    sent = res["counts"]["sent"]
    res.update(frames=[b.to_bytes() for b in res["out"]], seqnums=seqs,
               packets_a_frame=sent / n,
               lost=sent - len(set(seqs)),
               in_order=seqs == list(range(sent)))
    return res


def onvif_docs(rng) -> list:
    """17c's metadata: an event document at frame 0's time, then on each
    frame of ONVIF_BOXES a tt:Frame with two seeded bounding boxes, its
    UtcTime and pts mid-frame (so that the parser's UTC-to-pts mapping,
    pinned by the first box document, puts each on its frame). (xml, pts)
    pairs."""
    base = 1_767_225_600          # 2026-01-01T00:00:00Z
    dur = 10 ** 9 // 30
    docs = [(f'<tt:MetadataStream xmlns:tt="{ONVIF_NS}"><tt:Event>'
             f'<tt:MetadataStream/></tt:Event></tt:MetadataStream>'
             .encode(), 0)]
    for k in ONVIF_BOXES:
        pts = k * dur + dur // 2
        us = round(pts / 1000)
        utc = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(base)) \
            + f".{us:06d}Z"
        boxes = ""
        for obj in range(2):
            x = np.sort(rng.uniform(-0.9, 0.9, 2))
            y = np.sort(rng.uniform(-0.9, 0.9, 2))
            boxes += (f'<tt:Object ObjectId="{obj}"><tt:Appearance>'
                      f'<tt:Shape><tt:BoundingBox left="{x[0]:.4f}" '
                      f'top="{y[1]:.4f}" right="{x[1]:.4f}" '
                      f'bottom="{y[0]:.4f}"/></tt:Shape></tt:Appearance>'
                      f'</tt:Object>')
        docs.append((f'<tt:MetadataStream xmlns:tt="{ONVIF_NS}">'
                     f'<tt:VideoAnalytics><tt:Frame UtcTime="{utc}">{boxes}'
                     f'</tt:Frame></tt:VideoAnalytics></tt:MetadataStream>'
                     .encode(), pts))
    return docs


def onvif_grade(gstpu_torch, device: str, w: int, h: int, n: int,
                cube: Path, docs, frames=None) -> dict:
    """17c on `device`: the grade (or, given `frames`, those frames through
    appsrc `vsrc`) into onvifmetadatacombiner's media pad, `docs` through
    `appsrc ! onvifmetadatapay ! onvifmetadatadepay ! onvifmetadataparse`
    into its meta pad, then onvifmetadataoverlay into an appsink. The
    pipeline (in NULL), the wall seconds, the frames into the combiner's
    media pad and out of the overlay."""
    src, grade = grade_strings(w, h, n, cube)
    caps = f"video/x-raw, format=RGBA, width={w}, height={h}, framerate=30/1"
    video = (f"{src} ! {grade}" if frames is None
             else f'appsrc name=vsrc caps="{caps}"')
    launch = (f"{video} ! onvifmetadatacombiner name=comb ! "
              f"onvifmetadataoverlay name=ov ! appsink name=out")
    taps = {}

    def build(p) -> None:
        gstpu_torch.parse_launch(
            'appsrc name=msrc caps="application/x-onvif-metadata, '
            'encoding=utf8" ! onvifmetadatapay name=opay ! '
            'onvifmetadatadepay name=odepay ! onvifmetadataparse name=parse',
            pipeline=p)
        p.get_by_name("parse").link(p.get_by_name("comb"))
        taps["in"] = record_buffers(p.get_by_name(
            "lut" if frames is None else "vsrc").static_pad("src"))

    def feed(p) -> None:
        msrc = p.get_by_name("msrc")
        for xml, pts in docs:
            msrc.push_buffer(gstpu_torch.Buffer(xml, pts=pts))
        msrc.end_of_stream()
        if frames is not None:
            vsrc = p.get_by_name("vsrc")
            for b in frames:
                vsrc.push_buffer(gstpu_torch.Buffer(
                    np.asarray(b.array), pts=b.pts, duration=b.duration))
            vsrc.end_of_stream()

    p, dt, out, _ = run_string(gstpu_torch, device, launch, ("out",), feed,
                               build)
    return {"pipe": p, "seconds": dt, "in": taps["in"], "out": out["out"]}


def tcp_grade(gstpu_torch, device: str, w: int, h: int, n: int,
              cube: Path) -> dict:
    """17d on `device`: the grade into tcpserversink (port 0), read by
    `tcpclientsrc ! appsink` in a receiving pipeline of its own on a
    `run_async` thread, which ends when the sender, set to NULL after its
    last frame, closes the connection. The pipelines (in NULL), the
    sender's seconds and the bytes received."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    src, grade = grade_strings(w, h, n, cube)
    s = gstpu_torch.parse_launch(f"{src} ! {grade} ! tcpserversink name=tcp "
                                 f"port=0")
    s.set_state(State.READY)
    r = gstpu_torch.parse_launch(
        f"tcpclientsrc name=src port={s.get_by_name('tcp').bound_port} "
        f"blocksize={TCP_BLOCK} ! appsink name=out sync=false")
    r.set_state(State.PLAYING)
    thread = r.run_async()
    s.set_state(State.PLAYING)
    t0 = time.perf_counter()
    s.run(timeout=600)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s.set_state(State.NULL)
    thread.join(600)
    if thread.is_alive():
        raise AssertionError("17d: the TCP receiver did not end")
    got = b"".join(b.to_bytes() for b in r.get_by_name("out").pull_all())
    r.set_state(State.NULL)
    return {"pipes": {"send": s, "recv": r}, "seconds": dt, "bytes": got}


def new_reads(calls, names) -> dict:
    """The `Buffer.array` calls (ArrayCalls) by each of the elements
    `names`: the new elements of a string, beside its grade."""
    reads = calls.by_element()
    return {x: reads[x] for x in names if reads.get(x)}


def traced(kernels, fn):
    """`fn()` with every kernel's count set to 0 just before, under the
    pad-push tracer and ArrayCalls: its result, the tracer, the calls and
    each kernel's launches."""
    tracer = push_tracer()
    for k in kernels:
        k.launches = 0
    tracer.install()
    try:
        with ArrayCalls() as calls:
            res = fn()
    finally:
        tracer.uninstall()
    return res, tracer, calls, {k.name: k.launches for k in kernels}


def rtp_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """17. Queue D item 4's elements between the card's chains and the
    network, all on 127.0.0.1: (a) the flagship's telephony audio as
    A-law RTP through rtpsend and raptorqenc over UDP, seeded source
    packets dropped and recovered, the samples the CPU run's; (b)
    BASELINE config 4's 1080p grade as RFC 4175 raw video over UDP; (c)
    ONVIF boxes combined onto the grade and drawn; (d) the grade over TCP.
    Each kernel's launches in b-d."""
    cube = tmp / "rtp.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res, launches = {}, {k.name: 0 for k in kernels}
    w, h = EDGE_W, EDGE_H

    # 17a
    a, tracer, _, _ = traced(kernels, lambda: telephony_rtp(
        gstpu_torch, "cuda", PHONE_SECONDS))
    own = {"send": own_ms(tracer, a["pipes"]["send"],
                          ["echo", "norm", "res", "conv", "ae", "pay",
                           "send", "fec", "udp"], PHONE_SECONDS),
           "recv": own_ms(tracer, a["pipes"]["recv"],
                          ["fec", "recv", "depay", "ad", "out"],
                          PHONE_SECONDS)}
    echo_out = tracer.payload.get(a["pipes"]["send"].get_by_name("echo")
                                  .static_pad("src"))
    cpu = telephony_rtp(gstpu_torch, "cpu", PHONE_SECONDS)
    r = res["telephony"] = {
        "seconds_of_audio": PHONE_SECONDS, "wall_s": a["seconds"],
        "cpu_wall_s": cpu["seconds"], "source_packets": len(a["sent"]),
        "datagrams": a["counts"]["sent"], "dropped": a["counts"]["dropped"],
        "fec": a["stats"], "native_recvmmsg": a["native"],
        "samples": len(a["samples"]) // 2,
        "equal_to_cpu": a["samples"] == cpu["samples"],
        "payloads_are_alawenc": a["payloads"] == a["alaw"],
        "all_recovered": a["recovered"] == a["sent"],
        "host_ms_per_s": own, "echo_output": echo_out}
    log(f"[rtp] 17a: {PHONE_SECONDS} s of the flagship at 192 kHz stereo "
        f"into {r['samples']} A-law samples at {PHONE_RATE} Hz in "
        f"{r['source_packets']} RTP packets of 20 ms, {r['datagrams']} "
        f"datagrams sent with {RTP_FEC_REPAIR} repair a block of "
        f"{RTP_FEC_K} after {r['dropped']} source packets were dropped; "
        f"raptorqdec {r['fec']}, every source packet out of it: "
        f"{r['all_recovered']}; the payloads what alawenc wrote: "
        f"{r['payloads_are_alawenc']}; the samples "
        f"{'equal to' if r['equal_to_cpu'] else 'DIFFER FROM'} the CPU "
        f"run's; native recvmmsg {a['native']}; {a['seconds']:.3f} s on the "
        f"card (tracer on), {cpu['seconds']:.3f} s on the CPU; host ms per "
        f"second of audio: " + "; ".join(
            f"{side} " + ", ".join(f"{k} {v:.2f}" for k, v in o.items())
            for side, o in own.items())
        + f"; the echo's output: {echo_out}  [{smi}]")
    if not (a["native"]["built"]
            and a["native"]["datagrams"] == a["counts"]["sent"] > 0):
        raise AssertionError(f"17a: the native recvmmsg path did not receive "
                             f"every datagram: {a['native']}, "
                             f"{a['counts']}")
    if not (r["dropped"] > 0 and r["all_recovered"] and a["stats"] == {
            "recovered": r["dropped"], "unrecovered": 0}):
        raise AssertionError(f"17a: not every dropped packet came back: {r}")
    if r["samples"] != round(PHONE_SECONDS * PHONE_RATE) \
            or not r["equal_to_cpu"] or not r["payloads_are_alawenc"] \
            or echo_out != "tensor on cuda":
        raise AssertionError(f"17a: {r}")

    # the references: the card's own direct strings
    def direct(n):
        src, grade = grade_strings(w, h, n, cube)
        return run_string(gstpu_torch, "cuda", f"{src} ! {grade} ! appsink "
                          f"name=out", ("out",))[2]["out"]
    ref = {n: direct(n) for n in (RTP_FRAMES, ONVIF_FRAMES)}
    want = {n: [b.to_bytes() for b in ref[n]] for n in ref}

    # 17b
    b, tracer, calls, n = traced(kernels, lambda: vraw_rtp(
        gstpu_torch, "cuda", w, h, RTP_FRAMES, cube))
    r = res["vraw"] = {
        "frames": len(b["frames"]), "fps": RTP_FRAMES / b["seconds"],
        "packets_a_frame": b["packets_a_frame"], "lost": b["lost"],
        "in_order": b["in_order"], "native_recvmmsg": b["native"],
        "equal": b["frames"] == want[RTP_FRAMES], "launches": n,
        "array_calls": new_reads(calls, ("pay", "udp", "src", "depay",
                                         "out")),
        "downloads": dict(calls.tensor_calls),
        "host_ms_a_frame": {
            "send": own_ms(tracer, b["pipes"]["send"], ["pay", "udp"],
                           RTP_FRAMES),
            "recv": own_ms(tracer, b["pipes"]["recv"], ["depay", "out"],
                           RTP_FRAMES)}}
    log(f"[rtp] 17b: {r['frames']} frames of {w}x{h} RGBA through the grade "
        f"into rtpvrawpay2 mtu={RTP_MTU} and udpsink, {r['packets_a_frame']} "
        f"packets a frame, {r['lost']} lost, in order: {r['in_order']}; "
        f"{r['fps']:.3f} fps with the receiver paced every {RTP_PACE} "
        f"datagrams on the same thread (tracer on); frames "
        f"{'equal to' if r['equal'] else 'DIFFER FROM'} the direct "
        f"string's; launches {n}; Buffer.array calls {r['array_calls']}, "
        f"downloads {r['downloads']}; native recvmmsg {b['native']}; host ms "
        f"a frame {r['host_ms_a_frame']}  [{smi}]")
    if not r["equal"] or r["lost"] or not r["in_order"] \
            or r["array_calls"] != {"pay": RTP_FRAMES} \
            or r["downloads"] != {"pay": RTP_FRAMES} \
            or any(v != RTP_FRAMES for v in n.values()) \
            or b["native"]["datagrams"] != b["counts"]["sent"]:
        raise AssertionError(f"17b: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    # 17c
    docs = onvif_docs(np.random.default_rng(SEED))
    host = onvif_grade(gstpu_torch, "cuda", w, h, ONVIF_FRAMES, cube, docs,
                       ref[ONVIF_FRAMES])
    c, tracer, calls, n = traced(kernels, lambda: onvif_grade(
        gstpu_torch, "cuda", w, h, ONVIF_FRAMES, cube, docs))
    boxed = [k for k in range(ONVIF_FRAMES) if k in ONVIF_BOXES]
    r = res["onvif"] = {
        "frames": len(c["out"]), "fps": ONVIF_FRAMES / c["seconds"],
        "launches": n,
        "array_calls": new_reads(calls, ("msrc", "opay", "odepay", "parse",
                                         "comb", "ov", "out")),
        "reads_on_boxed": [calls.of("ov", c["out"][k].pts) for k in boxed],
        "payloads": [payload_kind(x.data) for x in c["out"]],
        "unread_frames_are_the_input": [
            x.data is y.data for k, (x, y) in enumerate(zip(c["out"],
                                                            c["in"]))
            if k not in boxed],
        "metas": [len(x.metas) for x in c["out"]],
        "equal_to_host_fed": [buffer_record(x) for x in c["out"]]
        == [buffer_record(x) for x in host["out"]],
        "host_ms_a_frame": own_ms(tracer, c["pipe"],
                                  ["comb", "ov", "parse"], ONVIF_FRAMES)}
    log(f"[rtp] 17c: {r['frames']} frames of {w}x{h} through the grade into "
        f"onvifmetadatacombiner, boxes on frames {boxed} from "
        f"onvifmetadatapay ! depay ! parse, then onvifmetadataoverlay: "
        f"frames and metas {'equal to' if r['equal_to_host_fed'] else 'DIFFER FROM'} "
        f"the same elements fed host frames; metas a frame {r['metas']}; "
        f"Buffer.array calls {r['array_calls']} ({r['reads_on_boxed']} on "
        f"the boxed frames); payloads {r['payloads']}; the unread frames the "
        f"tensors that went in: {r['unread_frames_are_the_input']}; "
        f"launches {n}; {r['fps']:.3f} fps (tracer on); host ms a frame "
        f"{r['host_ms_a_frame']}  [{smi}]")
    if not r["equal_to_host_fed"] or r["frames"] != ONVIF_FRAMES \
            or r["array_calls"] != {"ov": len(boxed)} \
            or r["reads_on_boxed"] != [1] * len(boxed) \
            or not all(r["unread_frames_are_the_input"]) \
            or [r["payloads"][k] for k in range(ONVIF_FRAMES)
                if k not in boxed] != ["tensor on cuda"] * (ONVIF_FRAMES
                                                            - len(boxed)) \
            or [r["metas"][k] > 0 for k in range(ONVIF_FRAMES)] \
            != [k in boxed for k in range(ONVIF_FRAMES)] \
            or any(v != ONVIF_FRAMES for v in n.values()):
        raise AssertionError(f"17c: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    # 17d
    d, tracer, calls, n = traced(kernels, lambda: tcp_grade(
        gstpu_torch, "cuda", w, h, RTP_FRAMES, cube))
    r = res["tcp"] = {
        "bytes": len(d["bytes"]), "fps": RTP_FRAMES / d["seconds"],
        "equal": d["bytes"] == b"".join(want[RTP_FRAMES]), "launches": n,
        "array_calls": new_reads(calls, ("tcp", "src", "out")),
        "host_ms_a_frame": own_ms(tracer, d["pipes"]["send"], ["tcp"],
                                  RTP_FRAMES)}
    log(f"[rtp] 17d: {RTP_FRAMES} frames of {w}x{h} through the grade into "
        f"tcpserversink, {r['bytes']} B read by tcpclientsrc on its own "
        f"thread, {'equal to' if r['equal'] else 'DIFFERENT FROM'} the direct "
        f"string's; Buffer.array calls {r['array_calls']}; launches {n}; "
        f"{r['fps']:.3f} fps (tracer on); host ms a frame "
        f"{r['host_ms_a_frame']}  [{smi}]")
    if not r["equal"] or r["array_calls"] != {"tcp": RTP_FRAMES} \
            or any(v != RTP_FRAMES for v in n.values()):
        raise AssertionError(f"17d: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]
    res["not_on_the_card"] = NOT_ON_THE_CARD
    for name, why in NOT_ON_THE_CARD.items():
        log(f"[rtp] not run on the card: {name}: {why}")
    res["launches"] = launches
    return res


def run_to_eos(gstpu_torch, device: str, p, names, feed=None) -> float:
    """Set `p` PLAYING, `feed(p)` pushing any appsrc input, and iterate it
    until each element of `names` has posted EOS: a pipeline's run() ends
    at the first EOS, and the branches of a string fed by several sources
    end apart. The wall seconds, the card synchronised."""
    mt = importlib.import_module(f"{gstpu_torch.__name__}.core.element")
    done = set()

    def seen(m) -> None:
        if m.type is mt.MessageType.EOS and m.src is not None:
            done.add(m.src.name)
    p.bus.add_sync_handler(seen)
    p.set_state(gstpu_torch.State.PLAYING)
    t0 = time.perf_counter()
    if feed is not None:
        feed(p)
    deadline = time.monotonic() + 600
    while not set(names) <= done:
        if p._error_seen is not None:
            raise RuntimeError(f"pipeline error: {p._error_seen}")
        if not p.iterate():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no EOS from {set(names) - done}")
            time.sleep(0.001)
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def hls_strings(w: int, h: int, n: int, cube: Path, out: Path) -> tuple:
    """18a's strings, writing into `out`: the grade into cmafmux `vmux`
    (fragments of HLS_FRAGMENT_FRAMES) teed into hlscmafsink `hls` and
    dashsink2 `dash`; the flagship from appsrc `asrc` into cmafmux `amux`;
    the CEA-608 pairs from appsrc `csrc` through cea608tojson and jsontovtt
    into hlswebvttsink `vtt`."""
    src, grade = grade_strings(w, h, n, cube)
    frag = HLS_FRAGMENT_FRAMES * 10 ** 9 // 30
    video = (f"{src} ! {grade} ! cmafmux name=vmux fragment-duration={frag} "
             f"! tee name=t ! hlscmafsink name=hls location={out}/video_"
             f"%05d.m4s init-location={out}/video_init.mp4 playlist-location="
             f"{out}/video.m3u8 target-duration=1 ! t. ! dashsink2 name=dash "
             f"mime-type=video/mp4 codecs=uncv mpd-location={out}/manifest.mpd"
             f" init-location={out}/dash_init.mp4 segment-template={out}/"
             f"dash_%05d.m4s target-duration=1")
    caps = (f"audio/x-raw, format=F64LE, rate={RATE_192K}, channels=2, "
            f"layout=interleaved")
    audio = (f'appsrc name=asrc caps="{caps}" ! rsaudioecho name=echo '
             f'delay=250000000 intensity={AUDIO_INTENSITY} feedback='
             f'{AUDIO_FEEDBACK} ! audioloudnorm name=norm ! cmafmux name=amux '
             f'fragment-duration={HLS_AUDIO_FRAGMENT}')
    captions = ('appsrc name=csrc caps="closedcaption/x-cea-608, format=raw" '
                '! cea608tojson name=cj ! jsontovtt name=jv default_duration='
                f'1000000000 ! hlswebvttsink name=vtt target_duration=1 '
                f'location={out}/subs_%05d.vtt playlist_location={out}/'
                f'subs.m3u8')
    return video, audio, captions


def hls_grade(gstpu_torch, device: str, w: int, h: int, n: int, cube: Path,
              out: Path) -> dict:
    """18a on `device`: hls_strings in one pipeline, cmafmux `amux` and a
    third branch of the tee feeding an hlsmultivariantsink `mv` (request
    pads made with their settings, which a launch string cannot give: the
    video variant `hi.m3u8` and the audio rendition `audio.m3u8`), then
    HLS_AUDIO_SECONDS of edge_signal into `asrc` in 100 ms blocks and
    HLS_CAPTIONS as pop-on CEA-608 a second apart into `csrc`, driven
    until all four sinks saw EOS. The pipeline (in NULL), the wall
    seconds and every file written, by name."""
    gstpu_torch.init(device=device)
    make = importlib.import_module(
        f"{gstpu_torch.__name__}.core.registry").make
    encoder = importlib.import_module(
        f"{gstpu_torch.__name__}.codecs.cea608").Cea608Encoder
    out.mkdir(parents=True)
    video, audio, captions = hls_strings(w, h, n, cube, out)
    p = gstpu_torch.parse_launch(video)
    gstpu_torch.parse_launch(audio, pipeline=p)
    gstpu_torch.parse_launch(captions, pipeline=p)
    mv = make("hlsmultivariantsink", "mv",
              playlist_location=str(out / "master.m3u8"), target_duration=1)
    p.add(mv)
    p.get_by_name("t").request_pad().link(mv.request_pad_with_settings(
        variant={"uri": "hi.m3u8", "bandwidth": w * h * 4 * 8 * 30,
                 "codecs": "uncv"}))
    p.get_by_name("amux").static_pad("src").link(mv.request_pad_with_settings(
        rendition={"media_type": "audio", "uri": "audio.m3u8",
                   "group_id": "aud", "name": "Flagship", "default": True,
                   "autoselect": True}))

    def feed(p) -> None:
        x = edge_signal(HLS_AUDIO_SECONDS, RATE_192K).astype(np.float64) \
            / 32768.0
        asrc, block = p.get_by_name("asrc"), RATE_192K // 10
        for i, off in enumerate(range(0, len(x), block)):
            asrc.push_buffer(gstpu_torch.Buffer(
                x[off:off + block].copy(), pts=i * 100_000_000,
                duration=100_000_000))
        asrc.end_of_stream()
        csrc = p.get_by_name("csrc")
        for k, text in enumerate(HLS_CAPTIONS):
            for i, pair in enumerate(encoder().encode_popon(text)):
                csrc.push_buffer(gstpu_torch.Buffer(
                    pair, pts=k * 10 ** 9 + i * 33_000_000))
        csrc.end_of_stream()

    dt = run_to_eos(gstpu_torch, device, p, ("hls", "dash", "mv", "vtt"),
                    feed)
    p.set_state(gstpu_torch.State.NULL)
    files = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    return {"pipe": p, "seconds": dt, "files": files}


def hls_compare(card: dict, cpu: dict) -> dict:
    """18a's gate on two runs' files: the same names, each byte for byte,
    but the audio rendition's media segments, whose boxes but mdat must be
    byte for byte and whose F64 samples (the flagship's, as in 13a) within
    EDGE_TOL. The names that fail, the segments held to the tolerance, the
    samples' max |err| and their differing bytes."""
    from gstpu_torch.mux.boxes import parse_boxes
    bad = sorted(set(card) ^ set(cpu))
    tolerated, err, differ = [], 0.0, 0
    for name in sorted(set(card) & set(cpu)):
        a, b = card[name], cpu[name]
        if a == b:
            continue
        ba, bb = parse_boxes(a), parse_boxes(b)
        if not (name.startswith("audio_") and name.endswith(".m4s")) \
                or [x.fourcc for x in ba] != [x.fourcc for x in bb] \
                or any(x.data != y.data for x, y in zip(ba, bb)
                       if x.fourcc != "mdat"):
            bad.append(name)
            continue
        tolerated.append(name)
        for x, y in zip(ba, bb):
            if x.fourcc == "mdat":
                ga, gb = (np.frombuffer(v.data, "<f8") for v in (x, y))
                err = max(err, float(np.abs(ga - gb).max()))
                differ += int(np.count_nonzero(
                    np.frombuffer(x.data, np.uint8)
                    != np.frombuffer(y.data, np.uint8)))
    return {"bad": bad, "tolerated": tolerated, "max_abs_err": err,
            "bytes_differ": differ}


def flac_string(head: str, dst: Path) -> str:
    """13a's string behind `head`, the source of the FLAC file's bytes."""
    return (f"{head} ! claxondec name=dec ! audioconvert name=conv ! "
            f"audio/x-raw, format=F64LE ! audioresample name=res ! "
            f"audio/x-raw, rate={RATE_192K} ! rsaudioecho name=echo "
            f"delay=250000000 intensity={AUDIO_INTENSITY} feedback="
            f"{AUDIO_FEEDBACK} ! audioloudnorm name=norm ! ebur128level ! "
            f"isomp4mux ! filesink location={dst}")


class Served:
    """`root` served over HTTP on 127.0.0.1 (port 0) from a thread of a
    ThreadingHTTPServer, shut down on leaving the `with` block; `url` is
    its address."""

    def __init__(self, root: Path):
        import http.server

        class Files(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *args, **kw):
                super().__init__(*args, directory=str(root), **kw)

            def log_message(self, *args) -> None:
                pass
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Files)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __enter__(self):
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def http_clip(gstpu_torch, device: str, which: str, url: str,
              clip: Path) -> tuple:
    """18b's supervisors on `device` into the flagship: `which` is
    "fallbacksrc" (`fallbacksrc uri=<url>`) or "uriplaylistbin" (over the
    http item `url` and the file item `clip`). The appsink's buffers,
    the wall seconds and the pipeline (in NULL)."""
    tail = (f"audioconvert name=conv ! audio/x-raw, format=F64LE ! "
            f"audioresample name=res ! audio/x-raw, rate={RATE_192K} ! "
            f"rsaudioecho name=echo delay=250000000 intensity="
            f"{AUDIO_INTENSITY} feedback={AUDIO_FEEDBACK} ! audioloudnorm "
            f"name=norm ! appsink name=out")
    if which == "fallbacksrc":
        head, build = f"fallbacksrc uri={url} ! claxondec name=dec", None
    else:
        head = "uriplaylistbin name=pl"

        def build(p) -> None:
            p.get_by_name("pl").set_property("uris", [url, f"file://{clip}"])
    p, dt, got, _ = run_string(gstpu_torch, device, f"{head} ! {tail}",
                               ("out",), build=build)
    return got["out"], dt, p


def quic_ready(sink) -> bool:
    """The QUIC (or WebTransport) sink's connection (or session) is up."""
    ep = sink._ep
    return ep.wt.session_ready if hasattr(ep, "wt") else ep.conn.connected


def quic_settled(sink) -> bool:
    """Nothing of the sink's connection waits to be sent or acked."""
    return not any(sp.unacked or sp.pending
                   for sp in sink._ep.conn._spaces.values())


def pump_until(cond, sink, r, what: str) -> None:
    """Pump the sink's endpoint and drain the receiver until `cond()`."""
    deadline = time.monotonic() + 120
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"18c: {what}")
        sink._ep.pump()
        drain(r)
        time.sleep(0.0005)


def quic_pair(gstpu_torch, device: str, send: str, recv: str, taps=(),
              feed=None, build=None, build_send=None,
              server_sink: bool = False) -> dict:
    """The sending string `send` (its QUIC sink `quic`) and the receiving
    one `recv` (its QUIC source `src`, every appsink named `out*` in it
    or added by `build(r)`), on 127.0.0.1, `build_send(s)` adding to the
    sending pipeline and `feed(s)` pushing its appsrc input. By default
    the source is the server: `recv` is set PLAYING (binding port 0),
    `send` gets its port in `{port}` and pins its certificate. With
    `server_sink` (the WebTransport pair) the sink binds and the source
    connects. A probe on the sink's pad connects both ends before the
    first buffer, drives the receiver every RTP_PACE buffers, and at EOS
    pumps both until nothing waits to be sent or acked; after the
    sender's end its connection is closed, which ends the receiver's
    stream. The pipelines (in NULL),
    the sender's wall seconds, the buffers by tap, every `out*` appsink's
    buffers and the sink's QUIC counts."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    if server_sink:
        s = gstpu_torch.parse_launch(send)
        if build_send is not None:
            build_send(s)
        s.set_state(State.READY)
        sink = s.get_by_name("quic")
        r = gstpu_torch.parse_launch(recv.format(port=sink.bound_port))
        r.get_by_name("src").certificate_fingerprint = sink.local_fingerprint
        if build is not None:
            build(r)
        r.set_state(State.PLAYING)
    else:
        r = gstpu_torch.parse_launch(recv)
        if build is not None:
            build(r)
        r.set_state(State.PLAYING)
        src = r.get_by_name("src")
        s = gstpu_torch.parse_launch(send.format(port=src.bound_port))
        if build_send is not None:
            build_send(s)
        sink = s.get_by_name("quic")
        sink.certificate_fingerprint = src.local_fingerprint
    pipes = {"send": s, "recv": r}
    recorded = {t: record_buffers(pipes[t[0]].get_by_name(t[1])
                                  .static_pad(t[2])) for t in taps}
    counts = {"sent": 0}

    def pace(_, item):
        if not hasattr(item, "to_bytes"):
            if type(item).__name__ == "EosEvent":
                pump_until(lambda: quic_settled(sink), sink, r,
                           "packets in flight at EOS were never acked")
            return None
        if not quic_ready(sink):
            pump_until(lambda: quic_ready(sink), sink, r,
                       "the handshake did not complete")
        counts["sent"] += 1
        if counts["sent"] % RTP_PACE == 0:
            drain(r)
        return None
    sink.static_pad("sink").add_probe(pace)
    s.set_state(State.PLAYING)
    conn = sink._ep.conn
    lost = {"lost": 0, "ptos": 0}
    on_lost, on_timeout = conn.cc.on_lost, conn.on_timeout

    def count_lost(*args, **kw):
        lost["lost"] += 1
        return on_lost(*args, **kw)

    def count_pto(*args, **kw):
        lost["ptos"] += 1
        return on_timeout(*args, **kw)
    conn.cc.on_lost, conn.on_timeout = count_lost, count_pto
    t0 = time.perf_counter()
    if feed is not None:
        feed(s)
    s.run(timeout=600)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    packets = {k: sp.next_pn for k, sp in conn._spaces.items()}
    s.set_state(State.NULL)
    outs = [el for el in r.iterate_elements()
            if el.name.startswith("out")]
    deadline = time.monotonic() + 120
    while not outs or not all(o.is_eos for o in outs):
        if time.monotonic() > deadline:
            raise TimeoutError("18c: the receiver's stream did not end")
        drain(r)
        time.sleep(0.0005)
        outs = [el for el in r.iterate_elements()
                if el.name.startswith("out")]
    got = {o.name: o.pull_all() for o in outs}
    r.set_state(State.NULL)
    return {"pipes": pipes, "seconds": dt, "counts": counts,
            "taps": recorded, "out": got,
            "quic": {"packets": packets, **lost}}


def roq_strings(w: int, h: int, n: int, cube: Path) -> tuple:
    """18c's datagram leg: the grade into rtpvrawpay2 at QUIC_MTU,
    quinnroqmux and quinnquicsink in datagram mode; quinnquicsrc (RoQ
    caps) into quinnroqdemux, the RTP caps of 17b, rtpvrawdepay2 and an
    appsink."""
    src, grade = grade_strings(w, h, n, cube)
    send = (f"{src} ! {grade} ! rtpvrawpay2 name=pay mtu={QUIC_MTU} "
            f"ssrc={RTP_SSRC} seqnum-offset=0 timestamp-offset=0 ! "
            f"quinnroqmux name=roq ! quinnquicsink name=quic "
            f"use-datagram=true address=127.0.0.1 port={{port}}")
    recv = (f'quinnquicsrc name=src address=127.0.0.1 port=0 caps='
            f'"application/x-roq" ! quinnroqdemux name=roqd ! capsfilter '
            f'caps="application/x-rtp, media=video, encoding-name=RAW, '
            f'clock-rate=90000, payload=96, sampling=RGBA, width=(string){w}'
            f', height=(string){h}, depth=(string)8" ! rtpvrawdepay2 '
            f'name=depay ! appsink name=out sync=false')
    return send, recv


def roq_grade(gstpu_torch, device: str, w: int, h: int, n: int,
              cube: Path) -> dict:
    """18c's datagram leg on `device`: quic_pair's result for
    roq_strings, with the frames received (bytes), the RTP sequence
    numbers into the depayloader and those lost (as 17b's)."""
    send, recv = roq_strings(w, h, n, cube)
    res = quic_pair(gstpu_torch, device, send, recv,
                    (("send", "pay", "src"), ("recv", "depay", "sink")))
    pk = importlib.import_module(f"{gstpu_torch.__name__}.net.rtp.packet")
    seqs = [pk.RtpPacket.parse(b.to_bytes()).seqnum
            for b in res["taps"]["recv", "depay", "sink"]]
    sent = len(res["taps"]["send", "pay", "src"])
    res.update(frames=[b.to_bytes() for b in res["out"]["out"]],
               seqnums=seqs, rtp_sent=sent, lost=sent - len(set(seqs)),
               in_order=seqs == list(range(sent)))
    return res


def phone_rtp_string() -> str:
    """17a's telephony leg up to its RTP payloader, without the FEC that
    a reliable QUIC stream does not need: the flagship from appsrc `src`
    into 8 kHz S16 mono A-law in 20 ms RTP packets (`pay`)."""
    caps = (f"audio/x-raw, format=F64LE, rate={RATE_192K}, channels=2, "
            f"layout=interleaved")
    return (f'appsrc name=src caps="{caps}" ! rsaudioecho name=echo '
            f'delay=250000000 intensity={AUDIO_INTENSITY} '
            f'feedback={AUDIO_FEEDBACK} ! audioloudnorm name=norm ! '
            f'audioresample name=res ! audio/x-raw, rate={PHONE_RATE} ! '
            f'audioconvert name=conv ! audio/x-raw, format=S16LE, '
            f'channels=1 ! alawenc name=ae ! rtppcmapay2 name=pay '
            f'mtu={PHONE_MTU} ssrc={RTP_SSRC} seqnum-offset=0 '
            f'timestamp-offset=0')


def quic_streams(gstpu_torch, device: str, w: int, h: int, n: int,
                 cube: Path, seconds: float) -> dict:
    """18c's stream leg on `device`: phone_rtp_string and the grade's
    rtpvrawpay2 (`vpay`, QUIC_MTU) linked into quinnquicmux (stream_0
    and stream_1) ahead of quinnquicsink; quinnquicsrc into
    quinnquicdemux, each pad it adds linked to an appsink `out_<pad>`.
    quic_pair's result with the RTP packets each payloader sent (`phone`,
    `video`) and each demuxed stream's packets (`streams`)."""
    src, grade = grade_strings(w, h, n, cube)
    make = importlib.import_module(
        f"{gstpu_torch.__name__}.core.registry").make
    send = "quinnquicmux name=mux ! quinnquicsink name=quic " \
           "address=127.0.0.1 port={port}"
    recv = "quinnquicsrc name=src address=127.0.0.1 port=0 ! " \
           "quinnquicdemux name=demux"
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0

    def build(r) -> None:
        def added(_, pad) -> None:
            out = make("appsink", f"out_{pad.name}", sync=False)
            r.add(out)
            out.set_state(gstpu_torch.State.PLAYING)
            pad.link(out.static_pad("sink"))
        r.get_by_name("demux").connect("pad-added", added)

    def build_send(s) -> None:
        gstpu_torch.parse_launch(phone_rtp_string(), pipeline=s)
        gstpu_torch.parse_launch(
            f"{src} ! {grade} ! rtpvrawpay2 name=vpay mtu={QUIC_MTU} "
            f"ssrc={RTP_SSRC + 1} seqnum-offset=0 timestamp-offset=0",
            pipeline=s)
        s.get_by_name("pay").link(s.get_by_name("mux"))
        s.get_by_name("vpay").link(s.get_by_name("mux"))

    res = quic_pair(gstpu_torch, device, send, recv,
                    (("send", "pay", "src"), ("send", "vpay", "src")),
                    feed_blocks(gstpu_torch, x, RATE_192K), build, build_send)
    res.update(
        phone=[b.to_bytes() for b in res["taps"]["send", "pay", "src"]],
        video=[b.to_bytes() for b in res["taps"]["send", "vpay", "src"]],
        streams={k: [b.to_bytes() for b in v] for k, v in res["out"].items()})
    return res


def wt_phone(gstpu_torch, device: str, seconds: float) -> dict:
    """18c's WebTransport leg on `device`: phone_rtp_string into
    quinnwtserversink (binding port 0, the server), read by
    quinnwtclientsrc into rtppcmadepay2, alawdec and an appsink. quic_pair's
    result with the RTP packets sent (`phone`) and the samples decoded."""
    send = f"{phone_rtp_string()} ! quinnwtserversink name=quic " \
           f"address=127.0.0.1 port=0"
    recv = ("quinnwtclientsrc name=src address=127.0.0.1 port={port} "
            f'caps="application/x-rtp, media=audio, clock-rate={PHONE_RATE}, '
            f'encoding-name=PCMA, payload=8" ! rtppcmadepay2 name=depay ! '
            f'alawdec name=ad ! appsink name=out sync=false')
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
    res = quic_pair(gstpu_torch, device, send, recv, (("send", "pay", "src"),),
                    feed_blocks(gstpu_torch, x, RATE_192K), server_sink=True)
    res.update(phone=[b.to_bytes() for b in res["taps"]["send", "pay", "src"]],
               samples=b"".join(b.to_bytes() for b in res["out"]["out"]))
    return res


def hls_phase(gstpu_torch, smi, tmp: Path, cube: Path, kernels) -> dict:
    """18a. hls_grade at BASELINE config 4's 1080p on the card and on the
    CPU: the files byte for byte (the audio segments' samples within
    EDGE_TOL), cmafmux reading each frame once for its sample and the
    first once more (gstpu's cmafmux keeps the first frame of every
    stream for the sample entries that need one), no sink reading one,
    each kernel once a frame."""
    w, h, n = EDGE_W, EDGE_H, HLS_FRAMES
    a, tracer, calls, launches = traced(kernels, lambda: hls_grade(
        gstpu_torch, "cuda", w, h, n, cube, tmp / "hls_card"))
    cpu = hls_grade(gstpu_torch, "cpu", w, h, n, cube, tmp / "hls_cpu")
    same = hls_compare(a["files"], cpu["files"])
    files = a["files"]
    p = a["pipe"]
    echo_out = tracer.payload.get(p.get_by_name("echo").static_pad("src"))
    segments = {k: sum(f.startswith(k + "_") and f.endswith(".m4s")
                       for f in files) for k in ("video", "dash", "hi",
                                                 "audio")}
    master = files["master.m3u8"].decode()
    r = {
        "frames": n, "fps": n / a["seconds"], "cpu_wall_s": cpu["seconds"],
        "files": len(files), "bytes": sum(map(len, files.values())),
        "segments": segments,
        "vtt_segments": sum(f.endswith(".vtt") for f in files),
        "compare": same, "launches": launches,
        "array_calls": new_reads(calls, ("vmux", "t", "hls", "dash", "mv",
                                         "asrc", "echo", "norm", "amux",
                                         "csrc", "cj", "jv", "vtt")),
        "vmux_reads_by_frame": [v for (el, _), v in sorted(
            calls.counts.items(), key=lambda x: (str(x[0][0]), x[0][1]))
            if el == "vmux"],
        "downloads": dict(calls.tensor_calls),
        "host_ms_a_frame": own_ms(tracer, p, ["vmux", "hls", "dash"], n),
        "host_ms_per_s": own_ms(tracer, p, ["echo", "norm", "amux"],
                                HLS_AUDIO_SECONDS),
        "host_ms_mv_both_pads": own_ms(tracer, p, ["mv"], 1)["mv"],
        "host_ms_vtt": own_ms(tracer, p, ["vtt"], 1)["vtt"],
        "echo_output": echo_out}
    log(f"[dist] 18a: {n} frames of {w}x{h} through the grade into cmafmux "
        f"({HLS_FRAGMENT_FRAMES}-frame fragments) teed into hlscmafsink, "
        f"dashsink2 and hlsmultivariantsink, {HLS_AUDIO_SECONDS} s of the "
        f"flagship into a second cmafmux as its audio rendition, "
        f"{len(HLS_CAPTIONS)} captions as WebVTT: {r['files']} files, "
        f"{r['bytes']} B, segments {segments}, {r['vtt_segments']} WebVTT; "
        f"against the CPU run's: {same}; Buffer.array calls "
        f"{r['array_calls']} (cmafmux's by frame "
        f"{r['vmux_reads_by_frame']}), downloads {r['downloads']}; launches "
        f"{launches}; {r['fps']:.3f} fps with the audio and captions in the "
        f"same run (tracer on), {cpu['seconds']:.3f} s on the CPU; host ms "
        f"a frame {r['host_ms_a_frame']}, per second of audio "
        f"{r['host_ms_per_s']}, hlsmultivariantsink "
        f"{r['host_ms_mv_both_pads']:.2f} ms in all, hlswebvttsink "
        f"{r['host_ms_vtt']:.2f}; the echo's "
        f"output: {echo_out}  [{smi}]")
    want = n // HLS_FRAGMENT_FRAMES
    if same["bad"] or same["max_abs_err"] > EDGE_TOL \
            or segments["video"] != want or segments["dash"] != want \
            or segments["hi"] != want or not segments["audio"] \
            or not r["vtt_segments"] \
            or "#EXT-X-MEDIA:TYPE=AUDIO" not in master \
            or "#EXT-X-STREAM-INF:" not in master \
            or not all(files[f].rstrip().endswith(b"#EXT-X-ENDLIST")
                       for f in ("video.m3u8", "hi.m3u8", "audio.m3u8",
                                 "subs.m3u8")) \
            or b'type="static"' not in files["manifest.mpd"] \
            or r["vmux_reads_by_frame"] != [2] + [1] * (n - 1) \
            or any(x in r["array_calls"] for x in ("hls", "dash", "mv",
                                                   "vtt")) \
            or any(v != n for v in launches.values()) \
            or echo_out != "tensor on cuda":
        raise AssertionError(f"18a: {r}")
    return r


def http_phase(gstpu_torch, smi, tmp: Path, edge: Path | None) -> dict:
    """18b. 13a's FLAC served over HTTP into 13a's string on the card
    through reqwesthttpsrc: the MP4 byte for byte 13a's filesrc MP4 (from
    phase 13's directory `edge`; without it, that string is run here);
    each source alone into fakesink; then fallbacksrc and uriplaylistbin
    on HTTP_CLIP_SECONDS clips into the flagship on the card and the CPU,
    the samples within EDGE_TOL."""
    from gstpu_torch.codecs.flac import encode_verbatim
    if edge is None or not (edge / "card.mp4").exists():
        edge = tmp / "edge"
        edge.mkdir()
        (edge / "in.flac").write_bytes(encode_verbatim(
            edge_signal(EDGE_SECONDS, EDGE_RATE), EDGE_RATE))
        run_string(gstpu_torch, "cuda", flac_string(
            f"filesrc location={edge / 'in.flac'}", edge / "card.mp4"))
    served = tmp / "served"
    served.mkdir()
    shutil.copy(edge / "in.flac", served / "in.flac")
    clip = served / "clip.flac"
    clip.write_bytes(encode_verbatim(edge_signal(HTTP_CLIP_SECONDS,
                                                 EDGE_RATE), EDGE_RATE))
    res = {}
    with Served(served) as srv:
        url = f"{srv.url}/in.flac"
        holder = {}

        def card_run():
            holder["p"], holder["dt"], _, _ = run_string(
                gstpu_torch, "cuda", flac_string(
                    f"reqwesthttpsrc location={url}", tmp / "http.mp4"))
        _, tracer, calls, _ = traced([], card_run)
        p = holder["p"]
        own = own_ms(tracer, p, ["dec", "conv", "res", "echo", "norm"],
                     EDGE_SECONDS)
        echo_out = tracer.payload.get(p.get_by_name("echo")
                                      .static_pad("src"))
        alone = {}
        for name, head in (("reqwesthttpsrc", f"reqwesthttpsrc "
                            f"location={url}"),
                           ("filesrc", f"filesrc location={served}/in.flac")):
            alone[name] = statistics.median(
                run_string(gstpu_torch, "cuda", f"{head} ! fakesink")[1]
                for _ in range(3)) * 1e3 / EDGE_SECONDS
        equal = (tmp / "http.mp4").read_bytes() \
            == (edge / "card.mp4").read_bytes()
        r = res["flac"] = {
            "seconds_of_audio": EDGE_SECONDS, "wall_s": holder["dt"],
            "equal_to_filesrc_mp4": equal, "host_ms_per_s": own,
            "source_alone_host_ms_per_s": alone, "echo_output": echo_out,
            "array_calls": new_reads(calls, ("dec", "conv", "res", "echo",
                                             "norm"))}
        log(f"[dist] 18b: 13a's {EDGE_SECONDS} s FLAC over HTTP through "
            f"reqwesthttpsrc into 13a's string on the card: the MP4 "
            f"{'equal to' if equal else 'DIFFERS FROM'} 13a's filesrc MP4; "
            f"{holder['dt']:.3f} s (tracer on); host ms per second of "
            f"audio by element {own}; each source alone into fakesink "
            f"(median of 3) {alone}; Buffer.array calls {r['array_calls']}; "
            f"the echo's output: {echo_out}  [{smi}]")
        if not equal or echo_out != "tensor on cuda":
            raise AssertionError(f"18b: {r}")

        for name, seconds in (("fallbacksrc", HTTP_CLIP_SECONDS),
                              ("uriplaylistbin", 2 * HTTP_CLIP_SECONDS)):
            card, tracer, calls, _ = traced([], lambda: http_clip(
                gstpu_torch, "cuda", name, f"{srv.url}/clip.flac", clip))
            cpu = http_clip(gstpu_torch, "cpu", name, f"{srv.url}/clip.flac",
                            clip)
            got, want = (np.concatenate([np.frombuffer(b.to_bytes(), "<f8")
                                         for b in x[0]]) for x in (card, cpu))
            err = float(np.abs(got - want).max()) \
                if got.shape == want.shape else float("inf")
            r = res[name] = {
                "samples": got.size // 2, "cpu_samples": want.size // 2,
                "max_abs_err": err, "wall_s": card[1], "cpu_wall_s": cpu[1],
                "host_ms_per_s": own_ms(tracer, card[2], ["conv", "res",
                                                          "echo", "norm"],
                                        seconds),
                "array_calls": new_reads(calls, ("conv", "res", "echo",
                                                 "norm", "out")),
                "echo_output": tracer.payload.get(
                    card[2].get_by_name("echo").static_pad("src"))}
            log(f"[dist] 18b: {name} over HTTP into the flagship on the "
                f"card: {r['samples']} samples at {RATE_192K} Hz, max |err| "
                f"{err:.3e} against the CPU's {r['cpu_samples']} (gate "
                f"{EDGE_TOL}); {r['wall_s']:.3f} s (tracer on), the CPU "
                f"{r['cpu_wall_s']:.3f} s; host ms per second of audio "
                f"{r['host_ms_per_s']}; Buffer.array calls "
                f"{r['array_calls']}; the echo's output: {r['echo_output']}"
                f"  [{smi}]")
            if not np.isfinite(got).all() or err > EDGE_TOL or not got.size \
                    or r["echo_output"] != "tensor on cuda":
                raise AssertionError(f"18b: {name}: {r}")
    n = round(HTTP_CLIP_SECONDS * EDGE_RATE)
    if res["uriplaylistbin"]["samples"] - res["fallbacksrc"]["samples"] \
            != 4 * n:
        raise AssertionError(f"18b: uriplaylistbin did not play both items: "
                             f"{res}")
    return res


def quic_phase(gstpu_torch, smi, cube: Path, kernels) -> dict:
    """18c. The grade as RoQ datagrams over QUIC (0 RTP packets lost, the
    frames the CPU run's), the telephony and grade RTP on two QUIC
    streams (each stream's packets those its payloader sent, and the CPU
    run's), the telephony RTP over WebTransport (the samples the CPU
    run's); QUIC packets a frame, losses and probes, host ms by element,
    each kernel's launches."""
    w, h = EDGE_W, EDGE_H
    res, launches = {}, {k.name: 0 for k in kernels}

    a, tracer, calls, n = traced(kernels, lambda: roq_grade(
        gstpu_torch, "cuda", w, h, QUIC_FRAMES, cube))
    cpu = roq_grade(gstpu_torch, "cpu", w, h, QUIC_FRAMES, cube)
    r = res["roq"] = {
        "frames": len(a["frames"]), "fps": QUIC_FRAMES / a["seconds"],
        "cpu_wall_s": cpu["seconds"], "rtp_a_frame": a["rtp_sent"]
        / QUIC_FRAMES, "quic_packets": a["quic"]["packets"],
        "quic_a_frame": a["quic"]["packets"][2] / QUIC_FRAMES,
        "lost_declared": a["quic"]["lost"], "probes": a["quic"]["ptos"],
        "lost": a["lost"], "in_order": a["in_order"],
        "equal_to_cpu": a["frames"] == cpu["frames"], "launches": n,
        "array_calls": new_reads(calls, ("pay", "roq", "quic", "src",
                                         "roqd", "depay", "out")),
        "downloads": dict(calls.tensor_calls),
        "host_ms_a_frame": {
            "send": own_ms(tracer, a["pipes"]["send"], ["pay", "roq",
                                                        "quic"], QUIC_FRAMES),
            "recv": own_ms(tracer, a["pipes"]["recv"], ["roqd", "depay",
                                                        "out"], QUIC_FRAMES)}}
    log(f"[dist] 18c: {r['frames']} frames of {w}x{h} through the grade into "
        f"rtpvrawpay2 mtu={QUIC_MTU}, quinnroqmux and quinnquicsink "
        f"use-datagram=true: {r['rtp_a_frame']} RTP packets and "
        f"{r['quic_a_frame']} QUIC packets a frame (by space "
        f"{r['quic_packets']}), {r['lost_declared']} declared lost, "
        f"{r['probes']} probes; {r['lost']} RTP packets lost, in order: "
        f"{r['in_order']}; frames "
        f"{'equal to' if r['equal_to_cpu'] else 'DIFFER FROM'} "
        f"the CPU run's; launches {n}; Buffer.array calls "
        f"{r['array_calls']}, downloads {r['downloads']}; {r['fps']:.3f} fps "
        f"with the receiver driven every {RTP_PACE} buffers on the same "
        f"thread (tracer on), {cpu['seconds']:.3f} s on the CPU; host ms a "
        f"frame {r['host_ms_a_frame']}  [{smi}]")
    if r["frames"] != QUIC_FRAMES or r["lost"] or not r["in_order"] \
            or not r["equal_to_cpu"] or r["array_calls"] != {
                "pay": QUIC_FRAMES} \
            or any(v != QUIC_FRAMES for v in n.values()):
        raise AssertionError(f"18c: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    b, tracer, calls, n = traced(kernels, lambda: quic_streams(
        gstpu_torch, "cuda", w, h, QUIC_STREAM_FRAMES, cube, PHONE_SECONDS))
    cpu = quic_streams(gstpu_torch, "cpu", w, h, QUIC_STREAM_FRAMES, cube,
                       PHONE_SECONDS)
    got = list(b["streams"].values())
    echo_out = tracer.payload.get(b["pipes"]["send"].get_by_name("echo")
                                  .static_pad("src"))
    r = res["streams"] = {
        "frames": QUIC_STREAM_FRAMES, "seconds_of_audio": PHONE_SECONDS,
        "wall_s": b["seconds"], "cpu_wall_s": cpu["seconds"],
        "streams": {k: len(v) for k, v in b["streams"].items()},
        "quic_packets": b["quic"]["packets"],
        "lost_declared": b["quic"]["lost"], "probes": b["quic"]["ptos"],
        "phone_as_sent": b["phone"] in got,
        "video_as_sent": b["video"] in got,
        "phone_equal_to_cpu": b["phone"] == cpu["phone"],
        "video_equal_to_cpu": b["video"] == cpu["video"], "launches": n,
        "array_calls": new_reads(calls, ("pay", "vpay", "mux", "quic", "src",
                                         "demux")),
        "host_ms_per_s": own_ms(tracer, b["pipes"]["send"],
                                ["echo", "norm", "res", "conv", "ae", "pay"],
                                PHONE_SECONDS),
        "host_ms_a_frame": own_ms(tracer, b["pipes"]["send"],
                                  ["vpay", "mux", "quic"],
                                  QUIC_STREAM_FRAMES),
        "echo_output": echo_out}
    log(f"[dist] 18c: {PHONE_SECONDS} s of the telephony leg's RTP and "
        f"the RTP of {QUIC_STREAM_FRAMES} graded frame(s) through "
        f"quinnquicmux and "
        f"quinnquicsink on two QUIC streams into quinnquicsrc and "
        f"quinnquicdemux: packets by stream {r['streams']}, QUIC packets by "
        f"space {r['quic_packets']}, {r['lost_declared']} declared lost, "
        f"{r['probes']} probes; each stream what its payloader sent: "
        f"telephony {r['phone_as_sent']}, video {r['video_as_sent']}; the "
        f"CPU run's: telephony {r['phone_equal_to_cpu']}, video "
        f"{r['video_equal_to_cpu']}; launches {n}; Buffer.array calls "
        f"{r['array_calls']}; {b['seconds']:.3f} s (tracer on), "
        f"{cpu['seconds']:.3f} s on the CPU; host ms per second of audio "
        f"{r['host_ms_per_s']}, a frame {r['host_ms_a_frame']}; the echo's "
        f"output: {echo_out}  [{smi}]")
    if len(b["streams"]) != 2 or not all(
            r[k] for k in ("phone_as_sent", "video_as_sent",
                           "phone_equal_to_cpu", "video_equal_to_cpu")) \
            or any(v != QUIC_STREAM_FRAMES for v in n.values()) \
            or r["array_calls"].get("vpay") != QUIC_STREAM_FRAMES \
            or echo_out != "tensor on cuda":
        raise AssertionError(f"18c: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    c, tracer, calls, _ = traced(kernels, lambda: wt_phone(
        gstpu_torch, "cuda", PHONE_SECONDS))
    echo_out = tracer.payload.get(c["pipes"]["send"].get_by_name("echo")
                                  .static_pad("src"))
    cpu = wt_phone(gstpu_torch, "cpu", PHONE_SECONDS)
    r = res["webtransport"] = {
        "seconds_of_audio": PHONE_SECONDS, "wall_s": c["seconds"],
        "cpu_wall_s": cpu["seconds"], "rtp_packets": len(c["phone"]),
        "quic_packets": c["quic"]["packets"],
        "lost_declared": c["quic"]["lost"], "probes": c["quic"]["ptos"],
        "samples": len(c["samples"]) // 2,
        "equal_to_cpu": c["samples"] == cpu["samples"],
        "array_calls": new_reads(calls, ("echo", "norm", "res", "conv", "ae",
                                         "pay", "quic", "src", "depay", "ad",
                                         "out")),
        "echo_output": echo_out,
        "host_ms_per_s": {
            "send": own_ms(tracer, c["pipes"]["send"], ["pay", "quic"],
                           PHONE_SECONDS),
            "recv": own_ms(tracer, c["pipes"]["recv"], ["depay", "ad",
                                                        "out"],
                           PHONE_SECONDS)}}
    log(f"[dist] 18c: {PHONE_SECONDS} s of the telephony leg's RTP, "
        f"{r['rtp_packets']} packets, through quinnwtserversink into "
        f"quinnwtclientsrc, rtppcmadepay2 and alawdec: {r['samples']} "
        f"samples {'equal to' if r['equal_to_cpu'] else 'DIFFERENT FROM'} "
        f"the CPU run's; QUIC packets by space {r['quic_packets']}, "
        f"{r['lost_declared']} declared lost, {r['probes']} probes; "
        f"{c['seconds']:.3f} s (tracer on), {cpu['seconds']:.3f} s on the "
        f"CPU; host ms per second of audio {r['host_ms_per_s']}; "
        f"Buffer.array calls {r['array_calls']}; the echo's output: "
        f"{echo_out}  [{smi}]")
    if r["samples"] != round(PHONE_SECONDS * PHONE_RATE) \
            or not r["equal_to_cpu"] or echo_out != "tensor on cuda":
        raise AssertionError(f"18c: {r}")
    res["launches"] = launches
    return res


def distribution_phase(gstpu_torch, smi, tmp: Path, kernels,
                       edge: Path | None = None) -> dict:
    """18. Queue D item 5's elements between the card's chains and their
    audience, all on 127.0.0.1: (a) HLS, DASH and WebVTT segments of the
    grade and the flagship's audio; (b) the FLAC over HTTP; (c) RTP over
    QUIC and WebTransport, only where `cryptography` imports. Each
    kernel's launches in a and c."""
    cube = tmp / "dist.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res = {"hls": hls_phase(gstpu_torch, smi, tmp, cube, kernels),
           "http": http_phase(gstpu_torch, smi, tmp, edge)}
    launches = dict(res["hls"]["launches"])
    not_run = dict(NOT_ON_THE_CARD_18)
    if importlib.util.find_spec("cryptography") is None:
        not_run["quinnquicsink, quinnquicsrc, quinnquicmux, "
                "quinnquicdemux, quinnwtserversink, quinnwtclientsrc, "
                "quinnroqmux, quinnroqdemux (18c)"] = (
            "the `cryptography` package does not import on this machine "
            "(its TLS 1.3 and packet protection need it); "
            "tests/test_torch_quic.py holds them against gstpu's")
    else:
        res["quic"] = quic_phase(gstpu_torch, smi, cube, kernels)
        for k, v in res["quic"]["launches"].items():
            launches[k] += v
    res["not_on_the_card"] = not_run
    for name, why in not_run.items():
        log(f"[dist] not run on the card: {name}: {why}")
    res["launches"] = launches
    return res


def alaw_string() -> str:
    """19a's source: phone_rtp_string up to its A-law encoder `ae`."""
    return phone_rtp_string().split(" ! rtppcmapay2")[0]


def element_messages(gstpu_torch, p) -> list:
    """The fields of every element message that `p`'s bus carries from
    now on, in order (a sync handler)."""
    mt = importlib.import_module(f"{gstpu_torch.__name__}.core.element")
    out: list = []

    def seen(m) -> None:
        if m.type is mt.MessageType.ELEMENT:
            out.append(m.fields)
    p.bus.add_sync_handler(seen)
    return out


def wait_for(cond, what: str, *steps, limit: float = WEBRTC_LIMIT) -> None:
    """Run `steps` until `cond()` holds; TimeoutError after `limit` s."""
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"19: {what}")
        for step in steps:
            step()
        time.sleep(0.0005)


def iterate_until_eos(gstpu_torch, p, pad, feed=None) -> float:
    """Set `p` PLAYING, `feed(p)` pushing its appsrc input, and iterate it
    until EOS has passed `pad`: the WebRTC sinks take EOS in and post
    none. The wall seconds, the card synchronised."""
    seen = {"eos": False}

    def probe(_, item) -> None:
        if type(item).__name__ == "EosEvent":
            seen["eos"] = True
    pad.add_probe(probe)
    p.set_state(gstpu_torch.State.PLAYING)
    t0 = time.perf_counter()
    if feed is not None:
        feed(p)

    def step() -> None:
        if p._error_seen is not None:
            raise RuntimeError(f"pipeline error: {p._error_seen}")
        p.iterate()
    wait_for(lambda: seen["eos"], "no EOS reached the sink", step,
             limit=600)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def seq_loss(packets: list, sent: int) -> dict:
    """The RTP sequence numbers of `packets` (bytes), those lost of
    `sent`, and whether they came in order without a gap."""
    seqs = [int.from_bytes(b[2:4], "big") for b in packets]
    return {"seqnums": seqs, "lost": sent - len(set(seqs)),
            "in_order": seqs == list(range(seqs[0], seqs[0] + len(seqs)))
            if seqs else False}


def webrtc_session(gstpu_torch, device: str, send: str, head: str,
                   kind: str, feed=None, setup=None) -> dict:
    """19a and 19d on `device`: the string `send`, its element `head`
    linked into a request pad of webrtcsink `rtc` (data transport, its
    own signalling server, GCC; `setup(sink)` before it starts), and in a
    second pipeline webrtcsrc `rtc`, pointed at the URI the sink
    announced, its RTP pad into appsink `rtp` and its typed pad
    `{kind}_0` into appsink `out`. webrtcsrc negotiates by itself over
    the server (listing, SDP, ICE, DTLS, SRTP). A probe on the sink's pad
    starts the receiver at the first buffer and pumps both ends until
    both transports are connected, then pumps the receiver on every
    buffer, and at EOS both until every RTP packet the sink sent has
    arrived and the sink has handled TWCC feedback for each 16 that did
    (webrtcsrc sends one for each 16 arrivals). A probe on the sink's
    payloader pumps the receiver every RTP_PACE packets, so that its
    socket never holds more than that. The pipelines (in NULL),
    the wall seconds, what `head` pushed (`head`), the RTP packets the
    sink sent (`sent`), those that arrived (`rtp`), the typed pad's
    buffers (`out`), the TWCC feedback the sink handled, both stats and
    the element messages of both pipelines."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    make = importlib.import_module(
        f"{gstpu_torch.__name__}.core.registry").make
    s = gstpu_torch.parse_launch(send)
    sink = make("webrtcsink", "rtc", enable_data_transport=True,
                run_signalling_server=True, congestion_control="gcc")
    if setup is not None:
        setup(sink)
    paced = {"packets": 0}

    def pace_packets(_, item) -> None:
        if hasattr(item, "to_bytes"):
            paced["packets"] += 1
            if paced["packets"] % RTP_PACE == 0:
                src.pump()

    def pace_payloader(_, pad_name, pay) -> bool:
        pay.static_pad("src").add_probe(pace_packets)
        return False
    sink.connect("payloader-setup", pace_payloader)
    s.add(sink)
    pad = sink.request_pad()
    s.get_by_name(head).static_pad("src").link(pad)
    pushed = record_buffers(s.get_by_name(head).static_pad("src"))
    msgs = {"send": element_messages(gstpu_torch, s)}
    twcc: list = []
    handle = sink.handle_twcc_feedback

    def counted(data: bytes):
        twcc.append(len(data))
        return handle(data)
    sink.handle_twcc_feedback = counted
    s.set_state(State.READY)
    uri = next(m["uri"] for m in msgs["send"]
               if m.get("name") == "signalling-server-started")
    core = sink._sig_server.core
    wait_for(lambda: any("producer" in p.roles
                         for p in list(core._peers.values())),
             "the producer never registered")
    r = gstpu_torch.parse_launch(
        f"webrtcsrc name=rtc enable-data-transport=true "
        f"signaller-uri={uri} ! appsink name=rtp sync=false")
    src = r.get_by_name("rtc")
    out = make("appsink", "out", sync=False)
    r.add(out)
    on_pad_added(src, f"{kind}_0", out.static_pad("sink"))
    msgs["recv"] = element_messages(gstpu_torch, r)
    arrived = record_buffers(src.static_pad("src"))

    def n_sent() -> int:
        return sum(n for n, _, _ in getattr(sink, "_sr_acct", {}).values())

    def connected() -> bool:
        trs = list(sink._transports.values())
        return bool(trs and trs[0][0].connected and src._transport
                    is not None and src._transport.connected)

    state = {"started": False}

    def pace(_, item):
        if not hasattr(item, "to_bytes"):
            if type(item).__name__ == "EosEvent":
                wait_for(lambda: len(arrived) == n_sent() and len(twcc)
                         >= len(arrived) // 16,
                         "not every RTP packet or TWCC report arrived",
                         sink.pump, src.pump)
            return None
        if not state["started"]:
            state["started"] = True
            r.set_state(State.PLAYING)
            wait_for(connected, "the session never connected",
                     sink.pump, src.pump)
        src.pump()
        return None
    pad.add_probe(pace)
    dt = iterate_until_eos(gstpu_torch, s, pad, feed)
    sid = next(iter(sink._transports))
    res = {"pipes": {"send": s, "recv": r}, "seconds": dt, "uri": uri,
           "head": [b.to_bytes() for b in pushed], "sent": n_sent(),
           "rtp": [b.to_bytes() for b in arrived],
           "out": [b.to_bytes() for b in out.pull_all()],
           "twcc": twcc, "sink_stats": sink.stats,
           "src_stats": src.stats, "session": sid,
           "limits": (sink.min_bitrate, sink.max_bitrate)}
    r.set_state(State.NULL)
    s.set_state(State.NULL)
    # webrtcsrc's NULL leaves its signalling client running (gstpu's
    # second `stop` hides the first; ROADMAP Queue C)
    if src._sig_client is not None:
        src._sig_client.stop()
    res.update(msgs=msgs, server_stopped=sink._sig_server is None
               and sink._sig_client is None, **seq_loss(res["rtp"],
                                                       res["sent"]))
    res["auth_failures"] = sum(
        m.get("name") == "webrtc-transport-drop"
        for side in msgs.values() for m in side)
    return res


def webrtc_phone(gstpu_torch, device: str, seconds: float) -> dict:
    """19a on `device`: `seconds` of edge_signal through alaw_string into
    webrtc_session, read depayloaded on `audio_0`. The sink's payloader
    gets 17a's mtu in its payloader-setup signal, so that it sends 20 ms
    packets (its default mtu makes ~173 ms ones)."""
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0

    def setup(sink) -> None:
        def configure(_, pad_name, pay) -> bool:
            pay.mtu = PHONE_MTU
            return False
        sink.connect("payloader-setup", configure)
    return webrtc_session(gstpu_torch, device, alaw_string(), "ae",
                          "audio", feed_blocks(gstpu_torch, x, RATE_192K),
                          setup)


def webrtc_video(gstpu_torch, device: str, w: int, h: int, n: int,
                 cube: Path) -> dict:
    """19d on `device`: the grade on n raw frames, as I420 (the encoders
    take no RGBA), into webrtcsink's encoder chain (the codec its
    discovery picks), read depayloaded on
    `video_0`. webrtc_session's result with what the encoder wrote
    (`encoded`) and its factory."""
    src, grade = grade_strings(w, h, n, cube)
    enc: dict = {"buffers": []}

    def setup(sink) -> None:
        def chosen(_, pad_name, encoder) -> bool:
            enc["factory"] = type(encoder).__name__
            enc["buffers"] = record_buffers(encoder.static_pad("src"))
            return False
        sink.connect("encoder-setup", chosen)
    res = webrtc_session(gstpu_torch, device, f'{src} ! {grade} ! '
                         f'videoconvert ! capsfilter name=i420 caps='
                         f'"video/x-raw, format=I420"', "i420", "video",
                         setup=setup)
    res.update(encoder=enc.get("factory"),
               encoded=[b.to_bytes() for b in enc["buffers"]])
    return res


def srtp_keys(gstpu_torch) -> tuple:
    """19b's keys: two of the package's DtlsEndpoints complete a
    handshake in memory; the client's exported sending key and salt and
    the server's receiving ones, each as the 60 hex digits webrtcsend
    and webrtcrecv take."""
    dtls = importlib.import_module(
        f"{gstpu_torch.__name__}.net.webrtc.dtls")
    client = dtls.DtlsEndpoint(client=True)
    server = dtls.DtlsEndpoint(client=False)
    client.handshake()
    while not (client.connected and server.connected):
        moved = False
        while (d := client.poll_transmit()) is not None:
            server.handle_packet(d)
            moved = True
        while (d := server.poll_transmit()) is not None:
            client.handle_packet(d)
            moved = True
        if not moved:
            raise AssertionError("19b: the DTLS handshake stalled")
    return (b"".join(client.srtp_keys.send_key_salt(True)).hex(),
            b"".join(server.srtp_keys.recv_key_salt(False)).hex())


def srtp_grade(gstpu_torch, device: str, w: int, h: int, n: int,
               cube: Path) -> dict:
    """19b on `device`: vraw_strings with webrtcsend ahead of udpsink and
    webrtcrecv behind udpsrc (SRTP caps with the stream's fields), keyed
    by srtp_keys. udp_pair's result, with the frames received (bytes),
    the sequence numbers into the depayloader and those lost (as 17b's),
    and webrtcrecv's authentication failures."""
    tx, rx = srtp_keys(gstpu_torch)
    send, recv = vraw_strings(w, h, n, cube)
    send = send.replace(" ! udpsink", f" ! webrtcsend name=srtp key={tx} "
                        f"! udpsink")
    recv = recv.replace("application/x-rtp", "application/x-srtp").replace(
        " ! rtpvrawdepay2", f" ! webrtcrecv name=srtp key={rx} ! "
        f"rtpvrawdepay2")
    res = udp_pair(gstpu_torch, device, send, recv,
                   (("recv", "depay", "sink"),))
    res.update(seq_loss([b.to_bytes()
                         for b in res["taps"]["recv", "depay", "sink"]],
                        res["counts"]["sent"]),
               frames=[b.to_bytes() for b in res["out"]], keys_equal=tx == rx,
               auth_failures=res["pipes"]["recv"].get_by_name("srtp")
               .stats["auth_failures"])
    return res


def relay_pad(gstpu_torch, fn):
    """A sink pad of no element that hands each buffer to `fn(buf)`: the
    application's hop between a WHIP or WHEP element and its peer."""
    el = importlib.import_module(f"{gstpu_torch.__name__}.core.element")
    caps = importlib.import_module(f"{gstpu_torch.__name__}.core.caps")
    pad = el.Pad("relay", el.PadDirection.SINK, el.PadTemplate(
        "sink", el.PadDirection.SINK, el.PadPresence.ALWAYS,
        caps.Caps.any()))

    def chain(_, buf):
        fn(buf)
        return el.FlowReturn.OK
    pad.chain_function = chain
    pad.event_function = lambda p, e: True
    return pad


def whip_phone(gstpu_torch, device: str, seconds: float) -> dict:
    """19c's WHIP leg on `device`: phone_rtp_string into whipclientsink
    `whip`, and whipserversrc `srv` in a second pipeline. The client's
    offer and the server's answer pass between them as HTTP records in
    code (the WHIP POST); the session pad the server adds feeds appsink
    `out`, and the client's `rtp` pad hands each packet to the server's
    push_rtp. Then the client's DELETE. The wall seconds, the RTP the
    payloader sent (`sent`), what `out` got, the HTTP statuses and
    whether the DELETE took the session pad away."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    make = importlib.import_module(
        f"{gstpu_torch.__name__}.core.registry").make
    s = gstpu_torch.parse_launch(f"{phone_rtp_string()} ! whipclientsink "
                                 f"name=whip whip-endpoint=/whip")
    r = gstpu_torch.parse_launch("whipserversrc name=srv")
    out = make("appsink", "out", sync=False)
    r.add(out)
    r.set_state(State.PLAYING)
    s.set_state(State.READY)
    whip, srv = s.get_by_name("whip"), r.get_by_name("srv")
    resp = srv.handle_request(whip.post_offer(WHIP_OFFER.format("sendonly")))
    whip.handle_response(resp)
    sid = whip.session.resource_url.rsplit("/", 1)[1]
    srv.static_pad(f"session_{sid}").link(out.static_pad("sink"))
    whip.static_pad("rtp").link(relay_pad(
        gstpu_torch, lambda b: srv.push_rtp(sid, b.to_bytes(), b.pts)))
    sent = record_buffers(s.get_by_name("pay").static_pad("src"))
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
    dt = iterate_until_eos(gstpu_torch, s, whip.static_pad("sink"),
                           feed_blocks(gstpu_torch, x, RATE_192K))
    got = [b.to_bytes() for b in out.pull_all()]
    bye = srv.handle_request(whip.session.teardown())
    res = {"seconds": dt, "sent": [b.to_bytes() for b in sent], "got": got,
           "status": (resp.status, bye.status), "state": whip.session.state,
           "pad_removed": srv.static_pad(f"session_{sid}") is None,
           "pipes": {"send": s, "recv": r}}
    for p in (s, r):
        p.set_state(State.NULL)
    return res


def whep_phone(gstpu_torch, device: str, seconds: float,
               clients: int) -> dict:
    """19c's WHEP leg on `device`: phone_rtp_string into whepserversink
    `whep`; in a second pipeline `clients` whepclientsrc `c<i>`, each
    into appsink `out<i>`. Each client's offer and the server's answer
    pass between them as HTTP records in code; each session pad the
    server adds hands its packets to its client's push_rtp. The wall
    seconds, the RTP the payloader sent (`sent`) and what each `out<i>`
    got."""
    gstpu_torch.init(device=device)
    State = gstpu_torch.State
    s = gstpu_torch.parse_launch(f"{phone_rtp_string()} ! whepserversink "
                                 f"name=whep")
    r = gstpu_torch.parse_launch("whepclientsrc name=c0 whep-endpoint=/whep "
                                 "! appsink name=out0 sync=false")
    for i in range(1, clients):
        gstpu_torch.parse_launch(f"whepclientsrc name=c{i} whep-endpoint="
                                 f"/whep ! appsink name=out{i} sync=false",
                                 pipeline=r)
    r.set_state(State.PLAYING)
    s.set_state(State.READY)
    whep = s.get_by_name("whep")
    status = []
    for i in range(clients):
        c = r.get_by_name(f"c{i}")
        resp = whep.handle_request(c.post_offer(WHIP_OFFER.format(
            "recvonly")))
        status.append(resp.status)
        c.handle_response(resp)
        sid = c.session.resource_url.rsplit("/", 1)[1]
        whep.static_pad(f"session_{sid}").link(relay_pad(
            gstpu_torch, lambda b, c=c: c.push_rtp(b.to_bytes(), b.pts)))
    sent = record_buffers(s.get_by_name("pay").static_pad("src"))
    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
    dt = iterate_until_eos(gstpu_torch, s, whep.static_pad("sink"),
                           feed_blocks(gstpu_torch, x, RATE_192K))
    res = {"seconds": dt, "sent": [b.to_bytes() for b in sent],
           "got": [[b.to_bytes() for b in r.get_by_name(f"out{i}")
                    .pull_all()] for i in range(clients)],
           "status": status, "pipes": {"send": s, "recv": r}}
    for p in (s, r):
        p.set_state(State.NULL)
    return res


def webrtc_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """19. Queue D item 6's WebRTC elements between the card's chains and
    their peers, all on 127.0.0.1: (a) the flagship's telephony in a live
    webrtcsink-webrtcsrc session over the sink's own signalling server;
    (b) BASELINE config 4's 1080p grade over SRTP keyed by a DTLS
    handshake; (c) the telephony RTP through WHIP and WHEP; (d) the grade
    into webrtcsink's encoder chain, only where the codec shim links.
    Each leg is held against the same on the CPU. Each kernel's launches
    in b and d."""
    cube = tmp / "webrtc.cube"
    write_cube(cube, np.random.default_rng(SEED))
    res, launches = {}, {k.name: 0 for k in kernels}
    w, h = EDGE_W, EDGE_H

    # 19a
    a, tracer, calls, _ = traced(kernels, lambda: webrtc_phone(
        gstpu_torch, "cuda", PHONE_SECONDS))
    cpu = webrtc_phone(gstpu_torch, "cpu", PHONE_SECONDS)
    est = a["sink_stats"]["gcc-estimate"]
    lo, hi = a["limits"]
    r = res["session"] = {
        "seconds_of_audio": PHONE_SECONDS, "wall_s": a["seconds"],
        "cpu_wall_s": cpu["seconds"], "uri": a["uri"],
        "connected": [a["sink_stats"]["sessions"][a["session"]]
                      ["transport-connected"],
                      a["src_stats"]["transport-connected"]],
        "data_channel_open": a["sink_stats"]["sessions"][a["session"]]
        ["data-channel-open"],
        "rtp_sent": a["sent"], "rtp_arrived": len(a["rtp"]),
        "lost": a["lost"], "in_order": a["in_order"],
        "auth_failures": a["auth_failures"],
        "twcc_feedback": len(a["twcc"]), "twcc_bytes": a["twcc"],
        "gcc_estimate": est, "gcc_limits": [lo, hi],
        "alaw_bytes": sum(map(len, a["out"])),
        "equal_to_cpu": a["out"] == cpu["out"],
        "equal_to_alawenc": b"".join(a["out"]) == b"".join(a["head"]),
        "cpu_lost": cpu["lost"], "cpu_auth_failures": cpu["auth_failures"],
        "server_stopped": a["server_stopped"],
        "array_calls": new_reads(calls, ("ae", "rtc", "out", "rtp")),
        "echo_output": tracer.payload.get(
            a["pipes"]["send"].get_by_name("echo").static_pad("src")),
        "host_ms_per_s": {
            "send": own_ms(tracer, a["pipes"]["send"],
                           ["echo", "norm", "res", "conv", "ae", "rtc"],
                           PHONE_SECONDS),
            "recv": own_ms(tracer, a["pipes"]["recv"], ["out", "rtp"],
                           PHONE_SECONDS)}}
    log(f"[webrtc] 19a: {PHONE_SECONDS} s of the flagship at 192 kHz stereo "
        f"into A-law at {PHONE_RATE} Hz, into webrtcsink (its signalling "
        f"server at {r['uri']}), negotiated by webrtcsrc over it: transports "
        f"connected {r['connected']}, data channel open "
        f"{r['data_channel_open']}; {r['rtp_sent']} RTP packets sent, "
        f"{r['rtp_arrived']} arrived, {r['lost']} lost, in order "
        f"{r['in_order']}, {r['auth_failures']} SRTP drops; "
        f"{r['twcc_feedback']} TWCC feedback packets ({r['twcc_bytes']} B) "
        f"into GCC, estimate {est} bps within [{lo}, {hi}]; "
        f"{r['alaw_bytes']} A-law bytes on audio_0, "
        f"{'equal to' if r['equal_to_cpu'] else 'DIFFERENT FROM'} the CPU "
        f"run's, what alawenc wrote: {r['equal_to_alawenc']}; the echo's "
        f"output {r['echo_output']}; Buffer.array calls {r['array_calls']}; "
        f"{a['seconds']:.3f} s on the card (tracer on), {cpu['seconds']:.3f} "
        f"s on the CPU; host ms per second of audio: " + "; ".join(
            f"{side} " + ", ".join(f"{k} {v:.2f}" for k, v in o.items())
            for side, o in r["host_ms_per_s"].items()) + f"  [{smi}]")
    if not (all(r["connected"]) and r["equal_to_cpu"]
            and r["equal_to_alawenc"] and r["alaw_bytes"]
            == round(PHONE_SECONDS * PHONE_RATE) and r["lost"] == 0
            and r["in_order"] and r["auth_failures"] == 0
            and r["cpu_lost"] == 0 and r["cpu_auth_failures"] == 0
            and r["twcc_feedback"] == r["rtp_arrived"] // 16 > 0
            and est is not None and lo <= est <= hi
            and r["server_stopped"]
            and r["echo_output"] == "tensor on cuda"):
        raise AssertionError(f"19a: {r}")

    # 19b
    b, tracer, calls, n = traced(kernels, lambda: srtp_grade(
        gstpu_torch, "cuda", w, h, WEBRTC_FRAMES, cube))
    cpu = srtp_grade(gstpu_torch, "cpu", w, h, WEBRTC_FRAMES, cube)
    r = res["srtp"] = {
        "frames": len(b["frames"]), "fps": WEBRTC_FRAMES / b["seconds"],
        "cpu_wall_s": cpu["seconds"], "keys_equal": b["keys_equal"],
        "datagrams": b["counts"]["sent"],
        "packets_a_frame": b["counts"]["sent"] / WEBRTC_FRAMES,
        "lost": b["lost"], "in_order": b["in_order"],
        "auth_failures": b["auth_failures"],
        "equal_to_cpu": b["frames"] == cpu["frames"],
        "cpu_lost": cpu["lost"], "launches": n,
        "array_calls": new_reads(calls, ("pay", "srtp", "udp", "src",
                                         "depay", "out")),
        "downloads": dict(calls.tensor_calls),
        "grade_output": tracer.payload.get(
            b["pipes"]["send"].get_by_name("pay").static_pad("sink").peer),
        "native_recvmmsg": b["native"],
        "host_ms_a_frame": {
            "send": own_ms(tracer, b["pipes"]["send"],
                           ["pay", "srtp", "udp"], WEBRTC_FRAMES),
            "recv": own_ms(tracer, b["pipes"]["recv"],
                           ["srtp", "depay", "out"], WEBRTC_FRAMES)}}
    log(f"[webrtc] 19b: {r['frames']} frames of {w}x{h} RGBA through the "
        f"grade into rtpvrawpay2 mtu={RTP_MTU}, webrtcsend and udpsink, "
        f"into udpsrc, webrtcrecv and rtpvrawdepay2, keyed by a DTLS "
        f"handshake (the two ends' keys equal: {r['keys_equal']}); "
        f"{r['packets_a_frame']} SRTP packets a frame, {r['lost']} lost, "
        f"in order {r['in_order']}, {r['auth_failures']} authentication "
        f"failures; frames {'equal to' if r['equal_to_cpu'] else 'DIFFERENT FROM'}"
        f" the CPU run's; the grade reached the payloader as "
        f"{r['grade_output']}; Buffer.array calls {r['array_calls']}, "
        f"downloads {r['downloads']}; launches {n}; native recvmmsg "
        f"{b['native']}; {r['fps']:.3f} fps (tracer on), "
        f"{cpu['seconds']:.3f} s on the CPU; host ms a frame "
        f"{r['host_ms_a_frame']} (udpsink beside webrtcsend is 17b's "
        f"element)  [{smi}]")
    if not r["equal_to_cpu"] or r["frames"] != WEBRTC_FRAMES \
            or r["lost"] or not r["in_order"] or r["auth_failures"] \
            or r["cpu_lost"] or not r["keys_equal"] \
            or r["array_calls"] != {"pay": WEBRTC_FRAMES} \
            or r["downloads"] != {"pay": WEBRTC_FRAMES} \
            or r["grade_output"] != "tensor on cuda" \
            or any(v != WEBRTC_FRAMES for v in n.values()):
        raise AssertionError(f"19b: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    # 19c
    c, tracer, calls, _ = traced(kernels, lambda: whip_phone(
        gstpu_torch, "cuda", PHONE_SECONDS))
    cpu = whip_phone(gstpu_torch, "cpu", PHONE_SECONDS)
    r = res["whip"] = {
        "rtp_sent": len(c["sent"]), "got": len(c["got"]),
        "exact": c["got"] == c["sent"], "equal_to_cpu": c["got"]
        == cpu["got"], "http_status": c["status"], "state": c["state"],
        "pad_removed": c["pad_removed"], "wall_s": c["seconds"],
        "array_calls": new_reads(calls, ("pay", "whip", "srv", "out")),
        "host_ms_per_s": own_ms(tracer, c["pipes"]["send"],
                                ["pay", "whip"], PHONE_SECONDS)}
    e, tracer, calls, _ = traced(kernels, lambda: whep_phone(
        gstpu_torch, "cuda", PHONE_SECONDS, WHEP_CLIENTS))
    cpu = whep_phone(gstpu_torch, "cpu", PHONE_SECONDS, WHEP_CLIENTS)
    q = res["whep"] = {
        "rtp_sent": len(e["sent"]), "got": [len(g) for g in e["got"]],
        "exact": [g == e["sent"] for g in e["got"]],
        "equal_to_cpu": e["got"] == cpu["got"], "http_status": e["status"],
        "wall_s": e["seconds"],
        "array_calls": new_reads(calls, ("pay", "whep", "out0", "out1")),
        "host_ms_per_s": own_ms(tracer, e["pipes"]["send"],
                                ["pay", "whep"], PHONE_SECONDS)}
    log(f"[webrtc] 19c: the telephony RTP through whipclientsink into "
        f"whipserversrc (HTTP {r['http_status']}, resource {r['state']}, "
        f"session pad removed by the DELETE: {r['pad_removed']}): "
        f"{r['got']} of {r['rtp_sent']} packets, exactly what the payloader "
        f"sent: {r['exact']}, the CPU run's: {r['equal_to_cpu']}; through "
        f"whepserversink to {WHEP_CLIENTS} whepclientsrc (HTTP "
        f"{q['http_status']}): {q['got']} of {q['rtp_sent']} packets, "
        f"exact {q['exact']}, the CPU run's: {q['equal_to_cpu']}; "
        f"Buffer.array calls WHIP {r['array_calls']}, WHEP "
        f"{q['array_calls']}; host ms per second of audio WHIP "
        f"{r['host_ms_per_s']}, WHEP {q['host_ms_per_s']}  [{smi}]")
    if not (r["exact"] and r["equal_to_cpu"] and r["rtp_sent"] > 0
            and r["http_status"] == (201, 200) and r["pad_removed"]
            and all(q["exact"]) and q["equal_to_cpu"] and q["rtp_sent"] > 0
            and q["http_status"] == [201] * WHEP_CLIENTS):
        raise AssertionError(f"19c: whip {r}, whep {q}")

    # 19d
    not_run = dict(NOT_ON_THE_CARD_19)
    shim = importlib.import_module(
        f"{gstpu_torch.__name__}.native_codec").load() is not None
    log(f"[webrtc] the codec shim {'links' if shim else 'does not link'} "
        f"(native_codec.load())")
    if shim:
        d, tracer, calls, n = traced(kernels, lambda: webrtc_video(
            gstpu_torch, "cuda", w, h, WEBRTC_VIDEO_FRAMES, cube))
        cpu = webrtc_video(gstpu_torch, "cpu", w, h, WEBRTC_VIDEO_FRAMES,
                           cube)
        r = res["video"] = {
            "encoder": d["encoder"], "frames_encoded": len(d["encoded"]),
            "rtp_sent": d["sent"], "lost": d["lost"],
            "auth_failures": d["auth_failures"],
            "depayloaded_is_encoded": b"".join(d["out"])
            == b"".join(d["encoded"]),
            "cpu_encoder": cpu["encoder"], "launches": n,
            "cpu_frames_encoded": len(cpu["encoded"]),
            "array_calls": new_reads(calls, ("i420", "rtc")),
            "host_ms_a_frame": own_ms(tracer, d["pipes"]["send"], ["rtc"],
                                      WEBRTC_VIDEO_FRAMES)}
        log(f"[webrtc] 19d: {WEBRTC_VIDEO_FRAMES} raw frames of {w}x{h} "
            f"into webrtcsink's encoder chain: {r}  [{smi}]")
        if not (r["depayloaded_is_encoded"] and r["lost"] == 0
                and r["auth_failures"] == 0 and r["encoder"]
                == r["cpu_encoder"] and r["frames_encoded"]
                == r["cpu_frames_encoded"] > 0
                and all(v == WEBRTC_VIDEO_FRAMES for v in n.values())):
            raise AssertionError(f"19d: {r}")
        for k in kernels:
            launches[k.name] += n[k.name]
    else:
        not_run["webrtcsink's raw-video encoder chain (19d)"] = (
            "its codecs (rav1enc, vp8enc, vp9enc) need the codec shim, "
            "which needs libavcodec; tests/test_torch_webrtcsink.py holds "
            "the chain against gstpu's, tests/test_torch_webrtc.py runs "
            "the leg at 64x48")
    res["not_on_the_card"] = not_run
    for name, why in not_run.items():
        log(f"[webrtc] not run on the card: {name}: {why}")
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# 20. the cloud and model elements of Queue D items 7-8
# ---------------------------------------------------------------------------

class StemSeparator(torch.nn.Module):
    """A stand-in for a demucs model with demucs' tensor contract, (1, C,
    T) -> (1, 4, C, T): two convolutions of SEPARATOR_TAPS taps and a 1x1
    one give each stem a soft mask (a softmax over the four stems) that
    scales the input. Its weights, drawn from `seed`, are registered
    parameters, so `.to(device)` moves them."""

    def __init__(self, channels: int = 2, seed: int = SEED):
        super().__init__()
        k = SEPARATOR_TAPS
        self.conv1 = torch.nn.Conv1d(channels, SEPARATOR_WIDTH, k,
                                     padding=k // 2)
        self.conv2 = torch.nn.Conv1d(SEPARATOR_WIDTH, SEPARATOR_WIDTH, k,
                                     padding=k // 2)
        self.mask = torch.nn.Conv1d(SEPARATOR_WIDTH, 4 * channels, 1)
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in self.parameters():
                fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32) / fan_in ** 0.5))

    def forward(self, wav):
        h = torch.relu(self.conv1(wav))
        h = torch.relu(self.conv2(h))
        m = self.mask(h).reshape(1, 4, wav.shape[1], wav.shape[2])
        return torch.softmax(m, dim=1) * wav[:, None]


def separator_file(path: Path) -> Path:
    """StemSeparator scripted into a TorchScript file at `path`."""
    torch.jit.script(StemSeparator()).save(str(path))
    return path


def whisper_model_dir(path: Path, d_model: int, layers: int, heads: int,
                      ffn: int, seed: int = SEED) -> Path:
    """A random-init WhisperForConditionalGeneration of these widths (80
    mel bins) and its processor saved into `path`, in transformers'
    format: tests/test_whisper.py's synthetic byte vocabulary with
    Whisper's special tokens, the model's `vocab_size` set to it."""
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration,
                              WhisperProcessor, WhisperTokenizer)
    tok_dir = path / "tok"
    tok_dir.mkdir(parents=True)
    vocab = {chr(c): c - 33 for c in range(33, 127)}
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>",
                "<|transcribe|>", "<|translate|>", "<|notimestamps|>",
                "<|nospeech|>", "<|startofprev|>"]
    for t in specials:
        vocab[t] = len(vocab)
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")
    tok = WhisperTokenizer(str(tok_dir / "vocab.json"),
                           str(tok_dir / "merges.txt"),
                           unk_token="<|endoftext|>",
                           bos_token="<|endoftext|>",
                           eos_token="<|endoftext|>")
    tok.add_special_tokens({"additional_special_tokens": specials})
    cfg = WhisperConfig(
        vocab_size=len(vocab), d_model=d_model, num_mel_bins=80,
        decoder_start_token_id=vocab["<|startoftranscript|>"],
        pad_token_id=vocab["<|endoftext|>"],
        eos_token_id=vocab["<|endoftext|>"],
        encoder_layers=layers, decoder_layers=layers,
        encoder_attention_heads=heads, decoder_attention_heads=heads,
        encoder_ffn_dim=ffn, decoder_ffn_dim=ffn,
        max_source_positions=1500, max_target_positions=448,
        suppress_tokens=[], begin_suppress_tokens=[])
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(cfg)
    out = path / "whisper"
    model.save_pretrained(str(out))
    WhisperProcessor(WhisperFeatureExtractor(), tok).save_pretrained(str(out))
    return out


def gpt2_model_dir(path: Path, seed: int = 0) -> Path:
    """tests/test_viuer_compositor_llm.py's GPT-2 (a synthetic byte
    vocabulary, n_embd 32, one layer, two heads), random-init from
    `seed`, saved into `path` in transformers' format."""
    from transformers import GPT2Config, GPT2LMHeadModel, GPT2TokenizerFast
    path.mkdir(parents=True)
    vocab = {chr(c): c - 33 for c in range(33, 127)}
    vocab["<|endoftext|>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    tok = GPT2TokenizerFast(str(path / "vocab.json"),
                            str(path / "merges.txt"),
                            unk_token="<|endoftext|>",
                            bos_token="<|endoftext|>",
                            eos_token="<|endoftext|>")
    cfg = GPT2Config(vocab_size=len(vocab), n_embd=32, n_layer=1,
                     n_head=2, n_positions=256)
    torch.manual_seed(seed)
    GPT2LMHeadModel(cfg).save_pretrained(str(path))
    tok.save_pretrained(str(path))
    return path


class ModelTaps:
    """While the `with` block runs, each engine of the class `cls` made
    (whisper's TransformersWhisper, llm's TransformersLm) is kept in
    `engines`, and forward hooks on its model's submodules `names` keep
    their outputs (a model output's first field), on the host, in
    `out[name]`."""

    def __init__(self, cls, names):
        self.cls, self.names = cls, names
        self.engines: list = []
        self.out: dict = {n: [] for n in names}

    def __enter__(self):
        self._init = init = self.cls.__init__

        def keep(name):
            def hook(module, args, output) -> None:
                if not isinstance(output, torch.Tensor):
                    output = output[0]
                self.out[name].append(output.detach().float().cpu())
            return hook

        def tapped(engine, *args, **kw):
            init(engine, *args, **kw)
            self.engines.append(engine)
            for n in self.names:
                engine.model.get_submodule(n).register_forward_hook(keep(n))

        self.cls.__init__ = tapped
        return self

    def __exit__(self, *exc) -> None:
        self.cls.__init__ = self._init


def model_devices(model) -> set:
    """The device types of a module's parameters and buffers."""
    return {t.device.type for t in itertools.chain(model.parameters(),
                                                   model.buffers())}


def first_divergence(card: list, cpu: list) -> dict | None:
    """Two runs' logits a decoding step (each (.., V), the last position
    read): at the first step whose greedy tokens differ, both tokens and
    the CPU's and the card's gap between their top two logits; None where
    every step picks the same token."""
    for i, (a, b) in enumerate(zip(card, cpu)):
        a, b = a.reshape(-1, a.shape[-1])[-1], b.reshape(-1, b.shape[-1])[-1]
        if int(a.argmax()) != int(b.argmax()):
            ta, tb = a.topk(2).values, b.topk(2).values
            return {"step": i, "card_token": int(a.argmax()),
                    "cpu_token": int(b.argmax()),
                    "cpu_top2_gap": float(tb[0] - tb[1]),
                    "card_top2_gap": float(ta[0] - ta[1])}
    return None


def flagship_string() -> str:
    """The flagship from appsrc `src` through its echo and loudness
    normaliser, as phone_rtp_string begins."""
    return phone_rtp_string().split(" ! audioresample")[0]


def separate_string(model: Path) -> str:
    """20a's string: the flagship through `audioconvert ! audioresample`
    to 44.1 kHz F32 stereo into `demucs` `sep`."""
    return (f"{flagship_string()} ! audioconvert name=conv ! audioresample "
            f"name=res ! audio/x-raw, format=F32LE, rate={SEPARATE_RATE}, "
            f"channels=2 ! demucs name=sep model-location={model} "
            f"segment={SEPARATE_SEGMENT}")


def separate(gstpu_torch, device: str, model: Path, seconds: float) -> dict:
    """20a on `device`: `seconds` of edge_signal through separate_string,
    an appsink named after each stem linked to its request pad. The
    pipeline (in NULL), the wall seconds, each stem's samples (T, 2) and
    each stem's buffers' (pts, duration)."""
    make = importlib.import_module(
        f"{gstpu_torch.__name__}.core.registry").make

    def build(p) -> None:
        sep = p.get_by_name("sep")
        for stem in SEPARATE_STEMS:
            sink = make("appsink", stem)
            p.add(sink)
            sep.request_pad(f"src_{stem}").link(sink.static_pad("sink"))

    x = edge_signal(seconds, RATE_192K).astype(np.float64) / 32768.0
    p, dt, out, _ = run_string(gstpu_torch, device, separate_string(model),
                               SEPARATE_STEMS,
                               feed_blocks(gstpu_torch, x, RATE_192K), build)
    return {"pipe": p, "seconds": dt,
            "stems": {s: np.concatenate([np.frombuffer(
                b.to_bytes(), np.float32) for b in out[s]]).reshape(-1, 2)
                for s in SEPARATE_STEMS},
            "times": {s: [(b.pts, b.duration) for b in out[s]]
                      for s in SEPARATE_STEMS}}


def speech_string(fmt: str, tail: str) -> str:
    """17a's telephony leg at SPEECH_RATE mono `fmt` into the string
    `tail`."""
    return (f"{flagship_string()} ! audioresample name=res ! audio/x-raw, "
            f"rate={SPEECH_RATE} ! audioconvert name=conv ! audio/x-raw, "
            f"format={fmt}, channels=1 ! {tail}")


def transcribe(gstpu_torch, device: str, model: Path) -> dict:
    """20b on `device`: PHONE_SECONDS of the telephony leg at 16 kHz mono
    F32 into `whispertranscriber` with the model at `model`, under
    ModelTaps on its encoder and its output projection. The pipeline, the
    wall seconds, the texts, the encoder's last hidden state, the logits
    a decoding step and the engine's model."""
    whisper = importlib.import_module(
        f"{gstpu_torch.__name__}.elements.audio.whisper")
    x = edge_signal(PHONE_SECONDS, RATE_192K).astype(np.float64) / 32768.0
    launch = speech_string("F32LE", f"whispertranscriber name=w model-path="
                                    f"{model} ! appsink name=out")
    with ModelTaps(whisper.TransformersWhisper,
                   ("model.encoder", "proj_out")) as taps:
        p, dt, out, _ = run_string(gstpu_torch, device, launch, ("out",),
                                   feed_blocks(gstpu_torch, x, RATE_192K))
    return {"pipe": p, "seconds": dt,
            "texts": [b.to_bytes().decode() for b in out["out"]],
            "encoder": taps.out["model.encoder"][0],
            "logits": taps.out["proj_out"], "model": taps.engines[0].model}


def rewrite(gstpu_torch, device: str, model: Path) -> dict:
    """20c on `device`: LM_PROMPTS into `llamatexttransform` (greedy,
    LM_TOKENS new tokens) with the model at `model`, under ModelTaps on
    its head. The pipeline, the wall seconds, the replies, the logits a
    decoding step and the engine's model."""
    llm = importlib.import_module(f"{gstpu_torch.__name__}.elements.text.llm")
    launch = ('appsrc name=src caps="text/x-raw, format=utf8" ! '
              f'llamatexttransform name=lm model-path={model} temp=0.0 '
              f'max-tokens={LM_TOKENS} ! appsink name=out')

    def feed(p) -> None:
        src = p.get_by_name("src")
        for i, text in enumerate(LM_PROMPTS):
            src.push_buffer(gstpu_torch.Buffer(
                text.encode(), pts=i * 10 ** 9, duration=10 ** 9))
        src.end_of_stream()

    with ModelTaps(llm.TransformersLm, ("lm_head",)) as taps:
        p, dt, out, _ = run_string(gstpu_torch, device, launch, ("out",),
                                   feed)
    return {"pipe": p, "seconds": dt,
            "texts": [b.to_bytes().decode() for b in out["out"]],
            "logits": taps.out["lm_head"], "model": taps.engines[0].model}


class StandInS3:
    """An S3 stand-in on 127.0.0.1 (a ThreadingHTTPServer on a thread,
    shut down on leaving the `with` block): it keeps each PUT object that
    carries a SigV4 Authorization header by its path in `objects`, counts
    the PUTs and refuses whatever else comes. The signatures themselves
    are held against AWS's published vectors in tests/test_torch_cloud.py."""

    def __init__(self):
        import http.server
        self.objects: dict = {}
        self.puts, self.refused = 0, 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def signed(self) -> bool:
                return self.headers.get("Authorization", "").startswith(
                    "AWS4-HMAC-SHA256 ")

            def do_PUT(self) -> None:
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if not self.signed():
                    outer.refused += 1
                    self.send_response(403)
                else:
                    outer.objects[self.path] = body
                    outer.puts += 1
                    self.send_response(200)
                    self.send_header("ETag", '"put"')
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                   Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __enter__(self):
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


class StandInStt:
    """A Deepgram listen-API stand-in on 127.0.0.1: one WebSocket
    connection served on a thread. It keeps the request line (`request`)
    and every binary frame (`frames`), answers each STT_RESULT_BYTES of
    audio with a final Results message ("dg<n>" over that stretch) and
    CloseStream with the closing Metadata."""

    def __init__(self, gstpu_torch):
        import base64
        import hashlib
        import socket
        sig = importlib.import_module(
            f"{gstpu_torch.__name__}.net.webrtc.signalling")
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.url = f"ws://127.0.0.1:{self.sock.getsockname()[1]}/v1/listen"
        self.request, self.frames = b"", []

        def serve() -> None:
            conn, _ = self.sock.accept()
            head = b""
            while b"\r\n\r\n" not in head:
                head += conn.recv(1)
            self.request = head.split(b"\r\n", 1)[0]
            key = next(line.split(b":", 1)[1].strip()
                       for line in head.split(b"\r\n")
                       if line.lower().startswith(b"sec-websocket-key"))
            accept = base64.b64encode(hashlib.sha1(
                key + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
            conn.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: "
                         b"websocket\r\nConnection: Upgrade\r\n"
                         b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n")
            audio = 0
            while (msg := sig.ws_recv(conn)) is not None:
                if msg.startswith(b"{"):
                    if json.loads(msg).get("type") == "CloseStream":
                        sig.ws_send(conn, json.dumps({
                            "type": "Metadata",
                            "transaction_key": "closed"}).encode())
                    continue
                self.frames.append(msg)
                before, audio = audio, audio + len(msg)
                step = STT_RESULT_BYTES / (SPEECH_RATE * 2)
                for n in range(before // STT_RESULT_BYTES + 1,
                               audio // STT_RESULT_BYTES + 1):
                    sig.ws_send(conn, json.dumps({
                        "type": "Results", "is_final": True,
                        "channel": {"alternatives": [
                            {"transcript": f"dg{n}"}]},
                        "start": (n - 1) * step,
                        "duration": step}).encode())
            conn.close()

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.thread.join(WEBRTC_LIMIT)
        self.sock.close()


def cloud_edge(gstpu_torch, device: str, cube: Path) -> dict:
    """20d on `device`: the grade on CLOUD_FRAMES 1080p frames through
    `cmafmux` (a fragment a frame) into `awss3hlssink` against a StandInS3,
    and PHONE_SECONDS of the telephony leg at 16 kHz S16 mono into
    `deepgramtranscriber` against a StandInStt. Both pipelines, their wall
    seconds, the objects, PUTs and refusals the S3 stand-in saw, and the
    request line, audio frames and texts of the speech leg."""
    src, grade = grade_strings(EDGE_W, EDGE_H, CLOUD_FRAMES, cube)
    with StandInS3() as s3:
        hls, dt, _, _ = run_string(
            gstpu_torch, device,
            f"{src} ! {grade} ! cmafmux name=mux fragment-duration="
            f"{10 ** 9 // 30} ! awss3hlssink name=s3 uri=s3://{CLOUD_REGION}"
            f"/card/hls access-key={CLOUD_ACCESS} secret-access-key="
            f"{CLOUD_SECRET} endpoint-uri={s3.url} target-duration=1")
    stt = StandInStt(gstpu_torch)
    x = edge_signal(PHONE_SECONDS, RATE_192K).astype(np.float64) / 32768.0
    speech, stt_dt, out, _ = run_string(
        gstpu_torch, device,
        speech_string("S16LE", f"deepgramtranscriber name=dg url={stt.url} "
                               f"api-key={CLOUD_ACCESS} ! appsink name=out"),
        ("out",), feed_blocks(gstpu_torch, x, RATE_192K))
    stt.close()
    return {"pipes": {"hls": hls, "speech": speech}, "seconds": dt,
            "stt_seconds": stt_dt, "objects": s3.objects, "puts": s3.puts,
            "refused": s3.refused, "request": stt.request,
            "frames": stt.frames,
            "texts": [(b.to_bytes().decode(), b.pts, b.duration)
                      for b in out["out"]]}


def cloud_phase(gstpu_torch, smi, tmp: Path, kernels) -> dict:
    """20. Queue D items 7-8's elements behind the card's chains, all on
    127.0.0.1: (a) the flagship separated by `demucs` on the card; (b)
    the telephony leg transcribed by `whispertranscriber` and (c) text
    rewritten by `llamatexttransform` on the card, only where
    `transformers` imports; (d) the grade into `awss3hlssink` and the
    telephony leg into `deepgramtranscriber`, against stand-ins; (e) the
    docs cache tool. Each leg is held against the same on the CPU, or
    against the checked-in file. Each kernel's launches in d."""
    res, not_run = {}, {}
    launches = {k.name: 0 for k in kernels}

    # 20a
    t0 = time.monotonic()
    model = separator_file(tmp / "separator.pt")
    a, tracer, _, _ = traced(kernels, lambda: separate(
        gstpu_torch, "cuda", model, SEPARATE_SECONDS))
    cpu = separate(gstpu_torch, "cpu", model, SEPARATE_SECONDS)
    sep = a["pipe"].get_by_name("sep")
    err = {s: float(np.abs(a["stems"][s] - cpu["stems"][s]).max())
           for s in SEPARATE_STEMS}
    r = res["demucs"] = {
        "seconds_of_audio": SEPARATE_SECONDS,
        "segment_s": SEPARATE_SEGMENT, "samples": {
            s: len(v) for s, v in a["stems"].items()},
        "model_devices": sorted(model_devices(sep._model)),
        "cpu_model_devices": sorted(model_devices(
            cpu["pipe"].get_by_name("sep")._model)),
        "max_abs_err": err, "tolerance": SEPARATE_TOL,
        "peak": float(max(np.abs(v).max() for v in cpu["stems"].values())),
        "times_equal": a["times"] == cpu["times"],
        "buffer_s": {s: [d / 10 ** 9 for _, d in v]
                     for s, v in a["times"].items()},
        "echo_output": tracer.payload.get(
            a["pipe"].get_by_name("echo").static_pad("src")),
        "model_params": sum(p.numel() for p in sep._model.parameters()),
        "wall_s": a["seconds"], "cpu_wall_s": cpu["seconds"],
        "host_ms_per_s": own_ms(tracer, a["pipe"], ["conv", "res", "sep"],
                                SEPARATE_SECONDS),
        "leg_s": time.monotonic() - t0}
    log(f"[cloud] 20a: {SEPARATE_SECONDS} s of the flagship at 192 kHz "
        f"stereo (the echo's output {r['echo_output']}) through audioconvert "
        f"and audioresample to {SEPARATE_RATE} Hz F32 into demucs segment="
        f"{SEPARATE_SEGMENT} ({r['model_params']}-parameter StemSeparator "
        f"as TorchScript, on {r['model_devices']}; the CPU run's on "
        f"{r['cpu_model_devices']}): samples a stem {r['samples']}, max "
        f"|card - CPU| by stem {err} (peak {r['peak']:.4f}, tolerance "
        f"{SEPARATE_TOL}, TF32 off), seconds a buffer {r['buffer_s']}, buffer "
        f"times equal {r['times_equal']}; "
        f"{a['seconds']:.3f} s on the card (tracer on), {cpu['seconds']:.3f} "
        f"s on the CPU; host ms per second of audio {r['host_ms_per_s']}  "
        f"[{smi}]")
    if not (r["model_devices"] == ["cuda"] and r["cpu_model_devices"]
            == ["cpu"] and r["times_equal"] and r["echo_output"]
            == "tensor on cuda" and max(err.values()) <= SEPARATE_TOL
            and r["samples"] == {s: len(v) for s, v in cpu["stems"].items()}
            and all(abs(n - SEPARATE_SECONDS * SEPARATE_RATE) <= 16
                    for n in r["samples"].values())
            and all(len(v) == 2 and v[0] == SEPARATE_SEGMENT
                    for v in r["buffer_s"].values())):
        raise AssertionError(f"20a: {r}")

    # 20b, 20c
    if importlib.util.find_spec("transformers") is None:
        for name, leg in (("whispertranscriber", "20b"),
                          ("llamatexttransform", "20c")):
            not_run[f"{name} ({leg})"] = (
                "the `transformers` package does not import on this "
                "machine; tests/test_torch_models.py holds it against "
                "gstpu's, and its model and inputs on the CPU")
    else:
        t0 = time.monotonic()
        model = whisper_model_dir(tmp / "whisper", *WHISPER_WIDTHS)
        b, _, _, _ = traced(kernels, lambda: transcribe(
            gstpu_torch, "cuda", model))
        cpu = transcribe(gstpu_torch, "cpu", model)
        enc = float((b["encoder"] - cpu["encoder"]).abs().max())
        r = res["whisper"] = {
            "widths": WHISPER_WIDTHS, "model_devices": sorted(
                model_devices(b["model"])),
            "encoder_shape": list(b["encoder"].shape),
            "encoder_max_abs_err": enc, "tolerance": WHISPER_TOL,
            "encoder_peak": float(cpu["encoder"].abs().max()),
            "texts": b["texts"], "cpu_texts": cpu["texts"],
            "steps": len(b["logits"]), "cpu_steps": len(cpu["logits"]),
            "divergence": first_divergence(b["logits"], cpu["logits"]),
            "wall_s": b["seconds"], "cpu_wall_s": cpu["seconds"],
            "leg_s": time.monotonic() - t0}
        log(f"[cloud] 20b: {PHONE_SECONDS} s of the telephony leg at "
            f"{SPEECH_RATE} Hz mono F32 into whispertranscriber (random "
            f"Whisper at d_model, layers, heads, ffn {WHISPER_WIDTHS}, on "
            f"{r['model_devices']}): the encoder's last hidden state "
            f"{r['encoder_shape']} within {enc:.3e} of the CPU's (peak "
            f"{r['encoder_peak']:.3f}, tolerance {WHISPER_TOL}, TF32 off); "
            f"texts {r['texts']!r} on the card, {r['cpu_texts']!r} on the "
            f"CPU, {r['steps']} and {r['cpu_steps']} decoding steps, first "
            f"divergence {r['divergence']}; {b['seconds']:.3f} s on the card"
            f", {cpu['seconds']:.3f} s on the CPU  [{smi}]")
        if not (r["model_devices"] == ["cuda"] and enc <= WHISPER_TOL
                and model_devices(cpu["model"]) == {"cpu"}):
            raise AssertionError(f"20b: {r}")
        t0 = time.monotonic()
        model = gpt2_model_dir(tmp / "gpt2")
        c, _, _, _ = traced(kernels, lambda: rewrite(gstpu_torch, "cuda",
                                                     model))
        cpu = rewrite(gstpu_torch, "cpu", model)
        first = float((c["logits"][0] - cpu["logits"][0]).abs().max())
        r = res["llm"] = {
            "model_devices": sorted(model_devices(c["model"])),
            "first_step_max_abs_err": first, "tolerance": LM_TOL,
            "first_step_peak": float(cpu["logits"][0].abs().max()),
            "texts": c["texts"], "cpu_texts": cpu["texts"],
            "divergence": first_divergence(c["logits"], cpu["logits"]),
            "wall_s": c["seconds"], "cpu_wall_s": cpu["seconds"],
            "leg_s": time.monotonic() - t0}
        log(f"[cloud] 20c: {len(LM_PROMPTS)} prompts into llamatexttransform"
            f" (tests/test_viuer_compositor_llm.py's GPT-2, greedy, "
            f"{LM_TOKENS} tokens, on {r['model_devices']}): the first step's "
            f"logits within {first:.3e} of the CPU's (peak "
            f"{r['first_step_peak']:.3f}, tolerance {LM_TOL}); replies "
            f"{r['texts']!r} on the card, {r['cpu_texts']!r} on the CPU, "
            f"first divergence {r['divergence']}; {c['seconds']:.3f} s on "
            f"the card, {cpu['seconds']:.3f} s on the CPU  [{smi}]")
        if not (r["model_devices"] == ["cuda"] and first <= LM_TOL
                and model_devices(cpu["model"]) == {"cpu"}):
            raise AssertionError(f"20c: {r}")

    # 20d
    t0 = time.monotonic()
    cube = tmp / "cloud.cube"
    write_cube(cube, np.random.default_rng(SEED))
    d, tracer, calls, n = traced(kernels, lambda: cloud_edge(
        gstpu_torch, "cuda", cube))
    cpu = cloud_edge(gstpu_torch, "cpu", cube)
    hls = d["pipes"]["hls"]
    r = res["cloud_edge"] = {
        "frames": CLOUD_FRAMES, "objects": {
            k: len(v) for k, v in d["objects"].items()},
        "puts": d["puts"], "refused": d["refused"],
        "objects_equal_to_cpu": d["objects"] == cpu["objects"],
        "cpu_puts": cpu["puts"], "launches": n,
        "array_calls": new_reads(calls, ("mux", "s3", "dg")),
        "downloads": dict(calls.tensor_calls),
        "grade_downloads": {k: v for k, v in calls.tensor_calls.items()
                            if k in ("hsv", "lut", "mux", "s3")},
        "mux_reads_by_frame": [calls.of("mux", i * 10 ** 9 // 30)
                               for i in range(CLOUD_FRAMES)],
        "grade_output": tracer.payload.get(
            hls.get_by_name("mux").sink_pads()[0].peer),
        "fps": CLOUD_FRAMES / d["seconds"], "cpu_wall_s": cpu["seconds"],
        "host_ms_a_frame": own_ms(tracer, hls, ["mux", "s3"],
                                  CLOUD_FRAMES),
        "stt_request": d["request"].decode(),
        "stt_frames": len(d["frames"]),
        "stt_bytes": sum(map(len, d["frames"])),
        "stt_frames_equal_to_cpu": d["frames"] == cpu["frames"],
        "stt_request_equal_to_cpu": d["request"] == cpu["request"],
        "stt_texts": d["texts"], "stt_texts_equal_to_cpu":
            d["texts"] == cpu["texts"],
        "stt_wall_s": d["stt_seconds"],
        "host_ms_per_s": own_ms(tracer, d["pipes"]["speech"], ["res", "dg"],
                                PHONE_SECONDS),
        "leg_s": time.monotonic() - t0}
    log(f"[cloud] 20d: {CLOUD_FRAMES} frames of {EDGE_W}x{EDGE_H} through "
        f"the grade (reaching cmafmux as {r['grade_output']}) into cmafmux "
        f"and awss3hlssink against the S3 stand-in: objects {r['objects']} "
        f"from {r['puts']} signed PUTs ({r['refused']} refused), "
        f"{'equal to' if r['objects_equal_to_cpu'] else 'DIFFERENT FROM'} "
        f"the CPU run's; launches {n}; Buffer.array calls "
        f"{r['array_calls']}, downloads {r['downloads']} (of the grade "
        f"{r['grade_downloads']}), cmafmux's reads by frame "
        f"{r['mux_reads_by_frame']}; {r['fps']:.3f} fps (tracer "
        f"on), {cpu['seconds']:.3f} s on the CPU; host ms a frame "
        f"{r['host_ms_a_frame']}. {PHONE_SECONDS} s of the telephony leg at "
        f"{SPEECH_RATE} Hz S16 mono into deepgramtranscriber against the "
        f"WebSocket stand-in ({r['stt_request']!r}): {r['stt_frames']} "
        f"audio frames, {r['stt_bytes']} B, equal to the CPU run's "
        f"{r['stt_frames_equal_to_cpu']}; texts {r['stt_texts']}, the CPU "
        f"run's {r['stt_texts_equal_to_cpu']}; host ms per second of audio "
        f"{r['host_ms_per_s']}  [{smi}]")
    if not (r["objects_equal_to_cpu"] and r["refused"] == 0
            and "/card/hls/playlist.m3u8" in d["objects"]
            and sum(k.endswith(".m4s") for k in d["objects"])
            == CLOUD_FRAMES and r["stt_frames_equal_to_cpu"]
            and r["stt_request_equal_to_cpu"] and r["stt_texts_equal_to_cpu"]
            and r["stt_bytes"] == round(PHONE_SECONDS * SPEECH_RATE) * 2
            and len(d["texts"]) == r["stt_bytes"] // STT_RESULT_BYTES
            and set(r["grade_downloads"]) == {"mux"}
            and "s3" not in r["array_calls"]
            and r["grade_output"] == "tensor on cuda"
            and all(v == CLOUD_FRAMES for v in n.values())):
        raise AssertionError(f"20d: {r}")
    for k in kernels:
        launches[k.name] += n[k.name]

    # 20e
    t0 = time.monotonic()
    cache = tmp / "cache.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gstpu_torch.tools.docs_cache", "-o",
         str(cache)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    checked_in = ROOT / "docs" / "plugins" / "gstpu_torch_plugins_cache.json"
    r = res["docs_cache"] = {
        "rc": proc.returncode, "stdout": proc.stdout.strip(),
        "elements": len(json.loads(cache.read_text())) if cache.exists()
        else 0, "equal_to_checked_in": cache.exists()
        and cache.read_bytes() == checked_in.read_bytes(),
        "leg_s": time.monotonic() - t0}
    log(f"[cloud] 20e: python -m gstpu_torch.tools.docs_cache: rc "
        f"{r['rc']}, {r['stdout']!r}, {r['elements']} elements, equal to "
        f"the checked-in {checked_in.relative_to(ROOT)}: "
        f"{r['equal_to_checked_in']}; {r['leg_s']:.3f} s  [{smi}]")
    if not (r["rc"] == 0 and r["elements"] == FACTORIES
            and r["equal_to_checked_in"]):
        raise AssertionError(f"20e: {r}; {proc.stderr[-2000:]}")

    res["not_on_the_card"] = not_run
    for name, why in not_run.items():
        log(f"[cloud] not run on the card: {name}: {why}")
    res["launches"] = launches
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
    # 13. the host edge: files through the device chains into files
    t13 = time.monotonic()
    # kept until phase 18, which holds its HTTP MP4 against 13a's
    edge_dir = tempfile.TemporaryDirectory()
    tmp = edge_dir.name
    edge = {"audio": edge_audio_phase(gstpu_torch, dev, smi, Path(tmp)),
            "video": edge_video_phase(gstpu_torch, dev, smi, Path(tmp),
                                      kernels),
            "containers": edge_container_phase(gstpu_torch, smi, Path(tmp))}
    for row in rows:
        row["launches_file"] = edge["video"]["launches"][row["name"]]
    # 14. the host codecs and images behind the card's chains
    t14 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        codecs = codecs_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_host_codecs"] = \
            codecs["video"]["launches"][row["name"]]
        row["launches_cdg"] = codecs["cdg"]["launches"][row["name"]]
    # 15. captions on the card's 1080p grade, and the PIL image elements
    t15 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        captions = captions_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_captions"] = sum(
            r["launches"][row["name"]] for r in captions["video"].values())
        row["launches_images"] = captions["images"]["launches"][row["name"]]
    # 16. the plumbing, supervisors, host consumers and launch tool of
    # Queue D item 3 around the card's grade
    t16 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        plumbing = plumbing_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_plumbing"] = plumbing["launches"][row["name"]]
    # 17. the RTP stack, UDP, TCP and ONVIF metadata of Queue D item 4
    # between the card's chains and the network
    t17 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        rtp = rtp_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_rtp"] = rtp["launches"][row["name"]]
    # 18. the HLS/DASH sinks, the HTTP source and QUIC of Queue D item 5
    # between the card's chains and their audience
    t18 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        dist = distribution_phase(gstpu_torch, smi, Path(tmp), kernels,
                                  Path(edge_dir.name))
    edge_dir.cleanup()
    for row in rows:
        row["launches_distribution"] = dist["launches"][row["name"]]
    # 19. the WebRTC elements of Queue D item 6 between the card's chains
    # and their peers
    t19 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        webrtc = webrtc_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_webrtc"] = webrtc["launches"][row["name"]]
    # 20. the cloud and model elements of Queue D items 7-8 behind the
    # card's chains
    t20 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        cloud = cloud_phase(gstpu_torch, smi, Path(tmp), kernels)
    for row in rows:
        row["launches_cloud"] = cloud["launches"][row["name"]]
    element["phase_s"].update({"8": t9 - t8, "9": t10 - t9, "10": t11 - t10,
                               "11": t12 - t11, "12": t13 - t12,
                               "13": t14 - t13, "14": t15 - t14,
                               "15": t16 - t15, "16": t17 - t16,
                               "17": t18 - t17, "18": t19 - t18,
                               "19": t20 - t19,
                               "20": time.monotonic() - t20})
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
    log(json.dumps({"host_edge": edge}))
    log(json.dumps({"host_codecs": codecs}))
    log(json.dumps({"captions": captions}))
    log(json.dumps({"plumbing": plumbing}))
    log(json.dumps({"rtp": rtp}))
    log(json.dumps({"distribution": dist}))
    log(json.dumps({"webrtc": webrtc}))
    log(json.dumps({"cloud": cloud}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
