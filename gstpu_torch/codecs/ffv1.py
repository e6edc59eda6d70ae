"""FFV1 (RFC 9043) version-1 bitstream model: range coder, header,
and lossless plane coding — built from the spec for the `ffv1enc`
element's TPU-split encoder.

The reference ships only a DECODER wrap (video/ffv1/src/ffv1dec — the
ffv1 crate); gstpu wraps the same engine for `ffv1dec` and goes one
step further with its own encoder, arranged the TPU-native way
(SURVEY.md §2.8 P4: codec-internal compute split — transforms on
device, entropy on host): `gstpu_torch/ops/ffv1_pred.py` computes the
whole prediction/context/residual field of every frame as torch ops on
the card, and the adaptive range coding of those residuals runs in
native C++ (native/gstpu_ffv1.cpp).  This file is the port's copy of
gstpu/codecs/ffv1.py and must stay byte for byte with it in what it
encodes (tests/test_torch_ffv1.py).

This module is the pure-Python spec model both sides are tested
against: an encoder and decoder for FFV1 version 1, YCbCr 8-bit,
range coder ("ac") with the default state transition, 3-gradient
contexts.  Conformance is proven the hard way in
tests/test_ffv1enc.py: bitstreams from this model and from the C++
fast path are decoded by libavcodec's independent ffv1 decoder and
must reproduce the source bit-exactly, and this model's decoder
round-trips bitstreams produced by libavcodec's encoder.

Nothing here is transcribed from FFmpeg or the ffv1 crate: the state
tables come from the spec's documented recurrence (factor 0.05, max_p
248), the quantization tables are gstpu's own choice (legal because
FFV1 transmits them in the header), and every rule the spec leaves
implicit (border samples, context-state reuse across chroma planes,
inter-frame state persistence) was pinned down empirically against
libavcodec's output, not by reading its source.
"""

from __future__ import annotations

import numpy as np

CONTEXT_SIZE = 32


def build_rac_states(factor: int = int(0.05 * (1 << 32)),
                     max_p: int = 256 - 8):
    """Default range-coder state-transition tables from the spec
    recurrence: probabilities walk toward certainty with a 5% pull,
    folded to 8 bits, clamped to [256-max_p, max_p]."""
    one = 1 << 32
    one_state = [0] * 256
    zero_state = [0] * 256
    p = one // 2
    last_p8 = 0
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 == i:
            p8 += 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return one_state, zero_state


ONE_STATE, ZERO_STATE = build_rac_states()


def new_state() -> bytearray:
    return bytearray([128] * CONTEXT_SIZE)


def new_plane_states(context_count: int) -> list[bytearray]:
    return [new_state() for _ in range(context_count)]


class RangeDecoder:
    """FFV1 range decoder (spec §4.1): 16-bit low/range, byte refill."""

    def __init__(self, data: bytes, one_state=None, zero_state=None):
        self.b = data
        self.ptr = 2
        self.low = (data[0] << 8) | data[1] if len(data) >= 2 else 0
        self.range = 0xFF00
        # per-stream transition tables: ac=2 streams (libavcodec's
        # coder=ac default) transmit a custom table in the header
        self.one = list(one_state) if one_state else list(ONE_STATE)
        self.zero = list(zero_state) if zero_state else list(ZERO_STATE)

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low = (self.low << 8) & 0xFFFFFFFF
            if self.ptr < len(self.b):
                self.low |= self.b[self.ptr]
                self.ptr += 1

    def get_rac(self, state: bytearray, i: int = 0) -> int:
        r1 = (self.range * state[i]) >> 8
        self.range -= r1
        if self.low < self.range:
            state[i] = self.zero[state[i]]
            self._refill()
            return 0
        self.low -= self.range
        self.range = r1
        state[i] = self.one[state[i]]
        self._refill()
        return 1

    def get_symbol(self, state: bytearray, is_signed: bool) -> int:
        if self.get_rac(state, 0):
            return 0
        e = 0
        while self.get_rac(state, 1 + min(e, 9)):
            e += 1
            if e > 31:
                raise ValueError("ffv1: corrupt symbol exponent")
        a = 1
        for i in range(e - 1, -1, -1):
            a += a + self.get_rac(state, 22 + min(i, 9))
        if is_signed and self.get_rac(state, 11 + min(e, 10)):
            return -a
        return a


class RangeEncoder:
    """FFV1 range encoder: mirror of RangeDecoder with carry handling
    through an outstanding-byte counter."""

    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = 0xFF00
        self.outstanding_byte = -1
        self.outstanding_count = 0

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xff" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put_rac(self, state: bytearray, i: int, bit: int):
        r1 = (self.range * state[i]) >> 8
        if bit:
            self.low += self.range - r1
            self.range = r1
            state[i] = ONE_STATE[state[i]]
        else:
            self.range -= r1
            state[i] = ZERO_STATE[state[i]]
        self._renorm()

    def put_symbol(self, state: bytearray, v: int, is_signed: bool):
        if v == 0:
            self.put_rac(state, 0, 1)
            return
        self.put_rac(state, 0, 0)
        a = abs(v)
        e = a.bit_length() - 1
        for i in range(e):
            self.put_rac(state, 1 + min(i, 9), 1)
        self.put_rac(state, 1 + min(e, 9), 0)
        for i in range(e - 1, -1, -1):
            self.put_rac(state, 22 + min(i, 9), (a >> i) & 1)
        if is_signed:
            self.put_rac(state, 11 + min(e, 10), 1 if v < 0 else 0)

    def terminate(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# quantization tables / header
# ---------------------------------------------------------------------------

# gstpu's gradient quantizer: 11 symmetric levels with boundaries at
# |d| = 1, 3, 7, 15, 32 (transmitted in the header, so any legal
# monotone choice interoperates).
QUANT_BOUNDS = (1, 3, 7, 15, 32)


def default_quant_tables() -> list[list[int]]:
    """Three chained 11-level tables (scales 1, 11, 121) + two zero
    tables: the classic 3-gradient context, 666 folded contexts."""
    def level(d):
        a = abs(d)
        for q, b in enumerate(QUANT_BOUNDS):
            if a < b:
                return q if d >= 0 else -q
        return 5 if d >= 0 else -5

    tables = []
    scale = 1
    for dim in range(5):
        t = [0] * 256
        if dim < 3:
            for i in range(128):
                t[i] = scale * level(i)
            for i in range(1, 128):
                t[256 - i] = -t[i]
            t[128] = -t[127]
            scale *= 11
        tables.append(t)
    return tables


def context_count(tables) -> int:
    n = 1
    for t in tables:
        lv = len({t[i] for i in range(128)})   # distinct positive levels
        n *= 2 * lv - 1
    return (n + 1) // 2


def write_quant_table(c: RangeEncoder, table: list[int]):
    state = new_state()
    i = 1
    last = 0
    while i < 128:
        if table[i] != table[i - 1]:
            c.put_symbol(state, i - last - 1, False)
            last = i
        i += 1
    c.put_symbol(state, 127 - last, False)


def read_quant_table(c: RangeDecoder, scale: int):
    state = new_state()
    table = [0] * 256
    v = 0
    i = 0
    while i < 128:
        ln = c.get_symbol(state, False) + 1
        if i + ln > 128:
            raise ValueError("ffv1: quant run overflow")
        for _ in range(ln):
            table[i] = scale * v
            i += 1
        v += 1
    for i in range(1, 128):
        table[256 - i] = -table[i]
    table[128] = -table[127]
    return table, 2 * v - 1


class Params:
    """Version-1 stream parameters (w/h live in the container)."""

    def __init__(self, width: int, height: int, chroma_planes: bool = True,
                 log2_h: int = 1, log2_v: int = 1, bits: int = 8):
        self.width = width
        self.height = height
        self.chroma_planes = chroma_planes
        self.log2_h = log2_h
        self.log2_v = log2_v
        self.bits = bits
        self.quant = default_quant_tables()
        self.context_count = context_count(self.quant)

    @property
    def chroma_size(self):
        return (-(-self.width >> self.log2_h),
                -(-self.height >> self.log2_v))

    def plane_sizes(self):
        sizes = [(self.width, self.height)]
        if self.chroma_planes:
            cw = -(-self.width >> self.log2_h)
            ch = -(-self.height >> self.log2_v)
            sizes += [(cw, ch), (cw, ch)]
        return sizes


def write_header(c: RangeEncoder, p: Params):
    state = new_state()
    c.put_symbol(state, 1, False)            # version
    c.put_symbol(state, 1, False)            # ac: range coder, default
    c.put_symbol(state, 0, False)            # colorspace: YCbCr
    c.put_symbol(state, p.bits, False)       # bits_per_raw_sample
    c.put_rac(state, 0, 1 if p.chroma_planes else 0)
    c.put_symbol(state, p.log2_h, False)
    c.put_symbol(state, p.log2_v, False)
    c.put_rac(state, 0, 0)                   # transparency
    for t in p.quant:
        write_quant_table(c, t)


def read_header(c: RangeDecoder) -> dict:
    state = new_state()
    h = {}
    h["version"] = c.get_symbol(state, False)
    if h["version"] > 1:
        raise ValueError("ffv1 model: only version 0/1 in-band headers")
    h["ac"] = c.get_symbol(state, False)
    if h["ac"] > 1:
        # custom transition table: signed deltas from the default
        # table.  The header itself stays coded with the DEFAULT
        # table; the custom one takes effect for plane data only
        # (pinned against libavcodec's coder=ac output).
        one = list(ONE_STATE)
        zero = list(ZERO_STATE)
        for i in range(1, 256):
            one[i] = c.get_symbol(state, True) + ONE_STATE[i]
            zero[256 - i] = 256 - one[i]
        h["one_state"] = one
        h["zero_state"] = zero
    h["colorspace"] = c.get_symbol(state, False)
    if h["version"] > 0:
        h["bits"] = c.get_symbol(state, False)
    else:
        h["bits"] = 8
    h["chroma_planes"] = c.get_rac(state, 0)
    h["log2_h"] = c.get_symbol(state, False)
    h["log2_v"] = c.get_symbol(state, False)
    h["transparency"] = c.get_rac(state, 0)
    tables = []
    n = 1
    for _ in range(5):
        t, lv = read_quant_table(c, n)
        tables.append(t)
        n *= lv
    h["quant"] = tables
    h["context_count"] = (n + 1) // 2
    return h


# ---------------------------------------------------------------------------
# plane coding (numpy reference path)
# ---------------------------------------------------------------------------

def _median3(a, b, c):
    return a + b + c - min(a, b, c) - max(a, b, c)


def predict_plane(plane: np.ndarray, quant) -> tuple[np.ndarray, np.ndarray]:
    """The codec-internal parallel pass: per-sample folded context and
    residual for a whole plane at once (numpy mirror of
    gstpu_torch/ops/ffv1_pred.py — lossless means decoded==source, so every
    neighbor is known up front and the field vectorizes).

    Border rules (pinned against libavcodec): t/tl/tr of row 0 are 0;
    l of column 0 is t; tl of column 0 is the first sample of the row
    TWO above (the codec's persistent swap-buffer artifact); tr of the
    last column replicates t.
    """
    p = plane.astype(np.int32)
    h, w = p.shape
    T = np.zeros_like(p)
    T[1:] = p[:-1]
    RT = np.zeros_like(p)
    RT[1:, :-1] = p[:-1, 1:]
    RT[1:, -1] = p[:-1, -1]
    L = np.zeros_like(p)
    L[:, 1:] = p[:, :-1]
    L[1:, 0] = p[:-1, 0]          # l(0) = t(0)
    LT = np.zeros_like(p)
    LT[1:, 1:] = p[:-1, :-1]
    LT[2:, 0] = p[:-2, 0]         # tl(0) = first sample two rows up
    q0, q1, q2 = quant[0], quant[1], quant[2]
    q0 = np.asarray(q0, np.int32)
    q1 = np.asarray(q1, np.int32)
    q2 = np.asarray(q2, np.int32)
    ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] + q2[(T - RT) & 0xFF]
    sign = ctx < 0
    ctx = np.abs(ctx)
    pred = np.median(np.stack([L, T, L + T - LT]), axis=0).astype(np.int32)
    diff = p - pred
    diff = np.where(sign, -diff, diff)
    diff = ((diff + 128) & 0xFF) - 128   # fold to int8
    return ctx.astype(np.int32), diff.astype(np.int32)


def encode_plane(c: RangeEncoder, plane: np.ndarray, quant, states):
    ctx, diff = predict_plane(plane, quant)
    h, w = plane.shape
    for y in range(h):
        for x in range(w):
            c.put_symbol(states[ctx[y, x]], int(diff[y, x]), True)


def decode_plane(c: RangeDecoder, w: int, h: int, bits: int, quant, states):
    mask = (1 << bits) - 1
    q0 = np.asarray(quant[0], np.int32)
    q1 = np.asarray(quant[1], np.int32)
    q2 = np.asarray(quant[2], np.int32)
    prev = np.zeros(w + 2, np.int32)   # index x+1; [0], [w+1] = borders
    out = np.zeros((h, w), np.int32)
    for y in range(h):
        cur = np.zeros(w + 2, np.int32)
        prev[w + 1] = prev[w]          # tr border
        cur[0] = prev[1]               # l(0) = t(0)
        for x in range(w):
            L = int(cur[x])
            LT = int(prev[x])
            T = int(prev[x + 1])
            RT = int(prev[x + 2])
            ctx = int(q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF]
                      + q2[(T - RT) & 0xFF])
            if ctx < 0:
                ctx = -ctx
                sign = True
            else:
                sign = False
            diff = c.get_symbol(states[ctx], True)
            if sign:
                diff = -diff
            cur[x + 1] = (_median3(L, T, L + T - LT) + diff) & mask
        out[y] = cur[1:w + 1]
        prev = cur                     # prev[0] keeps cur[0]: tl(0) rule
    return out


# ---------------------------------------------------------------------------
# frame model
# ---------------------------------------------------------------------------

class ModelEncoder:
    """Pure-Python FFV1 v1 encoder (spec model; the production path is
    gstpu_torch/ops/ffv1_pred.py + native/gstpu_ffv1.cpp)."""

    def __init__(self, params: Params, gop: int = 1):
        self.p = params
        self.gop = max(1, gop)
        self.frame_index = 0
        self.states = None

    def encode(self, planes: list[np.ndarray]) -> tuple[bytes, bool]:
        key = (self.frame_index % self.gop) == 0
        self.frame_index += 1
        c = RangeEncoder()
        keystate = new_state()
        c.put_rac(keystate, 0, 1 if key else 0)
        if key:
            write_header(c, self.p)
            self.states = [new_plane_states(self.p.context_count)
                           for _ in range(2)]
        for i, plane in enumerate(planes):
            st = self.states[0] if i == 0 else self.states[1]
            encode_plane(c, plane, self.p.quant, st)
        return c.terminate(), key


class ModelDecoder:
    """Pure-Python FFV1 v1 decoder (validates both our encoders and
    libavcodec's)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.hdr = None
        self.states = None

    def decode(self, data: bytes) -> list[np.ndarray]:
        # inter frames reuse the keyframe's custom transition table
        one = self.hdr.get("one_state") if self.hdr else None
        zero = self.hdr.get("zero_state") if self.hdr else None
        c = RangeDecoder(data, one, zero)
        key = c.get_rac(new_state(), 0)
        if key:
            c.one = list(ONE_STATE)
            c.zero = list(ZERO_STATE)
            self.hdr = read_header(c)
            if "one_state" in self.hdr:   # install for plane data
                c.one = list(self.hdr["one_state"])
                c.zero = list(self.hdr["zero_state"])
            self.states = [new_plane_states(self.hdr["context_count"])
                           for _ in range(2)]
        elif self.hdr is None:
            raise ValueError("ffv1: first frame is not a keyframe")
        h = self.hdr
        sizes = [(self.width, self.height)]
        if h["chroma_planes"]:
            cw = -(-self.width >> h["log2_h"])
            ch = -(-self.height >> h["log2_v"])
            sizes += [(cw, ch), (cw, ch)]
        planes = []
        for i, (pw, ph) in enumerate(sizes):
            st = self.states[0] if i == 0 else self.states[1]
            planes.append(decode_plane(c, pw, ph, h["bits"], h["quant"], st)
                          .astype(np.uint8))
        return planes
