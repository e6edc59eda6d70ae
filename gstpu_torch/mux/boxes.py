"""ISO BMFF (MP4) box serialization + parsing.

Rebuilds the box layer of the reference isobmff crate
(mux/isobmff/src/isobmff/boxes.rs + fmp4mux/boxes.rs): ftyp/styp,
moov (trak/mdia/stbl sample tables, mvex/trex), moof (mfhd/traf/
tfhd/tfdt/trun), mdat, codec sample entries (avc1/hvc1/av01/opus/
fLaC/mp4a/raw audio). The parser is used by the round-trip tests
(reference mux/isobmff/tests pattern: mux then parse back).

Depth features matching the reference crate:
- edit lists (edts/elst, boxes.rs write_elst)
- TAI precision timestamps: taic clock-info box + per-sample
  TAITimestampPacket aux info via saiz/saio
  (precision_timestamps.rs, aux_info.rs, ISO/IEC 23001-17 §8.1)
- AC-3/E-AC-3 sample entries with dac3/dec3 derived from the first
  frame's bitstream (ac3.rs, eac3.rs)
- PCM sample entries ipcm/fpcm with pcmC + chnl (ISO/IEC 23003-5)
- uncompressed video 'uncv' with uncC/cmpd (uncompressed.rs,
  ISO/IEC 23001-17)
- ctts/cslg composition-offset tables, mehd, stss

The port's copy of gstpu/mux/boxes.py: the standard library, as there.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from fractions import Fraction

SECOND = 1_000_000_000


def box(fourcc: str, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + fourcc.encode("ascii") + body


def full_box(fourcc: str, version: int, flags: int,
             *payloads: bytes) -> bytes:
    return box(fourcc, struct.pack(">I", (version << 24) | flags),
               *payloads)


def u8(v): return struct.pack(">B", v)
def u16(v): return struct.pack(">H", v)
def u32(v): return struct.pack(">I", v & 0xFFFFFFFF)
def u64(v): return struct.pack(">Q", v)
def i16(v): return struct.pack(">h", v)
def i32(v): return struct.pack(">i", v)
def fixed16_16(v: float): return u32(int(round(v * 65536)))
def fixed8_8(v: float): return u16(int(round(v * 256)) & 0xFFFF)


UNITY_MATRIX = (u32(0x00010000) + u32(0) + u32(0)
                + u32(0) + u32(0x00010000) + u32(0)
                + u32(0) + u32(0) + u32(0x40000000))


def ftyp(major: str, minor: int, compatible: list[str]) -> bytes:
    return box("ftyp", major.encode(), u32(minor),
               b"".join(b.encode() for b in compatible))


def styp(major: str, minor: int, compatible: list[str]) -> bytes:
    return box("styp", major.encode(), u32(minor),
               b"".join(b.encode() for b in compatible))


# ---------------------------------------------------------------------------
# Track/stream description
# ---------------------------------------------------------------------------

@dataclass
class ElstInfo:
    """One edit-list entry (reference isobmff/mod.rs ElstInfo).

    start_ns: media time the edit maps to (None = empty edit / gap);
    duration_ns: presentation duration of the edit.
    """

    start_ns: int | None
    duration_ns: int


TAIC_TIME_UNCERTAINTY_UNKNOWN = 0xFFFF_FFFF_FFFF_FFFF
TAIC_CLOCK_DRIFT_RATE_UNKNOWN = 0x7FFF_FFFF


@dataclass
class TaiClockInfo:
    """ISO/IEC 23001-17 TAI clock description
    (reference precision_timestamps.rs TaiClockInfo)."""

    time_uncertainty: int = TAIC_TIME_UNCERTAINTY_UNKNOWN
    clock_resolution: int = 1000  # microseconds expressed in ns units
    clock_drift_rate: int = TAIC_CLOCK_DRIFT_RATE_UNKNOWN
    clock_type: int = 0  # 0 unknown, 1 can't sync, 2 can sync


def taic(info: TaiClockInfo) -> bytes:
    return full_box("taic", 0, 0, u64(info.time_uncertainty),
                    u32(info.clock_resolution),
                    struct.pack(">i", info.clock_drift_rate),
                    u8((info.clock_type & 0x3) << 6))


def tai_timestamp_packet(tai_ns: int, synced: bool = False,
                         generation_failure: bool = False,
                         modified: bool = False) -> bytes:
    """TAITimestampPacket, ISO/IEC 23001-17 Amd 1 §8.1.2 (9 bytes)."""
    flags = ((0x80 if synced else 0) | (0x40 if generation_failure else 0)
             | (0x20 if modified else 0))
    return u64(tai_ns) + u8(flags)


def saiz(entry_lengths: list[int], aux_type: str | None = None,
         aux_param: int = 0) -> bytes:
    """SampleAuxiliaryInformationSizesBox (aux_info.rs write_full_saiz)."""
    head = (aux_type.encode("ascii") + u32(aux_param)) if aux_type else b""
    if entry_lengths and all(n == entry_lengths[0] for n in entry_lengths):
        body = u8(entry_lengths[0]) + u32(len(entry_lengths))
    else:
        body = (u8(0) + u32(len(entry_lengths))
                + bytes(entry_lengths))
    return full_box("saiz", 0, 1 if aux_type else 0, head, body)


def saio(chunk_offsets: list[int], aux_type: str | None = None,
         aux_param: int = 0, version: int | None = None) -> bytes:
    """SampleAuxiliaryInformationOffsetsBox (aux_info.rs).  `version`
    pins the offset width (two-pass moof building needs stable sizes
    before the real offsets are known)."""
    if version is None:
        version = (1 if chunk_offsets
                   and max(chunk_offsets) > 0xFFFFFFFF else 0)
    head = (aux_type.encode("ascii") + u32(aux_param)) if aux_type else b""
    offs = b"".join((u64(o) if version else u32(o)) for o in chunk_offsets)
    return full_box("saio", version, 1 if aux_type else 0, head,
                    u32(len(chunk_offsets)), offs)


def senc(entries: list[tuple[bytes, list[tuple[int, int]] | None]]) -> bytes:
    """SampleEncryptionBox (ISO/IEC 23001-7 §7.2): per-sample IV and
    optional subsample (clear, encrypted) runs."""
    use_sub = any(subs for _, subs in entries)
    body = [u32(len(entries))]
    for iv, subs in entries:
        body.append(iv)
        if use_sub:
            subs = subs or []
            body.append(u16(len(subs)))
            for clear, enc in subs:
                body.append(u16(clear) + u32(enc))
    return full_box("senc", 0, 0x2 if use_sub else 0, b"".join(body))


def cenc_aux_sizes(entries) -> list[int]:
    """Per-sample auxiliary info sizes for saiz, matching senc()."""
    use_sub = any(subs for _, subs in entries)
    return [len(iv) + (2 + 6 * len(subs or []) if use_sub else 0)
            for iv, subs in entries]


@dataclass
class StreamConfig:
    """Everything the muxer needs to describe one track."""

    track_id: int
    timescale: int
    is_video: bool
    caps_name: str
    # audio
    channels: int = 2
    sample_rate: int = 48000
    # video
    width: int = 0
    height: int = 0
    # codec private data (avcC/hvcC/av1C/dOps/dfLa payload etc.)
    codec_data: bytes = b""
    language: str = "und"
    # timed metadata track (ONVIF XML: metx sample entry, meta handler,
    # nmhd media header — reference mux/fmp4 onvif variant)
    is_meta: bool = False
    meta_namespace: str = ""
    # raw formats: video/x-raw format string ("RGBA", "I420", ...) or
    # audio/x-raw format string ("S16LE", "F32LE", ...)
    raw_format: str = ""
    # first frame of the stream, for bitstream-derived config boxes
    # (AC-3 dac3 / E-AC-3 dec3, reference boxes.rs create_dac3/create_dec3)
    first_frame: bytes = b""
    # ISO/IEC 23001-17 TAI clock info -> taic box in the sample entry
    tai_clock_info: TaiClockInfo | None = None
    # edit list entries -> edts/elst
    elst_infos: list[ElstInfo] = field(default_factory=list)
    # CENC protection (ISO/IEC 23001-7): (default KID 16 bytes,
    # per-sample IV size) -> encv/enca sample entry with sinf/tenc
    cenc: tuple[bytes, int] | None = None


def _sample_entry_audio(fourcc: str, cfg: StreamConfig,
                        extra: bytes = b"") -> bytes:
    body = (b"\x00" * 6 + u16(1)            # reserved + data_ref_index
            + u32(0) + u32(0)               # reserved
            + u16(cfg.channels) + u16(16)   # channelcount, samplesize
            + u16(0) + u16(0)               # predefined, reserved
            + fixed16_16(cfg.sample_rate))
    return box(fourcc, body, extra)


def _sample_entry_video(fourcc: str, cfg: StreamConfig,
                        extra: bytes = b"") -> bytes:
    body = (b"\x00" * 6 + u16(1)
            + u16(0) + u16(0)               # predefined, reserved
            + u32(0) * 3
            + u16(cfg.width) + u16(cfg.height)
            + fixed16_16(72.0) + fixed16_16(72.0)  # dpi
            + u32(0) + u16(1)               # reserved, frame_count
            + b"\x00" * 32                  # compressor name
            + u16(0x0018) + i16(-1))        # depth, predefined
    return box(fourcc, body, extra)


# -- AC-3 / E-AC-3 config boxes (reference ac3.rs / eac3.rs) ---------------

class _BitReader:
    def __init__(self, data: bytes):
        self._d, self._pos = data, 0

    def read(self, n: int) -> int:
        out = 0
        for _ in range(n):
            byte = self._d[self._pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return out


def dac3(frame: bytes) -> bytes:
    """AC3SpecificBox payload from the first AC-3 syncframe
    (reference boxes.rs create_dac3 + ac3.rs Header)."""
    r = _BitReader(frame)
    if r.read(16) != 0x0B77:
        raise ValueError("AC-3: bad syncword")
    r.read(16)                      # crc1
    fscod = r.read(2)
    frmsizecod = r.read(6)
    bsid = r.read(5)
    bsmod = r.read(3)
    acmod = r.read(3)
    if (acmod & 0x1) and acmod != 0x1:
        r.read(2)                   # cmixlev
    if acmod & 0x4:
        r.read(2)                   # surmixlev
    if acmod == 0x2:
        r.read(2)                   # dsurmod
    lfeon = r.read(1)
    bits = ((fscod << 22) | (bsid << 17) | (bsmod << 14) | (acmod << 11)
            | (lfeon << 10) | ((frmsizecod >> 1) << 5))
    return struct.pack(">I", bits)[1:]  # 24 bits


_EAC3_RATES = {0: 48000, 1: 44100, 2: 32000}
_EAC3_BLOCKS = {0: 1, 1: 2, 2: 3, 3: 6}


def dec3(frame: bytes) -> bytes:
    """EC3SpecificBox payload from the first E-AC-3 frame
    (reference boxes.rs create_dec3 + eac3.rs; single independent
    substream, no dependent substreams)."""
    r = _BitReader(frame)
    if r.read(16) != 0x0B77:
        raise ValueError("E-AC-3: bad syncword")
    r.read(2)                       # strmtyp
    r.read(3)                       # substreamid
    frmsiz = r.read(11)
    fscod = r.read(2)
    if fscod == 3:
        r.read(2)                   # fscod2
        numblkscod = 3
        rate = 24000
    else:
        numblkscod = r.read(2)
        rate = _EAC3_RATES[fscod]
    acmod = r.read(3)
    lfeon = r.read(1)
    bsid = r.read(5)
    frame_bytes = (frmsiz + 1) * 2
    blocks = _EAC3_BLOCKS[numblkscod]
    data_rate = frame_bytes * 8 * rate // (256 * blocks) // 1000  # kbit/s
    out = u16((data_rate << 3) | 0)  # data_rate(13) + num_ind_sub-1(3)
    sub = ((fscod << 22) | (bsid << 17) | (0 << 16) | (0 << 15)
           | (0 << 12) | (acmod << 9) | (lfeon << 8) | (0 << 4) | 0)
    # fscod(2) bsid(5) reserved(1) asvc(1) bsmod(3) acmod(3) lfeon(1)
    # reserved(3) num_dep_sub(4) reserved(1) — 24 bits
    return out + struct.pack(">I", sub)[1:]


def pcmc(audio_format: str) -> bytes:
    """pcmC box, ISO/IEC 23003-5 (reference boxes.rs create_pcmc)."""
    little = audio_format.endswith("LE")
    width = int("".join(ch for ch in audio_format if ch.isdigit()))
    return full_box("pcmC", 0, 0, u8(1 if little else 0), u8(width))


def chnl(channels: int) -> bytes:
    """ChannelLayout box (ISO 14496-12 12.2.4, reference write_chnl)."""
    defined_layout = {1: 1, 2: 2}.get(channels, 0)
    if defined_layout:
        return full_box("chnl", 0, 0, u8(1), u8(defined_layout), u64(0))
    # explicit speaker positions 0..n-1
    return full_box("chnl", 0, 0, u8(1), u8(0),
                    bytes(range(channels)))


# -- uncompressed video (ISO/IEC 23001-17, reference uncompressed.rs) ------

# component types, 23001-17 Table 1
_MONO, _LUMA, _CB, _CR, _RED, _GREEN, _BLUE, _ALPHA = 0, 1, 2, 3, 4, 5, 6, 7

# fmt -> (profile fourcc, components in memory order [(type, depth)],
#         sampling_type, interleave_type, pixel_size_bytes)
# sampling: 0=none 1=4:2:2 2=4:2:0; interleave: 0=planar 1=pixel
# 2=semi-planar (mixed) 5=multi-Y packed
_UNCV_FORMATS = {
    "RGBA":      ("rgba", [(_RED, 8), (_GREEN, 8), (_BLUE, 8), (_ALPHA, 8)], 0, 1, 4),
    "ABGR":      ("abgr", [(_ALPHA, 8), (_BLUE, 8), (_GREEN, 8), (_RED, 8)], 0, 1, 4),
    "BGRA":      (None,   [(_BLUE, 8), (_GREEN, 8), (_RED, 8), (_ALPHA, 8)], 0, 1, 4),
    "ARGB":      (None,   [(_ALPHA, 8), (_RED, 8), (_GREEN, 8), (_BLUE, 8)], 0, 1, 4),
    "RGB":       ("rgb3", [(_RED, 8), (_GREEN, 8), (_BLUE, 8)], 0, 1, 3),
    "BGR":       (None,   [(_BLUE, 8), (_GREEN, 8), (_RED, 8)], 0, 1, 3),
    "GRAY8":     (None,   [(_MONO, 8)], 0, 0, 0),
    "GRAY16_LE": (None,   [(_MONO, 16)], 0, 0, 0),
    "I420":      ("i420", [(_LUMA, 8), (_CB, 8), (_CR, 8)], 2, 0, 0),
    "YV12":      ("yv20", [(_LUMA, 8), (_CR, 8), (_CB, 8)], 2, 0, 0),
    "NV12":      ("nv12", [(_LUMA, 8), (_CB, 8), (_CR, 8)], 2, 2, 0),
    "NV21":      ("nv21", [(_LUMA, 8), (_CR, 8), (_CB, 8)], 2, 2, 0),
    "Y444":      (None,   [(_LUMA, 8), (_CB, 8), (_CR, 8)], 0, 0, 0),
    "Y42B":      ("yu22", [(_LUMA, 8), (_CB, 8), (_CR, 8)], 1, 0, 0),
    "YUY2":      ("yuv2", [(_LUMA, 8), (_CB, 8), (_LUMA, 8), (_CR, 8)], 1, 5, 0),
    "UYVY":      ("2vuy", [(_CB, 8), (_LUMA, 8), (_CR, 8), (_LUMA, 8)], 1, 5, 0),
}

# formats where the v1 header-only uncC fully describes the layout
# (reference write_uncompressed_sample_entries: Rgba | Abgr | Rgb)
_UNCV_V1 = {"RGBA", "ABGR", "RGB"}


def uncompressed_boxes(fmt: str) -> bytes:
    """cmpd + uncC for a video/x-raw format (uncompressed.rs
    write_uncompressed_sample_entries)."""
    if fmt not in _UNCV_FORMATS:
        raise ValueError(f"uncv: unsupported raw format {fmt}")
    profile, comps, sampling, interleave, pixel_size = _UNCV_FORMATS[fmt]
    prof = (profile or "\x00\x00\x00\x00").encode("latin1")
    if fmt in _UNCV_V1:
        return full_box("uncC", 1, 0, prof)
    cmpd = box("cmpd", u32(len(comps)),
               b"".join(u16(t) for t, _ in comps))
    entries = b"".join(u16(i) + u8(d - 1) + u8(0) + u8(0)
                       for i, (_, d) in enumerate(comps))
    uncc = full_box("uncC", 0, 0, prof, u32(len(comps)), entries,
                    u8(sampling), u8(interleave),
                    u8(0),            # block_size
                    u8(0),            # flag bits
                    u32(pixel_size),
                    u32(0),           # row_align_size
                    u32(0),           # tile_align_size
                    u32(0), u32(0))   # tile cols/rows minus one
    return cmpd + uncc


def _protect_entry(entry: bytes, cfg: StreamConfig) -> bytes:
    """Wrap a plain sample entry into its CENC-protected form
    (ISO/IEC 23001-7 §8): fourcc -> encv/enca, original fourcc in
    sinf/frma, scheme cenc 1.0, defaults in schi/tenc."""
    orig = entry[4:8]
    body = entry[8:]
    kid, iv_size = cfg.cenc
    if len(kid) != 16:
        raise ValueError("cenc KID must be 16 bytes")
    sinf = box("sinf",
               box("frma", orig),
               full_box("schm", 0, 0, b"cenc", u32(0x00010000)),
               box("schi", full_box(
                   "tenc", 0, 0,
                   u8(0), u8(0),            # reserved, pattern (none)
                   u8(1),                   # default_isProtected
                   u8(iv_size), kid)))
    fourcc = "encv" if cfg.is_video else "enca"
    return box(fourcc, body + sinf)


def sample_entry(cfg: StreamConfig) -> bytes:
    """Codec-specific sample entry (reference boxes.rs codec builders)."""
    if cfg.cenc is not None:
        import dataclasses
        plain = dataclasses.replace(cfg, cenc=None)
        return _protect_entry(sample_entry(plain), cfg)
    n = cfg.caps_name
    tai = taic(cfg.tai_clock_info) if cfg.tai_clock_info else b""
    if cfg.is_meta:
        # metx: XML metadata sample entry (ISO 14496-12 12.3.3)
        return box("metx", b"\x00" * 6 + u16(1),
                   b"\x00",                       # content_encoding
                   cfg.meta_namespace.encode() + b"\x00",
                   b"\x00")                       # schema_location
    if n == "video/x-h264":
        return _sample_entry_video("avc1", cfg,
                                   box("avcC", cfg.codec_data) + tai)
    if n == "video/x-h265":
        return _sample_entry_video("hvc1", cfg,
                                   box("hvcC", cfg.codec_data) + tai)
    if n == "video/x-av1":
        return _sample_entry_video("av01", cfg,
                                   box("av1C", cfg.codec_data) + tai)
    if n == "video/x-vp9":
        return _sample_entry_video("vp09", cfg,
                                   box("vpcC", cfg.codec_data) + tai)
    if n == "video/x-raw":
        return _sample_entry_video(
            "uncv", cfg, uncompressed_boxes(cfg.raw_format or "RGBA") + tai)
    if n == "audio/x-opus":
        # dOps: version 0, channel count, pre-skip, input rate, gain
        dops = (u8(0) + u8(cfg.channels) + u16(312)
                + u32(cfg.sample_rate) + u16(0) + u8(0))
        return _sample_entry_audio("Opus", cfg, box("dOps", dops) + tai)
    if n == "audio/x-flac":
        return _sample_entry_audio("fLaC", cfg,
                                   full_box("dfLa", 0, 0,
                                            cfg.codec_data) + tai)
    if n == "audio/mpeg":  # AAC
        esds = full_box("esds", 0, 0, cfg.codec_data)
        return _sample_entry_audio("mp4a", cfg, esds + tai)
    if n == "audio/x-ac3":
        return _sample_entry_audio("ac-3", cfg,
                                   box("dac3", dac3(cfg.first_frame)) + tai)
    if n == "audio/x-eac3":
        return _sample_entry_audio("ec-3", cfg,
                                   box("dec3", dec3(cfg.first_frame)) + tai)
    if n == "audio/x-raw":
        fmt = cfg.raw_format or "S16LE"
        fourcc = "fpcm" if fmt.startswith("F") else "ipcm"
        return _sample_entry_audio(
            fourcc, cfg, chnl(cfg.channels) + pcmc(fmt) + tai)
    raise ValueError(f"unsupported codec for mp4: {n}")


def _hdlr(cfg: StreamConfig) -> bytes:
    if cfg.is_meta:
        return full_box("hdlr", 0, 0, u32(0), b"meta", u32(0) * 3,
                        b"MetadataHandler\x00")
    handler = b"vide" if cfg.is_video else b"soun"
    name = b"VideoHandler\x00" if cfg.is_video else b"SoundHandler\x00"
    return full_box("hdlr", 0, 0, u32(0), handler, u32(0) * 3, name)


def _mdhd(cfg: StreamConfig, duration: int) -> bytes:
    lang = cfg.language
    packed = (((ord(lang[0]) - 0x60) << 10) | ((ord(lang[1]) - 0x60) << 5)
              | (ord(lang[2]) - 0x60))
    return full_box("mdhd", 0, 0, u32(0), u32(0), u32(cfg.timescale),
                    u32(duration), u16(packed), u16(0))


def _tkhd(cfg: StreamConfig, duration_mvts: int) -> bytes:
    flags = 0x7  # enabled | in movie | in preview
    body = (u32(0) + u32(0) + u32(cfg.track_id) + u32(0)
            + u32(duration_mvts)
            + u32(0) * 2 + i16(0) + i16(0)
            + (fixed8_8(1.0) if not cfg.is_video else fixed8_8(0.0))
            + u16(0) + UNITY_MATRIX
            + fixed16_16(cfg.width) + fixed16_16(cfg.height))
    return full_box("tkhd", 0, flags, body)


def _dinf() -> bytes:
    url = full_box("url ", 0, 1)
    dref = full_box("dref", 0, 0, u32(1), url)
    return box("dinf", dref)


def _ctts_cslg(samples: list["Mp4Sample"]) -> list[bytes]:
    """ctts (v1, signed) + cslg composition-offset boxes
    (reference boxes.rs write_ctts/write_cslg)."""
    runs: list[list[int]] = []
    for s in samples:
        if runs and runs[-1][1] == s.composition_offset:
            runs[-1][0] += 1
        else:
            runs.append([1, s.composition_offset])
    ctts = full_box("ctts", 1, 0, u32(len(runs)),
                    b"".join(u32(c) + i32(o) for c, o in runs))
    least = min(s.composition_offset for s in samples)
    greatest = max(s.composition_offset for s in samples)
    dts = 0
    start = end = None
    for s in samples:
        cts = dts + s.composition_offset
        start = cts if start is None else min(start, cts)
        end = cts + s.duration if end is None else max(end, cts + s.duration)
        dts += s.duration
    cslg = full_box("cslg", 0, 0, i32(max(0, -least)), i32(least),
                    i32(greatest), i32(start), i32(end))
    return [ctts, cslg]


def _stbl(cfg: StreamConfig, samples: list["Mp4Sample"] | None = None,
          chunk_offsets: list[int] | None = None,
          aux: "AuxData | None" = None) -> bytes:
    stsd = full_box("stsd", 0, 0, u32(1), sample_entry(cfg))
    if not samples:
        # empty tables (fragmented)
        stts = full_box("stts", 0, 0, u32(0))
        stsc = full_box("stsc", 0, 0, u32(0))
        stsz = full_box("stsz", 0, 0, u32(0), u32(0))
        stco = full_box("stco", 0, 0, u32(0))
        return box("stbl", stsd, stts, stsc, stsz, stco)
    # non-fragmented sample tables
    # stts: run-length encode durations
    runs = []
    for s in samples:
        if runs and runs[-1][1] == s.duration:
            runs[-1][0] += 1
        else:
            runs.append([1, s.duration])
    stts = full_box("stts", 0, 0, u32(len(runs)),
                    b"".join(u32(c) + u32(d) for c, d in runs))
    # one chunk per sample (simple + valid)
    stsc = full_box("stsc", 0, 0, u32(1), u32(1) + u32(1) + u32(1))
    stsz = full_box("stsz", 0, 0, u32(0), u32(len(samples)),
                    b"".join(u32(len(s.data)) for s in samples))
    stco = full_box("stco", 0, 0, u32(len(chunk_offsets)),
                    b"".join(u32(o) for o in chunk_offsets))
    boxes = [stsd, stts]
    if any(s.composition_offset for s in samples):
        boxes.extend(_ctts_cslg(samples))
    boxes.extend([stsc, stsz, stco])
    sync = [i + 1 for i, s in enumerate(samples) if s.keyframe]
    if cfg.is_video and len(sync) != len(samples):
        boxes.append(full_box("stss", 0, 0, u32(len(sync)),
                              b"".join(u32(i) for i in sync)))
    if aux is not None:
        boxes.append(saiz(aux.entry_lengths, aux.aux_type, aux.aux_param))
        boxes.append(saio(aux.chunk_offsets, aux.aux_type, aux.aux_param))
    return box("stbl", *boxes)


@dataclass
class AuxData:
    """Per-track sample auxiliary information location
    (reference mod.rs AuxiliaryInformation + AuxiliaryInformationData)."""

    aux_type: str | None
    aux_param: int
    entry_lengths: list[int]
    chunk_offsets: list[int]


def elst(cfg: StreamConfig, movie_timescale: int) -> bytes:
    """edts/elst from the stream's ElstInfos
    (reference boxes.rs write_elst: v1, durations in movie timescale,
    media times in track timescale, -1 for empty edits)."""
    entries = b""
    count = 0
    for info in cfg.elst_infos:
        dur = info.duration_ns * movie_timescale // SECOND
        if dur == 0:
            continue
        if info.start_ns is None:
            media_time = -1
        else:
            media_time = info.start_ns * cfg.timescale // SECOND
        entries += (u64(dur) + struct.pack(">q", media_time)
                    + u16(1) + u16(0))
        count += 1
    return box("edts", full_box("elst", 1, 0, u32(count), entries))


def _minf(cfg: StreamConfig, stbl: bytes) -> bytes:
    if cfg.is_meta:
        header = full_box("nmhd", 0, 0)
    elif cfg.is_video:
        header = full_box("vmhd", 0, 1, u16(0), u16(0) * 3)
    else:
        header = full_box("smhd", 0, 0, u16(0), u16(0))
    return box("minf", header, _dinf(), stbl)


def trak(cfg: StreamConfig, duration: int = 0,
         movie_timescale: int = 1000,
         samples: list["Mp4Sample"] | None = None,
         chunk_offsets: list[int] | None = None,
         aux: "AuxData | None" = None) -> bytes:
    dur_mvts = duration * movie_timescale // cfg.timescale \
        if duration else 0
    mdia = box("mdia", _mdhd(cfg, duration), _hdlr(cfg),
               _minf(cfg, _stbl(cfg, samples, chunk_offsets, aux)))
    parts = [_tkhd(cfg, dur_mvts)]
    if cfg.elst_infos:
        parts.append(elst(cfg, movie_timescale))
    parts.append(mdia)
    return box("trak", *parts)


def mvhd(movie_timescale: int, duration: int, next_track: int) -> bytes:
    return full_box("mvhd", 0, 0, u32(0), u32(0), u32(movie_timescale),
                    u32(duration), fixed16_16(1.0), fixed8_8(1.0),
                    b"\x00" * 10, UNITY_MATRIX, b"\x00" * 24,
                    u32(next_track))


def trex(track_id: int) -> bytes:
    return full_box("trex", 0, 0, u32(track_id), u32(1), u32(0), u32(0),
                    u32(0))


def mehd(duration_mvts: int) -> bytes:
    """MovieExtendsHeader: total fragmented-movie duration
    (reference fmp4mux write-mehd property)."""
    return full_box("mehd", 1, 0, u64(duration_mvts))


def moov(configs: list[StreamConfig], movie_timescale: int = 1000,
         fragmented: bool = True, durations: dict[int, int] | None = None,
         samples: dict[int, list["Mp4Sample"]] | None = None,
         chunk_offsets: dict[int, list[int]] | None = None,
         aux: dict[int, "AuxData"] | None = None,
         mehd_duration_mvts: int | None = None) -> bytes:
    durations = durations or {}
    total = max((durations.get(c.track_id, 0) * movie_timescale
                 // c.timescale for c in configs), default=0)
    parts = [mvhd(movie_timescale, total,
                  max(c.track_id for c in configs) + 1)]
    for c in configs:
        parts.append(trak(c, durations.get(c.track_id, 0),
                          movie_timescale,
                          (samples or {}).get(c.track_id),
                          (chunk_offsets or {}).get(c.track_id),
                          (aux or {}).get(c.track_id)))
    if fragmented:
        mvex = [trex(c.track_id) for c in configs]
        if mehd_duration_mvts is not None:
            mvex.insert(0, mehd(mehd_duration_mvts))
        parts.append(box("mvex", *mvex))
    return box("moov", *parts)


# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------

@dataclass
class Mp4Sample:
    data: bytes
    duration: int          # in track timescale
    keyframe: bool = True
    composition_offset: int = 0


TRUN_DATA_OFFSET = 0x000001
TRUN_FIRST_SAMPLE_FLAGS = 0x000004
TRUN_DURATION = 0x000100
TRUN_SIZE = 0x000200
TRUN_FLAGS = 0x000400
TRUN_CTS = 0x000800


def moof(seqno: int, runs: list[tuple[int, int, list[Mp4Sample]]],
         cenc: list[list[tuple[bytes, list | None]] | None] | None = None
         ) -> bytes:
    """runs: [(track_id, base_decode_time, samples)]. Computes the
    data offsets so that mdat payload immediately follows.  The same
    track may appear in several runs (interleaved chunks).  `cenc`,
    when given, aligns with `runs`: per-sample (iv, subsamples) aux
    info emitting senc + saiz + saio in that traf (23001-7 §7)."""
    cenc = cenc or [None] * len(runs)

    # build twice: first to learn sizes (offset widths are pinned so
    # sizes are offset-independent), then with the real offsets
    def build(offsets: list[int], saio_offs: list[int]) -> bytes:
        parts = [full_box("mfhd", 0, 0, u32(seqno))]
        for i, ((track_id, bdt, samples), off) in enumerate(
                zip(runs, offsets)):
            tfhd = full_box("tfhd", 0, 0x020000, u32(track_id))
            tfdt = full_box("tfdt", 1, 0, u64(bdt))
            flags = (TRUN_DATA_OFFSET | TRUN_DURATION | TRUN_SIZE
                     | TRUN_FLAGS | TRUN_CTS)
            entries = []
            for s in samples:
                sflags = 0x00010000 if not s.keyframe else 0x02000000
                entries.append(u32(s.duration) + u32(len(s.data))
                               + u32(sflags) + i32(s.composition_offset))
            trun = full_box("trun", 1, flags, u32(len(samples)),
                            i32(off), b"".join(entries))
            aux = cenc[i]
            if aux is None:
                parts.append(box("traf", tfhd, tfdt, trun))
            else:
                parts.append(box(
                    "traf", tfhd, tfdt, trun, senc(aux),
                    saiz(cenc_aux_sizes(aux), "cenc"),
                    saio([saio_offs[i]], "cenc", version=1)))
        return box("moof", *parts)

    probe = build([0] * len(runs), [0] * len(runs))
    moof_size = len(probe)
    offsets = []
    data_off = moof_size + 8  # mdat header
    for _, _, samples in runs:
        offsets.append(data_off)
        data_off += sum(len(s.data) for s in samples)
    # saio points at the first senc entry (offset from moof start,
    # default-base-is-moof); sizes are pass-stable, so parse the probe
    # to locate each traf's senc payload
    saio_offs = [0] * len(runs)
    if any(a is not None for a in cenc):
        trafs = [b for b in parse_boxes(probe)[0].children
                 if b.fourcc == "traf"]
        j = 0
        for i in range(len(runs)):
            if cenc[i] is None:
                j += 1
                continue
            sb = trafs[j].find("senc")
            saio_offs[i] = sb.offset + 12 + 4   # hdr + sample_count
            j += 1
    return build(offsets, saio_offs)


def mdat(payload: bytes) -> bytes:
    return box("mdat", payload)


# ---------------------------------------------------------------------------
# parser (for tests and demuxing)
# ---------------------------------------------------------------------------

@dataclass
class ParsedBox:
    fourcc: str
    offset: int
    size: int
    data: bytes
    children: list["ParsedBox"] = field(default_factory=list)

    def find(self, path: str) -> "ParsedBox | None":
        parts = path.split(".")
        cur = self
        for p in parts:
            nxt = None
            for c in cur.children:
                if c.fourcc == p:
                    nxt = c
                    break
            if nxt is None:
                return None
            cur = nxt
        return cur

    def find_all(self, fourcc: str) -> list["ParsedBox"]:
        return [c for c in self.children if c.fourcc == fourcc]


_CONTAINERS = {"moov", "trak", "mdia", "minf", "stbl", "mvex", "moof",
               "traf", "edts", "dinf", "udta"}


def parse_boxes(data: bytes, offset: int = 0) -> list[ParsedBox]:
    out = []
    pos = 0
    while pos + 8 <= len(data):
        size, = struct.unpack_from(">I", data, pos)
        fourcc = data[pos + 4:pos + 8].decode("latin1")
        if size == 1:
            size, = struct.unpack_from(">Q", data, pos + 8)
            body = data[pos + 16:pos + size]
        elif size == 0:
            size = len(data) - pos
            body = data[pos + 8:]
        else:
            body = data[pos + 8:pos + size]
        b = ParsedBox(fourcc, offset + pos, size, body)
        if fourcc in _CONTAINERS:
            b.children = parse_boxes(body, offset + pos + 8)
        out.append(b)
        if size <= 0:
            break
        pos += size
    return out
