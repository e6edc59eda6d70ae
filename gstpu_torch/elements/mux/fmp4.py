"""isofmp4mux / cmafmux / isomp4mux: ISO BMFF muxers.

Rebuilds the reference isobmff crate's muxer family
(mux/isobmff/src/isobmff/fmp4mux/imp.rs: Aggregator-driven GOP
queueing, fragment draining at fragment-duration boundaries on
keyframes, moof/mdat serialization; imp.rs:5503-5897 subclass brand
sets) on gstpu_torch.mux.boxes.

The port's copy of gstpu/elements/mux/fmp4.py: host code, as there; a
sample's payload is read through `Buffer.to_bytes()`, so a tensor
payload is downloaded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

from gstpu_torch.core.base import Aggregator, AggregatorPad
from gstpu_torch.core.buffer import (Buffer, BufferFlags, BufferList, Meta,
                                     ReferenceTimestampMeta)
from gstpu_torch.core.caps import Caps, Structure
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import Segment, SegmentEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.mux import boxes
from gstpu_torch.mux.boxes import (AuxData, ElstInfo, Mp4Sample, StreamConfig,
                                   TaiClockInfo)

SECOND = 1_000_000_000

# GStreamer reference-timestamp caps for TAI (ISO/IEC 23001-17;
# reference mp4mux/imp.rs TAI1958_CAPS)
TAI1958 = "timestamp/x-tai1958"

AUDIO_CODECS = ("audio/x-opus", "audio/x-flac", "audio/mpeg",
                "audio/x-ac3", "audio/x-eac3", "audio/x-raw")
VIDEO_CODECS = ("video/x-h264", "video/x-h265", "video/x-av1",
                "video/x-vp9", "video/x-raw")

# codecs whose sample entry is derived from the first frame's
# bitstream (dac3/dec3) — header generation waits for one buffer
FIRST_FRAME_CODECS = ("audio/x-ac3", "audio/x-eac3")


class FMP4KeyframeMeta(Meta):
    """Marks fragment-header buffers holding a keyframe
    (reference mux/isobmff/src/isobmff/mod.rs:122-124)."""

    def __init__(self, keyframe: bool = True):
        self.keyframe = keyframe


META_CODECS = ("application/x-onvif-metadata",)
CENC_CAPS = "application/x-cenc"


class CencAuxMeta(Meta):
    """Per-sample CENC auxiliary info attached by an upstream
    protector: the IV actually used and the (clear, encrypted)
    subsample runs.  The muxer serializes these as senc + saiz/saio
    in the fragment (ISO/IEC 23001-7 §7; reference fmp4mux aux-info
    plumbing)."""

    def __init__(self, iv: bytes, subsamples=()):
        self.iv = bytes(iv)
        self.subsamples = [(int(c), int(e)) for c, e in subsamples]


def _mux_sink_caps(meta: bool = False) -> Caps:
    names = AUDIO_CODECS + VIDEO_CODECS + (CENC_CAPS,) \
        + (META_CODECS if meta else ())
    return Caps([Structure(n) for n in names])


@dataclass
class _Stream:
    pad: AggregatorPad
    cfg: StreamConfig
    pending: list[tuple[Buffer, int]] = field(default_factory=list)
    next_decode_time: int = 0          # in track timescale
    total_duration_ts: int = 0
    frag_filled_ns: int = 0            # chunk mode: ns into fragment

    def caps_duration_to_ts(self, dur_ns: int) -> int:
        return dur_ns * self.cfg.timescale // SECOND


class FMP4MuxBase(Aggregator):
    """Fragmented MP4 base; subclasses set brands/constraints."""

    MAJOR_BRAND = "iso6"
    COMPAT_BRANDS = ["iso6", "isom", "mp41"]
    SINGLE_STREAM = False
    FRAGMENT_STYP = True

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/quicktime", variant="iso-fragmented")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    _mux_sink_caps()),
    ]

    fragment_duration = Property(int, default=10 * SECOND, minimum=1,
                                 mutable=Mutability.READY,
                                 blurb="Target fragment duration (ns)")
    movie_timescale = Property(int, default=1000, minimum=1,
                               mutable=Mutability.READY)
    header_update_mode = Property(
        str, default="none", mutable=Mutability.READY,
        blurb="none|rewrite: rewrite moov with final duration at EOS "
              "(reference fmp4mux header-update-mode)")
    write_mehd = Property(bool, default=False, mutable=Mutability.READY,
                          blurb="Write mehd (total duration) in mvex "
                                "(reference fmp4mux write-mehd)")
    interleave_bytes = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="Interleave streams inside a fragment in chunks of at "
              "most this many bytes (0 = one run per stream; "
              "reference fmp4mux interleave-bytes)")
    interleave_time = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="Interleave streams inside a fragment in chunks of at "
              "most this duration in ns (0 = off; reference fmp4mux "
              "interleave-time, default 500ms there)")
    chunk_duration = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="CMAF low-latency chunking (ns; 0 = off): emit a "
              "moof+mdat every chunk-duration WITHOUT waiting for "
              "the fragment boundary; fragments still open on "
              "keyframes every fragment-duration (styp + non-delta "
              "buffer), so LL-HLS/DASH packagers can ship partial "
              "segments (reference fmp4mux chunk-duration)")

    def __init__(self, name=None):
        super().__init__(name)
        self._streams: dict[str, _Stream] = {}
        self._header_sent = False
        self._header_size = 0
        self._seqno = 0
        self._frag_start_ns: int | None = None
        self._chunk_frag_open = False

    # -- setup ---------------------------------------------------------
    def _make_cfg(self, pad: AggregatorPad, track_id: int) -> StreamConfig:
        caps = pad.current_caps
        s = caps[0]
        cenc = None
        if s.name == CENC_CAPS:
            # protected stream: sample entry follows the ORIGINAL
            # media type, wrapped encv/enca + sinf/tenc
            # (ISO/IEC 23001-7 §8; reference fmp4mux cenc aux-info)
            orig = s.get("original-media-type")
            if not orig:
                raise ValueError("application/x-cenc caps need "
                                 "original-media-type")
            kid = bytes.fromhex(str(s.get("kid", "00" * 16)))
            iv_size = int(s.get("iv-size", 8))
            s = s.copy()
            s.name = str(orig)
            cenc = (kid, iv_size)
        is_video = s.name in VIDEO_CODECS
        codec_data = s.get("codec_data", b"")
        if isinstance(codec_data, str):
            codec_data = bytes.fromhex(codec_data)
        if s.name in META_CODECS:
            from gstpu_torch.elements.net.onvif import ONVIF_SCHEMA
            return StreamConfig(track_id, 1000, False, s.name,
                                is_meta=True,
                                meta_namespace=ONVIF_SCHEMA)
        if is_video:
            timescale = 90000
            return StreamConfig(track_id, timescale, True, s.name,
                                width=int(s.get("width", 0)),
                                height=int(s.get("height", 0)),
                                codec_data=codec_data,
                                raw_format=str(s.get("format", "")),
                                cenc=cenc)
        rate = int(s.get("rate", 48000))
        return StreamConfig(track_id, rate, False, s.name,
                            channels=int(s.get("channels", 2)),
                            sample_rate=rate, codec_data=codec_data,
                            raw_format=str(s.get("format", "")),
                            cenc=cenc)

    def _setup_streams(self) -> bool:
        pads = self.agg_sink_pads()
        if self.SINGLE_STREAM and len(pads) > 1:
            if not getattr(self, "_constraint_error_posted", False):
                self._constraint_error_posted = True
                self.post_error(f"{self.ELEMENT_NAME}: single-stream "
                                f"muxer with {len(pads)} pads")
            return False
        streams = {}
        for i, pad in enumerate(sorted(pads, key=lambda p: p.name)):
            if pad.current_caps is None:
                return False  # wait until every pad has caps
            try:
                cfg = self._make_cfg(pad, i + 1)
            except ValueError as e:
                if not getattr(self, "_caps_error_posted", False):
                    self._caps_error_posted = True
                    self.post_error(f"{type(self).__name__}: {e}")
                return False
            streams[pad.name] = _Stream(pad, cfg)
        self._streams = streams
        return True

    def negotiate_src_caps(self) -> Caps:
        return Caps.new("video/quicktime", variant="iso-fragmented")

    # -- aggregation ----------------------------------------------------
    def _build_header(self, final: bool = False) -> bytes:
        mehd_dur = None
        if self.write_mehd:
            # placeholder 0 in the initial header so a rewrite at EOS
            # keeps the moov size stable (reference fmp4mux writes mehd
            # up front in update modes)
            mehd_dur = 0
            if final:
                mehd_dur = max((st.total_duration_ts
                                * self.movie_timescale
                                // st.cfg.timescale
                                for st in self._streams.values()),
                               default=0)
        durations = None
        if final:
            durations = {st.cfg.track_id: st.total_duration_ts
                         for st in self._streams.values()}
        return (boxes.ftyp(self.MAJOR_BRAND, 0, self.COMPAT_BRANDS)
                + boxes.moov([st.cfg for st in self._streams.values()],
                             self.movie_timescale, fragmented=True,
                             durations=durations,
                             mehd_duration_mvts=mehd_dur))

    def aggregate(self, timeout: bool) -> FlowReturn:
        if not self._streams:
            if not self._setup_streams():
                return FlowReturn.OK  # wait for caps on all pads

        # move queued pad buffers into per-stream pending lists (before
        # the header: dac3/dec3 sample entries need the first frame)
        for st in self._streams.values():
            while True:
                buf = st.pad.pop_buffer()
                if buf is None:
                    break
                if not st.cfg.first_frame:
                    st.cfg.first_frame = buf.to_bytes()
                dur = buf.duration if buf.duration is not None else 0
                st.pending.append((buf, dur))
                if self._frag_start_ns is None and buf.pts is not None:
                    self._frag_start_ns = buf.pts

        if not self._header_sent:
            if any(st.cfg.caps_name in FIRST_FRAME_CODECS
                   and not st.cfg.first_frame
                   for st in self._streams.values()):
                return FlowReturn.OK  # wait for the config frame
            hdr = self._build_header()
            self._header_size = len(hdr)
            b = Buffer(hdr, flags=BufferFlags.HEADER)
            ret = self.srcpad.push(b)
            if not ret.is_ok:
                return ret
            self._header_sent = True

        if self.chunk_duration:
            ret = FlowReturn.OK
            while self._chunk_ready():
                ret = self._drain_chunk()
                if not ret.is_ok:
                    return ret
            if timeout and any(st.pending
                               for st in self._streams.values()):
                # sparse streams (metadata/caption tracks) must not
                # stall low-latency output: on timeout ship whatever
                # is queued (the reference drains on timeout too)
                ret = self._drain_chunk()
            return ret
        if self._fragment_ready():
            return self._drain_fragment()
        return FlowReturn.OK

    def _fragment_ready(self) -> bool:
        """Fragment boundary: every stream has >= fragment_duration
        queued, and video streams have a keyframe to cut at
        (reference queue_gops/drain, imp.rs:1163, 3635)."""
        if not self._streams:
            return False
        for st in self._streams.values():
            if self._cut_index(st) is None:
                return False
        return True

    def _cut_index(self, st: _Stream) -> int | None:
        """First index where a fragment may end: accumulated duration
        reached and (for video) the next sample starts a GOP."""
        acc = 0
        for i, (buf, dur) in enumerate(st.pending):
            if acc >= self.fragment_duration \
                    and (not st.cfg.is_video or buf.is_keyframe()):
                return i
            acc += dur
        return None

    def _chunk(self, st: _Stream,
               take: list[tuple[Buffer, int]]
               ) -> list[list[tuple[Buffer, int]]]:
        """Split one stream's fragment share into interleave chunks
        (reference fmp4mux interleave-bytes/interleave-time: bound
        how much of one stream is written before switching)."""
        if not self.interleave_bytes and not self.interleave_time:
            return [take]
        chunks, cur, acc_b, acc_t = [], [], 0, 0
        for buf, dur in take:
            cur.append((buf, dur))
            acc_b += buf.size
            acc_t += dur
            if (self.interleave_bytes
                    and acc_b >= self.interleave_bytes) or \
               (self.interleave_time
                    and acc_t >= self.interleave_time):
                chunks.append(cur)
                cur, acc_b, acc_t = [], 0, 0
        if cur:
            chunks.append(cur)
        return chunks

    def _drain_fragment(self, final: bool = False) -> FlowReturn:
        # per-stream share of this fragment, split into interleave
        # chunks, then emitted round-robin: one traf/trun per chunk
        per_stream: list[tuple[_Stream, list]] = []
        for st in self._streams.values():
            take = st.pending if final else self._take_fragment(st)
            if final:
                st.pending = []
            if take:
                per_stream.append((st, self._chunk(st, take)))
        order: list[tuple[_Stream, list]] = []
        depth = 0
        while True:
            layer = [(st, chs[depth]) for st, chs in per_stream
                     if depth < len(chs)]
            if not layer:
                break
            order += layer
            depth += 1

        built = self._build_runs(order)
        if built is None:
            return FlowReturn.ERROR
        runs, cenc, payload, keyframe = built
        if not runs:
            return FlowReturn.OK
        self._frag_start_ns = None
        return self._push_moof(runs, cenc, payload,
                               styp=self.FRAGMENT_STYP,
                               keyframe=keyframe)

    def _build_runs(self, order):
        """Returns (runs, cenc, payload, keyframe), or None after
        posting an error (protection metadata inconsistency — a track
        advertising tenc isProtected=1 MUST NOT carry samples without
        real per-sample aux info)."""
        runs, cenc, payload, keyframe = [], [], b"", False
        for st, chunk in order:
            samples, aux = [], []
            n_meta = 0
            for buf, dur in chunk:
                samples.append(Mp4Sample(buf.to_bytes(),
                                         st.caps_duration_to_ts(dur),
                                         buf.is_keyframe()))
                keyframe = keyframe or buf.is_keyframe()
                m = buf.get_meta(CencAuxMeta)
                if m is not None:
                    n_meta += 1
                    aux.append((m.iv, m.subsamples))
            protected = st.cfg.cenc is not None or n_meta > 0
            if protected and n_meta != len(samples):
                self.post_error(
                    f"{type(self).__name__}: track "
                    f"{st.cfg.track_id} is CENC-protected but "
                    f"{len(samples) - n_meta}/{len(samples)} samples "
                    f"carry no CencAuxMeta (clear samples cannot be "
                    f"advertised as encrypted)")
                return None
            runs.append((st.cfg.track_id, st.next_decode_time,
                         samples))
            cenc.append(aux if protected else None)
            st.next_decode_time += sum(s.duration for s in samples)
            st.total_duration_ts += sum(s.duration for s in samples)
            payload += b"".join(s.data for s in samples)
        return runs, cenc, payload, keyframe

    def _push_moof(self, runs, cenc, payload, styp: bool,
                   keyframe: bool) -> FlowReturn:
        self._seqno += 1
        frag = b""
        if styp:
            frag += boxes.styp("msdh", 0, ["msdh", "msix"])
        frag += boxes.moof(
            self._seqno, runs,
            cenc=cenc if any(a is not None for a in cenc) else None) \
            + boxes.mdat(payload)
        b = Buffer(frag)
        b.add_meta(FMP4KeyframeMeta(keyframe))
        if not keyframe:
            b.set_flag(BufferFlags.DELTA_UNIT)
        return self.srcpad.push(b)

    # -- CMAF low-latency chunk mode --------------------------------------
    def _chunk_ready(self) -> bool:
        if not self._streams:
            return False
        return all(sum(d for _, d in st.pending) >= self.chunk_duration
                   and st.pending
                   for st in self._streams.values())

    def _at_boundary(self, st: _Stream) -> bool:
        return (st.frag_filled_ns >= self.fragment_duration
                and bool(st.pending)
                and (not st.cfg.is_video
                     or st.pending[0][0].is_keyframe()))

    def _take_chunk(self, st: _Stream):
        """Take ~chunk-duration from one stream, never crossing a
        fragment boundary (>= fragment-duration into the fragment AND,
        for video, the next sample is a keyframe)."""
        take, acc = [], 0
        while st.pending:
            # never cross the boundary — even with an empty take: a
            # stream that reached it WAITS until every stream has
            # (the keyframe must open the next fragment, not leak
            # into a mid-fragment chunk)
            if self._at_boundary(st):
                break
            if acc >= self.chunk_duration:
                break
            buf, dur = st.pending.pop(0)
            take.append((buf, dur))
            acc += dur
            st.frag_filled_ns += dur
        return take

    def _drain_chunk(self) -> FlowReturn:
        # fragment closure first: when every stream sits at a
        # boundary, the chunk taken below OPENS the next fragment
        if self._chunk_frag_open and self._streams and all(
                self._at_boundary(st)
                for st in self._streams.values()):
            for st in self._streams.values():
                st.frag_filled_ns = 0
            self._chunk_frag_open = False
        new_frag = not self._chunk_frag_open
        order = []
        for st in self._streams.values():
            take = self._take_chunk(st)
            if take:
                order.append((st, take))
        built = self._build_runs(order)
        if built is None:
            return FlowReturn.ERROR
        runs, cenc, payload, _kf = built
        if not runs:
            return FlowReturn.OK
        self._chunk_frag_open = True
        return self._push_moof(runs, cenc, payload,
                               styp=self.FRAGMENT_STYP and new_frag,
                               keyframe=new_frag)

    def _take_fragment(self, st: _Stream) -> list[tuple[Buffer, int]]:
        """Take up to the keyframe-aligned cut point."""
        cut = self._cut_index(st)
        if cut is None:
            cut = len(st.pending)
        take, st.pending = st.pending[:cut], st.pending[cut:]
        return take

    def drain(self) -> None:
        if not self._streams and not self._setup_streams():
            return
        if not self._header_sent:
            self.aggregate(timeout=False)
        # pull any remaining pad buffers
        for st in self._streams.values():
            while True:
                buf = st.pad.pop_buffer()
                if buf is None:
                    break
                if not st.cfg.first_frame:
                    st.cfg.first_frame = buf.to_bytes()
                st.pending.append((buf, buf.duration or 0))
        if self.chunk_duration:
            # close the open fragment with one final chunk (no styp
            # mid-fragment)
            while self._chunk_ready():
                self._drain_chunk()
            order = []
            for st in self._streams.values():
                if st.pending:
                    order.append((st, st.pending))
                    st.pending = []
            built = self._build_runs(order)
            runs, cenc, payload, _kf = built or ([], [], b"", False)
            if runs:
                new_frag = not self._chunk_frag_open
                self._push_moof(runs, cenc, payload,
                                styp=self.FRAGMENT_STYP and new_frag,
                                keyframe=new_frag)
        else:
            self._drain_fragment(final=True)
        if self.header_update_mode == "rewrite" and self._header_sent:
            # seek the sink back to byte 0 and overwrite the moov with
            # final durations (reference fmp4mux update_header at EOS,
            # fmp4mux/imp.rs:4050; delivered via a bytes segment like
            # GStreamer's header-update rewrite)
            hdr = self._build_header(final=True)
            if len(hdr) != self._header_size:
                self.post_error("fmp4mux: rewritten header size changed "
                                f"({len(hdr)} != {self._header_size})")
                return
            self.srcpad.push_event(
                SegmentEvent(Segment(fmt="bytes", start=0)))
            self.srcpad.push(Buffer(hdr, flags=BufferFlags.HEADER))


@register_element("isofmp4mux", Rank.PRIMARY)
class IsoFmp4Mux(FMP4MuxBase):
    MAJOR_BRAND = "iso6"
    COMPAT_BRANDS = ["iso6", "isom", "mp41", "mp42"]


@register_element("cmafmux", Rank.PRIMARY)
class CmafMux(FMP4MuxBase):
    MAJOR_BRAND = "cmf2"
    COMPAT_BRANDS = ["cmf2", "cmfc", "iso6", "isom"]
    SINGLE_STREAM = True


@register_element("dashmp4mux", Rank.PRIMARY)
class DashMp4Mux(FMP4MuxBase):
    MAJOR_BRAND = "msdh"
    COMPAT_BRANDS = ["msdh", "msix", "iso6"]


@register_element("onviffmp4mux", Rank.PRIMARY)
class OnvifFmp4Mux(FMP4MuxBase):
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/quicktime")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    _mux_sink_caps(meta=True)),
    ]
    MAJOR_BRAND = "iso6"
    COMPAT_BRANDS = ["iso6", "isom", "onvif"]


# ---------------------------------------------------------------------------
# non-fragmented isomp4mux
# ---------------------------------------------------------------------------

@register_element("isomp4mux", Rank.PRIMARY)
class IsoMp4Mux(Aggregator):
    """Non-fragmented MP4: accumulates all samples, emits
    ftyp + mdat + moov (with full sample tables) at EOS
    (reference MP4Mux, mux/isobmff/src/isobmff/mp4mux)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/quicktime")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    _mux_sink_caps()),
    ]

    movie_timescale = Property(int, default=1000, minimum=1,
                               mutable=Mutability.READY)
    with_precision_timestamps = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Write ISO/IEC 23001-17 TAI timestamps: taic in the "
              "sample entry + per-sample stai aux info (saiz/saio), "
              "sourced from TAI ReferenceTimestampMeta "
              "(reference mp4mux with-precision-timestamps)")
    SINGLE_STREAM = False

    def __init__(self, name=None):
        super().__init__(name)
        self._streams: dict[str, _Stream] = {}

    _make_cfg = FMP4MuxBase._make_cfg
    _setup_streams = FMP4MuxBase._setup_streams

    def negotiate_src_caps(self) -> Caps:
        return Caps.new("video/quicktime")

    def aggregate(self, timeout: bool) -> FlowReturn:
        if not self._streams:
            if not self._setup_streams():
                return FlowReturn.OK
        for st in self._streams.values():
            while True:
                buf = st.pad.pop_buffer()
                if buf is None:
                    break
                if not st.cfg.first_frame:
                    st.cfg.first_frame = buf.to_bytes()
                st.pending.append((buf, buf.duration or 0))
        return FlowReturn.OK

    def _tai_packet(self, buf: Buffer, last_tai: int) -> tuple[bytes, int]:
        """TAITimestampPacket for one sample; falls back to a
        generation-failure packet when the buffer carries no TAI meta
        (reference mp4mux/imp.rs:1297-1410)."""
        for m in buf.iter_meta(ReferenceTimestampMeta):
            if m.reference == TAI1958 and m.timestamp is not None:
                return (boxes.tai_timestamp_packet(m.timestamp,
                                                   synced=True),
                        m.timestamp)
        ts = last_tai + 1
        return (boxes.tai_timestamp_packet(ts, generation_failure=True),
                ts)

    def _elst_infos(self, st: _Stream, min_earliest: int) -> list[ElstInfo]:
        """Edit list: initial gap vs the earliest stream + b-frame
        start shift (reference mp4mux/imp.rs get_elst_infos)."""
        if not st.pending:
            return []
        first_buf = st.pending[0][0]
        earliest = first_buf.pts or 0
        end = earliest + sum(d for _, d in st.pending)
        start_dts = first_buf.dts if first_buf.dts is not None else earliest
        infos = [ElstInfo(earliest - start_dts, end - earliest)]
        if earliest > min_earliest:
            infos.insert(0, ElstInfo(None, earliest - min_earliest))
        return infos

    def drain(self) -> None:
        if not self._streams and not self._setup_streams():
            return
        self.aggregate(timeout=False)
        ftyp = boxes.ftyp("isom", 512, ["isom", "iso2", "mp41"])
        # mdat layout: one chunk per sample, sequential; per-track TAI
        # aux blobs appended after the sample data
        offsets: dict[int, list[int]] = {}
        samples: dict[int, list[Mp4Sample]] = {}
        durations: dict[int, int] = {}
        aux: dict[int, AuxData] = {}
        payload = b""
        base = len(ftyp) + 8
        min_earliest = min(((st.pending[0][0].pts or 0)
                            for st in self._streams.values()
                            if st.pending), default=0)
        for st in self._streams.values():
            if self.with_precision_timestamps:
                st.cfg.tai_clock_info = TaiClockInfo()
            st.cfg.elst_infos = self._elst_infos(st, min_earliest)
            offs, smps = [], []
            tai_packets = b""
            last_tai = 0
            for buf, dur in st.pending:
                offs.append(base + len(payload))
                payload += buf.to_bytes()
                comp = 0
                if buf.pts is not None and buf.dts is not None:
                    comp = st.caps_duration_to_ts(buf.pts - buf.dts)
                smps.append(Mp4Sample(buf.to_bytes(),
                                      st.caps_duration_to_ts(dur),
                                      buf.is_keyframe(),
                                      composition_offset=comp))
                if self.with_precision_timestamps:
                    pkt, last_tai = self._tai_packet(buf, last_tai)
                    tai_packets += pkt
            if self.with_precision_timestamps and smps:
                aux[st.cfg.track_id] = AuxData(
                    "stai", 0, [9] * len(smps),
                    [base + len(payload)])
                payload += tai_packets
            offsets[st.cfg.track_id] = offs
            samples[st.cfg.track_id] = smps
            durations[st.cfg.track_id] = sum(s.duration for s in smps)
        out = (ftyp + boxes.mdat(payload)
               + boxes.moov([st.cfg for st in self._streams.values()],
                            self.movie_timescale, fragmented=False,
                            durations=durations, samples=samples,
                            chunk_offsets=offsets, aux=aux))
        self.srcpad.push(Buffer(out, flags=BufferFlags.HEADER))


@register_element("onvifmp4mux", Rank.PRIMARY)
class OnvifMp4Mux(IsoMp4Mux):
    """Non-fragmented variant accepting an ONVIF XML metadata track
    (metx sample entry, meta handler, nmhd — reference onvifmp4mux)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/quicktime")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    _mux_sink_caps(meta=True)),
    ]
