"""The port's muxers and demuxer against gstpu's, on the CPU: the ISO BMFF
family (`isomp4mux`, `isofmp4mux`, `cmafmux`, `onvifmp4mux`), the FLV
parser, writer and `rsflvdemux`, and `mpegtsmux`/`hlssink3`.

Twins of tests/test_mp4mux.py, tests/test_flv.py and
tests/test_mpegtsmux.py (the `dashsink2` case of the last is in
tests/test_torch_hls.py): each scenario runs once in each package on the same inputs, and
every output buffer's bytes, flags and metas must be equal, with the
reference test's own checks applied to the port's output. The modules
are host code in both packages, so nothing here has a tolerance.
`MuxDriver` is a copy of the reference test's driver that takes the
package it drives.
"""

import importlib
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from torch_session import torch_test_limit  # noqa: F401

SECOND = 1_000_000_000
MSECOND = 1_000_000
OPUS_CAPS = "audio/x-opus, rate=48000, channels=2"
H264_CAPS = ("video/x-h264, width=320, height=240, "
             "codec_data=0142c01e03010203")


def _package(root: str) -> SimpleNamespace:
    """The names the scenarios use, from one package."""
    ns = SimpleNamespace(root=importlib.import_module(root))
    for mod, names in {
            "core.buffer": ("Buffer", "BufferFlags", "ReferenceTimestampMeta"),
            "core.caps": ("Caps", "Structure", "parse_caps"),
            "core.element": ("Pad", "PadDirection", "PadPresence",
                             "PadTemplate", "State", "FlowReturn"),
            "core.event": ("CapsEvent", "EosEvent", "Segment",
                           "SegmentEvent", "StreamStartEvent"),
            "core.registry": ("make",),
            "core.parse": ("parse_launch",),
            "core.harness": ("Harness",),
            "runtime.scheduler": ("TaskResult",),
            "mux.boxes": ("parse_boxes",),
            "mux.flv": ("FlvParser", "FlvWriter"),
            "codecs.mpegts": ("crc32_mpeg2", "parse_pat", "parse_pmt",
                              "parse_ts_packet", "section_from_payload"),
            "elements.mux.fmp4": ("CencAuxMeta",)}.items():
        m = importlib.import_module(f"{root}.{mod}")
        for n in names:
            setattr(ns, n, getattr(m, n))
    return ns


PKGS = {"gstpu": _package("gstpu"), "gstpu_torch": _package("gstpu_torch")}


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


class MuxDriver:
    """Feeds N synthetic streams into a mux element of package `g` and
    captures its output (tests/test_mp4mux.py's driver)."""

    def __init__(self, g, mux, caps_list, sink=True):
        self.g, self.mux, self.out = g, mux, []
        if sink:
            pad = g.Pad("cap", g.PadDirection.SINK,
                        g.PadTemplate("sink", g.PadDirection.SINK,
                                      g.PadPresence.ALWAYS, g.Caps.any()))
            pad.chain_function = lambda p, b: (self.out.append(b)
                                               or g.FlowReturn.OK)
            pad.event_function = lambda p, ev: True
            mux.static_pad("src").link(pad)
        mux.set_state(g.State.PLAYING)
        self.feeders = []
        for i, caps in enumerate(caps_list):
            pad = mux.request_pad()
            feeder = g.Pad(f"feed{i}", g.PadDirection.SRC,
                           g.PadTemplate("src", g.PadDirection.SRC,
                                         g.PadPresence.ALWAYS, g.Caps.any()))
            feeder.link(pad)
            feeder.push_event(g.StreamStartEvent(f"s{i}"))
            feeder.push_event(g.CapsEvent(
                caps if isinstance(caps, g.Caps) else g.parse_caps(caps)))
            feeder.push_event(g.SegmentEvent(g.Segment()))
            self.feeders.append(feeder)

    def push(self, i, data, pts, dur, keyframe=True):
        b = self.g.Buffer(data, pts=pts, duration=dur)
        if not keyframe:
            b.set_flag(self.g.BufferFlags.DELTA_UNIT)
        return self.feeders[i].push(b)

    def eos(self):
        for f in self.feeders:
            f.push_event(self.g.EosEvent())

    def bytes(self):
        return b"".join(b.to_bytes() for b in self.out)


def _meta_key(m) -> tuple:
    return (type(m).__name__, sorted(
        (k, v) for k, v in vars(m).items() if not k.startswith("_")))


def _outputs(d: MuxDriver) -> list:
    """What the mux pushed: each buffer's bytes, timing, flags and metas."""
    return [(b.to_bytes(), b.pts, b.duration, int(b.flags),
             [_meta_key(m) for m in b.metas]) for b in d.out]


def _twin(scenario, check=None):
    """Run `scenario(g)` in both packages; its outputs must be equal.
    `check(g, d)` then runs the reference test's assertions on the
    port's output."""
    got = {name: scenario(g) for name, g in PKGS.items()}
    port, ref = got["gstpu_torch"], got["gstpu"]
    assert _outputs(port) == _outputs(ref)
    assert port.out
    if check is not None:
        check(PKGS["gstpu_torch"], port)
    return port


def _descend(g, node, path):
    for four in path:
        node = next(c for c in g.parse_boxes(node.data) if c.fourcc == four)
    return node


def _moov(g, d):
    return next(b for b in g.parse_boxes(d.bytes()) if b.fourcc == "moov")


def _stsd(g, d):
    return _descend(g, _moov(g, d), ["trak", "mdia", "minf", "stbl",
                                     "stsd"])


# -- ISO BMFF (tests/test_mp4mux.py) ----------------------------------------

def _cmaf_audio(g):
    d = MuxDriver(g, g.make("cmafmux", fragment_duration=100_000_000),
                  [OPUS_CAPS])
    for i in range(15):
        d.push(0, bytes([i]) * 10, pts=i * 20_000_000, dur=20_000_000)
    d.eos()
    return d


def _check_cmaf_audio(g, d):
    tree = g.parse_boxes(d.bytes())
    names = [b.fourcc for b in tree]
    assert names[:2] == ["ftyp", "moov"] and names.count("moof") >= 2
    stbl = tree[1].find_all("trak")[0].find("mdia.minf.stbl")
    assert b"Opus" in stbl.data and b"dOps" in stbl.data
    assert tree[1].find("mvex") is not None


def _fmp4_two_streams(g):
    d = MuxDriver(g, g.make("isofmp4mux", fragment_duration=100_000_000),
                  [OPUS_CAPS, H264_CAPS])
    for i in range(10):
        d.push(0, b"a" * 20, pts=i * 20_000_000, dur=20_000_000)
    for i in range(6):
        d.push(1, b"v" * 100, pts=i * 33_000_000, dur=33_000_000,
               keyframe=(i % 3 == 0))
    d.eos()
    return d


def _check_fmp4_two_streams(g, d):
    tree = g.parse_boxes(d.bytes())
    assert len(next(b for b in tree if b.fourcc == "moov")
               .find_all("trak")) == 2
    moofs = [b for b in tree if b.fourcc == "moof"]
    assert moofs
    for i, mf in enumerate(moofs):
        assert struct.unpack_from(">I", mf.children[0].data, 4)[0] == i + 1
        for traf in mf.find_all("traf"):
            assert all(traf.find(n) is not None
                       for n in ("tfhd", "tfdt", "trun"))


def _trun_sizes(g):
    d = MuxDriver(g, g.make("cmafmux", fragment_duration=50_000_000),
                  [OPUS_CAPS])
    for i, n in enumerate([11, 22, 33, 44, 55]):
        d.push(0, bytes(n), pts=i * 20_000_000, dur=20_000_000)
    d.eos()
    return d


def _check_trun_sizes(g, d):
    total_trun = total_mdat = 0
    for b in g.parse_boxes(d.bytes()):
        if b.fourcc == "moof":
            trun = b.find("traf.trun")
            count, = struct.unpack_from(">I", trun.data, 4)
            total_trun += sum(struct.unpack_from(
                ">I", trun.data, 12 + 16 * k + 4)[0] for k in range(count))
        elif b.fourcc == "mdat":
            total_mdat += len(b.data)
    assert total_trun == total_mdat == 165


def _tfdt(g):
    d = MuxDriver(g, g.make("cmafmux", fragment_duration=40_000_000),
                  [OPUS_CAPS])
    for i in range(9):
        d.push(0, b"x", pts=i * 20_000_000, dur=20_000_000)
    d.eos()
    return d


def _check_tfdt(g, d):
    tfdts = [struct.unpack_from(">Q", b.find("traf.tfdt").data, 4)[0]
             for b in g.parse_boxes(d.bytes()) if b.fourcc == "moof"]
    assert tfdts[0] == 0 and tfdts == sorted(tfdts) and tfdts[1] % 960 == 0


PAYLOADS = [bytes([i]) * (i + 1) for i in range(5)]


def _full_file(g):
    d = MuxDriver(g, g.make("isomp4mux"), [OPUS_CAPS])
    for i, p in enumerate(PAYLOADS):
        d.push(0, p, pts=i * 20_000_000, dur=20_000_000)
    d.eos()
    return d


def _check_full_file(g, d):
    data = d.bytes()
    tree = g.parse_boxes(data)
    assert [b.fourcc for b in tree] == ["ftyp", "mdat", "moov"]
    assert tree[1].data == b"".join(PAYLOADS)
    stbl = tree[2].find("trak.mdia.minf.stbl")
    stco = next(c for c in g.parse_boxes(stbl.data) if c.fourcc == "stco")
    n, = struct.unpack_from(">I", stco.data, 4)
    assert n == 5
    for k in range(n):
        off, = struct.unpack_from(">I", stco.data, 8 + 4 * k)
        assert data[off:off + len(PAYLOADS[k])] == PAYLOADS[k]


def _two_streams_into_cmaf(g):
    d = MuxDriver(g, g.make("cmafmux"), [OPUS_CAPS, OPUS_CAPS])
    d.push(0, b"x", pts=0, dur=20_000_000)
    d.push(1, b"y", pts=0, dur=20_000_000)
    d.eos()
    return d


def _keyframe_cut(g):
    d = MuxDriver(g, g.make("isofmp4mux", fragment_duration=50_000_000),
                  [H264_CAPS])
    for i in range(16):
        d.push(0, bytes([i]), pts=i * 25_000_000, dur=25_000_000,
               keyframe=(i % 4 == 0))
    d.eos()
    return d


def _check_keyframe_cut(g, d):
    for b in g.parse_boxes(d.bytes()):
        if b.fourcc == "moof":
            trun = b.find("traf.trun")
            assert struct.unpack_from(">I", trun.data, 20)[0] == 0x02000000


XML = b'<tt:MetadataStream xmlns:tt="x"/>'


def _onvif(g):
    d = MuxDriver(g, g.make("onvifmp4mux"),
                  ["video/x-h264, width=16, height=16, "
                   "codec_data=(string)0142c01e",
                   "application/x-onvif-metadata, encoding=utf8"])
    d.push(0, b"frame", 0, SECOND // 30)
    d.push(1, XML, 0, SECOND)
    d.eos()
    return d


def _check_onvif(g, d):
    traks = [b for b in g.parse_boxes(_moov(g, d).data)
             if b.fourcc == "trak"]
    assert len(traks) == 2
    mdia = _descend(g, traks[1], ["mdia"])
    assert b"meta" in _descend(g, mdia, ["hdlr"]).data[4:12]
    minf = _descend(g, mdia, ["minf"])
    assert any(c.fourcc == "nmhd" for c in g.parse_boxes(minf.data))
    metx = _descend(g, minf, ["stbl", "stsd"])
    assert b"metx" in metx.data and b"onvif.org" in metx.data
    assert XML in next(b for b in g.parse_boxes(d.bytes())
                       if b.fourcc == "mdat").data


def _ac3_frame():
    return bytes([0x0B, 0x77, 0x00, 0x00, 0x14, 0x40, 0x40]) + bytes(32)


def _ac3(g):
    d = MuxDriver(g, g.make("isomp4mux"),
                  ["audio/x-ac3, rate=48000, channels=2"])
    d.push(0, _ac3_frame(), pts=0, dur=32_000_000)
    d.push(0, _ac3_frame(), pts=32_000_000, dur=32_000_000)
    d.eos()
    return d


def _check_ac3(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"dac3")
    bits = int.from_bytes(stsd.data[i + 4:i + 7], "big")
    assert b"ac-3" in stsd.data
    assert ((bits >> 22) & 3, (bits >> 17) & 31, (bits >> 11) & 7,
            (bits >> 5) & 31) == (0, 8, 2, 10)


def _eac3(g):
    bits = (191 << 40) | (3 << 36) | (2 << 33) | (16 << 27)
    frame = bytes([0x0B, 0x77]) + bits.to_bytes(7, "big") + bytes(32)
    d = MuxDriver(g, g.make("isomp4mux"),
                  ["audio/x-eac3, rate=48000, channels=2"])
    d.push(0, frame, pts=0, dur=32_000_000)
    d.eos()
    return d


def _check_eac3(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"dec3")
    assert b"ec-3" in stsd.data
    assert struct.unpack_from(">H", stsd.data, i + 4)[0] >> 3 == 96


def _raw(caps, data, dur):
    def scenario(g):
        d = MuxDriver(g, g.make("isomp4mux"), [caps])
        d.push(0, data, pts=0, dur=dur)
        d.eos()
        return d
    return scenario


def _check_ipcm(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"pcmC")
    assert b"ipcm" in stsd.data and b"chnl" in stsd.data
    assert (stsd.data[i + 8], stsd.data[i + 9]) == (1, 16)


def _check_fpcm(g, d):
    stsd = _stsd(g, d)
    assert b"fpcm" in stsd.data
    assert stsd.data[stsd.data.index(b"pcmC") + 9] == 32


def _check_fpcm64(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"pcmC")
    assert b"fpcm" in stsd.data
    assert (stsd.data[i + 8], stsd.data[i + 9]) == (1, 64)


def _check_rgba(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"uncC")
    assert b"uncv" in stsd.data and b"cmpd" not in stsd.data
    assert stsd.data[i + 4] == 1 and stsd.data[i + 8:i + 12] == b"rgba"


def _check_i420(g, d):
    stsd = _stsd(g, d)
    i = stsd.data.index(b"cmpd")
    assert struct.unpack_from(">I", stsd.data, i + 4)[0] == 3
    assert struct.unpack_from(">3H", stsd.data, i + 8) == (1, 2, 3)
    j = stsd.data.index(b"uncC")
    body = stsd.data[j + 8:]
    assert stsd.data[j + 4] == 0 and body[:4] == b"i420"
    assert (body[8 + 15], body[8 + 16]) == (2, 0)


TAIS = [1_000_000_000_000, 1_000_000_020_000, 1_000_000_040_000]


def _tai(g):
    d = MuxDriver(g, g.make("isomp4mux", with_precision_timestamps=True),
                  [OPUS_CAPS])
    for i, tai in enumerate(TAIS):
        b = g.Buffer(bytes([i]) * 8, pts=i * 20_000_000,
                     duration=20_000_000)
        b.add_meta(g.ReferenceTimestampMeta("timestamp/x-tai1958", tai))
        d.feeders[0].push(b)
    d.eos()
    return d


def _check_tai(g, d):
    data = d.bytes()
    stbl = _descend(g, _moov(g, d), ["trak", "mdia", "minf", "stbl"])
    assert b"taic" in stbl.data
    children = g.parse_boxes(stbl.data)
    saiz = next(c for c in children if c.fourcc == "saiz")
    assert saiz.data[4:8] == b"stai"
    assert struct.unpack_from(">BI", saiz.data, 12) == (9, 3)
    saio = next(c for c in children if c.fourcc == "saio")
    n_off, off = struct.unpack_from(">II", saio.data, 12)
    assert n_off == 1
    for k, tai in enumerate(TAIS):
        ts, flags = struct.unpack_from(">QB", data, off + 9 * k)
        assert ts == tai and flags & 0x80


def _tai_fallback(g):
    d = MuxDriver(g, g.make("isomp4mux", with_precision_timestamps=True),
                  [OPUS_CAPS])
    d.push(0, b"x" * 8, pts=0, dur=20_000_000)
    d.eos()
    return d


def _check_tai_fallback(g, d):
    stbl = _descend(g, _moov(g, d), ["trak", "mdia", "minf", "stbl"])
    saio = next(c for c in g.parse_boxes(stbl.data) if c.fourcc == "saio")
    _, off = struct.unpack_from(">II", saio.data, 12)
    ts, flags = struct.unpack_from(">QB", d.bytes(), off)
    assert flags & 0x40 and ts == 1


def _edit_list(g):
    d = MuxDriver(g, g.make("isomp4mux"), [OPUS_CAPS, OPUS_CAPS])
    for i in range(5):
        d.push(0, b"a", pts=i * 20_000_000, dur=20_000_000)
    for i in range(5):
        d.push(1, b"b", pts=100_000_000 + i * 20_000_000, dur=20_000_000)
    d.eos()
    return d


def _check_edit_list(g, d):
    elst = _descend(g, _moov(g, d).find_all("trak")[1], ["edts", "elst"])
    assert struct.unpack_from(">I", elst.data, 4)[0] == 2
    assert struct.unpack_from(">Qq", elst.data, 8) == (100, -1)
    assert struct.unpack_from(">Qq", elst.data, 28) == (100, 0)


FRAMES_MS = [(0, 0), (33, 99), (66, 66), (99, 132)]


def _ctts(g):
    d = MuxDriver(g, g.make("isomp4mux"), [H264_CAPS])
    for k, (dts, pts) in enumerate(FRAMES_MS):
        b = g.Buffer(bytes([k]) * 10, pts=pts * MSECOND, dts=dts * MSECOND,
                     duration=33_000_000)
        if k:
            b.set_flag(g.BufferFlags.DELTA_UNIT)
        d.feeders[0].push(b)
    d.eos()
    return d


def _check_ctts(g, d):
    stbl = _descend(g, _moov(g, d), ["trak", "mdia", "minf", "stbl"])
    children = g.parse_boxes(stbl.data)
    ctts = next(c for c in children if c.fourcc == "ctts")
    assert ctts.data[0] == 1
    n, = struct.unpack_from(">I", ctts.data, 4)
    offs = []
    for k in range(n):
        cnt, off = struct.unpack_from(">Ii", ctts.data, 8 + 8 * k)
        offs.extend([off] * cnt)
    assert offs == [(p - t) * MSECOND * 90000 // SECOND
                    for t, p in FRAMES_MS]
    assert any(c.fourcc == "cslg" for c in children)


def _interleave(g):
    d = MuxDriver(g, g.make("isofmp4mux", fragment_duration=SECOND // 2,
                            interleave_bytes=200),
                  ["video/x-h264, width=64, height=64, codec_data=0142c01e",
                   OPUS_CAPS])
    for i in range(8):
        d.push(0, bytes(250), pts=i * SECOND // 4, dur=SECOND // 4)
        d.push(1, bytes(120), pts=i * SECOND // 4, dur=SECOND // 4)
    d.eos()
    return d


def _check_interleave(g, d):
    saw_multi = False
    for b in d.out[1:]:
        moof = [x for x in g.parse_boxes(b.to_bytes()) if x.fourcc == "moof"]
        if moof and len(moof[0].find_all("traf")) > 2:
            saw_multi = True
    assert saw_multi


KID = bytes(range(16))
IVS = [bytes([i] * 8) for i in range(1, 4)]


def _cenc(g):
    d = MuxDriver(g, g.make("isofmp4mux", fragment_duration=10 * SECOND),
                  [g.Caps([g.Structure(
                      "application/x-cenc",
                      **{"original-media-type": "video/x-h264",
                         "kid": KID.hex(), "iv-size": 8, "width": 64,
                         "height": 64,
                         "codec_data": bytes.fromhex("0142")})])])
    for i, iv in enumerate(IVS):
        b = g.Buffer(bytes(100 + i), pts=i * SECOND, duration=SECOND)
        b.add_meta(g.CencAuxMeta(iv, [(10, 90 + i)]))
        d.feeders[0].push(b)
    d.eos()
    return d


def _check_cenc(g, d):
    moov = [b for b in g.parse_boxes(d.out[0].to_bytes())
            if b.fourcc == "moov"][0]
    stsd = _descend(g, moov, ["trak", "mdia", "minf", "stbl", "stsd"])
    assert all(x in stsd.data for x in (b"encv", b"frma", b"avc1", b"schm",
                                        b"cenc"))
    tenc = stsd.data[stsd.data.index(b"tenc") + 4:]
    assert (tenc[6], tenc[7], tenc[8:24]) == (1, 8, KID)
    frag = b"".join(b.to_bytes() for b in d.out[1:])
    traf = [b for b in g.parse_boxes(frag) if b.fourcc == "moof"][0] \
        .find("traf")
    senc = traf.find("senc")
    assert struct.unpack(">I", senc.data[4:8])[0] == len(IVS)
    assert senc.data[8:16] == IVS[0]


def _cmaf_chunks(g):
    d = MuxDriver(g, g.make("cmafmux", fragment_duration=SECOND,
                            chunk_duration=SECOND // 4),
                  ["video/x-h264, width=64, height=64, codec_data=0142c01e"])
    for i in range(8):
        d.push(0, bytes(200), pts=i * SECOND // 4, dur=SECOND // 4,
               keyframe=(i % 4 == 0))
    d.eos()
    return d


def _cmaf_async(g):
    d = MuxDriver(g, g.make("isofmp4mux", fragment_duration=SECOND,
                            chunk_duration=SECOND // 5),
                  ["video/x-h264, width=64, height=64, codec_data=0142c01e",
                   OPUS_CAPS])
    for i in range(20):
        d.push(0, bytes(180), pts=i * SECOND // 10, dur=SECOND // 10,
               keyframe=(i % 10 == 0))
        if i < 13:
            d.push(1, bytes(90), pts=i * 160_000_000, dur=160_000_000)
    d.eos()
    return d


def _check_chunks(g, d):
    frags = d.out[1:]
    assert len(frags) >= 6
    styps = [any(x.fourcc == "styp" for x in g.parse_boxes(b.to_bytes()))
             for b in frags]
    assert sum(styps) == 2
    for b, s in zip(frags, styps):
        assert b.has_flag(g.BufferFlags.DELTA_UNIT) != s


MP4_CASES = {
    "cmafmux_audio_fragments": (_cmaf_audio, _check_cmaf_audio),
    "fmp4mux_two_streams_moof_structure": (_fmp4_two_streams,
                                           _check_fmp4_two_streams),
    "fmp4_trun_sizes_match_mdat": (_trun_sizes, _check_trun_sizes),
    "fmp4_tfdt_advances": (_tfdt, _check_tfdt),
    "isomp4mux_full_file": (_full_file, _check_full_file),
    "fragment_cut_on_keyframe": (_keyframe_cut, _check_keyframe_cut),
    "onvifmp4mux_metadata_track": (_onvif, _check_onvif),
    "ac3_dac3_sample_entry": (_ac3, _check_ac3),
    "eac3_dec3_sample_entry": (_eac3, _check_eac3),
    "raw_audio_ipcm_pcmc_chnl": (_raw(
        "audio/x-raw, format=S16LE, rate=48000, channels=2", bytes(192),
        1_000_000), _check_ipcm),
    "raw_audio_fpcm": (_raw(
        "audio/x-raw, format=F32LE, rate=48000, channels=1", bytes(192),
        1_000_000), _check_fpcm),
    # the file chain's output: 192 kHz F64LE stereo
    "raw_audio_fpcm_f64": (_raw(
        "audio/x-raw, format=F64LE, rate=192000, channels=2",
        np.random.default_rng(3).uniform(-1, 1, (960, 2)).tobytes(),
        5_000_000), _check_fpcm64),
    "uncompressed_video_rgba_v1": (_raw(
        "video/x-raw, format=RGBA, width=4, height=4", bytes(64),
        33_000_000), _check_rgba),
    "uncompressed_video_i420_v0": (_raw(
        "video/x-raw, format=I420, width=4, height=4", bytes(24),
        33_000_000), _check_i420),
    "precision_timestamps_taic_stai": (_tai, _check_tai),
    "precision_timestamps_fallback_packet": (_tai_fallback,
                                             _check_tai_fallback),
    "edit_list_gap_and_shift": (_edit_list, _check_edit_list),
    "ctts_cslg_composition_offsets": (_ctts, _check_ctts),
    "interleave_bytes_chunks_runs": (_interleave, _check_interleave),
    "cenc_protected_stream_skeleton": (_cenc, _check_cenc),
    "cmaf_chunk_mode_low_latency": (_cmaf_chunks, _check_chunks),
    "cmaf_chunk_mode_async_stream_boundaries": (_cmaf_async, _check_chunks),
}


@pytest.mark.parametrize("case", MP4_CASES)
def test_mp4mux_matches_gstpu(case):
    scenario, check = MP4_CASES[case]
    _twin(scenario, check)


def test_cmafmux_rejects_two_streams():
    """One stream only: no fragment in either package."""
    got = {name: _two_streams_into_cmaf(g) for name, g in PKGS.items()}
    assert _outputs(got["gstpu_torch"]) == _outputs(got["gstpu"])
    g = PKGS["gstpu_torch"]
    assert not any(b.fourcc == "moof"
                   for b in g.parse_boxes(got["gstpu_torch"].bytes()))


def test_fmp4_header_rewrite_with_mehd(tmp_path):
    files = {}
    for name, g in PKGS.items():
        path = tmp_path / f"{name}.mp4"
        mux = g.make("isofmp4mux", fragment_duration=40_000_000,
                     header_update_mode="rewrite", write_mehd=True)
        sink = g.make("filesink", location=str(path))
        mux.static_pad("src").link(sink.static_pad("sink"))
        sink.set_state(g.State.PLAYING)
        d = MuxDriver(g, mux, [OPUS_CAPS], sink=False)
        for i in range(10):
            d.push(0, b"x" * 10, pts=i * 20_000_000, dur=20_000_000)
        d.eos()
        sink.set_state(g.State.NULL)
        files[name] = path.read_bytes()
    assert files["gstpu_torch"] == files["gstpu"]
    g = PKGS["gstpu_torch"]
    tree = g.parse_boxes(files["gstpu_torch"])
    moov = next(b for b in tree if b.fourcc == "moov")
    mvhd = next(c for c in g.parse_boxes(moov.data) if c.fourcc == "mvhd")
    assert struct.unpack_from(">I", mvhd.data, 16)[0] == 200
    mehd = next(c for c in g.parse_boxes(moov.find("mvex").data)
                if c.fourcc == "mehd")
    assert struct.unpack_from(">Q", mehd.data, 4)[0] == 200
    assert any(b.fourcc == "moof" for b in tree)


def test_isomp4mux_takes_tensor_payloads():
    """A tensor payload is muxed as its bytes (Buffer.to_bytes): the
    same file as from the same samples in a numpy array."""
    g = PKGS["gstpu_torch"]
    x = np.random.default_rng(4).uniform(-1, 1, (3, 480, 2))
    caps = "audio/x-raw, format=F64LE, rate=48000, channels=2"
    files = []
    for wrap in (torch.from_numpy, lambda a: a):
        d = MuxDriver(g, g.make("isomp4mux"), [caps])
        for i, block in enumerate(x):
            d.push(0, wrap(block), pts=i * 10_000_000, dur=10_000_000)
        d.eos()
        files.append(d.bytes())
    assert files[0] == files[1]
    mdat = next(b for b in g.parse_boxes(files[0]) if b.fourcc == "mdat")
    assert mdat.data == x.tobytes()


# -- FLV (tests/test_flv.py) ------------------------------------------------

def _flv_tags(g, data: bytes, step: int) -> list:
    p = g.FlvParser()
    tags = []
    for i in range(0, len(data), step):
        p.push(data[i:i + step])
        while (t := p.poll()) is not None:
            tags.append(vars(t))
    return tags


def test_flv_parser_roundtrip():
    data = {}
    for name, g in PKGS.items():
        w = g.FlvWriter()
        w.audio_tag(10, b"abc", sound_format=2, rate_idx=3, stereo=True)
        w.video_tag(20, b"vvv", codec=7, keyframe=True)
        data[name] = w.to_bytes()
    assert data["gstpu_torch"] == data["gstpu"]
    tags = _flv_tags(PKGS["gstpu_torch"], data["gstpu"], len(data["gstpu"]))
    assert tags == _flv_tags(PKGS["gstpu"], data["gstpu"],
                             len(data["gstpu"]))
    g = PKGS["gstpu_torch"]
    p = g.FlvParser()
    p.push(data["gstpu"])
    t1, t2 = p.poll(), p.poll()
    assert (t1.tag_type, t1.timestamp_ms, t1.sound_format, t1.sound_rate,
            t1.sound_channels, t1.audio_payload) == (8, 10, 2, 44100, 2,
                                                     b"abc")
    assert (t2.tag_type, t2.is_keyframe, t2.video_codec,
            t2.video_payload) == (9, True, 7, b"vvv")
    assert p.poll() is None


def test_flv_parser_incremental_feed():
    w = PKGS["gstpu"].FlvWriter()
    w.audio_tag(1, b"x" * 50)
    data = w.to_bytes()
    tags = _flv_tags(PKGS["gstpu_torch"], data, 7)
    assert tags == _flv_tags(PKGS["gstpu"], data, 7)
    assert len(tags) == 1 and tags[0]["data"][1:] == b"x" * 50


def _flv_file(path):
    w = PKGS["gstpu_torch"].FlvWriter()
    w.video_tag(0, b"\x01seqhdr", codec=7, keyframe=True,
                avc_packet_type=0)
    for i in range(4):
        w.video_tag(i * 40, bytes([i]) * 20, codec=7, keyframe=(i == 0))
    for i in range(6):
        w.audio_tag(i * 23, bytes([i]) * 10, sound_format=2)
    path.write_bytes(w.to_bytes())


def _demux(g, launch: str, both: bool):
    """Run `launch` (ending in `rsflvdemux name=d`) with appsinks on the
    demuxer's pads: per pad, its caps and buffers."""
    p = g.parse_launch(launch)
    d = p.get_by_name("d")
    sinks = {"audio": g.make("appsink"), "video": g.make("appsink")}
    p.add(*sinks.values())
    d.connect("pad-added", lambda el, pad: pad.link(
        sinks["audio" if pad.name == "audio" else "video"]
        .static_pad("sink")))
    p.set_state(g.State.PLAYING)
    p.run()
    out = {k: (repr(s.caps), [(b.to_bytes(), b.pts, b.duration,
                               b.is_keyframe()) for b in s.pull_all()],
               s.is_eos) for k, s in sinks.items() if both or s.caps}
    return p, d, out


def test_flvdemux_pipeline(tmp_path):
    f = tmp_path / "t.flv"
    _flv_file(f)
    got = {}
    for name, g in PKGS.items():
        p, _, got[name] = _demux(
            g, f"filesrc location={f} blocksize=64 ! rsflvdemux name=d",
            both=True)
        p.set_state(g.State.NULL)
    assert got["gstpu_torch"] == got["gstpu"]
    (acaps, abufs, aeos), (vcaps, vbufs, veos) = \
        got["gstpu_torch"]["audio"], got["gstpu_torch"]["video"]
    assert (len(abufs), len(vbufs), aeos, veos) == (6, 4, True, True)
    assert "audio/mpeg" in acaps and "video/x-h264" in vcaps
    assert vbufs[0][3] and not vbufs[1][3]
    assert abufs[1][1] == 23 * MSECOND and vbufs[2][1] == 80 * MSECOND


def test_flvdemux_garbage_errors():
    rets = {}
    for name, g in PKGS.items():
        h = g.Harness("rsflvdemux", src_pad="audio")
        h.set_caps("video/x-flv")
        rets[name] = h.push(g.Buffer(b"NOTFLV" + b"\x00" * 20)).name
        h.teardown()
    assert rets["gstpu_torch"] == rets["gstpu"] == "ERROR"


def test_flvdemux_pull_mode_and_seek(tmp_path):
    w = PKGS["gstpu_torch"].FlvWriter()
    w.video_tag(0, b"\x01seqhdr", codec=7, keyframe=True,
                avc_packet_type=0)
    for i in range(12):
        w.video_tag(i * 40, bytes([i]) * 30, codec=7, keyframe=(i % 4 == 0))
    f = tmp_path / "seek.flv"
    f.write_bytes(w.to_bytes())
    got = {}
    for name, g in PKGS.items():
        p, d, out = _demux(g, f"filesrc location={f} ! rsflvdemux name=d",
                           both=False)
        assert d._pull_active
        index = list(d._keyframe_index)
        vsink = next(e for e in p.children if e.ELEMENT_NAME == "appsink"
                     and e.caps is not None)
        assert d.seek(200_000_000)
        for _ in range(200):
            if d._pull_iterate() is g.TaskResult.EOS:
                break
        after = [(b.to_bytes(), b.pts) for b in vsink.pull_all()]
        got[name] = (out, index, after, vsink.is_eos)
        p.set_state(g.State.NULL)
    assert got["gstpu_torch"] == got["gstpu"]
    out, index, after, eos = got["gstpu_torch"]
    assert [b[0][0] for b in out["video"][1]] == list(range(12))
    assert [ts for ts, _ in index] == [0, 160_000_000, 320_000_000]
    assert [b[0][0] for b in after] == list(range(4, 12)) and eos


# -- MPEG-TS and HLS (tests/test_mpegtsmux.py) ------------------------------

def _ts(g):
    d = MuxDriver(g, g.make("mpegtsmux"),
                  ["video/x-h264, stream-format=byte-stream",
                   "audio/mpeg, mpegversion=4"])
    d.push(0, b"\x00\x00\x00\x01\x65" + bytes(300), 0, SECOND // 30)
    d.push(1, b"\xff\xf1" + bytes(40), 0, SECOND // 48)
    d.push(0, b"\x00\x00\x00\x01\x41" + bytes(100), SECOND // 30,
           SECOND // 30, keyframe=False)
    d.eos()
    return d


def _check_ts(g, d):
    data = d.bytes()
    assert len(data) % 188 == 0
    pkts = [g.parse_ts_packet(data[i:i + 188])
            for i in range(0, len(data), 188)]
    assert pkts[0][0].pid == 0 and pkts[0][0].pusi
    pat_sec = g.section_from_payload(pkts[0][2])
    end = pat_sec[2] + 3
    assert g.crc32_mpeg2(pat_sec[:end - 4]) \
        == int.from_bytes(pat_sec[end - 4:end], "big")
    pmt_pid = next(iter(g.parse_pat(pat_sec).values()))
    assert pkts[1][0].pid == pmt_pid
    pmt = g.parse_pmt(g.section_from_payload(pkts[1][2]))
    assert pmt.pcr_pid == 0x100
    assert sorted(t for t, _ in pmt.streams) == [0x0F, 0x1B]
    vid = [p for p in pkts if p[0].pid == 0x100]
    assert vid[0][1] and vid[0][1]["pcr"] is not None
    ccs = [p[0].cc for p in vid if p[0].afc & 1]
    assert ccs == [(ccs[0] + i) & 0xF for i in range(len(ccs))]
    assert vid[0][2][:4] == b"\x00\x00\x01\xe0"


def test_mpegtsmux_stream_structure():
    _twin(_ts, _check_ts)


def _hls(tmp_path, monkeypatch, n, props, key) -> dict:
    """hlssink3 in each package, in a directory of its own: the playlist
    and every segment's bytes."""
    got = {}
    for name, g in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        h = g.Harness(g.make("hlssink3", target_duration=1,
                             playlist_location="p.m3u8", **props))
        h.set_caps("video/mpegts, systemstream=true, packetsize=188")
        for i in range(n):
            b = g.Buffer(bytes(188), pts=i * SECOND // 2,
                         duration=SECOND // 2)
            if not key(i):
                b.set_flag(g.BufferFlags.DELTA_UNIT)
            h.push(b)
        h.push_eos()
        pl = (d / "p.m3u8").read_text()
        segs = [ln for ln in pl.splitlines() if ln.endswith(".ts")]
        got[name] = (pl, [(d / s).read_bytes() for s in segs])
        h.teardown()
    assert got["gstpu_torch"] == got["gstpu"]
    return got["gstpu_torch"]


def test_hlssink3_segments(tmp_path, monkeypatch):
    pl, segs = _hls(tmp_path, monkeypatch, 8, {}, lambda i: i % 2 == 0)
    assert "#EXT-X-ENDLIST" in pl and "#EXTINF:1.000," in pl
    assert len(segs) >= 3 and all(len(s) % 188 == 0 for s in segs)


def test_hlssink3_i_frames_only(tmp_path, monkeypatch):
    pl, segs = _hls(tmp_path, monkeypatch, 6, {"i_frames_only": True},
                    lambda i: i % 2 == 0)
    assert "#EXT-X-I-FRAMES-ONLY" in pl
    assert [len(s) for s in segs] == [188] * 3


def test_mpegtsmux_into_filesink(tmp_path):
    """`appsrc ! mpegtsmux ! filesink` on seeded H.264 access units (the
    mux takes coded streams only), byte for byte in both packages."""
    rng = np.random.default_rng(5)
    aus = [(b"\x00\x00\x00\x01" + (b"\x65" if i % 4 == 0 else b"\x41")
            + rng.integers(0, 256, 200 + 37 * i, dtype=np.uint8).tobytes())
           for i in range(8)]
    files = {}
    for name, g in PKGS.items():
        path = tmp_path / f"{name}.ts"
        p = g.parse_launch(
            f'appsrc name=src caps="video/x-h264, stream-format=byte-stream, '
            f'width=64, height=64" ! mpegtsmux ! filesink location={path}')
        p.set_state(g.State.PLAYING)
        src = p.get_by_name("src")
        for i, au in enumerate(aus):
            b = g.Buffer(au, pts=i * SECOND // 30, duration=SECOND // 30)
            if i % 4:
                b.set_flag(g.BufferFlags.DELTA_UNIT)
            src.push_buffer(b)
        src.end_of_stream()
        p.run()
        p.set_state(g.State.NULL)
        files[name] = path.read_bytes()
    assert files["gstpu_torch"] == files["gstpu"]
    data = files["gstpu_torch"]
    g = PKGS["gstpu_torch"]
    assert data and len(data) % 188 == 0
    pids = {g.parse_ts_packet(data[i:i + 188])[0].pid
            for i in range(0, len(data), 188)}
    assert pids == {0x0000, 0x0020, 0x0100}
