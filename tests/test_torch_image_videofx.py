"""The port's image codecs, `videofx` elements, `viuersink` and CD+G
decoder against gstpu's, on the CPU.

Twins of tests/test_cdg.py, the image cases of
tests/test_video_convert_image.py, the videofx cases of
tests/test_generic_elements.py and the viuersink cases of
tests/test_viuer_compositor_llm.py: the same seeded inputs and launch
strings go through gstpu and through gstpu_torch, and the bytes, bus
messages and caps must be equal. These modules are host numpy and PIL in
both packages, and the port's `hsvfilter ! colorlut` plain versions give
gstpu's bytes, so any difference is a fault of the copy: nothing here
has a tolerance. The strings of `chip_smoke.py`'s phase 14 run here at a
small size.
"""

import importlib
import io

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.codecs import cdg as jcdg
from gstpu_torch.codecs import cdg
from torch_session import torch_test_limit  # noqa: F401

NAMES = ("gstpu", "gstpu_torch")
HSV = "hue_shift=12 saturation_mul=1.1 value_mul=0.9 value_off=0.02"


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _mod(name: str, path: str):
    return importlib.import_module(f"{name}.{path}")


def _pil():
    return pytest.importorskip("PIL.Image")


def _messages(name: str, bus) -> list:
    element = _mod(name, "core.element").MessageType.ELEMENT
    return [(m.name, m.fields) for m in bus.drain() if m.type is element]


def _run(name: str, launch: str, sinks=("sink",)):
    """A launch string in one package: per appsink, its caps string and
    every buffer's bytes, pts and duration; and the element messages."""
    pkg = importlib.import_module(name)
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    out = {}
    for s in sinks:
        el = p.get_by_name(s)
        out[s] = (repr(el.caps), [(b.to_bytes(), b.pts, b.duration)
                                  for b in el.pull_all()])
    out["messages"] = _messages(name, p.bus)
    p.set_state(pkg.State.NULL)
    return out


def _run_both(launch: str, sinks=("sink",)):
    ref, port = (_run(name, launch, sinks) for name in NAMES)
    assert port == ref
    return port


def _frames(name: str, caps: str, bufs):
    """Each buffer of `bufs` as gstpu's or the port's VideoInfo sees it."""
    vi = _mod(name, "core.video").VideoInfo.from_caps(
        _mod(name, "core.caps").parse_caps(caps))
    buffer = importlib.import_module(name).Buffer
    return vi, [vi.view(buffer(b[0])) if vi.is_packed else
                vi.planes(buffer(b[0])) for b in bufs]


def _write_cube(path, n: int = 5, seed: int = 1) -> None:
    rng = np.random.default_rng(seed)
    lines = [f"LUT_3D_SIZE {n}"]
    lines += [" ".join(f"{x:.6f}" for x in v) for v in rng.random((n ** 3, 3))]
    path.write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# CD+G (tests/test_cdg.py)
# ---------------------------------------------------------------------------

def pkt(insn: int, data: bytes) -> bytes:
    body = bytes([cdg.CMD_CDG, insn, 0, 0]) + data.ljust(16, b"\x00") \
        + bytes(4)
    assert len(body) == 24
    return body


def color_table(colors, insn=cdg.INSN_COLORS_LOW):
    data = bytearray()
    for r, g, b in colors:
        r4, g4, b4 = r // 17, g // 17, b // 17
        data.append(((r4 << 2) | (g4 >> 2)) & 0x3F)
        data.append((((g4 & 0x03) << 4) | b4) & 0x3F)
    return pkt(insn, bytes(data))


def tile(insn, c0, c1, row, col, rows):
    return pkt(insn, bytes([c0, c1, row, col]) + bytes(rows))


def seeded_cdg(rng, n: int) -> bytes:
    """`n` seeded CD+G packets: both colour tables, memory and border
    presets, normal and XOR tiles, scrolls (preset and copy), repeats
    and non-CD+G packets, as a subcode stream carries them."""
    out = [color_table([tuple(int(v) * 17 for v in rng.integers(0, 16, 3))
                        for _ in range(8)], insn)
           for insn in (cdg.INSN_COLORS_LOW, cdg.INSN_COLORS_HIGH)]
    out.append(pkt(cdg.INSN_MEMORY_PRESET, bytes([3, 0])))
    for _ in range(n - 3):
        k = rng.random()
        if k < 0.6:
            insn = cdg.INSN_TILE_XOR if rng.random() < 0.4 \
                else cdg.INSN_TILE_NORMAL
            out.append(tile(insn, *(int(v) for v in rng.integers(0, 16, 2)),
                            int(rng.integers(0, 18)), int(rng.integers(0, 50)),
                            [int(v) for v in rng.integers(0, 64, 12)]))
        elif k < 0.7:
            insn = cdg.INSN_SCROLL_COPY if rng.random() < 0.5 \
                else cdg.INSN_SCROLL_PRESET
            h = (int(rng.integers(0, 3)) << 4) | int(rng.integers(0, 6))
            v = (int(rng.integers(0, 3)) << 4) | int(rng.integers(0, 12))
            out.append(pkt(insn, bytes([int(rng.integers(0, 16)), h, v])))
        elif k < 0.75:
            out.append(color_table(
                [tuple(int(v) * 17 for v in rng.integers(0, 16, 3))
                 for _ in range(8)],
                cdg.INSN_COLORS_LOW if rng.random() < 0.5
                else cdg.INSN_COLORS_HIGH))
        elif k < 0.8:
            out.append(pkt(cdg.INSN_MEMORY_PRESET,
                           bytes([int(rng.integers(0, 16)),
                                  int(rng.integers(0, 2))])))
        elif k < 0.85:
            out.append(pkt(cdg.INSN_BORDER_PRESET,
                           bytes([int(rng.integers(0, 16))])))
        else:                                  # not a CD+G command
            out.append(bytes(24))
    return b"".join(out)


def _both_decoders(packets):
    """Push the packets into both decoders: each one's return, screen,
    palette and RGB frame after every packet must be equal."""
    ours, theirs = cdg.CdgDecoder(), jcdg.CdgDecoder()
    for p in packets:
        assert ours.push_packet(p) == theirs.push_packet(p)
        np.testing.assert_array_equal(ours.screen, theirs.screen)
        np.testing.assert_array_equal(ours.palette, theirs.palette)
        assert ours.border_color == theirs.border_color
        np.testing.assert_array_equal(ours.render_rgb(), theirs.render_rgb())
    return ours


def test_decoder_memory_preset_and_palette():
    d = _both_decoders([
        color_table([(255, 0, 0), (0, 255, 0)] + [(0, 0, 0)] * 6),
        pkt(cdg.INSN_MEMORY_PRESET, bytes([1, 0]))])
    assert tuple(d.render_rgb()[100, 100]) == (0, 255, 0)


def test_decoder_tile_and_xor():
    d = _both_decoders([
        color_table([(0, 0, 0), (255, 255, 255), (255, 0, 0)]
                    + [(0, 0, 0)] * 5),
        tile(cdg.INSN_TILE_NORMAL, 0, 1, 2, 3, [0x3F] * 12),
        tile(cdg.INSN_TILE_XOR, 0, 2, 2, 3, [0x3F] * 12)])
    assert (d.screen[24:36, 18:24] == 3).all()


def test_decoder_seeded_stream():
    data = seeded_cdg(np.random.default_rng(60), 400)
    _both_decoders([data[i:i + 24] for i in range(0, len(data), 24)])


def test_cdg_pipeline(tmp_path):
    stream = (color_table([(0, 0, 255)] + [(0, 0, 0)] * 7)
              + pkt(cdg.INSN_MEMORY_PRESET, bytes([0, 0]))
              + tile(cdg.INSN_TILE_NORMAL, 0, 0, 1, 1, [0x3F] * 12))
    f = tmp_path / "t.cdg"
    f.write_bytes(stream)
    out = _run_both(f"filesrc location={f} ! video/x-cdg ! cdgparse ! "
                    f"cdgdec ! appsink name=sink")
    vi, frames = _frames("gstpu_torch", *out["sink"])
    assert len(frames) == 3 and (vi.width, vi.height) == (300, 216)
    assert tuple(frames[-1][100, 100]) == (0, 0, 255)
    bufs = out["sink"][1]
    assert bufs[1][1] - bufs[0][1] == 10 ** 9 // 300


def test_cdg_through_the_video_chain(tmp_path):
    """Phase 14c's string: a seeded .cdg file through `cdgparse ! cdgdec !
    queue ! videoconvert ! RGBA ! hsvfilter ! colorlut`. Without the
    queue neither package negotiates: `cdgdec`'s sink answers a caps query
    with what downstream takes, raw video, which `video/x-cdg` refuses."""
    f = tmp_path / "s.cdg"
    f.write_bytes(seeded_cdg(np.random.default_rng(14), 120))
    cube = tmp_path / "g.cube"
    _write_cube(cube)
    out = _run_both(f"filesrc location={f} ! video/x-cdg ! cdgparse ! "
                    f"cdgdec ! queue ! videoconvert ! video/x-raw, "
                    f"format=RGBA ! "
                    f"hsvfilter {HSV} ! colorlut location={cube} ! "
                    f"appsink name=sink")
    assert len(out["sink"][1]) > 50
    assert {len(b[0]) for b in out["sink"][1]} == {300 * 216 * 4}


# ---------------------------------------------------------------------------
# image codecs (tests/test_video_convert_image.py)
# ---------------------------------------------------------------------------

def test_pngenc_produces_valid_png():
    Image = _pil()
    bufs = _run_both("videotestsrc num-buffers=2 pattern=smpte ! "
                     "video/x-raw, format=RGB, width=64, height=32 ! "
                     "rspngenc ! appsink name=sink")["sink"][1]
    assert len(bufs) == 2
    assert Image.open(io.BytesIO(bufs[0][0])).size == (64, 32)
    assert bufs[0][0][:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("fmt,level", [("RGBA", 6), ("GRAY8", 0),
                                       ("RGB", 9)])
def test_pngenc_formats(fmt, level):
    _pil()
    _run_both(f"videotestsrc num-buffers=2 pattern=snow ! video/x-raw, "
              f"format={fmt}, width=40, height=24 ! rspngenc "
              f"compression-level={level} ! appsink name=sink")


@pytest.mark.parametrize("decoder", ["imagedecoder", "imagersdec"])
def test_png_roundtrip_through_imagedecoder(decoder):
    _pil()
    out = _run_both("videotestsrc num-buffers=1 pattern=gradient ! "
                    "video/x-raw, format=RGB, width=32, height=16 ! "
                    f"rspngenc ! {decoder} ! appsink name=sink")
    vi, (frame,) = _frames("gstpu_torch", *out["sink"])
    assert (vi.format, vi.width, vi.height) == ("RGBA", 32, 16)
    assert frame[0, 31, 0] > frame[0, 0, 0]


def test_gif_roundtrip():
    _pil()
    bufs = _run_both("videotestsrc num-buffers=3 pattern=gradient ! "
                     "video/x-raw, format=RGB, width=16, height=16 ! "
                     "gifenc ! gifdec ! appsink name=sink")["sink"][1]
    assert len(bufs) == 3
    assert bufs[1][1] > bufs[0][1]


def test_gifenc_bytes():
    _pil()
    bufs = _run_both("videotestsrc num-buffers=4 pattern=snow ! "
                     "video/x-raw, format=RGBA, width=24, height=16 ! "
                     "gifenc repeat=2 ! appsink name=sink")["sink"][1]
    assert len(bufs) == 1 and bufs[0][0][:6] == b"GIF89a"


def test_webp_and_still_decoders(tmp_path):
    """An animated WebP through `rswebpdec`, and a seeded JPEG and BMP
    through `imagedecoder` read by `filesrc` in chunks."""
    Image = _pil()
    rng = np.random.default_rng(7)
    frames = [Image.fromarray(rng.integers(0, 256, (12, 20, 3), np.uint8))
              for _ in range(3)]
    webp = tmp_path / "a.webp"
    frames[0].save(webp, format="WEBP", save_all=True,
                   append_images=frames[1:], duration=[40, 50, 60],
                   lossless=True)
    _run_both(f"filesrc location={webp} ! image/webp ! rswebpdec ! "
              f"appsink name=sink")
    for ext in ("jpeg", "bmp"):
        f = tmp_path / f"a.{ext}"
        frames[1].save(f, format=ext.upper())
        _run_both(f"filesrc location={f} blocksize=200 ! image/{ext} ! "
                  f"imagedecoder ! appsink name=sink")


@pytest.mark.parametrize("overlay", ["imageoverlay", "imagersoverlay"])
def test_imageoverlay(tmp_path, overlay):
    Image = _pil()
    ov = np.zeros((8, 8, 4), np.uint8)
    ov[..., 0] = 255
    ov[..., 3] = 255
    f = tmp_path / "ov.png"
    Image.fromarray(ov, "RGBA").save(f)
    out = _run_both(f"videotestsrc num-buffers=1 pattern=black ! "
                    f"video/x-raw, format=RGBA, width=32, height=32 ! "
                    f"{overlay} location={f} offset-x=4 offset-y=4 "
                    f"! appsink name=sink")
    _, (frame,) = _frames("gstpu_torch", *out["sink"])
    assert tuple(frame[6, 6, :3]) == (255, 0, 0)
    assert tuple(frame[20, 20, :3]) == (0, 0, 0)


def test_imageoverlay_takes_a_tensor_payload(tmp_path):
    """In place behind a device element: the port's `hsvfilter` hands
    `imageoverlay` a tensor; the blend of a seeded half-transparent
    overlay clipped at the frame's edge equals gstpu's."""
    Image = _pil()
    rng = np.random.default_rng(9)
    ov = rng.integers(0, 256, (20, 24, 4), np.uint8)
    f = tmp_path / "ov.png"
    Image.fromarray(ov, "RGBA").save(f)
    launch = (f"videotestsrc num-buffers=2 pattern=snow ! video/x-raw, "
              f"format=RGBA, width=40, height=30 ! hsvfilter {HSV} ! "
              f"imageoverlay location={f} offset-x=25 offset-y=3 ! "
              f"appsink name=sink")
    _run_both(launch)
    p = gstpu_torch.parse_launch(launch)
    kinds = []
    next(e for e in p.children if e.ELEMENT_NAME == "imageoverlay") \
        .static_pad("sink").peer.add_probe(
            lambda pad, item: kinds.append(type(item.data))
            if isinstance(item, gstpu_torch.Buffer) else None)
    p.set_state(gstpu_torch.State.PLAYING)
    p.run()
    p.set_state(gstpu_torch.State.NULL)
    assert kinds == [torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# videofx (tests/test_generic_elements.py)
# ---------------------------------------------------------------------------

def test_roundedcorners():
    out = _run_both("videotestsrc num-buffers=1 pattern=white ! "
                    "video/x-raw, format=I420, width=32, height=32 ! "
                    "roundedcorners border-radius-px=8 ! appsink name=sink")
    vi, (planes,) = _frames("gstpu_torch", *out["sink"])
    assert vi.format == "A420" and len(planes) == 4
    alpha = planes[3]
    assert alpha[0, 0] == 0 and alpha[16, 16] == 255 and alpha[0, 16] == 255


@pytest.mark.parametrize("radius", [0, 1, 13])
def test_roundedcorners_radii(radius):
    _run_both(f"videotestsrc num-buffers=2 pattern=snow ! video/x-raw, "
              f"format=I420, width=46, height=30 ! roundedcorners "
              f"border-radius-px={radius} ! appsink name=sink")


def test_colordetect_posts_message():
    out = _run_both("videotestsrc num-buffers=2 pattern=red ! "
                    "video/x-raw, format=RGB, width=32, height=32 ! "
                    "colordetect ! appsink name=sink")
    msgs = [m for m in out["messages"] if m[0] == "colordetect"]
    assert len(msgs) == 1 and msgs[0][1]["dominant_color"] == "red"


@pytest.mark.parametrize("quality,colors", [(1, 4), (10, 2), (3, 16)])
def test_colordetect_graded_frames(tmp_path, quality, colors):
    """Behind `hsvfilter ! colorlut`, whose frames reach it as tensors in
    the port: the same palettes and names."""
    cube = tmp_path / "g.cube"
    _write_cube(cube, seed=quality)
    out = _run_both(f"videotestsrc num-buffers=3 pattern=snow ! video/x-raw, "
                    f"format=RGBA, width=48, height=40 ! hsvfilter {HSV} ! "
                    f"colorlut location={cube} ! colordetect "
                    f"quality={quality} max-colors={colors} ! "
                    f"appsink name=sink")
    assert out["messages"]


def _videocompare(name: str, frames, threshold: float, algo: str):
    """`videocompare` in a harness of one package: secondary frame i
    pushed before reference frame i; the element messages."""
    pkg = importlib.import_module(name)
    el = _mod(name, "core.registry").make("videocompare")
    el.set_property("max-dist-threshold", threshold)
    el.set_property("hash-algo", algo)
    h = _mod(name, "core.harness").Harness(el)
    caps = "video/x-raw, format=RGB, width=64, height=64, framerate=30/1"
    h.set_caps(caps)
    elmod, evmod = _mod(name, "core.element"), _mod(name, "core.event")
    feeder = elmod.Pad("feeder", elmod.PadDirection.SRC, elmod.PadTemplate(
        "src", elmod.PadDirection.SRC, elmod.PadPresence.ALWAYS,
        pkg.Caps.any()))
    feeder.link(el.static_pad("sink_secondary"))
    feeder.push_event(evmod.StreamStartEvent("sec"))
    feeder.push_event(evmod.CapsEvent(_mod(name, "core.caps")
                                      .parse_caps(caps)))
    for i, (ref, sec) in enumerate(frames):
        feeder.push(pkg.Buffer(sec.reshape(-1).copy(), pts=1000 + i))
        h.push(pkg.Buffer(ref.reshape(-1).copy(), pts=i))
    out = [b.pts for b in h.pull_all()]
    msgs = _messages(name, h.bus)
    h.teardown()
    return out, msgs


@pytest.mark.parametrize("algo", ["blockhash", "dssim"])
def test_videocompare_match(algo):
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    noisy = np.clip(frame.astype(int) + rng.integers(-3, 4, frame.shape),
                    0, 255).astype(np.uint8)
    other = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    frames = [(frame, frame), (noisy, frame), (other, frame)]
    ref, port = (_videocompare(name, frames, 0.1, algo) for name in NAMES)
    assert port == ref
    assert port[0] == [0, 1, 2]
    assert [m[1]["pts"] for m in port[1]] == [0, 1]
    assert port[1][0][1]["distance"] <= 0.1


# ---------------------------------------------------------------------------
# viuersink (tests/test_viuer_compositor_llm.py)
# ---------------------------------------------------------------------------

def test_viuersink_ansi_halfblocks(tmp_path):
    texts = []
    for name in NAMES:
        out = tmp_path / f"{name}.txt"
        _run(name, 'videotestsrc num-buffers=1 ! capsfilter caps="video/'
                   'x-raw, format=RGB, width=16, height=8" ! viuersink '
                   f'width=16 file={out}', sinks=())
        texts.append(out.read_text())
    assert texts[0] == texts[1]
    lines = [ln for ln in texts[1].splitlines() if ln]
    assert len(lines) == 4 and lines[0].count("▀") == 16


@pytest.mark.parametrize("fmt,width,height,lines", [("RGBA", 21, 0, 7),
                                                    ("I420", 30, 5, 5),
                                                    ("GRAY8", 7, 0, 2)])
def test_viuersink_formats(tmp_path, fmt, width, height, lines):
    texts = []
    for name in NAMES:
        out = tmp_path / f"{name}.txt"
        _run(name, f"videotestsrc num-buffers=2 pattern=snow ! video/x-raw, "
                   f"format={fmt}, width=50, height=31 ! viuersink "
                   f"width={width} height={height} file={out}", sinks=())
        texts.append(out.read_text())
    assert texts[0] == texts[1] and texts[1].count("\x1b[0m") == 2 * lines


def test_viuersink_render_golden():
    from gstpu.elements.video.viuer import render_ansi_halfblocks as jrender
    from gstpu_torch.elements.video.viuer import render_ansi_halfblocks
    img = np.zeros((2, 1, 3), np.uint8)
    img[0, 0] = (255, 0, 0)
    img[1, 0] = (0, 0, 255)
    s = render_ansi_halfblocks(img)
    assert s == ("\x1b[38;2;255;0;0m\x1b[48;2;0;0;255m▀\x1b[0m\n")
    odd = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    assert render_ansi_halfblocks(odd) == jrender(odd)


# ---------------------------------------------------------------------------
# phase 14a's string at a small size
# ---------------------------------------------------------------------------

def test_graded_video_into_the_new_sinks(tmp_path):
    """`videotestsrc ! hsvfilter ! colorlut ! colordetect ! tee` into
    `videoconvert ! I420 ! roundedcorners`, `viuersink` and `rspngenc !
    filesink`: the A420 frames, the terminal text, the PNG file and the
    colordetect messages equal in both packages."""
    _pil()
    cube = tmp_path / "g.cube"
    _write_cube(cube)
    got = []
    for name in NAMES:
        txt, png = tmp_path / f"{name}.txt", tmp_path / f"{name}.png"
        out = _run(name,
                   f"videotestsrc num-buffers=3 pattern=snow ! video/x-raw, "
                   f"format=RGBA, width=64, height=48, framerate=30/1 ! "
                   f"hsvfilter {HSV} ! colorlut location={cube} ! "
                   f"colordetect ! tee name=t ! videoconvert ! video/x-raw, "
                   f"format=I420 ! roundedcorners border-radius-px=8 ! "
                   f"appsink name=sink ! t. ! viuersink width=20 file={txt} "
                   f"! t. ! rspngenc ! filesink location={png}")
        got.append((out, txt.read_text(), png.read_bytes()))
    assert got[0] == got[1]
    out, txt, png = got[1]
    assert len(out["sink"][1]) == 3 and "A420" in out["sink"][0]
    assert png.count(b"\x89PNG") == 3 and txt.count("\x1b[0m") == 3 * 8
    assert out["messages"]


def test_a420_in_both_packages():
    vi = [_mod(name, "core.video").VideoInfo("A420", 33, 17)
          for name in NAMES]
    assert vi[0].size == vi[1].size == 33 * 17 * 2 + 2 * 17 * 9
