"""cea608overlay: burn CEA-608 captions into video frames.

Rebuilds the reference cea608overlay (video/closedcaption/src/
cea608overlay/imp.rs): captions arrive as VideoCaptionMeta on the
video buffers (imp.rs:264); decoded pop-on text renders bottom-center
with an optional black background box. Rendering uses PIL's bitmap
font on the host; compositing is a numpy alpha blend like
imageoverlay.

The port's copy of gstpu/elements/video/ccoverlay.py, as it stands: PIL
on the host; a frame with a caption strip is read through
`VideoInfo.view`, so a tensor payload is downloaded and the drawn frame
goes on as a host array.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.codecs.cea608 import Cea608Decoder
from gstpu_torch.codecs.cea708 import extract_cea608
from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoCaptionMeta, video_caps


@register_element("cea608overlay", Rank.NONE)
class Cea608Overlay(VideoFilter):
    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
    ]

    black_background = Property(bool, default=False,
                                mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = Cea608Decoder()
        self._text: str | None = None
        self._strip: np.ndarray | None = None

    def _pairs_from_meta(self, m: VideoCaptionMeta):
        if m.caption_type == "cea608-raw":
            return [m.data[i:i + 2]
                    for i in range(0, len(m.data) - 1, 2)]
        if m.caption_type == "cea608-s334-1a":
            return [m.data[i + 1:i + 3]
                    for i in range(0, len(m.data) - 2, 3)
                    if m.data[i] & 0x80]          # field 1 only
        if m.caption_type == "cea708-raw":
            return extract_cea608(m.data)[0]
        return []

    def _render(self, text: str) -> np.ndarray:
        from PIL import Image, ImageDraw, ImageFont
        font = ImageFont.load_default()
        lines = text.split("\n")
        pad = 4
        boxes = [ImageDraw.Draw(Image.new("RGBA", (1, 1)))
                 .textbbox((0, 0), ln, font=font) for ln in lines]
        w = max(b[2] - b[0] for b in boxes) + 2 * pad
        lh = max(b[3] - b[1] for b in boxes) + 2
        h = lh * len(lines) + 2 * pad
        img = Image.new("RGBA", (w, h),
                        (0, 0, 0, 255 if self.black_background else 0))
        draw = ImageDraw.Draw(img)
        for i, ln in enumerate(lines):
            draw.text((pad, pad + i * lh), ln, font=font,
                      fill=(255, 255, 255, 255))
        return np.asarray(img)

    def transform_ip(self, buf: Buffer) -> None:
        for m in buf.metas:
            if not isinstance(m, VideoCaptionMeta):
                continue
            for pair in self._pairs_from_meta(m):
                text = self._dec.push_pair(pair)
                if text is not None:
                    self._text = text or None
                    self._strip = (self._render(text)
                                   if text else None)
        if self._strip is None:
            return
        info = self.video_info
        frame = info.view(buf).copy()
        ov = self._strip
        h = min(ov.shape[0], info.height)
        w = min(ov.shape[1], info.width)
        y0 = max(0, info.height - h - info.height // 10)
        x0 = max(0, (info.width - w) // 2)
        region = frame[y0:y0 + h, x0:x0 + w, :3].astype(np.float32)
        src = ov[:h, :w]
        alpha = src[..., 3:4].astype(np.float32) / 255.0
        blended = src[..., :3] * alpha + region * (1 - alpha)
        frame[y0:y0 + h, x0:x0 + w, :3] = \
            blended.round().astype(np.uint8)
        buf.data = frame


@register_element("cea708overlay", Rank.NONE)
class Cea708Overlay(Cea608Overlay):
    """Burns CEA-708 DTVCC captions into frames (reference
    cea708overlay + cea708utils.rs): cc_data/CDP captions arrive as
    VideoCaptionMeta; the selected service runs through the FULL
    window/pen state machine (gstpu_torch.codecs.dtvcc.Service708) and
    every visible window renders at its anchor-point geometry —
    multi-window captions, roll-up scrolling, pen positioning.
    Embedded 608 pairs also render (bottom-center)."""

    from gstpu_torch.core.props import Mutability, Property
    service = Property(int, default=1, minimum=1, maximum=63,
                       mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        from gstpu_torch.codecs.dtvcc import DtvccDecoder
        self._dtvcc = DtvccDecoder()

    def _anchor_xy(self, win, ow, oh, W, H):
        """CEA-708 anchor geometry: anchor_h/v position (0..209 /
        0..74 for 16:9 absolute), anchor_point picks which corner of
        the window sits there."""
        ax = int(win.anchor_h / 210.0 * W)
        ay = int(win.anchor_v / 75.0 * H)
        if win.relative:
            ax = int(win.anchor_h / 100.0 * W)
            ay = int(win.anchor_v / 100.0 * H)
        col = win.anchor_point % 3        # 0 left 1 center 2 right
        row = win.anchor_point // 3       # 0 top 1 middle 2 bottom
        x0 = ax - (ow // 2 if col == 1 else ow if col == 2 else 0)
        y0 = ay - (oh // 2 if row == 1 else oh if row == 2 else 0)
        return (max(0, min(x0, W - ow)), max(0, min(y0, H - oh)))

    def transform_ip(self, buf: Buffer) -> None:
        from gstpu_torch.codecs.cea708 import ccdata_split, parse_cdp
        from gstpu_torch.core.video import VideoCaptionMeta
        for m in buf.metas:
            if not isinstance(m, VideoCaptionMeta):
                continue
            cc = m.data
            if m.caption_type == "cea708-cdp":
                cc = parse_cdp(cc).cc_data
            elif m.caption_type != "cea708-raw":
                continue
            pairs, _pkts = ccdata_split(cc)
            for _f, pair in pairs:
                text = self._dec.push_pair(pair)
                if text is not None:
                    self._text = text or None
                    self._strip = self._render(text) if text else None
            self._dtvcc.feed_cc_data(cc)

        info = self.video_info
        wins = self._dtvcc.visible_windows(self.service)
        if wins:
            frame = info.view(buf).copy()
            for win, text in wins:
                ov = self._render(text)
                h = min(ov.shape[0], info.height)
                w = min(ov.shape[1], info.width)
                x0, y0 = self._anchor_xy(win, w, h, info.width,
                                         info.height)
                region = frame[y0:y0 + h, x0:x0 + w, :3] \
                    .astype(np.float32)
                src = ov[:h, :w]
                alpha = src[..., 3:4].astype(np.float32) / 255.0
                frame[y0:y0 + h, x0:x0 + w, :3] = (
                    src[..., :3] * alpha + region * (1 - alpha)
                ).round().astype(np.uint8)
            buf.data = frame
            return
        # fall back to embedded-608 bottom-center rendering
        metas, buf.metas = buf.metas, []
        try:
            super().transform_ip(buf)
        finally:
            buf.metas = metas
