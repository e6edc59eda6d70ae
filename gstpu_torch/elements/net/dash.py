"""dashsink2: DASH segmenter sink (MPD manifest writer).

Rebuilds the reference net/dashsink2 (dash-mpd based MPD segmenter):
consumes cmafmux output — the HEADER buffer becomes the init segment,
fragments become media segments — and maintains a SegmentTemplate MPD.

The port's copy of gstpu/elements/net/dash.py, as it stands.
"""

from __future__ import annotations

import os

from gstpu_torch.core.base import BaseSink
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000


@register_element("dashsink2", Rank.NONE)
class DashSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS,
                                 Caps.new("video/quicktime"))]

    mpd_location = Property(str, default="manifest.mpd",
                            mutable=Mutability.READY)
    init_location = Property(str, default="init.mp4",
                             mutable=Mutability.READY)
    segment_template = Property(str, default="segment-%05d.m4s",
                                mutable=Mutability.READY)
    target_duration = Property(int, default=6, minimum=1,
                               mutable=Mutability.READY,
                               blurb="Segment duration hint (s)")
    mime_type = Property(str, default="audio/mp4",
                         mutable=Mutability.READY)
    codecs = Property(str, default="opus", mutable=Mutability.READY)
    dynamic = Property(bool, default=True, mutable=Mutability.READY,
                       blurb="Generate a dynamic (live) MPD; false = "
                             "static even mid-stream (reference "
                             "dynamic)")
    latency = Property(int, default=0, minimum=0,
                       mutable=Mutability.READY,
                       blurb="suggestedPresentationDelay in ms for "
                             "dynamic MPDs; 0 = omitted (reference "
                             "latency)")
    min_buffer_time = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="minBufferTime in ms; 0 = target-duration seconds "
              "(reference min-buffer-time)")
    minimum_update_period = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="minimumUpdatePeriod in ms for dynamic MPDs; 0 = "
              "omitted (reference minimum-update-period)")
    mpd_root_path = Property(
        str, default="", mutable=Mutability.READY,
        blurb="Directory the MPD is written to; empty = "
              "mpd-location as-is (reference mpd-root-path + "
              "mpd-filename pair)")
    mpd_filename = Property(
        str, default="", mutable=Mutability.READY,
        blurb="Manifest filename inside mpd-root-path; empty = "
              "mpd-location (reference mpd-filename)")
    utc_timing_url = Property(
        str, default="", mutable=Mutability.READY,
        blurb="UTCTiming http-xsdate URL stamped into dynamic MPDs "
              "(reference utc-timing-url)")

    def __init__(self, name=None):
        super().__init__(name)
        self._segments: list[tuple[str, int]] = []  # (name, dur_ns)
        self._index = 1   # DASH segment numbers start at 1
        self._have_init = False

    def render(self, buf: Buffer):
        data = buf.to_bytes()
        if buf.has_flag(BufferFlags.HEADER) and not self._have_init:
            with open(self.init_location, "wb") as f:
                f.write(data)
            self._have_init = True
            return FlowReturn.OK
        name = self.segment_template % self._index \
            if "%" in self.segment_template \
            else f"{self.segment_template}{self._index}"
        with open(name, "wb") as f:
            f.write(data)
        dur = buf.duration or self.target_duration * SECOND
        self._segments.append((name, dur))
        self._index += 1
        self._write_mpd(live=True)
        return FlowReturn.OK

    def _mpd_path(self) -> str:
        if self.mpd_root_path or self.mpd_filename:
            root = self.mpd_root_path or "."
            os.makedirs(root, exist_ok=True)
            return os.path.join(root,
                                self.mpd_filename or "manifest.mpd")
        return self.mpd_location

    def _write_mpd(self, live: bool) -> None:
        live = live and self.dynamic
        total = sum(d for _, d in self._segments)
        total_s = total / SECOND
        tpl = os.path.basename(self.segment_template).replace(
            "%05d", "$Number%05d$").replace("%d", "$Number$")
        mpd_type = "dynamic" if live else "static"
        mbt = (f"PT{self.min_buffer_time / 1000:.3f}S"
               if self.min_buffer_time
               else f"PT{self.target_duration}S")
        extra = ""
        if live and self.minimum_update_period:
            extra += (f' minimumUpdatePeriod='
                      f'"PT{self.minimum_update_period / 1000:.3f}S"')
        if live and self.latency:
            extra += (f' suggestedPresentationDelay='
                      f'"PT{self.latency / 1000:.3f}S"')
        lines = [
            '<?xml version="1.0" encoding="utf-8"?>',
            f'<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" '
            f'type="{mpd_type}" '
            f'profiles="urn:mpeg:dash:profile:isoff-live:2011" '
            f'minBufferTime="{mbt}"' + extra
            + (f' mediaPresentationDuration="PT{total_s:.3f}S"'
               if not live else "") + ">",
            *([f'  <UTCTiming '
               f'schemeIdUri="urn:mpeg:dash:utc:http-xsdate:2014" '
               f'value="{self.utc_timing_url}"/>']
              if live and self.utc_timing_url else []),
            f'  <Period id="0" start="PT0S">',
            f'    <AdaptationSet mimeType="{self.mime_type}" '
            f'segmentAlignment="true">',
            f'      <Representation id="0" codecs="{self.codecs}" '
            f'bandwidth="128000">',
            f'        <SegmentTemplate media="{tpl}" '
            f'initialization="{os.path.basename(self.init_location)}" '
            f'startNumber="1" '
            f'duration="{self.target_duration * 1000}" '
            f'timescale="1000"/>',
            "      </Representation>",
            "    </AdaptationSet>",
            "  </Period>",
            "</MPD>",
        ]
        with open(self._mpd_path(), "w") as f:
            f.write("\n".join(lines) + "\n")

    def on_eos(self) -> None:
        self._write_mpd(live=False)
