"""rtpgccbwe: bandwidth-estimation element around the GCC core
(reference net/rtp/src/gcc/imp.rs). Passthrough on RTP; feedback is
injected via feed_feedback() (the reference consumes TWCC RTCP from
webrtcbin); posts `estimated-bitrate` notifications + bus messages.

The port's copy of gstpu/elements/net/gccbwe.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.net.rtp.gcc import GccEstimator, PacketFeedback


@register_element("rtpgccbwe", Rank.NONE)
class RtpGccBwe(BaseTransform):
    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("application/x-rtp")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("application/x-rtp")),
    ]

    min_bitrate = Property(int, default=100_000, minimum=1000,
                           mutable=Mutability.READY)
    max_bitrate = Property(int, default=50_000_000, minimum=1000,
                           mutable=Mutability.READY)
    estimated_bitrate = Property(int, default=1_000_000, minimum=0,
                                 mutable=Mutability.PLAYING,
                                 blurb="Current estimate (read-mostly)")

    def __init__(self, name=None):
        super().__init__(name)
        self._est: GccEstimator | None = None

    def start(self) -> bool:
        self._est = GccEstimator(self.estimated_bitrate,
                                 self.min_bitrate, self.max_bitrate)
        return True

    def transform_ip(self, buf: Buffer) -> None:
        return None  # passthrough; estimation is feedback-driven

    def feed_feedback(self, packets: list[PacketFeedback]) -> int:
        """Inject transport-wide feedback (send/recv times + sizes)."""
        rate = self._est.process_feedback(packets)
        if rate != self.estimated_bitrate:
            self.set_property("estimated_bitrate", rate)
            self.post_element_message("rtpgccbwe", estimated_bitrate=rate,
                                      usage=self._est.last_usage.value)
        return rate
