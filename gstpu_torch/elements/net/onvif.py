"""The ONVIF metadata pieces that the analytics converters need.

A copy of two names of gstpu/elements/net/onvif.py: the ONVIF schema
namespace and `OnvifMetadataFrameMeta`, the meta that carries one ONVIF
XML document on a media buffer. The RTP payloaders
(`onvifmetadatapay`/`onvifmetadatadepay`), `onvifmetadataparse` and
`onvifmetadatacombiner` are not ported: they are host code over gstpu's
RTP stack, which the port does not have.
"""

from __future__ import annotations

from gstpu_torch.core.buffer import Meta

ONVIF_SCHEMA = "http://www.onvif.org/ver10/schema"


class OnvifMetadataFrameMeta(Meta):
    """A complete ONVIF XML document attached to a media buffer
    (reference onvifmetadatacombiner attaches the meta buffers)."""

    def __init__(self, data: bytes, pts: int | None = None):
        self.data = data
        self.pts = pts

    def copy(self):
        return OnvifMetadataFrameMeta(self.data, self.pts)
