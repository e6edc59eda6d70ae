"""analyticscombiner / analyticssplitter / yoloxtensordec /
yoloxinference / handdetectiontensordec / onvifmeta2relationmeta /
relationmeta2onvifmeta.

Rebuilds the reference analytics/analytics crate: N streams batched
into meta-carried mini-batches and back (the batching primitive at
the element level), and tensor-output decoding into
AnalyticsRelationMeta object detections.

The port of gstpu/elements/analytics/analytics.py. yoloxinference runs
the torch YOLOX (gstpu_torch/ops/yolox.py) on the frame's device; the
decoders, the combiner/splitter, the ONVIF converters and the metas are
gstpu's host code, copied; the converters take the ONVIF schema and meta
from the port's copy of them (gstpu_torch/elements/net/onvif.py).
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.base import Aggregator, BaseTransform
from gstpu_torch.core.buffer import Buffer, Meta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps
from gstpu_torch.elements.net.onvif import (ONVIF_SCHEMA,
                                            OnvifMetadataFrameMeta)
from gstpu_torch.elements.video.scale import frame_tensor
from gstpu_torch.ops.detection import Detection, yolox_decode


class AnalyticsRelationMeta(Meta):
    """Object-detection/classification relations on a buffer
    (gst-analytics AnalyticsRelationMeta analogue)."""

    def __init__(self, detections: list[Detection] | None = None):
        self.detections = detections or []


class AnalyticsBatchMeta(Meta):
    """A mini-batch of per-stream buffers carried on one buffer
    (reference analyticscombiner output)."""

    def __init__(self, streams: list[tuple[str, Buffer, Caps | None]]):
        self.streams = streams  # (stream_name, buffer, caps)


@register_element("analyticscombiner", Rank.NONE)
class AnalyticsCombiner(Aggregator):
    """Batches one buffer per sink pad into a single buffer carrying
    AnalyticsBatchMeta (N streams -> device mini-batch)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("multistream/x-analytics-batch")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    Caps.any()),
    ]

    def negotiate_src_caps(self) -> Caps:
        return Caps.new("multistream/x-analytics-batch")

    def aggregate(self, timeout: bool) -> FlowReturn:
        pads = self.agg_sink_pads()
        if not all(p.queue or p.pad_eos for p in pads):
            return FlowReturn.OK
        streams = []
        pts = None
        for p in pads:
            buf = p.pop_buffer()
            if buf is None:
                continue
            streams.append((p.name, buf, p.current_caps))
            if pts is None or (buf.pts or 0) < pts:
                pts = buf.pts or 0
        if not streams:
            return FlowReturn.OK
        out = Buffer(b"", pts=pts)
        out.add_meta(AnalyticsBatchMeta(streams))
        return self.srcpad.push(out)


@register_element("analyticssplitter", Rank.NONE)
class AnalyticsSplitter(Element):
    """Splits AnalyticsBatchMeta batches back into per-stream pads
    (created on demand, named after the combiner's pads)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("multistream/x-analytics-batch")),
        PadTemplate("src_%u", PadDirection.SRC, PadPresence.SOMETIMES,
                    Caps.any()),
    ]

    SIGNALS = ("pad-added",)

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._srcs: dict[str, Pad] = {}

    def _get_src(self, stream_name: str, caps: Caps | None) -> Pad:
        pad = self._srcs.get(stream_name)
        if pad is None:
            pad = Pad(f"src_{stream_name}", PadDirection.SRC,
                      self.PAD_TEMPLATES[1], self)
            self.add_pad(pad)
            self._srcs[stream_name] = pad
            self.emit("pad-added", pad)
            pad.push_event(StreamStartEvent(f"{self.name}/{stream_name}"))
            if caps is not None:
                pad.push_event(CapsEvent(caps))
            pad.push_event(SegmentEvent(Segment()))
        return pad

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        meta = buf.get_meta(AnalyticsBatchMeta)
        if meta is None:
            return FlowReturn.OK
        for stream_name, sbuf, caps in meta.streams:
            src = self._get_src(stream_name, caps)
            ret = src.push(sbuf)
            if not ret.is_ok and ret is not FlowReturn.NOT_LINKED:
                return ret
        return FlowReturn.OK

    def _event(self, pad, ev) -> bool:
        if isinstance(ev, EosEvent):
            for p in self._srcs.values():
                p.push_event(EosEvent())
            return True
        return True


@register_element("yoloxtensordec", Rank.NONE)
class YoloxTensorDec(BaseTransform):
    """Decodes raw YOLOX head tensors into AnalyticsRelationMeta
    detections (reference yoloxtensordec: box decode + NMS)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps(list(Caps.new("application/x-tensor",
                                       type="yolox"))
                         + list(video_caps()))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps(list(Caps.new("application/x-tensor",
                                       type="yolox"))
                         + list(video_caps()))),
    ]

    score_threshold = Property(float, default=0.3, minimum=0.0,
                               maximum=1.0, mutable=Mutability.PLAYING)
    nms_threshold = Property(float, default=0.45, minimum=0.0,
                             maximum=1.0, mutable=Mutability.PLAYING)
    image_width = Property(int, default=640, minimum=32,
                           mutable=Mutability.READY)
    image_height = Property(int, default=640, minimum=32,
                            mutable=Mutability.READY)
    num_classes = Property(int, default=80, minimum=1,
                           mutable=Mutability.READY)

    def transform_ip(self, buf: Buffer) -> None:
        tm = buf.get_meta(TensorMeta)
        if tm is not None:
            # video buffer carrying inference output (yoloxinference)
            arr = np.asarray(tm.data).reshape(-1,
                                              5 + self.num_classes)
            info = VideoInfo.from_caps(self.in_caps)
            w, h = info.width, info.height
        else:
            arr = buf.array.view(np.float32) \
                .reshape(-1, 5 + self.num_classes)
            w, h = self.image_width, self.image_height
        dets = yolox_decode(arr, w, h,
                            self.score_threshold, self.nms_threshold)
        buf.add_meta(AnalyticsRelationMeta(dets))


class TensorMeta(Meta):
    """Raw inference output attached to a media buffer (gst analytics
    TensorMeta analogue; reference burn-yoloxinference attaches its
    output this way)."""

    def __init__(self, data: np.ndarray, tensor_type: str = "yolox"):
        self.data = data
        self.tensor_type = tensor_type

    def copy(self):
        return TensorMeta(self.data, self.tensor_type)


@register_element("yoloxinference", Rank.NONE)
class YoloxInference(BaseTransform):
    """Runs the torch YOLOX forward (gstpu_torch/ops/yolox.py) on RGB
    frames on the device and attaches the (A, 5+C) f32 output as a
    numpy TensorMeta (reference analytics/burn/src/yoloxinference).
    Input frames must already be scaled to a multiple of 32 (like the
    reference's videoconvertscale step)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGB", "RGBA"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGB", "RGBA"))),
    ]

    model_file = Property(str, default=None, mutable=Mutability.READY,
                          blurb=".npz weights or an official YOLOX "
                                ".pth checkpoint (random init if "
                                "unset)")
    model_size = Property(str, default="tiny", mutable=Mutability.READY,
                          enum_values=("nano", "tiny", "s", "m", "l",
                                       "x"),
                          blurb="YOLOX variant (depth/width preset)")
    num_classes = Property(int, default=80, minimum=1,
                           mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._model = None
        self._device: torch.device | None = None
        self._255: torch.Tensor | None = None

    def start(self) -> bool:
        """Loads or initialises the parameters once, onto the device."""
        from gstpu_torch.ops import yolox
        self._device = default_device()
        if self.model_file and self.model_file.endswith(".pth"):
            state = yolox.load_torch_checkpoint(self.model_file)
            self._model = yolox.build_model(state, self._device,
                                            self.num_classes,
                                            self.model_size)
        else:
            params = yolox.load_params(self.model_file) \
                if self.model_file else \
                yolox.init_params(self.num_classes, size=self.model_size)
            self._model = yolox.build_model(params, self._device)
        # a 0-dim tensor on the device: torch divides a CUDA tensor by a
        # Python scalar as a product with its reciprocal, by a tensor as
        # IEEE division (gstpu's numpy `/ 255.0`)
        self._255 = torch.tensor(255.0, device=self._device)
        return True

    def stop(self) -> bool:
        self._model = self._255 = None
        return super().stop()

    def transform_ip(self, buf: Buffer) -> None:
        from gstpu_torch.ops.yolox import forward
        info = VideoInfo.from_caps(self.in_caps)
        frame = frame_tensor(buf)
        frame = info.tensor(buf, self._device) if frame is None \
            else frame.reshape(info.height, info.width, -1)
        x = frame[..., :3].to(self._device).to(torch.float32) / self._255
        pred = forward(self._model, x)
        buf.add_meta(TensorMeta(pred.cpu().numpy()))


# -- hand detection (MediaPipe palm) --------------------------------------

def palm_rotation_from_keypoints(kp0, kp2) -> float:
    """pi/2 + atan2 of the wrist->middle-finger vector (reference
    handdetectiontensordec/imp.rs:255 hand alignment offset)."""
    import math
    return math.pi / 2 + math.atan2(kp2[1] - kp0[1], kp2[0] - kp0[0])


def decode_palm_detections(rows: np.ndarray, *, confidence=0.5,
                           nms_iou=0.3, max_hands=2,
                           video_size=None) -> list:
    """rows: (N, 8) [score, cx, cy, size, kp0x, kp0y, kp2x, kp2y] ->
    rotated palm ROIs (imp.rs:184-245: rr_size = 2.9*size, center
    shifted half a box along the rotation)."""
    import math

    from gstpu_torch.ops.detection import Detection, nms
    cands = []
    for det in np.asarray(rows, np.float32).reshape(-1, 8):
        score, cx, cy, size, k0x, k0y, k2x, k2y = (float(v)
                                                   for v in det)
        if score < confidence or size <= 0:
            continue
        rot = palm_rotation_from_keypoints((k0x, k0y), (k2x, k2y))
        rr = 2.9 * size
        ccx = cx + 0.5 * size * math.sin(rot)
        ccy = cy - 0.5 * size * math.cos(rot)
        if video_size is not None:
            w, h = video_size
            ccx, ccy, rr = ccx * w, ccy * h, rr * max(w, h)
        half = rr / 2
        d = Detection(x=ccx - half, y=ccy - half, w=rr, h=rr,
                      score=score, class_id=0, label="hand")
        d.rotation = rot
        cands.append(d)
    if not cands:
        return []
    boxes = np.array([[d.x, d.y, d.w, d.h] for d in cands],
                     np.float32)
    scores = np.array([d.score for d in cands], np.float32)
    keep = nms(boxes, scores, nms_iou)
    return [cands[i] for i in keep[:max_hands]]


@register_element("handdetectiontensordec", Rank.NONE)
class HandDetectionTensorDec(BaseTransform):
    """Decodes post-processed palm-detection tensors into
    AnalyticsRelationMeta hand ROIs (reference analytics/analytics/
    src/handdetectiontensordec)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps(list(Caps.new("application/x-tensor",
                                       type="palm-detection"))
                         + list(video_caps()))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps(list(Caps.new("application/x-tensor",
                                       type="palm-detection"))
                         + list(video_caps()))),
    ]

    confidence_threshold = Property(float, default=0.5, minimum=0.0,
                                    maximum=1.0,
                                    mutable=Mutability.PLAYING)
    nms_iou_threshold = Property(float, default=0.3, minimum=0.0,
                                 maximum=1.0,
                                 mutable=Mutability.PLAYING)
    max_hands = Property(int, default=2, minimum=1,
                         mutable=Mutability.PLAYING)

    def transform_ip(self, buf: Buffer) -> None:
        tm = buf.get_meta(TensorMeta)
        video_size = None
        if tm is not None:
            rows = np.asarray(tm.data)
            info = VideoInfo.from_caps(self.in_caps)
            video_size = (info.width, info.height)
        else:
            rows = buf.array.view(np.float32).reshape(-1, 8)
        hands = decode_palm_detections(
            rows, confidence=self.confidence_threshold,
            nms_iou=self.nms_iou_threshold, max_hands=self.max_hands,
            video_size=video_size)
        buf.add_meta(AnalyticsRelationMeta(hands))


@register_element("burn-yoloxinference", Rank.NONE)
class BurnYoloxInference(YoloxInference):
    """The reference's factory name for yoloxinference."""


# -- ONVIF XML <-> AnalyticsRelationMeta ----------------------------------

@register_element("onvifmeta2relationmeta", Rank.NONE)
class OnvifMeta2RelationMeta(BaseTransform):
    """Parses attached ONVIF documents' BoundingBoxes into
    AnalyticsRelationMeta detections (normalized [-1,1] coords mapped
    like onvifmeta2relationmeta/imp.rs:502)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps()),
    ]

    def transform_ip(self, buf: Buffer) -> None:
        import xml.etree.ElementTree as ET
        info = VideoInfo.from_caps(self.in_caps)
        W, H = info.width, info.height
        dets = []
        for m in buf.metas:
            if not isinstance(m, OnvifMetadataFrameMeta):
                continue
            root = ET.fromstring(m.data)
            for obj in root.iter(f"{{{ONVIF_SCHEMA}}}Object"):
                bbox = obj.find(f".//{{{ONVIF_SCHEMA}}}BoundingBox")
                if bbox is None:
                    continue
                left = float(bbox.get("left", 0))
                right = float(bbox.get("right", 0))
                top = float(bbox.get("top", 0))
                bottom = float(bbox.get("bottom", 0))
                x1 = (1.0 + left) * W / 2
                x2 = (1.0 + right) * W / 2
                y1 = (1.0 - top) * H / 2
                y2 = (1.0 - bottom) * H / 2
                dets.append(Detection(
                    x=min(x1, x2), y=min(y1, y2),
                    w=abs(x2 - x1), h=abs(y2 - y1), score=1.0,
                    class_id=int(obj.get("ObjectId", 0)), label=""))
        if dets:
            buf.add_meta(AnalyticsRelationMeta(dets))


@register_element("relationmeta2onvifmeta", Rank.NONE)
class RelationMeta2OnvifMeta(BaseTransform):
    """Inverse: AnalyticsRelationMeta detections become an attached
    ONVIF VideoAnalytics document (reference relationmeta2onvifmeta).
    """

    IN_PLACE = True
    PAD_TEMPLATES = OnvifMeta2RelationMeta.PAD_TEMPLATES

    def transform_ip(self, buf: Buffer) -> None:
        import xml.etree.ElementTree as ET
        rm = buf.get_meta(AnalyticsRelationMeta)
        if rm is None or not rm.detections:
            return
        info = VideoInfo.from_caps(self.in_caps)
        W, H = info.width, info.height
        ET.register_namespace("tt", ONVIF_SCHEMA)
        root = ET.Element(f"{{{ONVIF_SCHEMA}}}MetadataStream")
        va = ET.SubElement(root, f"{{{ONVIF_SCHEMA}}}VideoAnalytics")
        frame = ET.SubElement(va, f"{{{ONVIF_SCHEMA}}}Frame")
        frame.set("UtcTime", "1970-01-01T00:00:00.000Z")
        for d in rm.detections:
            obj = ET.SubElement(frame, f"{{{ONVIF_SCHEMA}}}Object")
            obj.set("ObjectId", str(d.class_id))
            app = ET.SubElement(obj, f"{{{ONVIF_SCHEMA}}}Appearance")
            shape = ET.SubElement(app, f"{{{ONVIF_SCHEMA}}}Shape")
            bbox = ET.SubElement(shape,
                                 f"{{{ONVIF_SCHEMA}}}BoundingBox")
            bbox.set("left", f"{d.x / W * 2 - 1:.6f}")
            bbox.set("right", f"{(d.x + d.w) / W * 2 - 1:.6f}")
            bbox.set("top", f"{1 - d.y / H * 2:.6f}")
            bbox.set("bottom", f"{1 - (d.y + d.h) / H * 2:.6f}")
        buf.add_meta(OnvifMetadataFrameMeta(ET.tostring(root),
                                            buf.pts))
