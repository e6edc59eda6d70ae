"""Detection tensor decoding: YOLOX head decode + NMS.

Re-implements the math of the reference analytics tensor decoders
(analytics/analytics yoloxtensordec: grid/stride box decode, class
scores, IoU NMS into AnalyticsRelationMeta).

The port's copy of gstpu/ops/detection.py: host numpy, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Detection:
    x: float
    y: float
    w: float
    h: float
    score: float
    class_id: int
    label: str = ""


def yolox_grids(img_w: int, img_h: int,
                strides=(8, 16, 32)) -> tuple[np.ndarray, np.ndarray]:
    """Flattened (grid_xy (A,2), stride (A,)) for the YOLOX head."""
    gs, ss = [], []
    for s in strides:
        gw, gh = img_w // s, img_h // s
        xv, yv = np.meshgrid(np.arange(gw), np.arange(gh))
        g = np.stack([xv, yv], axis=-1).reshape(-1, 2)
        gs.append(g)
        ss.append(np.full(g.shape[0], s))
    return (np.concatenate(gs).astype(np.float32),
            np.concatenate(ss).astype(np.float32))


def yolox_decode(pred: np.ndarray, img_w: int, img_h: int,
                 score_threshold: float = 0.3,
                 nms_threshold: float = 0.45,
                 strides=(8, 16, 32)) -> list[Detection]:
    """pred: (A, 5+C) raw head output [dx, dy, logw, logh, obj, cls...].
    Returns NMS-filtered detections in pixel coordinates."""
    grids, ss = yolox_grids(img_w, img_h, strides)
    A = grids.shape[0]
    if pred.shape[0] != A:
        raise ValueError(f"expected {A} anchors for {img_w}x{img_h}, "
                         f"got {pred.shape[0]}")
    xy = (pred[:, :2] + grids) * ss[:, None]
    wh = np.exp(np.clip(pred[:, 2:4], -20, 10)) * ss[:, None]
    obj = _sigmoid(pred[:, 4])
    cls = _sigmoid(pred[:, 5:])
    scores = obj[:, None] * cls
    class_id = scores.argmax(axis=1)
    score = scores[np.arange(A), class_id]
    keep = score >= score_threshold
    boxes = np.concatenate([xy - wh / 2, wh], axis=1)[keep]
    score, class_id = score[keep], class_id[keep]
    idx = nms(boxes, score, nms_threshold)
    return [Detection(float(boxes[i, 0]), float(boxes[i, 1]),
                      float(boxes[i, 2]), float(boxes[i, 3]),
                      float(score[i]), int(class_id[i]))
            for i in idx]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def nms(boxes: np.ndarray, scores: np.ndarray,
        threshold: float) -> list[int]:
    """Greedy IoU NMS; boxes as (x, y, w, h)."""
    if boxes.shape[0] == 0:
        return []
    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2, y2 = boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]
    areas = boxes[:, 2] * boxes[:, 3]
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-9)
        order = order[1:][iou <= threshold]
    return keep
