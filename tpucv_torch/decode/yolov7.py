"""YOLOv7 anchor-grid decode (counterpart of ``tpucv/decode/yolov7.py``):
xy = (2·sigmoid - 0.5 + cell) · stride, wh = (2·sigmoid)² · anchor, score
= obj · class, then single-label class-offset NMS. Anchors are flattened
as tpucv flattens them, (h, w, a) within a level, since the top-k's and
the NMS's tie orders depend on it."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tpucv_torch.ops.anchors import yolo_anchor_grid
from tpucv_torch.ops.nms import batched_single_label_nms


def raw_to_pred_yolo7(
    raw_maps: Sequence[torch.Tensor],
    anchors: np.ndarray,
    strides: Sequence[int],
    nc: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level NHWC raw maps (B, H, W, na*(5+nc)), any float dtype ->
    (boxes (B, A, 4) xyxy px, scores (B, A, nc)), f32; ``anchors`` is
    (nl, na, 2) in pixels."""
    na = anchors.shape[1]
    grids = yolo_anchor_grid(anchors, [m.shape[1:3] for m in raw_maps],
                             strides, device=raw_maps[0].device)
    boxes_all, scores_all = [], []
    for m, s, (grid, anchor_wh) in zip(raw_maps, strides, grids):
        B, H, W, _ = m.shape
        sig = torch.sigmoid(m.reshape(B, H, W, na, 5 + nc).float())
        xy = (sig[..., :2] * 2.0 - 0.5 + grid[:, :, None, :]) * s
        wh = (sig[..., 2:4] * 2.0) ** 2 * anchor_wh
        score = sig[..., 4:5] * sig[..., 5:]
        b = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        boxes_all.append(b.reshape(B, -1, 4))
        scores_all.append(score.reshape(B, -1, nc))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


def decode_yolov7(
    raw_maps: Sequence[torch.Tensor],
    anchors: np.ndarray,
    strides: Sequence[int],
    nc: int,
    conf_threshold: float = 0.5,
    iou_threshold: float = 0.3,
    max_det: int = 100,
    pre_nms_topk: int = 1024,
) -> Tuple[torch.Tensor, ...]:
    """Raw maps -> fixed-shape (boxes (B, max_det, 4) xyxy px, scores,
    classes, valid): each anchor offers only its best class, scored obj ·
    class (``batched_single_label_nms``)."""
    boxes, scores = raw_to_pred_yolo7(raw_maps, anchors, strides, nc)
    return batched_single_label_nms(
        torch.cat([boxes, scores], -1), conf_threshold, iou_threshold,
        max_det, pre_nms_topk, xywh=False)
