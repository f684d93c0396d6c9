"""YOLOv3 decode (counterpart of ``tpucv/decode/yolov3.py``; reference
``core/predict/yolov3_decode.py``): xy = (sigmoid + cell) · stride, wh =
exp(clip(t, -10, 10)) · anchor, score = obj · class, the levels
concatenated in (h, w, anchor) order, then the per-class multilabel NMS.

tpucv passes ``cfg.decode.pre_nms_topk`` (4,096 by default, no cap as
YOLOv8's predict has), so the shipped decode takes the sequential scan
(``ops/nms.py:dispatch_batched_nms``: K > 1,024), on the card one
``nms_scan`` launch a batch and no ``nms_keep``; at K <= 1,024 it takes
``nms_keep``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tpucv_torch.ops.nms import batched_non_max_suppression_multilabel


def raw_to_pred_yolo3(
    raw_maps: Sequence[torch.Tensor],
    anchors: np.ndarray,              # (9, 2) px
    anchor_mask: Sequence[Sequence[int]],
    strides: Sequence[int],
    nc: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level NHWC raw maps -> (boxes (B, A, 4) xyxy px, scores (B, A,
    nc)), f32."""
    dev = raw_maps[0].device
    anc_all = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)
    boxes_all, scores_all = [], []
    for l, (m, s) in enumerate(zip(raw_maps, strides)):
        ids = list(anchor_mask[l])
        na = len(ids)
        anc = anc_all[torch.as_tensor(ids, device=dev)]
        B, H, W, _ = m.shape
        x = m.reshape(B, H, W, na, 5 + nc).float()
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                             device=dev),
                                torch.arange(W, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cx = (torch.sigmoid(x[..., 0]) + gx[None, :, :, None]) * s
        cy = (torch.sigmoid(x[..., 1]) + gy[None, :, :, None]) * s
        w = torch.exp(x[..., 2].clamp(-10, 10)) * anc[:, 0]
        h = torch.exp(x[..., 3].clamp(-10, 10)) * anc[:, 1]
        score = torch.sigmoid(x[..., 4:5]) * torch.sigmoid(x[..., 5:])
        b = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        boxes_all.append(b.reshape(B, -1, 4))
        scores_all.append(score.reshape(B, -1, nc))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


def decode_yolov3(
    raw_maps: Sequence[torch.Tensor],
    anchors: np.ndarray,
    anchor_mask: Sequence[Sequence[int]],
    strides: Sequence[int],
    nc: int,
    conf_threshold: float = 0.5,
    iou_threshold: float = 0.45,
    max_det: int = 100,
    pre_nms_topk: int = 1024,
) -> Tuple[torch.Tensor, ...]:
    """Raw maps -> fixed-shape (boxes (B, max_det, 4) xyxy px, scores,
    classes, valid)."""
    boxes, scores = raw_to_pred_yolo3(raw_maps, anchors, anchor_mask,
                                      strides, nc)
    return batched_non_max_suppression_multilabel(
        boxes, scores, conf_threshold, iou_threshold, max_det, pre_nms_topk)
