"""The detection pipeline in plain PyTorch and numpy, float32: letterbox,
forward, decode, greedy NMS, boxes back in original pixels.

- Letterbox: the image scaled by min(S/h, S/w) (float64, truncated to
  whole pixels) with nearest source pixels ``(dst - off) * len // new``,
  centred on an S x S canvas of grey 128 (ultralytics' ``LetterBox``
  with nearest resampling).
- YOLOv8 decode: the DFL expectation (softmax over ``reg_max`` bins times
  ``arange(reg_max)``), ``dist2bbox`` about the anchor centres (cell +
  0.5), times the stride; sigmoid class scores. The expectation and the
  sigmoid run in the maps' dtype (float32 in the reference; bfloat16 maps,
  from a forward under autocast, keep the configuration's decode
  precision), the rest in float32.
- YOLOv7 decode: xy = (2·sigmoid - 0.5 + cell)·stride,
  wh = (2·sigmoid)²·anchor, score = objectness · class.
- NMS: each anchor offers its best class, gated at ``conf``; the top
  ``topk`` by score (lower index first on ties); greedy per class: a
  candidate is kept when no kept candidate of its class above it overlaps
  it with IoU > ``iou``; at most ``max_det`` kept, by score.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


def letterbox(img: np.ndarray, S: int, fill: int = 128):
    """(canvas (S, S, 3) uint8, scale, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    scale = min(S / h, S / w)
    nh, nw = int(h * scale), int(w * scale)
    top, left = (S - nh) // 2, (S - nw) // 2
    r = np.arange(S)
    sy = np.clip((r - top) * h // max(nh, 1), 0, h - 1)
    sx = np.clip((r - left) * w // max(nw, 1), 0, w - 1)
    out = img[sy[:, None], sx[None, :]]
    inside = (((r >= top) & (r < top + nh))[:, None]
              & ((r >= left) & (r < left + nw))[None, :])
    out = np.where(inside[..., None], out, np.uint8(fill))
    return out, np.float32(scale), (float(left), float(top))


def _grid(h: int, w: int, dev) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    return torch.stack([gx, gy], -1)                 # (h, w, 2): x, y


def dense_yolov8(raw: Sequence[torch.Tensor], nc: int, reg_max: int,
                 strides: Sequence[int]):
    """Raw maps -> (boxes (B, A, 4) xyxy input px, scores (B, A, nc),
    best class (B, A): the argmax of the logits, which sigmoid scores
    saturated at 1 no longer order)."""
    boxes, scores, best = [], [], []
    proj = torch.arange(reg_max, dtype=raw[0].dtype, device=raw[0].device)
    for m, s in zip(raw, strides):
        B, h, w, _ = m.shape
        m = m.reshape(B, h * w, -1)
        logits = m[..., :4 * reg_max].reshape(B, h * w, 4, reg_max)
        dist = (torch.softmax(logits, -1) @ proj).float()
        c = _grid(h, w, m.device).reshape(1, h * w, 2) + 0.5
        boxes.append(torch.cat([c - dist[..., :2], c + dist[..., 2:]], -1) * s)
        scores.append(torch.sigmoid(m[..., 4 * reg_max:]).float())
        best.append(m[..., 4 * reg_max:].argmax(-1))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(best, 1)


def dense_yolov7(raw: Sequence[torch.Tensor], nc: int, anchors: np.ndarray,
                 strides: Sequence[int]):
    """Raw maps -> (boxes (B, A, 4) xyxy input px, scores (B, A, nc), best
    class (B, A)), anchors flattened (h, w, a) within a level; ``anchors``
    (nl, na, 2)."""
    boxes, scores = [], []
    for m, s, anc in zip(raw, strides, anchors):
        B, h, w, _ = m.shape
        na = len(anc)
        sig = torch.sigmoid(m.float().reshape(B, h, w, na, 5 + nc))
        g = _grid(h, w, m.device)[:, :, None, :]
        wh_a = torch.as_tensor(np.asarray(anc, np.float32), device=m.device)
        xy = (sig[..., :2] * 2.0 - 0.5 + g) * s
        wh = (sig[..., 2:4] * 2.0) ** 2 * wh_a
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1)
                     .reshape(B, -1, 4))
        scores.append((sig[..., 4:5] * sig[..., 5:]).reshape(B, -1, nc))
    scores = torch.cat(scores, 1)
    return torch.cat(boxes, 1), scores, scores.argmax(-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


@dataclass
class Detections:
    """One image: kept detections by score (boxes xyxy in original pixels,
    scores, classes, their anchors) and every anchor's boxes (original
    pixels) and class scores, for judging detections that the NMS order
    alone set apart."""
    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    anchors: np.ndarray
    dense_boxes: torch.Tensor
    dense_scores: torch.Tensor


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor,
               classes: torch.Tensor, iou: float, max_det: int) -> List[int]:
    """Indices kept by greedy NMS over score-sorted candidates, class by
    class, at most ``max_det``."""
    over = ((iou_matrix(boxes, boxes) > iou)
            & (classes[:, None] == classes[None, :])).cpu().numpy()
    valid = (scores > 0).cpu().numpy()
    removed = np.zeros(len(valid), bool)
    keep = []
    for i in range(len(valid)):
        if not valid[i] or removed[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        removed |= over[i]
    return keep


def detect_image(boxes: torch.Tensor, scores: torch.Tensor,
                 cls: torch.Tensor, conf: float, iou: float, max_det: int,
                 topk: int, scale: float, pad) -> Detections:
    """One image's dense predictions (input px: boxes, class scores, best
    class) -> its ``Detections``."""
    best = scores.gather(-1, cls[:, None])[:, 0]
    gated = torch.where(best > conf, best, torch.zeros_like(best))
    order = torch.sort(gated, descending=True, stable=True).indices[:topk]
    keep = greedy_nms(boxes[order], gated[order], cls[order], iou, max_det)
    k = order[torch.as_tensor(keep, dtype=torch.long, device=order.device)]
    off = torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                       dtype=torch.float32, device=boxes.device)
    orig = (boxes - off) / scale
    return Detections(orig[k].cpu().numpy(), best[k].cpu().numpy(),
                      cls[k].cpu().numpy().astype(np.int64),
                      k.cpu().numpy(), orig, scores)
