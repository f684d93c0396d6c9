"""Box geometry (counterpart of ``tpucv/ops/boxes.py``): the conversions the
detection decode uses. The IoU family arrives with the training slice."""

from __future__ import annotations

import torch


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = False) -> torch.Tensor:
    """(l, t, r, b) distances + anchor centres -> boxes."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(bbox: torch.Tensor, anchor_points: torch.Tensor,
              reg_max: float) -> torch.Tensor:
    """Inverse of dist2bbox, clamped to reg_max-0.01."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    return d.clamp(0, reg_max - 0.01)
