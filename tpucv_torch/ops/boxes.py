"""Box geometry (counterpart of ``tpucv/ops/boxes.py``): the conversions
the detection decode uses and the IoU family the losses and the assigner
use, in XLA's expression trees (the same ``eps`` placements, ``4 / pi^2``,
``rho2 / 4``)."""

from __future__ import annotations

import math

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


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix between (..., M, 4) and (..., N, 4) xyxy boxes ->
    (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             giou: bool = False, diou: bool = False, ciou: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU with the GIoU / DIoU / CIoU variants. Shapes
    broadcast; returns (...). CIoU's ``alpha`` carries no gradient."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1

    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             .clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
             .clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area

    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((b2x1 + b2x2) - (b1x1 + b1x2)) ** 2
            + ((b2y1 + b2y2) - (b1y1 + b1y2)) ** 2) / 4
    if diou:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def pairwise_ciou(gt: torch.Tensor, pd: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """CIoU matrix between (B, M, 4) GTs and (B, A, 4) preds -> (B, M, A).

    The expression tree of ``bbox_iou(gt[:, :, None], pd[:, None],
    ciou=True)``, with every per-box term (areas, the two arctans, the
    centre sums) computed once at its (B, M) or (B, A) shape and
    broadcast: M + A arctans an image, not 2 * M * A."""
    gx1, gy1, gx2, gy2 = gt.unbind(-1)                       # (B, M)
    px1, py1, px2, py2 = pd.unbind(-1)                       # (B, A)
    gw, gh = gx2 - gx1, gy2 - gy1
    pw, ph = px2 - px1, py2 - py1
    g_area, p_area = gw * gh, pw * ph
    g_atan, p_atan = torch.atan(gw / (gh + eps)), torch.atan(pw / (ph + eps))
    gcx, pcx, gcy, pcy = gx1 + gx2, px1 + px2, gy1 + gy2, py1 + py2

    gx1, gy1, gx2, gy2 = (v[:, :, None] for v in (gx1, gy1, gx2, gy2))
    px1, py1, px2, py2 = (v[:, None] for v in (px1, py1, px2, py2))
    inter = ((torch.minimum(gx2, px2) - torch.maximum(gx1, px1)).clamp(min=0)
             * (torch.minimum(gy2, py2) - torch.maximum(gy1, py1))
             .clamp(min=0))
    union = g_area[:, :, None] + p_area[:, None] - inter + eps
    iou = inter / union
    cw = torch.maximum(gx2, px2) - torch.minimum(gx1, px1)
    ch = torch.maximum(gy2, py2) - torch.minimum(gy1, py1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((pcx[:, None] - gcx[:, :, None]) ** 2
            + (pcy[:, None] - gcy[:, :, None]) ** 2) / 4
    v = (4 / math.pi ** 2) * (p_atan[:, None] - g_atan[:, :, None]) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
