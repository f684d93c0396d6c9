"""YOLOv8's detection loss in plain PyTorch, float32: the task-aligned
assigner (TAL: metric s^0.5 · CIoU^6, the top 10 anchors a GT among the
anchors whose centres lie inside it, an anchor claimed twice going to the
GT it overlaps most), BCE on the classes against the normalised aligned
targets, CIoU on the boxes and the distribution focal loss, with
ultralytics' gains (box 7.5, cls 0.5, dfl 1.5), the total times the batch.

Written from ultralytics' ``v8DetectionLoss`` and ``TaskAlignedAssigner``
at fixed shapes: the GTs padded to M rows with a mask. Departures from
ultralytics, shared with the measured program: the top-k takes every
real GT's 10 best anchors with no threshold on the metric (ties to the
lower anchor index), and an anchor claimed twice goes to the highest
CIoU over all M rows.
"""

from __future__ import annotations

import math

import torch


def ciou(b1: torch.Tensor, b2: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise CIoU of xyxy boxes (broadcasting)."""
    b1x1, b1y1, b1x2, b1y2 = b1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = b2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = iw * ih
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((b2x1 + b2x2) - (b1x1 + b1x2)) ** 2
            + ((b2y1 + b2y2) - (b1y1 + b1y2)) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def assign(scores, boxes, points, gt_labels, gt_boxes, gt_mask, nc,
           topk=10, alpha=0.5, beta=6.0, eps=1e-9):
    """TAL over (B, A, nc) scores, (B, A, 4) boxes and (A, 2) anchor
    points, all in input pixels, and (B, M) GTs. Returns (target boxes
    (B, A, 4), target scores (B, A, nc), foreground (B, A))."""
    B, A, _ = scores.shape
    M = gt_labels.shape[1]
    lab = gt_labels.long().clamp(0, nc - 1)
    s = torch.gather(scores.transpose(1, 2), 1, lab[..., None].expand(B, M, A))
    overlaps = ciou(gt_boxes[:, :, None, :], boxes[:, None, :, :]).clamp(min=0)
    align = s ** alpha * overlaps ** beta
    x, y = points[:, 0], points[:, 1]
    g = [gt_boxes[..., i, None] for i in range(4)]
    inside = (x - g[0] > eps) & (y - g[1] > eps) & (g[2] - x > eps) \
        & (g[3] - y > eps)
    valid = inside & gt_mask[..., None]
    align = torch.where(valid, align, torch.zeros_like(align))
    top = torch.sort(align, dim=-1, descending=True, stable=True).indices
    top = top[..., :min(topk, A)]
    pos = torch.zeros_like(valid).scatter_(-1, top, True) & valid
    pos = pos.float()
    multi = pos.sum(1) > 1                                       # (B, A)
    best_raw = overlaps.argmax(1)
    onehot = (best_raw[:, None, :] == torch.arange(M, device=pos.device)
              [:, None]).float()
    pos = torch.where(multi[:, None, :], onehot, pos)
    fg = pos.sum(1) > 0
    best = pos.argmax(1)                                         # (B, A)
    tl = torch.where(fg, torch.gather(gt_labels.long(), 1, best), 0)
    tb = torch.where(fg[..., None],
                     torch.gather(gt_boxes, 1,
                                  best[..., None].expand(B, A, 4)),
                     torch.zeros((), device=pos.device))
    align = align * pos
    norm = (align * (overlaps * pos).amax(-1, keepdim=True)
            / (align.amax(-1, keepdim=True) + eps)).amax(1)      # (B, A)
    onehot_cls = (tl[..., None] == torch.arange(nc, device=pos.device)).float()
    return tb, onehot_cls * (norm * fg)[..., None], fg


def anchors(shapes, strides, dev):
    pts, st = [], []
    for (h, w), s in zip(shapes, strides):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        st.append(torch.full((h * w, 1), float(s), device=dev))
    return torch.cat(pts), torch.cat(st)


def yolov8_loss(raw, gt_labels, gt_boxes, gt_mask, nc=80, reg_max=16,
                strides=(8, 16, 32), box_gain=7.5, cls_gain=0.5,
                dfl_gain=1.5, topk=10):
    """The scalar training loss of a batch (raw maps NHWC; GTs xyxy in
    input pixels)."""
    B = raw[0].shape[0]
    dev = raw[0].device
    points, stride = anchors([m.shape[1:3] for m in raw], strides, dev)
    x = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw], 1).float()
    dist_logits, cls_logits = x[..., :4 * reg_max], x[..., 4 * reg_max:]
    proj = torch.arange(reg_max, dtype=torch.float32, device=dev)
    logits4 = dist_logits.reshape(B, -1, 4, reg_max)
    dist = torch.softmax(logits4, -1) @ proj
    pred = torch.cat([points - dist[..., :2], points + dist[..., 2:]], -1)
    scores = torch.sigmoid(cls_logits)
    tb, ts, fg = assign(scores.detach(), (pred * stride).detach(),
                        points * stride, gt_labels, gt_boxes.float(),
                        gt_mask, nc, topk)
    tb = tb / stride
    tss = ts.sum().clamp(min=1.0)
    bce = cls_logits.clamp(min=0) - cls_logits * ts \
        + torch.log1p(torch.exp(-cls_logits.abs()))
    loss_cls = bce.sum() / tss
    weight = ts.sum(-1)
    zero = torch.zeros((), device=dev)
    loss_box = torch.where(fg, (1.0 - ciou(pred, tb)) * weight,
                           zero).sum() / tss
    t = torch.cat([points - tb[..., :2], tb[..., 2:] - points], -1) \
        .clamp(0, reg_max - 1 - 0.01)
    j = torch.arange(reg_max, dtype=torch.float32, device=dev)
    hat = (1.0 - (t[..., None] - j).abs()).clamp(min=0.0)
    dfl = (torch.logsumexp(logits4, -1) - (logits4 * hat).sum(-1)).mean(-1)
    loss_dfl = torch.where(fg, dfl * weight, zero).sum() / tss
    return (box_gain * loss_box + cls_gain * loss_cls
            + dfl_gain * loss_dfl) * B
