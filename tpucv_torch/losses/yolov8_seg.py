"""YOLOv8 instance-segmentation loss (counterpart of
``tpucv/losses/yolov8_seg.py``): the detection loss plus a per-instance
mask BCE, fixed shapes.

Semantics follow ultralytics v8-seg: each foreground anchor's predicted
mask (sigmoid of its coefficients against the prototypes) is trained
with BCE against the assigned GT's instance mask, cropped to the GT box
and normalised by the box area. As in tpucv, only the top ``mask_topk``
foreground anchors of each image (by assignment weight) are taken, so the
mask logits are (B, K, Hm, Wm) and not (B, A, Hm, Wm).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from tpucv_torch.losses.common import sigmoid_bce
from tpucv_torch.losses.yolov8 import yolov8_loss


def topk_foreground(aux: Dict[str, torch.Tensor], k: int):
    """The ``k`` anchors of each image with the largest assignment
    weight, foreground first: ``lax.top_k`` over where(fg, weight, -1),
    ties (every background anchor at -1) to the lowest index, as the
    assigner's ``topk_mask`` breaks them. Returns (top_idx (B, k) int64,
    valid (B, k) bool: a foreground anchor with a positive weight)."""
    score = torch.where(aux["fg"], aux["weight"],
                        torch.full_like(aux["weight"], -1.0))
    top_w, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
    return top_idx[:, :k], top_w[:, :k] > 0.0


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, *rest), idx (B, K) -> (B, K, *rest)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def yolov8_seg_loss(
    raw: Tuple,
    gt_labels: torch.Tensor,        # (B, M)
    gt_bboxes: torch.Tensor,        # (B, M, 4) xyxy px
    gt_mask: torch.Tensor,          # (B, M)
    gt_inst_masks: torch.Tensor,    # (B, M, Hm, Wm) {0,1} at proto resolution
    nc: int = 80,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
    mask_gain: float = 2.5,
    tal_topk: int = 10,
    mask_topk: int = 64,
):
    """(total, metrics): the detection loss's total plus
    ``mask_gain * mask_loss * B``, and its metrics plus ``mask_loss``. The
    mask term runs in f32 with autocast off."""
    det_maps, coef_maps, protos = raw
    B = det_maps[0].shape[0]
    Hm, Wm, nm = protos.shape[1:]
    dev = protos.device
    # input pixels per axis, kept apart for rectangular inputs
    Sh = strides[0] * det_maps[0].shape[1]
    Sw = strides[0] * det_maps[0].shape[2]

    det_total, metrics, aux = yolov8_loss(
        det_maps, gt_labels, gt_bboxes, gt_mask, nc=nc, reg_max=reg_max,
        strides=strides, box_gain=box_gain, cls_gain=cls_gain,
        dfl_gain=dfl_gain, tal_topk=tal_topk, return_aux=True)

    with torch.autocast(dev.type, enabled=False):
        coefs = torch.cat([m.reshape(B, -1, nm) for m in coef_maps], 1)
        top_idx, valid = topk_foreground(aux, min(mask_topk, coefs.shape[1]))
        sel_coefs = gather_rows(coefs, top_idx).float()          # (B, K, nm)
        sel_gt = gather_rows(aux["gt_idx"].long(), top_idx)      # (B, K)
        sel_boxes = gather_rows(aux["target_bboxes_px"].float(), top_idx)

        pred = torch.einsum("bkn,bhwn->bkhw", sel_coefs, protos.float())
        # the assigned GT's mask: tpucv's one-hot contraction over M has
        # one nonzero term, so it equals this gather exactly
        tgt = gather_rows(gt_inst_masks, sel_gt).float()        # (B,K,Hm,Wm)
        bce = sigmoid_bce(pred, tgt)

        # crop to the assigned box at proto resolution; normalise by area
        bx = sel_boxes * torch.tensor([Wm / Sw, Hm / Sh, Wm / Sw, Hm / Sh],
                                      dtype=torch.float32, device=dev)
        cx = torch.arange(Wm, dtype=torch.float32, device=dev)
        cy = torch.arange(Hm, dtype=torch.float32, device=dev)[:, None]
        x1, y1, x2, y2 = (bx[..., i, None, None] for i in range(4))
        inside = (cx >= x1) & (cx < x2) & (cy >= y1) & (cy < y2)
        area = ((x2 - x1) * (y2 - y1)).clamp(min=1.0)[..., 0, 0]  # (B, K)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        per_anchor = torch.where(inside, bce, zero).sum((-2, -1)) / area
        n_valid = valid.sum().float().clamp(min=1.0)
        loss_mask = torch.where(valid, per_anchor, zero).sum() / n_valid

    total = det_total + mask_gain * loss_mask * B
    metrics = dict(metrics)
    metrics["mask_loss"] = loss_mask
    return total, metrics
