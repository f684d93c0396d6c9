"""YOLOv8 detection loss: TAL assignment + BCE cls + CIoU + DFL
(counterpart of ``tpucv/losses/yolov8.py``).

Targets arrive padded to a fixed shape: (B, M) labels, (B, M, 4) xyxy
boxes in input pixels and a (B, M) mask. The raw maps may be bf16 (the
forward under autocast); the loss casts them to f32 and runs in f32, as
tpucv does off the TPU.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from tpucv_torch.losses.common import sigmoid_bce
from tpucv_torch.losses.tal import task_aligned_assigner
from tpucv_torch.nn.heads import dfl_project
from tpucv_torch.ops.anchors import make_anchors
from tpucv_torch.ops.boxes import bbox2dist, bbox_iou, dist2bbox


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss in tpucv's hat form.

    pred_dist: (..., 4, reg_max) logits; target: (..., 4) continuous in
    [0, reg_max-1]. Returns (...,), the mean over the 4 sides. With
    wl + wr = 1, -(logp[tl]*wl + logp[tr]*wr) = logsumexp(x) - sum_j x_j *
    relu(1 - |t - j|)."""
    reg_max = pred_dist.shape[-1]
    j = torch.arange(reg_max, dtype=target.dtype, device=target.device)
    hat = (1.0 - (target[..., None] - j).abs()).clamp(min=0.0)
    pick = (pred_dist * hat).sum(-1)
    lse = torch.logsumexp(pred_dist, dim=-1)
    return (lse - pick).mean(-1)


def yolov8_loss(
    raw_maps: Sequence[torch.Tensor],
    gt_labels: torch.Tensor,
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    nc: int = 80,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
    tal_topk: int = 10,
    return_aux: bool = False,
):
    """The YOLOv8 training loss.

    Args:
      raw_maps: per-level (B, H, W, 4*reg_max+nc) raw head outputs.
      gt_labels: (B, M) int; gt_bboxes: (B, M, 4) xyxy in input pixels;
      gt_mask: (B, M) bool.
    Returns:
      (scalar total loss, dict of unweighted components); the total is
      scaled by the batch size. With ``return_aux`` a third dict holds the
      assignment (fg anchors, their GT rows, per-anchor weights, the
      normaliser and the assigned boxes in input pixels).
    """
    B = raw_maps[0].shape[0]
    dev = raw_maps[0].device
    feat_shapes = [m.shape[1:3] for m in raw_maps]
    anchor_points, stride_arr = make_anchors(feat_shapes, strides,
                                             device=dev)   # (A,2), (A,1)

    flat = [m.reshape(B, -1, m.shape[-1]) for m in raw_maps]
    x = torch.cat(flat, 1).float()                            # (B, A, no)
    pred_dist_logits = x[..., : 4 * reg_max]                  # (B, A, 64)
    pred_cls_logits = x[..., 4 * reg_max:]                    # (B, A, nc)
    pred_scores = torch.sigmoid(pred_cls_logits)

    # boxes at feature scale (grid units)
    dist = dfl_project(pred_dist_logits, reg_max)
    pred_bboxes = dist2bbox(dist, anchor_points[None])        # (B, A, 4)

    # the assigner works in pixels, on inputs that carry no gradient
    assigned = task_aligned_assigner(
        pred_scores.detach(), (pred_bboxes * stride_arr[None]).detach(),
        anchor_points * stride_arr, gt_labels, gt_bboxes.float(), gt_mask,
        topk=tal_topk, num_classes=nc)
    target_bboxes = assigned.target_bboxes / stride_arr[None]  # grid units
    target_scores = assigned.target_scores
    fg = assigned.fg_mask
    tss = target_scores.sum().clamp(min=1.0)

    # cls: BCE with soft targets, sum / target_scores_sum
    loss_cls = sigmoid_bce(pred_cls_logits, target_scores).sum() / tss

    # box: CIoU weighted by each anchor's target-score weight
    weight = target_scores.sum(-1)                             # (B, A)
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, ciou=True)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    loss_box = torch.where(fg, (1.0 - iou) * weight, zero).sum() / tss

    # dfl
    target_ltrb = bbox2dist(target_bboxes, anchor_points[None], reg_max - 1)
    df = _df_loss(pred_dist_logits.reshape(B, -1, 4, reg_max), target_ltrb)
    loss_dfl = torch.where(fg, df * weight, zero).sum() / tss

    total = (box_gain * loss_box + cls_gain * loss_cls
             + dfl_gain * loss_dfl) * B
    metrics: Dict[str, torch.Tensor] = {
        "box_loss": loss_box, "cls_loss": loss_cls, "dfl_loss": loss_dfl,
        "num_fg": fg.sum().float(),
    }
    if return_aux:
        aux = {"fg": fg, "gt_idx": assigned.target_gt_idx, "weight": weight,
               "tss": tss, "target_bboxes_px": assigned.target_bboxes}
        return total, metrics, aux
    return total, metrics
