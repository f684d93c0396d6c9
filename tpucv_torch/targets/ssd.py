"""SSD target assignment on the device (counterpart of
``tpucv/targets/ssd.py``), batched over images with tensor ops: the IoU of
every GT with every prior, threshold assignment, each GT forced onto its
best prior, and the variance encoding of the matched boxes.

Ties follow tpucv's jitted result: ``argmax`` takes the lowest index, and
where two GTs share a best prior, tpucv's duplicate-index scatter keeps the
later GT (XLA applies the updates in order), so the forced prior takes the
highest GT index that claims it (a max over the claimants). Divisions by
the variances are f32 reciprocal products, as XLA compiles them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tpucv_torch.ops.boxes import pairwise_iou


class SSDTargets(NamedTuple):
    loc: torch.Tensor       # (B, A, 4) encoded offsets, 0 for background
    cls: torch.Tensor       # (B, A) int32: 0 background, 1..nc class + 1
    pos_mask: torch.Tensor  # (B, A) bool


def _recip(v: float) -> float:
    """The f32 reciprocal of the f32 constant ``v``."""
    return float(torch.tensor(1.0) / torch.tensor(v))


def encode_boxes(gt_boxes: torch.Tensor, priors: torch.Tensor,
                 variances: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """xyxy GT boxes and xyxy priors -> (cx, cy, w, h) offsets."""
    g_cxy = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2
    g_wh = (gt_boxes[..., 2:] - gt_boxes[..., :2]).clamp(min=1e-8)
    p_cxy = (priors[..., :2] + priors[..., 2:]) / 2
    p_wh = (priors[..., 2:] - priors[..., :2]).clamp(min=1e-8)
    d_cxy = (g_cxy - p_cxy) / p_wh * _recip(variances[0])
    d_wh = torch.log(g_wh / p_wh) * _recip(variances[1])
    return torch.cat([d_cxy, d_wh], -1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """The inverse of ``encode_boxes``: offsets -> xyxy."""
    p_cxy = (priors[..., :2] + priors[..., 2:]) / 2
    p_wh = priors[..., 2:] - priors[..., :2]
    cxy = loc[..., :2] * variances[0] * p_wh + p_cxy
    wh = torch.exp(loc[..., 2:] * variances[1]) * p_wh
    return torch.cat([cxy - wh / 2, cxy + wh / 2], -1)


def assign_ssd_targets(
    gt_boxes: torch.Tensor,     # (B, M, 4) xyxy normalised to [0, 1]
    gt_labels: torch.Tensor,    # (B, M) int in [0, nc)
    gt_mask: torch.Tensor,      # (B, M) bool
    priors: torch.Tensor,       # (A, 4) xyxy normalised
    overlap_threshold: float = 0.5,
    variances: Sequence[float] = (0.1, 0.2),
) -> SSDTargets:
    """A prior is positive for the GT it overlaps best when that IoU is at
    least ``overlap_threshold``; every valid GT also claims its single best
    prior, whatever the IoU. Padded GT rows claim nothing."""
    B, M = gt_mask.shape
    A = priors.shape[0]
    gt_boxes = gt_boxes.float()
    iou = pairwise_iou(gt_boxes, priors)                        # (B, M, A)
    iou = torch.where(gt_mask[..., None], iou, torch.full_like(iou, -1.0))
    best_iou_per_prior, best_gt_per_prior = iou.max(1)          # (B, A)
    assigned = best_iou_per_prior >= overlap_threshold

    # each valid GT's best prior; padded rows go to the dropped slot A
    best_prior_per_gt = torch.where(
        gt_mask, iou.argmax(2), torch.full_like(gt_mask, A, dtype=torch.long))
    gt_ids = torch.arange(M, device=iou.device).expand(B, M)
    gt_of_forced = torch.full((B, A + 1), -1, dtype=torch.long,
                              device=iou.device).scatter_reduce_(
        1, best_prior_per_gt, gt_ids, "amax")[:, :A]
    forced = gt_of_forced >= 0
    gt_idx = torch.where(forced, gt_of_forced, best_gt_per_prior)
    pos = assigned | forced

    tgt_boxes = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    tgt_labels = torch.gather(gt_labels.long(), 1, gt_idx)
    loc = encode_boxes(tgt_boxes, priors, variances)
    loc = torch.where(pos[..., None], loc, torch.zeros_like(loc))
    cls = torch.where(pos, tgt_labels + 1,
                      torch.zeros_like(tgt_labels)).to(torch.int32)
    return SSDTargets(loc, cls, pos)
