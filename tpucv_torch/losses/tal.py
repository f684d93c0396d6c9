"""Task-aligned assigner (counterpart of ``tpucv/losses/tal.py``, its exact
path): fixed shapes, (B, M, A) masked tensor algebra over a static number
M of GT rows, no host sync.

tpucv takes an approximate top-k and a bf16 metric on the TPU only; off
the TPU it runs the f32 metric and the exact top-k, and that is the path
here. The exact top-k breaks ties by the lowest anchor index
(``lax.top_k``'s order), on the CPU and on CUDA alike: at initialisation
most metrics are 0, and which zero-metric anchors a GT takes decides the
assignment wherever a GT covers low-index anchors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpucv_torch.ops.boxes import pairwise_ciou


class TALResult(NamedTuple):
    target_labels: torch.Tensor   # (B, A) int32
    target_bboxes: torch.Tensor   # (B, A, 4) xyxy
    target_scores: torch.Tensor   # (B, A, nc)
    fg_mask: torch.Tensor         # (B, A) bool
    target_gt_idx: torch.Tensor   # (B, A) int32, assigned GT row (0 if !fg)


def select_candidates_in_gts(anc_points: torch.Tensor,
                             gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) anchor centres strictly inside (B, M, 4) xyxy GTs ->
    (B, M, A) bool."""
    x, y = anc_points[:, 0], anc_points[:, 1]                  # (A,)
    x1, y1, x2, y2 = (gt_bboxes[..., i, None] for i in range(4))  # (B,M,1)
    return ((x - x1 > eps) & (y - y1 > eps)
            & (x2 - x > eps) & (y2 - y > eps))


def select_highest_overlaps(
    mask_pos: torch.Tensor, overlaps: torch.Tensor, max_boxes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resolve anchors claimed by several GTs.

    An anchor claimed more than once takes the GT of the highest RAW
    overlap over all M rows, claimant or not (tpucv's faithful rule).
    ``argmax`` returns the first maximum, as ``jnp.argmax`` does.

    Args:
      mask_pos: (B, M, A) positive mask (float), overlaps: (B, M, A).
    Returns:
      target_gt_idx (B, A) int64, fg_mask (B, A) bool, mask_pos (B, M, A).
    """
    multi = mask_pos.sum(-2) > 1                                # (B, A)
    best_raw = overlaps.argmax(-2)                              # (B, A)
    rows = torch.arange(max_boxes, device=mask_pos.device)
    onehot_raw = (best_raw[:, None, :] == rows[:, None]).to(mask_pos.dtype)
    mask_pos = torch.where(multi[:, None, :], onehot_raw, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0
    best_gt = mask_pos.argmax(-2)
    return best_gt, fg_mask, mask_pos


def topk_mask(align: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, A) -> (B, M, A) bool marking each row's ``k`` largest
    entries, ties broken by the lowest index: a stable descending sort
    keeps equal values in index order, and the first ``k`` are marked by
    a scatter (a (B, M, k, A) one-hot would be 1.38 GB at B=128, M=32,
    A=8400)."""
    idx = torch.sort(align, dim=-1, descending=True, stable=True)[1][..., :k]
    mask = torch.zeros(align.shape, dtype=torch.bool, device=align.device)
    return mask.scatter_(-1, idx, True)


def task_aligned_assigner(
    pd_scores: torch.Tensor,
    pd_bboxes: torch.Tensor,
    anc_points: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    num_classes: int = 80,
    eps: float = 1e-9,
) -> TALResult:
    """Assign GTs to anchors by the task-aligned metric s^alpha * iou^beta.

    Args:
      pd_scores: (B, A, nc) sigmoid class scores.
      pd_bboxes: (B, A, 4) xyxy predictions (same units as gt_bboxes).
      anc_points: (A, 2) anchor centres (same units).
      gt_labels: (B, M) int, gt_bboxes: (B, M, 4) xyxy,
      gt_mask: (B, M) bool; False rows are padding.
    """
    B, A, nc = pd_scores.shape
    M = gt_labels.shape[1]
    gt_labels = gt_labels.long()

    # each GT's class score at every anchor: a gather over the class axis,
    # equal to tpucv's one-hot contraction (one nonzero term)
    lab = gt_labels.clamp(0, nc - 1)
    gt_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                             lab[..., None].expand(B, M, A))   # (B, M, A)
    overlaps = pairwise_ciou(gt_bboxes, pd_bboxes).clamp(min=0)
    align = gt_scores ** alpha * overlaps ** beta

    valid = (select_candidates_in_gts(anc_points, gt_bboxes, eps)
             & gt_mask[..., None])
    align = torch.where(valid, align, torch.zeros((), dtype=align.dtype,
                                                  device=align.device))

    # each real GT keeps its top-k anchors with no metric threshold, so
    # zero-metric anchors can be tie-selected; the invalid ones die here
    mask_pos = (topk_mask(align, min(topk, A)) & valid).to(align.dtype)

    best_gt, fg_mask, mask_pos = select_highest_overlaps(
        mask_pos, overlaps, M)

    # after the best-claim select each anchor column of mask_pos has at most
    # one nonzero, so the targets are gathers at best_gt, 0 where !fg
    tl = torch.where(fg_mask, torch.gather(gt_labels, 1, best_gt), 0)
    tb = torch.where(fg_mask[..., None],
                     torch.gather(gt_bboxes, 1,
                                  best_gt[..., None].expand(B, A, 4)),
                     torch.zeros((), dtype=gt_bboxes.dtype,
                                 device=gt_bboxes.device))

    # normalised target scores
    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)                    # (B, M, 1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm_align = (align * pos_overlap / (pos_align + eps)).amax(-2)  # (B, A)

    classes = torch.arange(num_classes, device=tl.device)
    scores_onehot = (tl[..., None] == classes).to(pd_scores.dtype)
    target_scores = scores_onehot * (norm_align * fg_mask)[..., None]

    return TALResult(tl.int(), tb, target_scores, fg_mask,
                     torch.where(fg_mask, best_gt, 0).int())
