"""Fixed-shape exact greedy NMS (counterpart of ``tpucv/ops/nms.py``).

Every engine takes a fixed candidate count and returns a fixed ``max_det``
slate with a validity mask; class-awareness uses the coordinate-offset
trick. ``dispatch_batched_nms`` is the one home of the engine policy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpucv_torch.ops.cuda_nms import (NEG_INF, MAX_BOXES, select_kept,
                                      cuda_nms, nms_keep_reference)


def _nms_scan(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, max_det: int,
              diou: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sequential greedy: (B, N, 4), (B, N) -> (B, max_det) x2.
    Each step takes the best live candidate and kills what it overlaps —
    O(max_det * N) memory-light work, for candidate floods."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    live = torch.where(scores > 0, scores, torch.full_like(scores, NEG_INF))
    bi = torch.arange(boxes.shape[0], device=boxes.device)
    idxs, valids = [], []
    for _ in range(max_det):
        best = live.argmax(-1)                                 # (B,)
        at = lambda v: v[bi, best][:, None]                    # noqa: E731
        valids.append(at(live)[:, 0] > NEG_INF / 2)
        inter = ((torch.minimum(at(x2), x2) - torch.maximum(at(x1), x1))
                 .clamp(min=0) *
                 (torch.minimum(at(y2), y2) - torch.maximum(at(y1), y1))
                 .clamp(min=0))
        iou = inter / (at(areas) + areas - inter + 1e-7)
        if diou:
            cw = torch.maximum(at(x2), x2) - torch.minimum(at(x1), x1)
            ch = torch.maximum(at(y2), y2) - torch.minimum(at(y1), y1)
            rho2 = (at(cx) - cx) ** 2 + (at(cy) - cy) ** 2
            iou = iou - rho2 / (cw ** 2 + ch ** 2 + 1e-7)
        live = torch.where(iou > iou_threshold,
                           torch.full_like(live, NEG_INF), live)
        live[bi, best] = NEG_INF
        idxs.append(best.to(torch.int32))
    return torch.stack(idxs, 1), torch.stack(valids, 1)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    diou: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over N xyxy boxes by sequential scan. With ``diou=True``
    the criterion is distance-IoU (CenterNet's).

    boxes (N, 4), scores (N,) with invalid candidates <= 0.
    Returns (indices (max_det,) int32, valid (max_det,) bool)."""
    idx, valid = _nms_scan(boxes[None], scores[None], iou_threshold,
                           max_det, diou)
    return idx[0], valid[0]


def nms_fixpoint(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    max_iters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS via the suppression-wave fixpoint on score-sorted
    candidates (boxes (N, 4), scores (N,)). Returns (indices into the input
    (max_det,), valid (max_det,))."""
    order = torch.sort(scores, descending=True, stable=True).indices[None]
    keep = nms_keep_reference(boxes[order[0]][None], scores[order],
                              iou_threshold, max_iters)
    idx, valid = select_kept(keep, scores[order], order, max_det)
    return idx[0], valid[0]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    class_agnostic: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS via the coordinate-offset trick (torchvision
    ``batched_nms`` semantics). ``boxes`` xyxy, coords assumed < ~7680."""
    if not class_agnostic:
        boxes = boxes + class_ids.to(boxes.dtype)[:, None] * 7680.0
    return nms_fixpoint(boxes, scores, iou_threshold, max_det)


def dispatch_batched_nms(off_boxes: torch.Tensor, top_scores: torch.Tensor,
                         iou_threshold: float, max_det: int):
    """Pick the exact-NMS engine for presorted (B, K) candidates:

    * K <= 1024: ``cuda_nms`` — the CUDA kernel on a CUDA tensor, its plain
      version on a CPU tensor;
    * K > 1024 (evaluation floods at conf 0.001): the sequential scan,
      which never builds the (K, K) matrix.

    Returns (idx (B, max_det) into the K axis, valid (B, max_det))."""
    K = top_scores.shape[-1]
    if K > MAX_BOXES:
        return _nms_scan(off_boxes, top_scores, iou_threshold, max_det,
                         diou=False)
    return cuda_nms(off_boxes, top_scores, iou_threshold, max_det,
                    presorted=True)
