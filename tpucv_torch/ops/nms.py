"""Fixed-shape exact greedy NMS (counterpart of ``tpucv/ops/nms.py``).

Every engine takes a fixed candidate count and returns a fixed ``max_det``
slate with a validity mask; class-awareness uses the coordinate-offset
trick. ``dispatch_batched_nms`` is the one home of the engine policy. Two
engines, each one launch a batch on the card: ``nms_keep``
(``cuda_nms.py``, the keep mask, K <= 1,024) and ``nms_scan``
(``cuda_scan.py``, the sequential scan, K <= 4,096, and the only one
with CenterNet's DIoU); on CPU tensors each runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpucv_torch.ops.boxes import xywh2xyxy
from tpucv_torch.ops.cuda_nms import (MAX_BOXES, select_kept, cuda_nms,
                                      nms_keep_reference)
from tpucv_torch.ops.cuda_scan import nms_scan
from tpucv_torch.utils.profile import span


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    diou: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over N xyxy boxes by sequential scan (``nms_scan``: one
    kernel launch for the batch on the card, N <= 4,096). With
    ``diou=True`` the criterion is distance-IoU (CenterNet's).

    boxes (N, 4), scores (N,) with invalid candidates <= 0, or a batch of
    them, (B, N, 4) and (B, N), scanned together (tpucv vmaps its scan).
    Returns (indices ([B,] max_det) int32, valid ([B,] max_det) bool)."""
    if boxes.dim() == 3:
        return nms_scan(boxes, scores, iou_threshold, max_det, diou)
    idx, valid = nms_scan(boxes[None], scores[None], iou_threshold, max_det,
                          diou)
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

    * K <= 1024: ``cuda_nms`` — the keep-mask kernels (``nms_keep``) on a
      CUDA tensor, their plain version on a CPU tensor;
    * K > 1024 (evaluation floods at conf 0.001, YOLOv7's 4,096):
      ``nms_scan``, the sequential scan, which never builds the (K, K)
      matrix — its kernel on a CUDA tensor (K <= 4,096), its plain
      version on a CPU tensor.

    Returns (idx (B, max_det) into the K axis, valid (B, max_det)).
    Either engine runs in the span ``tpucv.nms``; ``nms_keep.launches``
    and ``nms_scan.launches`` tell them apart."""
    K = top_scores.shape[-1]
    with span("tpucv.nms"):
        if K > MAX_BOXES:
            return nms_scan(off_boxes, top_scores, iou_threshold, max_det)
        return cuda_nms(off_boxes, top_scores, iou_threshold, max_det,
                        presorted=True)


def batched_single_label_nms(
    pred: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.7,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    class_agnostic: bool = False,
    xywh: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Batched best-class NMS over (B, A, 4+nc) boxes in pixels (cx, cy,
    w, h; with ``xywh=False`` already x1, y1, x2, y2) and class scores.
    Each anchor offers its best class (the lowest index on ties) gated at
    ``conf_threshold``; the top ``pre_nms_topk`` by score (lowest anchor
    first on ties, as ``lax.top_k`` orders them), as xyxy, offset by
    class x 7680 px unless ``class_agnostic``, go through
    ``dispatch_batched_nms`` for the whole batch: ``nms_keep`` (one launch)
    at K <= 1024, ``nms_scan`` (one launch) above.

    Returns fixed-shape (boxes (B, max_det, 4) xyxy, scores, classes
    int32, valid)."""
    cls_scores = pred[..., 4:]
    best_score = cls_scores.amax(-1)
    best_cls = cls_scores.argmax(-1).to(torch.int32)
    gated = torch.where(best_score > conf_threshold, best_score,
                        torch.zeros_like(best_score))
    k = min(pre_nms_topk, gated.shape[1])
    top_scores, top_idx = torch.sort(gated, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k].contiguous(), top_idx[:, :k]
    top_boxes = torch.gather(pred[..., :4], 1,
                             top_idx[..., None].expand(-1, -1, 4))
    if xywh:
        top_boxes = xywh2xyxy(top_boxes)
    top_cls = torch.gather(best_cls, 1, top_idx)
    return class_offset_nms(top_boxes, top_scores, top_cls, conf_threshold,
                            iou_threshold, max_det, class_agnostic)[:4]


def batched_non_max_suppression(
    pred: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 2048,
    class_agnostic: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """YOLO-style decode-and-suppress over a batch of (B, A, 4+nc)
    predictions: xywh boxes in pixels and per-class scores in [0, 1]
    (tpucv's ``non_max_suppression`` vmapped). The best class gated at
    ``conf_threshold``, the top ``pre_nms_topk``, xywh -> xyxy, class-aware
    (or agnostic) exact greedy NMS, capped at ``max_det``, re-gated and
    the invalid slots zeroed: ``batched_single_label_nms`` with tpucv's
    defaults. At K = min(pre_nms_topk, A) <= 1024 the whole batch is one
    ``nms_keep`` launch on the card; above, one ``nms_scan`` launch.

    Returns (boxes (B, max_det, 4) xyxy, scores, classes int32, valid)."""
    return batched_single_label_nms(pred, conf_threshold, iou_threshold,
                                    max_det, pre_nms_topk, class_agnostic)


def non_max_suppression(
    pred: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 2048,
    class_agnostic: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``batched_non_max_suppression`` of one image's (A, 4+nc)
    predictions: (boxes (max_det, 4) xyxy, scores, classes, valid)."""
    out = batched_non_max_suppression(pred[None], conf_threshold,
                                      iou_threshold, max_det, pre_nms_topk,
                                      class_agnostic)
    return tuple(t[0] for t in out)


def class_offset_nms(top_boxes: torch.Tensor, top_scores: torch.Tensor,
                     top_cls: torch.Tensor, conf_threshold: float,
                     iou_threshold: float, max_det: int,
                     class_agnostic: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """Score-sorted (B, K) candidates, offset by class x 7680 px (unless
    ``class_agnostic``), through ``dispatch_batched_nms``; the kept ones
    gathered into fixed-shape (boxes, scores, classes, valid), valid only
    above ``conf_threshold`` and zero elsewhere, and their positions on
    the K axis (B, max_det) int64 as a fifth (the YOLOv8 decode gathers
    each kept detection's anchor with them)."""
    off = top_boxes if class_agnostic else \
        top_boxes + top_cls[..., None].to(top_boxes.dtype) * 7680.0
    idx, valid = dispatch_batched_nms(off, top_scores, iou_threshold,
                                      max_det)
    idx = idx.long()
    out_boxes = torch.gather(top_boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, idx)
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    out_cls = torch.gather(top_cls, 1, idx)
    valid = valid & (out_scores > conf_threshold)
    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    return out_boxes, out_scores, out_cls, valid, idx


def batched_non_max_suppression_multilabel(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    max_det: int = 100,
    pre_nms_topk: int = 1024,
) -> Tuple[torch.Tensor, ...]:
    """Per-class NMS over (B, A, 4) xyxy boxes and (B, A, nc) class
    probabilities, SSD's: every (anchor, class) pair above
    ``conf_threshold`` is a candidate of its own. The flattened (A, nc)
    scores gated at ``conf_threshold``, the top ``min(pre_nms_topk, A·nc)``
    by score (lowest flat index first on ties, as ``lax.top_k`` orders
    them), anchor = index // nc and class = index % nc, the anchor's box
    offset by class x 7680 px, then ``dispatch_batched_nms`` (SSD's K =
    1,024: ``nms_keep``). The candidates are already in score order, so the
    keep set is that of tpucv's ``nms_fixpoint``, which sorts them again
    stably.

    Returns fixed-shape (boxes (B, max_det, 4) xyxy, scores, classes
    int32, valid)."""
    B, A, nc = cls_scores.shape
    flat = torch.where(cls_scores > conf_threshold, cls_scores,
                       torch.zeros_like(cls_scores)).reshape(B, -1)
    k = min(pre_nms_topk, A * nc)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k].contiguous(), top_idx[:, :k]
    anchor = top_idx // nc
    cls = (top_idx % nc).to(torch.int32)
    cand = torch.gather(boxes, 1, anchor[..., None].expand(-1, -1, 4))
    return class_offset_nms(cand, top_scores, cls, conf_threshold,
                            iou_threshold, max_det)[:4]
