"""The least time of one greedy NMS over score-sorted candidates, on an
H100, counted from its inputs whatever implements it.

Bytes: the boxes (16 B) and scores (4 B) read once and the keep mask
(1 B) written once, for each of the B·K candidates, over the HBM rate.
Operations: each valid candidate is tested against the kept candidates
above it, up to the first that suppresses it (an IoU is 14 float32
operations: per axis a min, a max, a subtraction and a clamp, then a
product, a sum, a difference, a sum, a division and a comparison), plus
5 for each valid candidate's area; over the float32 rate outside the
tensor cores. The least time is the larger of the two. The keep set is
the benchmark's own (``keep``), not the program's.
"""

from __future__ import annotations

import torch

from benchmark.common import H100_FP32_FLOPS, H100_HBM_BYTES_PER_S

IOU_OPS = 14
AREA_OPS = 5


def iou_above(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, K) IoU of every pair of (B, K, 4) xyxy boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix = (torch.minimum(x2[:, :, None], x2[:, None]) -
          torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
    iy = (torch.minimum(y2[:, :, None], y2[:, None]) -
          torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
    inter = ix * iy
    return inter / (area[:, :, None] + area[:, None] - inter + 1e-7)


def keep(iou: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy keep mask (B, K): candidate i is kept when valid and no kept
    candidate above it overlaps it above ``thr``; iterated to its fixed
    point (each sweep settles at least one more candidate)."""
    K = scores.shape[-1]
    above = torch.ones(K, K, dtype=torch.bool, device=iou.device).tril(-1)
    over = (iou > thr) & above                    # [b, i, j]: j above i
    valid = scores > 0
    kept = valid.clone()
    for _ in range(K):
        nxt = valid & ~(over & kept[:, None, :]).any(-1)
        if torch.equal(nxt, kept):
            break
        kept = nxt
    return kept


def least_s(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> float:
    """Least seconds for the keep mask of (B, K, 4) boxes and (B, K)
    scores sorted by score."""
    B, K = scores.shape
    nbytes = B * K * (16 + 4 + 1)
    iou = iou_above(boxes.float())
    kept = keep(iou, scores, thr)
    above = torch.ones(K, K, dtype=torch.bool, device=iou.device).tril(-1)
    cand = above & kept[:, None, :]
    tested = cand.cumsum(-1)
    hit = cand & (iou > thr)
    first = hit.float().argmax(-1, keepdim=True)
    n_tests = torch.where(hit.any(-1), tested.gather(-1, first)[..., 0],
                          tested[..., -1])
    valid = scores > 0
    ops = int((n_tests * valid).sum()) * IOU_OPS + int(valid.sum()) * AREA_OPS
    return max(nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_FLOPS)
