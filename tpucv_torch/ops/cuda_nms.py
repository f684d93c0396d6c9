"""Greedy NMS through the hand-written CUDA kernel ``csrc/nms.cu`` — the
counterpart of ``tpucv/ops/pallas_nms.py`` (``pallas_nms_keep`` and
``pallas_nms``, which launch the Pallas ``_nms_kernel``).

``nms_keep`` is the kernel's wrapper: on a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs
``nms_keep_reference``, the plain PyTorch version of the same function
(the vectorised suppression-wave fixpoint of ``nms_fixpoint``).
``cuda_nms`` is the ``pallas_nms``-shaped wrapper around it: sort (unless
presorted), keep mask, top-``max_det`` selection.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e10
MAX_BOXES = 1024            # the kernel's shared-memory mask holds K <= 1024


def nms_keep_reference(boxes_sorted: torch.Tensor,
                       scores_sorted: torch.Tensor,
                       iou_threshold: float = 0.45,
                       max_iters: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch greedy keep mask: (B, K, 4) xyxy f32 boxes sorted by
    score, (B, K) f32 scores (<= 0 invalid) -> (B, K) bool.

    Box i is suppressed iff some higher-ranked *kept* box overlaps it with
    IoU > threshold; the wave runs to fixpoint (at most K sweeps, the
    deepest possible chain), which is the exact greedy keep-set."""
    K = scores_sorted.shape[-1]
    if max_iters is None:
        max_iters = K
    x1, y1, x2, y2 = boxes_sorted.unbind(-1)                 # (B, K)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix = (torch.minimum(x2[:, :, None], x2[:, None]) -
          torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
    iy = (torch.minimum(y2[:, :, None], y2[:, None]) -
          torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
    inter = ix * iy
    iou = inter / (area[:, :, None] + area[:, None] - inter + 1e-7)
    # overlap[b, i, j]: higher-ranked j (j < i) overlaps i above threshold
    lower = torch.ones(K, K, dtype=torch.bool,
                       device=boxes_sorted.device).tril(-1)
    overlap = (iou > iou_threshold) & lower
    invalid = scores_sorted <= 0
    suppressed = invalid
    for _ in range(max_iters):
        active = ~suppressed & ~invalid
        new_sup = (overlap & active[:, None, :]).any(-1) | invalid
        if torch.equal(new_sup, suppressed):
            break
        suppressed = new_sup
    return ~suppressed & ~invalid


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with typed entry points
    (untyped, ctypes would pass each pointer as a 32-bit int)."""
    from tpucv_torch import _build

    lib = _build.load("nms")
    lib.tpucv_nms_keep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.tpucv_nms_keep.restype = ctypes.c_int
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2 \
            or boxes.shape[:2] != scores.shape:
        raise ValueError(f"nms_keep wants boxes (B, K, 4) and scores (B, K), "
                         f"got {tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_keep wants float32, got {boxes.dtype} and "
                        f"{scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_keep wants contiguous boxes and scores")


def nms_keep(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
             iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy keep mask (B, K) bool over score-sorted candidates.

    CUDA tensors launch ``csrc/nms.cu`` (K <= 1024) on the current stream
    and count the launch in ``nms_keep.launches``; CPU tensors run
    ``nms_keep_reference``. Any other input raises."""
    _check(boxes_sorted, scores_sorted)
    dev = boxes_sorted.device
    if dev.type == "cpu":
        return nms_keep_reference(boxes_sorted, scores_sorted, iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"nms_keep runs on cuda or cpu tensors, not {dev}")
    B, K = scores_sorted.shape
    if K > MAX_BOXES:
        raise ValueError(f"nms_keep kernel takes K <= {MAX_BOXES}, got {K}")
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpucv_nms_keep(
            boxes_sorted.data_ptr(), scores_sorted.data_ptr(),
            keep.data_ptr(), B, K, float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(
            f"nms_keep kernel launch failed (B={B}, K={K}): "
            f"{lib.tpucv_cuda_error_string(err).decode()}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def cuda_nms(
    boxes: torch.Tensor,          # (B, N, 4) xyxy (any order)
    scores: torch.Tensor,         # (B, N)
    iou_threshold: float = 0.45,
    max_det: int = 300,
    presorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full NMS: stable descending sort (skipped when ``presorted``), the
    kernel's keep mask, then the top ``max_det`` kept scores.

    Returns (indices (B, max_det) int32 into the input order,
    valid (B, max_det) bool)."""
    if presorted:
        order = None
        sb, ss = boxes, scores
    else:
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
        sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        ss = torch.gather(scores, 1, order)
    keep = nms_keep(sb, ss, iou_threshold)
    return select_kept(keep, ss, order, max_det)


def select_kept(keep, ss, order, max_det):
    """Top ``max_det`` kept candidates by score, lower index first on ties
    (``lax.top_k``'s order)."""
    keep_scores = torch.where(keep, ss, torch.full_like(ss, NEG_INF))
    top_scores, top_pos = torch.sort(keep_scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_pos = top_scores[:, :max_det], top_pos[:, :max_det]
    valid = top_scores > NEG_INF / 2
    idx = top_pos if order is None else torch.gather(order, 1, top_pos)
    return idx.to(torch.int32), valid
