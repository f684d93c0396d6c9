"""YOLOv8 decode: raw head maps -> boxes (counterpart of
``tpucv/decode/yolov8.py``): anchors, DFL expectation, dist2bbox, sigmoid
class scores, top-k, class-offset NMS. Shapes are fixed throughout."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpucv_torch.nn.heads import dfl_project
from tpucv_torch.ops.anchors import make_anchors
from tpucv_torch.ops.boxes import dist2bbox
from tpucv_torch.ops.nms import class_offset_nms


def raw_to_pred(
    raw_maps: Sequence[torch.Tensor],
    nc: int = 80,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
) -> torch.Tensor:
    """Per-level NHWC raw maps -> (B, A, 4+nc): xywh boxes in input pixels
    + sigmoid class scores. A = sum(H*W) (8400 for a 640 input)."""
    feat_shapes = [m.shape[1:3] for m in raw_maps]
    anchor_points, stride_arr = make_anchors(
        feat_shapes, strides, device=raw_maps[0].device)
    flat = [m.reshape(m.shape[0], -1, m.shape[-1]) for m in raw_maps]
    x = torch.cat(flat, 1).float()                        # (B, A, no)
    box_dist, cls = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_project(box_dist, reg_max)                   # (B, A, 4)
    boxes = dist2bbox(dist, anchor_points[None], xywh=True) * stride_arr[None]
    return torch.cat([boxes, torch.sigmoid(cls)], -1)


def topk_candidates(
    raw_maps: Sequence[torch.Tensor],
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    conf_threshold: float = 0.25,
    pre_nms_topk: int = 2048,
    return_idx: bool = False,
):
    """The top-``pre_nms_topk`` anchors by best-class score, the stage
    before NMS. The DFL expectation runs in the maps' dtype (bf16 on the
    served path), as tpucv's does, then casts to f32.

    Returns (boxes (B, K, 4) xyxy px f32, scores (B, K) f32 descending,
    classes (B, K) int32), and with ``return_idx`` the candidates' flat
    anchor indices (B, K) int64 as a fourth."""
    feat_shapes = [m.shape[1:3] for m in raw_maps]
    dev = raw_maps[0].device
    anchor_points, stride_arr = make_anchors(feat_shapes, strides, device=dev)
    B = raw_maps[0].shape[0]
    proj = torch.arange(reg_max, dtype=raw_maps[0].dtype, device=dev)
    bests, bcls, dists = [], [], []
    for m in raw_maps:
        logits = m[..., 4 * reg_max:]                     # (B, H, W, nc)
        # best class by max over logits, then one sigmoid (monotone)
        bests.append(torch.sigmoid(logits.amax(-1)).reshape(B, -1))
        bcls.append(logits.argmax(-1).reshape(B, -1))
        bd = m[..., : 4 * reg_max].reshape(B, -1, 4, reg_max)
        dists.append(torch.softmax(bd, -1) @ proj)
    best_score = torch.cat(bests, 1).float()              # (B, A)
    best_cls = torch.cat(bcls, 1).to(torch.int32)
    dist = torch.cat(dists, 1).float()                    # (B, A, 4)
    all_boxes = dist2bbox(dist, anchor_points[None]) * stride_arr[None]

    gated = torch.where(best_score > conf_threshold, best_score,
                        torch.zeros_like(best_score))
    k = min(pre_nms_topk, gated.shape[1])
    # stable descending sort == lax.top_k's order: lower index first on
    # ties, which letterbox padding makes common
    top_scores, top_idx = torch.sort(gated, dim=1, descending=True,
                                      stable=True)
    top_scores, top_idx = top_scores[:, :k].contiguous(), top_idx[:, :k]
    boxes = torch.gather(all_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(best_cls, 1, top_idx)
    if return_idx:
        return boxes, top_scores, top_cls, top_idx
    return boxes, top_scores, top_cls


def decode_boxes(
    raw_maps: Sequence[torch.Tensor],
    nc: int = 80,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.7,
    max_det: int = 300,
    pre_nms_topk: int = 2048,
    return_idx: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Full decode + class-offset NMS. Returns fixed-shape (boxes
    (B, max_det, 4) xyxy px, scores, classes, valid), and with
    ``return_idx`` the flat anchor index (B, max_det) of each kept
    detection as a fifth (the segment and pose decodes gather their
    per-anchor outputs with it)."""
    boxes, top_scores, top_cls, top_idx = topk_candidates(
        raw_maps, reg_max, strides, conf_threshold, pre_nms_topk,
        return_idx=True)
    *out, idx = class_offset_nms(boxes, top_scores, top_cls,
                                 conf_threshold, iou_threshold, max_det)
    if return_idx:
        return (*out, torch.gather(top_idx, 1, idx))
    return tuple(out)
