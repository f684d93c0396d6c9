"""YOLOv8 decode: raw head maps -> boxes (counterpart of
``tpucv/decode/yolov8.py``): anchors, DFL expectation, dist2bbox, sigmoid
class scores, top-k, class-offset NMS. Shapes are fixed throughout."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpucv_torch.nn.heads import dfl_project
from tpucv_torch.ops.anchors import make_anchors
from tpucv_torch.ops.boxes import dist2bbox
from tpucv_torch.ops.nms import dispatch_batched_nms


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
):
    """The top-``pre_nms_topk`` anchors by best-class score, the stage
    before NMS. The DFL expectation runs in the maps' dtype (bf16 on the
    served path), as tpucv's does, then casts to f32.

    Returns (boxes (B, K, 4) xyxy px f32, scores (B, K) f32 descending,
    classes (B, K) int32)."""
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
) -> Tuple[torch.Tensor, ...]:
    """Full decode + class-offset NMS. Returns fixed-shape (boxes
    (B, max_det, 4) xyxy px, scores, classes, valid)."""
    boxes, top_scores, top_cls = topk_candidates(
        raw_maps, reg_max, strides, conf_threshold, pre_nms_topk)
    off = boxes + top_cls[..., None].to(boxes.dtype) * 7680.0
    idx, valid = dispatch_batched_nms(off, top_scores, iou_threshold,
                                      max_det)
    idx = idx.long()
    out_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, idx)
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    out_cls = torch.gather(top_cls, 1, idx)
    valid = valid & (out_scores > conf_threshold)
    out_boxes = torch.where(valid[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    return out_boxes, out_scores, out_cls, valid
