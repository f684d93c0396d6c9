"""YOLOv8-pose decode (counterpart of ``tpucv/decode/yolov8_pose.py``):
the detection decode plus each kept detection's keypoints."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpucv_torch.decode.yolov8 import decode_boxes
from tpucv_torch.losses.yolov8_pose import decode_kpts_flat


def decode_pose(
    raw: Tuple,
    kpt_shape=(17, 3),
    nc: int = 1,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.7,
    max_det: int = 300,
    pre_nms_topk: int = 2048,
):
    """Returns (boxes xyxy px, scores, classes, valid,
    kpts (B, max_det, nk, 3): xy in input pixels, sigmoid visibility)."""
    det_maps, kpt_maps = raw
    boxes, scores, classes, valid, anchor_idx = decode_boxes(
        det_maps, nc=nc, reg_max=reg_max, strides=strides,
        conf_threshold=conf_threshold, iou_threshold=iou_threshold,
        max_det=max_det, pre_nms_topk=pre_nms_topk, return_idx=True)
    kpts = decode_kpts_flat(kpt_maps, kpt_shape, strides)     # (B, A, nk, 3)
    sel = torch.gather(kpts, 1, anchor_idx[..., None, None].expand(
        -1, -1, *kpts.shape[2:]))
    sel = torch.cat([sel[..., :2], torch.sigmoid(sel[..., 2:3])], -1)
    return boxes, scores, classes, valid, sel
