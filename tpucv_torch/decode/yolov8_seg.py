"""YOLOv8-seg decode (counterpart of ``tpucv/decode/yolov8_seg.py``):
the detection decode plus each kept detection's mask coefficients. Masks
are combined later (``tpucv_torch.ops.masks.process_mask``) so the caller
picks their resolution."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpucv_torch.decode.yolov8 import decode_boxes


def decode_seg(
    raw: Tuple,
    nc: int = 80,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.7,
    max_det: int = 300,
    pre_nms_topk: int = 2048,
):
    """Returns (boxes xyxy px, scores, classes, valid, coefs
    (B, max_det, nm) f32, protos (B, Hm, Wm, nm))."""
    det_maps, coef_maps, protos = raw
    B, nm = det_maps[0].shape[0], protos.shape[-1]
    boxes, scores, classes, valid, anchor_idx = decode_boxes(
        det_maps, nc=nc, reg_max=reg_max, strides=strides,
        conf_threshold=conf_threshold, iou_threshold=iou_threshold,
        max_det=max_det, pre_nms_topk=pre_nms_topk, return_idx=True)
    coefs = torch.cat([m.reshape(B, -1, nm) for m in coef_maps], 1).float()
    sel = torch.gather(coefs, 1, anchor_idx[..., None].expand(-1, -1, nm))
    return boxes, scores, classes, valid, sel, protos
