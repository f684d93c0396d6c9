"""YOLOv8-pose loss (counterpart of ``tpucv/losses/yolov8_pose.py``): the
detection loss plus OKS keypoint regression and keypoint-visibility BCE,
fixed shapes.

Semantics follow ultralytics v8-pose: on each foreground anchor the
predicted keypoints (decoded relative to the anchor cell) regress to the
assigned GT's keypoints with the OKS-weighted loss (area-normalised), and
the visibility channel trains with BCE against visibility > 0. As for the
segment loss, the top ``pose_topk`` foreground anchors of each image are
taken.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tpucv_torch.losses.common import sigmoid_bce
from tpucv_torch.losses.extras import keypoint_loss
from tpucv_torch.losses.yolov8 import yolov8_loss
from tpucv_torch.losses.yolov8_seg import gather_rows, topk_foreground
from tpucv_torch.metrics.coco_map import OKS_SIGMAS
from tpucv_torch.ops.anchors import make_anchors

# the one 17-keypoint OKS sigma table, shared with the evaluator
OKS_SIGMA_17 = OKS_SIGMAS.astype(np.float32)


def decode_kpts_flat(kpt_maps: Sequence[torch.Tensor], kpt_shape,
                     strides: Sequence[int]) -> torch.Tensor:
    """Per-level NHWC keypoint maps -> (B, A, nk, 3) f32: xy in input
    pixels (ultralytics' k*2 + anchor - 0.5, times the stride), the raw
    visibility logit in channel 2."""
    B, nk = kpt_maps[0].shape[0], kpt_shape[0]
    feat_shapes = [m.shape[1:3] for m in kpt_maps]
    anc, stride_arr = make_anchors(feat_shapes, strides,
                                   device=kpt_maps[0].device)  # grid units
    flat = torch.cat([m.reshape(B, -1, nk, kpt_shape[1]) for m in kpt_maps],
                     1).float()                              # (B, A, nk, 3)
    s = stride_arr[None, :, 0, None]
    x = (flat[..., 0] * 2.0 + (anc[None, :, None, 0] - 0.5)) * s
    y = (flat[..., 1] * 2.0 + (anc[None, :, None, 1] - 0.5)) * s
    return torch.stack([x, y, flat[..., 2]], -1)


def yolov8_pose_loss(
    raw: Tuple,
    gt_labels: torch.Tensor,        # (B, M)
    gt_bboxes: torch.Tensor,        # (B, M, 4) xyxy px
    gt_mask: torch.Tensor,          # (B, M)
    gt_kpts: torch.Tensor,          # (B, M, nk, 3) px xy + visibility {0,1,2}
    nc: int = 1,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
    kpt_gain: float = 12.0,
    kobj_gain: float = 1.0,
    tal_topk: int = 10,
    pose_topk: int = 64,
):
    """(total, metrics): the detection loss's total plus
    ``(kpt_gain * kpt_loss + kobj_gain * kobj_loss) * B``, and its metrics
    plus ``kpt_loss`` and ``kobj_loss``, in f32 with autocast off."""
    det_maps, kpt_maps = raw
    B, nk = det_maps[0].shape[0], gt_kpts.shape[2]
    dev = det_maps[0].device

    det_total, metrics, aux = yolov8_loss(
        det_maps, gt_labels, gt_bboxes, gt_mask, nc=nc, reg_max=reg_max,
        strides=strides, box_gain=box_gain, cls_gain=cls_gain,
        dfl_gain=dfl_gain, tal_topk=tal_topk, return_aux=True)

    with torch.autocast(dev.type, enabled=False):
        pred_kpts = decode_kpts_flat(kpt_maps, (nk, 3), strides)
        top_idx, valid = topk_foreground(
            aux, min(pose_topk, pred_kpts.shape[1]))
        sel_pred = gather_rows(pred_kpts, top_idx)             # (B, K, nk, 3)
        sel_gt = gather_rows(aux["gt_idx"].long(), top_idx)
        sel_boxes = gather_rows(aux["target_bboxes_px"].float(), top_idx)
        # the assigned GT's keypoints (tpucv's one-hot contraction, exact)
        tgt = gather_rows(gt_kpts.float(), sel_gt)             # (B, K, nk, 3)

        area = ((sel_boxes[..., 2] - sel_boxes[..., 0])
                * (sel_boxes[..., 3] - sel_boxes[..., 1])).clamp(min=1.0)
        vis = ((tgt[..., 2] > 0) & valid[..., None]).float()   # (B, K, nk)
        sigmas = torch.from_numpy(
            OKS_SIGMA_17 if nk == 17
            else np.full(nk, 1.0 / nk, np.float32)).to(dev)
        loss_kpt = keypoint_loss(sel_pred[..., :2], tgt[..., :2], vis, area,
                                 sigmas)

        kobj_bce = sigmoid_bce(sel_pred[..., 2], vis)          # (B, K, nk)
        n_valid = (valid.sum().float() * nk).clamp(min=1.0)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss_kobj = torch.where(valid[..., None], kobj_bce, zero).sum() \
            / n_valid

    total = det_total + (kpt_gain * loss_kpt + kobj_gain * loss_kobj) * B
    metrics = dict(metrics)
    metrics["kpt_loss"] = loss_kpt
    metrics["kobj_loss"] = loss_kobj
    return total, metrics
