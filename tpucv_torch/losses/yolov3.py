"""YOLOv3 loss and in-graph grid targets (counterpart of
``tpucv/losses/yolov3.py``; reference ``core/loss/yolov3_loss.py``).

Each GT goes to the anchor of best wh-IoU among the nine, at the level
that holds that anchor, in the cell of its centre (clipped to the map):
xy as offsets in the cell, wh as log ratios to the anchor, objectness 1
and a one-hot class. tpucv scatters the GTs with ``.at[...].set(mode=
"drop")``, dropping the GTs of other levels through an out-of-range row;
where two GTs of an image land on one (cell, anchor), XLA:CPU keeps the
later one (the larger GT index). The port scatters the in-level GTs only,
and picks that winner itself (a ``scatter_reduce`` of the GT index by
``amax``), since ``index_put_`` on CUDA keeps an arbitrary one.

The loss: BCE on xy and squared error on wh over the positives, BCE on
objectness over every cell but the ignored ones (a decoded box whose best
IoU with any GT of its image exceeds ``ignore_threshold``), BCE on the
classes over the positives; each positive term is divided by the level's
positive count, the objectness by its cell count.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpucv_torch.losses.common import sigmoid_bce
from tpucv_torch.ops.boxes import pairwise_iou


def make_yolov3_targets(
    gt_bboxes: torch.Tensor,     # (B, M, 4) xyxy px
    gt_labels: torch.Tensor,     # (B, M)
    gt_mask: torch.Tensor,       # (B, M)
    anchors: np.ndarray,         # (9, 2) px
    anchor_mask: Sequence[Sequence[int]],
    strides: Sequence[int],
    feat_shapes: Sequence[Tuple[int, int]],
    nc: int,
) -> List[torch.Tensor]:
    """Per level: (B, H, W, na, 5+nc) dense f32 targets."""
    B, M = gt_labels.shape
    dev = gt_bboxes.device
    gt_bboxes = gt_bboxes.float()
    g_cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    g_cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    g_w = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    g_h = gt_bboxes[..., 3] - gt_bboxes[..., 1]

    # wh-IoU of each GT against the 9 anchors (centred)
    gt_wh_boxes = torch.stack([-g_w / 2, -g_h / 2, g_w / 2, g_h / 2], -1)
    anc = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)
    anc_boxes = torch.cat([-anc / 2, anc / 2], -1)               # (9, 4)
    iou = pairwise_iou(gt_wh_boxes.reshape(B * M, 1, 4),
                       anc_boxes[None].expand(B * M, -1, -1))    # (BM, 1, 9)
    best_anchor = iou[:, 0, :].argmax(-1).reshape(B, M)
    onehot = F.one_hot(gt_labels.long().clamp(0, nc - 1), nc).float()
    m_idx = torch.arange(M, device=dev).expand(B, M)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, M)

    targets = []
    for l, ((H, W), s) in enumerate(zip(feat_shapes, strides)):
        mask_ids = torch.as_tensor(list(anchor_mask[l]), device=dev)
        na = len(anchor_mask[l])
        hit = best_anchor[..., None] == mask_ids                  # (B, M, na)
        in_level = hit.any(-1) & gt_mask.bool() & (g_w > 0)
        a_local = hit.int().argmax(-1)
        cx = torch.floor(g_cx / s).clamp(0, W - 1).long()
        cy = torch.floor(g_cy / s).clamp(0, H - 1).long()
        a_wh = anc[mask_ids][a_local]                             # (B, M, 2)
        vals = torch.stack([
            g_cx / s - cx, g_cy / s - cy,
            torch.log(g_w.clamp(min=1e-6) / a_wh[..., 0].clamp(min=1e-6)),
            torch.log(g_h.clamp(min=1e-6) / a_wh[..., 1].clamp(min=1e-6)),
            torch.ones_like(g_w)], -1)
        full = torch.cat([vals, onehot], -1)                    # (B, M, 5+nc)
        flat = ((b_idx * H + cy) * W + cx) * na + a_local
        # tpucv's scatter keeps the last GT of a (cell, anchor): the
        # largest in-level GT index wins
        n_cells = B * H * W * na
        winner = torch.full((n_cells,), -1, dtype=torch.long, device=dev)
        winner.scatter_reduce_(0, flat[in_level], m_idx[in_level], "amax")
        keep = in_level & (winner[flat] == m_idx)
        t = torch.zeros(n_cells, 5 + nc, device=dev)
        t[flat[keep]] = full[keep]
        targets.append(t.reshape(B, H, W, na, 5 + nc))
    return targets


def yolov3_loss(
    raw_maps: Sequence[torch.Tensor],
    gt_bboxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors: np.ndarray,           # (9, 2)
    anchor_mask: Sequence[Sequence[int]],
    strides: Sequence[int],
    nc: int,
    ignore_threshold: float = 0.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """NHWC raw maps (B, H, W, na*(5+nc)), any float dtype -> (total, terms),
    f32."""
    B = raw_maps[0].shape[0]
    dev = raw_maps[0].device
    gt_bboxes = gt_bboxes.float()
    feat_shapes = [tuple(m.shape[1:3]) for m in raw_maps]
    targets = make_yolov3_targets(gt_bboxes, gt_labels, gt_mask, anchors,
                                  anchor_mask, strides, feat_shapes, nc)
    anc_all = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)
    has_gt = gt_mask.bool().any(-1)[:, None]

    total_xy = total_wh = total_obj = total_cls = 0.0
    for l, (m, t, s) in enumerate(zip(raw_maps, targets, strides)):
        na = t.shape[3]
        H, W = t.shape[1:3]
        p = m.reshape(B, H, W, na, 5 + nc).float()
        obj_t = t[..., 4]
        pos = obj_t > 0.5
        n_pos = pos.sum().clamp(min=1).float()

        # xy BCE, wh squared error on the positives
        xy_bce = sigmoid_bce(p[..., :2], t[..., :2]).sum(-1)
        wh_mse = (p[..., 2:4] - t[..., 2:4]).square().sum(-1)
        total_xy = total_xy + torch.where(pos, xy_bce, 0.0).sum() / n_pos
        total_wh = total_wh + torch.where(pos, wh_mse, 0.0).sum() / n_pos

        # decoded boxes for the ignore mask
        anc = anc_all[torch.as_tensor(list(anchor_mask[l]), device=dev)]
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                             device=dev),
                                torch.arange(W, dtype=torch.float32,
                                             device=dev), indexing="ij")
        px = (torch.sigmoid(p[..., 0]) + gx[None, :, :, None]) * s
        py = (torch.sigmoid(p[..., 1]) + gy[None, :, :, None]) * s
        pw = torch.exp(p[..., 2].clamp(-10, 10)) * anc[:, 0]
        ph = torch.exp(p[..., 3].clamp(-10, 10)) * anc[:, 1]
        pred_boxes = torch.stack(
            [px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], -1)
        with torch.no_grad():
            best_iou = pairwise_iou(pred_boxes.reshape(B, -1, 4),
                                    gt_bboxes).amax(-1)        # vs all GTs
            best_iou = torch.where(has_gt, best_iou, 0.0)
            ignore = (best_iou.reshape(B, H, W, na) > ignore_threshold) \
                & ~pos

        obj_bce = sigmoid_bce(p[..., 4], obj_t)
        total_obj = total_obj + torch.where(ignore, 0.0, obj_bce).sum() \
            / (B * H * W * na)
        cls_bce = sigmoid_bce(p[..., 5:], t[..., 5:]).sum(-1)
        total_cls = total_cls + torch.where(pos, cls_bce, 0.0).sum() / n_pos

    total = total_xy + total_wh + total_obj + total_cls
    return total, {"xy_loss": total_xy, "wh_loss": total_wh,
                   "obj_loss": total_obj, "cls_loss": total_cls}
