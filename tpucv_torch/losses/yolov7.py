"""YOLOv7 loss: the static simOTA assignment, CIoU box, BCE objectness
(IoU target) and BCE class terms with per-layer balance (counterpart of
``tpucv/losses/yolov7.py``).

Every GT owns a fixed slate of 3 cells x na anchors x nl layers = 27
candidates (the cell holding its centre and its two nearest neighbours),
masked by bounds and the anchor-ratio test. Each candidate costs
class BCE + 3·(-log IoU) (+1e5 when masked); a GT takes its dynamic-k
cheapest (k = the floored sum of its top-20 IoUs, in [1, 20]), and an
anchor claimed by several GTs goes to the cheapest (within 1e-6).

Ties decide assignments, so the port keeps tpucv's tie rules: the cost
order is a stable sort (equal costs in slate order); where GTs tie for an
anchor, the one written last in flat (gt, candidate) order wins, as
XLA:CPU resolves tpucv's duplicate-index scatter, here by a max over the
flat position, which is deterministic on the CPU and on CUDA. The target
boxes and labels are gathered by index (tpucv contracts a one-hot, which
is exact too). The whole loss runs in f32; the raw maps may be bf16.
Divisions by the anchor sizes and by a layer's anchor count are products
with the f32 reciprocal, as XLA compiles tpucv's.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpucv_torch.losses.common import sigmoid_bce
from tpucv_torch.ops.boxes import bbox_iou


@functools.lru_cache(maxsize=16)
def _flat_geometry(feat_shapes: Tuple[Tuple[int, int], ...],
                   strides: Tuple[int, ...],
                   anchors: Tuple[Tuple[Tuple[float, float], ...], ...],
                   device: torch.device):
    """Per flat prediction, (h, w, a) order within a level: cell x, cell
    y, anchor w, anchor h, stride (A,) f32; and each level's offset.
    Built on ``device`` once for each set of shapes, as tpucv's are
    trace-time constants: no copy from host memory (a wait for the
    device's queue) and no launches on later steps. Never inference
    tensors, whatever mode the first call came in: a training step saves
    them for its backward."""
    cxs, cys, aws, ahs, sts, offs = [], [], [], [], [], [0]
    na = len(anchors[0])
    f32 = dict(dtype=torch.float32, device=device)
    with torch.inference_mode(False):
        for l, ((h, w), s) in enumerate(zip(feat_shapes, strides)):
            cxs.append(torch.arange(w, **f32).repeat(h).repeat_interleave(na))
            cys.append(torch.arange(h, **f32).repeat_interleave(w * na))
            for out, j in ((aws, 0), (ahs, 1)):
                out.append(torch.stack(
                    [torch.full((h * w,), anchors[l][a][j], **f32)
                     for a in range(na)], -1).reshape(-1))
            sts.append(torch.full((h * w * na,), float(s), **f32))
            offs.append(offs[-1] + h * w * na)
        geo = tuple(torch.cat(v) for v in (cxs, cys, aws, ahs, sts))
    return geo, offs


def _recip(x) -> float:
    """The f32 reciprocal of ``x`` (f32), as a Python float (exact)."""
    return float(np.float32(1.0) / np.float32(x))


@torch.no_grad()
def _assign(preds, pred_boxes, gt_bboxes, gt_labels, gt_mask, feat_shapes,
            strides, anchors, offs, nc, anchor_t, max_dynamic_k):
    """simOTA over the static slates -> (matched (B, A) bool, the GT row
    of each anchor (B, A) int64, 0 where unmatched)."""
    B, A = preds.shape[:2]
    M = gt_labels.shape[1]
    na = anchors.shape[1]
    dev = preds.device
    g_cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    g_cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    g_w = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    g_h = gt_bboxes[..., 3] - gt_bboxes[..., 1]

    cand_flat, cand_valid = [], []
    for l, ((H, W), s) in enumerate(zip(feat_shapes, strides)):
        gx, gy = g_cx / s, g_cy / s
        cxi, cyi = torch.floor(gx), torch.floor(gy)
        one = torch.ones_like(gx)
        dx = torch.where(gx - cxi < 0.5, -one, one)
        dy = torch.where(gy - cyi < 0.5, -one, one)
        for ccx, ccy in ((cxi, cyi), (cxi + dx, cyi), (cxi, cyi + dy)):
            in_bounds = (ccx >= 0) & (ccx < W) & (ccy >= 0) & (ccy < H)
            cell = (ccy.clamp(0, H - 1) * W + ccx.clamp(0, W - 1))
            for a in range(na):
                r_w = g_w * _recip(anchors[l, a, 0] + 1e-9)
                r_h = g_h * _recip(anchors[l, a, 1] + 1e-9)
                ratio_ok = torch.maximum(
                    torch.maximum(r_w, 1 / (r_w + 1e-9)),
                    torch.maximum(r_h, 1 / (r_h + 1e-9))) < anchor_t
                cand_flat.append((offs[l] + cell * na + a).long())
                cand_valid.append(in_bounds & ratio_ok & gt_mask)
    cand_flat = torch.stack(cand_flat, -1)                   # (B, M, K)
    cand_valid = torch.stack(cand_valid, -1)
    K = cand_flat.shape[-1]
    flat_bmk = cand_flat.reshape(B, M * K)

    # cost over the slate
    cand_boxes = torch.gather(
        pred_boxes, 1, flat_bmk[..., None].expand(-1, -1, 4)).reshape(
        B, M, K, 4)
    iou = bbox_iou(gt_bboxes[:, :, None, :], cand_boxes, xywh=False)
    iou = iou.clamp(0.0, 1.0)
    cand_preds = torch.gather(
        preds, 1, flat_bmk[..., None].expand(-1, -1, preds.shape[-1]))
    cand_preds = cand_preds.reshape(B, M, K, -1)
    p_obj = torch.sigmoid(cand_preds[..., 4:5])
    p_cls = torch.sigmoid(cand_preds[..., 5:]) * p_obj
    onehot = (gt_labels.clamp(0, nc - 1)[..., None] ==
              torch.arange(nc, device=dev)).float()[:, :, None, :]
    y = torch.sqrt(p_cls.clamp(1e-8, 1.0))
    bce = -(onehot * torch.log(y)
            + (1 - onehot) * torch.log((1 - y).clamp(min=1e-8)))
    cost = bce.sum(-1) + 3.0 * -torch.log(iou + 1e-8) \
        + 1e5 * (~cand_valid).float()

    # dynamic k: the GT's k cheapest valid candidates
    kk = min(max_dynamic_k, K)
    topk_iou = torch.topk(torch.where(cand_valid, iou, torch.zeros_like(iou)),
                          kk, dim=-1).values
    dyn_k = topk_iou.sum(-1).to(torch.int32).clamp(1, max_dynamic_k)
    order = torch.argsort(cost, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    selected = (rank < dyn_k[..., None]) & cand_valid

    # conflicts: an anchor goes to its cheapest claimant (within 1e-6)
    cost_bmk = torch.where(selected, cost, torch.full_like(cost, 1e9))
    best_cost = torch.full((B, A), 1e9, device=dev).scatter_reduce_(
        1, flat_bmk, cost_bmk.reshape(B, M * K), "amin", include_self=True)
    final = selected & (
        cost <= torch.gather(best_cost, 1, flat_bmk).reshape(B, M, K)
        + 1e-6)

    # the last claimant in flat (gt, candidate) order wins a tie
    pos = torch.arange(M * K, device=dev).expand(B, -1)
    fin = final.reshape(B, M * K)
    w_idx = torch.where(fin, flat_bmk, torch.full_like(flat_bmk, A))
    last = torch.full((B, A + 1), -1, dtype=torch.long,
                      device=dev).scatter_reduce_(
        1, w_idx, torch.where(fin, pos, torch.full_like(pos, -1)), "amax",
        include_self=True)[:, :A]
    matched = last >= 0
    return matched, torch.where(matched, last // K, torch.zeros_like(last))


def yolov7_loss(
    raw_maps: Sequence[torch.Tensor],
    gt_bboxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors: np.ndarray,
    strides: Sequence[int] = (8, 16, 32),
    nc: int = 20,
    box_gain: float = 0.05,
    obj_gain: float = 0.7,
    cls_gain: float = 0.3,
    layer_balance: Sequence[float] = (4.0, 1.0, 0.4),
    anchor_t: float = 4.0,
    max_dynamic_k: int = 20,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The YOLOv7 training loss.

    Args:
      raw_maps: per-level NHWC (B, H, W, na*(5+nc)) raw head outputs.
      gt_bboxes: (B, M, 4) xyxy in input pixels; gt_labels: (B, M) int;
      gt_mask: (B, M) bool. anchors: (nl, na, 2) in pixels.
    Returns:
      (total, {box_loss, obj_loss, cls_loss, num_match}). Box and class
      terms are per-layer means summed over the layers; objectness is the
      balance-weighted per-layer mean over every anchor. The total is the
      gain-weighted sum, with no batch-size factor.
    """
    B = raw_maps[0].shape[0]
    dev = raw_maps[0].device
    feat_shapes = tuple((int(m.shape[1]), int(m.shape[2])) for m in raw_maps)
    (cx, cy, aw, ah, st), offs = _flat_geometry(
        feat_shapes, tuple(strides),
        tuple(tuple(map(tuple, lvl)) for lvl in np.asarray(anchors).tolist()),
        torch.device(dev))
    preds = torch.cat([m.reshape(B, -1, 5 + nc) for m in raw_maps],
                      1).float()                              # (B, A, 5+nc)

    sig = torch.sigmoid(preds[..., :4])
    px = (sig[..., 0] * 2.0 - 0.5 + cx) * st
    py = (sig[..., 1] * 2.0 - 0.5 + cy) * st
    pw = (sig[..., 2] * 2.0) ** 2 * aw
    ph = (sig[..., 3] * 2.0) ** 2 * ah
    pred_boxes = torch.stack(
        [px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], -1)

    gt_bboxes = gt_bboxes.float()
    matched, gt_idx = _assign(
        preds.detach(), pred_boxes.detach(), gt_bboxes, gt_labels,
        gt_mask.bool(), feat_shapes, strides, anchors, offs, nc, anchor_t,
        max_dynamic_k)
    tgt_boxes = torch.gather(gt_bboxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    tgt_labels = torch.gather(gt_labels.long(), 1, gt_idx)

    ciou = bbox_iou(pred_boxes, tgt_boxes, xywh=False, ciou=True)  # (B, A)
    zero = torch.zeros((), device=dev)
    obj_target = torch.where(matched, ciou.detach().clamp(0.0, 1.0), zero)
    obj_bce = sigmoid_bce(preds[..., 4], obj_target)
    cls_target = ((tgt_labels[..., None] == torch.arange(nc, device=dev))
                  & matched[..., None]).float()
    cls_bce = sigmoid_bce(preds[..., 5:], cls_target).sum(-1)      # (B, A)

    loss_box = loss_obj = loss_cls = zero
    for l in range(len(raw_maps)):
        lo, hi = offs[l], offs[l + 1]
        m_l = matched[:, lo:hi]
        denom = m_l.sum().clamp(min=1).float()
        loss_box = loss_box + torch.where(
            m_l, 1.0 - ciou[:, lo:hi], zero).sum() / denom
        loss_cls = loss_cls + torch.where(
            m_l, cls_bce[:, lo:hi], zero).sum() / (denom * nc)
        layer_obj = obj_bce[:, lo:hi].sum() * _recip(max((hi - lo) * B, 1))
        loss_obj = loss_obj + layer_balance[l] * layer_obj

    total = box_gain * loss_box + obj_gain * loss_obj + cls_gain * loss_cls
    return total, {"box_loss": loss_box, "obj_loss": loss_obj,
                   "cls_loss": loss_cls,
                   "num_match": matched.sum().float()}
