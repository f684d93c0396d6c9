"""Loss extras (counterpart of ``tpucv/losses/extras.py``): the keypoint
loss that the pose family trains with, and the three that no registered
family uses: the varifocal loss, YOLOX's IoU loss and MultiBox with a
per-image hard-negative ranking. Each is in tpucv's operation order."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpucv_torch.losses.multibox import smooth_l1
from tpucv_torch.ops.boxes import bbox_iou


def varifocal_loss(pred_logits: torch.Tensor, gt_score: torch.Tensor,
                   label: torch.Tensor, alpha: float = 0.75,
                   gamma: float = 2.0) -> torch.Tensor:
    """IoU-aware classification loss (VarifocalNet, reference
    ``ultralytics_loss.py:11-22``): BCE with logits against ``gt_score``,
    weighted by alpha·p^gamma on negatives and ``gt_score`` on positives;
    summed."""
    p = torch.sigmoid(pred_logits.float())
    weight = alpha * p.pow(gamma) * (1 - label) + gt_score * label
    bce = (pred_logits.clamp(min=0) - pred_logits * gt_score
           + torch.log1p(torch.exp(-pred_logits.abs())))
    return (bce * weight).sum()


def keypoint_loss(pred_kpts: torch.Tensor, gt_kpts: torch.Tensor,
                  kpt_mask: torch.Tensor, area: torch.Tensor,
                  sigmas: torch.Tensor) -> torch.Tensor:
    """OKS-weighted keypoint regression loss (reference
    ``ultralytics_loss.py:60-71``), in tpucv's operation order."""
    d2 = ((pred_kpts[..., 0] - gt_kpts[..., 0]) ** 2
          + (pred_kpts[..., 1] - gt_kpts[..., 1]) ** 2)
    e = d2 / (2 * sigmas) ** 2 / (area[..., None] + 1e-9) / 2
    loss = (1 - torch.exp(-e)) * kpt_mask
    return loss.sum() / kpt_mask.sum().clamp(min=1.0)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, mode: str = "iou",
             xywh: bool = True) -> torch.Tensor:
    """YOLOX's elementwise IoU loss (reference ``iou_loss.py:5-49``):
    1 - IoU² (``"iou"``) or 1 - GIoU clipped to [0, 2] (``"giou"``)."""
    if mode == "giou":
        g = bbox_iou(pred, target, xywh=xywh, giou=True)
        return (1.0 - g).clamp(0.0, 2.0)
    i = bbox_iou(pred, target, xywh=xywh)
    return 1.0 - i ** 2


def multibox_loss_v1(loc_pred, conf_pred, loc_true, cls_true, pos_mask,
                     neg_pos_ratio: int = 3, alpha: float = 1.0):
    """MultiBox with the reference's v1 hard-negative ranking
    (``multi_box_loss.py:50-64``): in each image the ``neg_pos_ratio`` x
    its positives highest-CE negatives. The rank is two stable argsorts,
    as ``jnp.argsort``'s, so negatives of equal CE rank by anchor index.
    Smooth-L1 over the positives' offsets and CE over positives and kept
    negatives, each over the batch's positives (at least 1).

    Returns (conf + alpha · loc, {"loc_loss", "conf_loss"})."""
    conf_pred = conf_pred.float()
    n_pos_img = pos_mask.sum(1)                                  # (B,)
    n_pos = pos_mask.sum().clamp(min=1).float()

    l1 = smooth_l1(loc_pred.float() - loc_true).sum(-1)
    zero = torch.zeros((), device=l1.device)
    loss_loc = torch.where(pos_mask, l1, zero).sum() / n_pos

    logp = F.log_softmax(conf_pred, -1)
    ce = -torch.gather(logp, -1, cls_true[..., None].long())[..., 0]
    neg_ce = torch.where(pos_mask, torch.full_like(ce, -torch.inf), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)              # (B, A)
    keep_neg = rank < (neg_pos_ratio * n_pos_img)[:, None]
    loss_conf = (torch.where(pos_mask, ce, zero).sum()
                 + torch.where(keep_neg & ~pos_mask, ce, zero).sum()) / n_pos
    return loss_conf + alpha * loss_loc, {
        "loc_loss": loss_loc, "conf_loss": loss_conf}
