"""SSD's MultiBox loss with batch-global hard negative mining (counterpart
of ``tpucv/losses/multibox.py``): smooth-L1 localisation on the positives
plus softmax cross-entropy on the positives and the hardest negatives.

Hard negatives are ranked over the whole batch by their non-background
probability mass, with a stable descending sort (tpucv's
``argsort(-x)``: equal scores keep their flat order, and most positives
and many negatives tie); the budget is the sum of the per-image caps
``min(ratio * pos_i, A - pos_i)``, or 100 when no image has a negative
budget. Softmax probabilities are clamped to 1e-7 before the log; the
terms are normalised by ``sum(max(pos_i, 1))`` and blended ``conf * (1 -
alpha) + loc * alpha``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def multibox_loss(
    loc_pred: torch.Tensor,     # (B, A, 4)
    conf_pred: torch.Tensor,    # (B, A, nc) logits, class 0 the background
    loc_true: torch.Tensor,     # (B, A, 4)
    cls_true: torch.Tensor,     # (B, A) int
    pos_mask: torch.Tensor,     # (B, A) bool
    neg_pos_ratio: int = 3,
    alpha: float = 0.5,
    negatives_for_hard: float = 100.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, A, _ = conf_pred.shape
    conf_pred, loc_pred = conf_pred.float(), loc_pred.float()
    posf = pos_mask.float()

    probs = torch.softmax(conf_pred, -1).clamp(min=1e-7)
    ce = -torch.gather(torch.log(probs), -1,
                       cls_true.long()[..., None])[..., 0]        # (B, A)

    l1 = smooth_l1(loc_pred - loc_true).sum(-1)                   # (B, A)
    pos_loc = (l1 * posf).sum()
    pos_conf = (ce * posf).sum()

    num_pos = posf.sum(1)                                         # (B,)
    num_neg = torch.minimum(neg_pos_ratio * num_pos, A - num_pos)
    num_neg_batch = torch.where((num_neg > 0).any(), num_neg.sum(),
                                torch.full_like(num_neg[0],
                                                negatives_for_hard))

    max_confs = probs[..., 1:].sum(-1) * (1.0 - posf)             # (B, A)
    order = torch.sort(max_confs.reshape(-1), descending=True,
                       stable=True).indices
    rank = torch.arange(B * A, dtype=torch.float32, device=ce.device)
    neg_conf = torch.where(rank < num_neg_batch, ce.reshape(-1)[order],
                           torch.zeros_like(rank)).sum()

    norm = torch.where(num_pos != 0, num_pos, torch.ones_like(num_pos)).sum()
    loss_conf = (pos_conf + neg_conf) / norm
    loss_loc = pos_loc / norm
    total = loss_conf * (1.0 - alpha) + loss_loc * alpha
    return total, {"loc_loss": loss_loc, "conf_loss": loss_conf,
                   "num_pos": num_pos.sum()}
