"""CenterNet loss (counterpart of ``tpucv/losses/centernet.py``): the
penalty-reduced focal loss on the heatmap and masked L1 on the offsets and
sizes gathered at the GT centres.

The channel contract is the reference's: offsets at ``[C:C+2]``, sizes at
``[C+2:C+4]`` of the raw (B, H, W, C + 4) output, whatever the heads are
named.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpucv_torch.targets.centernet import CenterNetTargets


def penalty_reduced_focal(hm_logits: torch.Tensor, hm_true: torch.Tensor,
                          eps: float = 1e-4) -> torch.Tensor:
    """CornerNet / CenterNet focal: positives where ``hm_true`` reaches 1
    (within 1e-6), negatives weighted by (1 - hm_true)^4; the sigmoid
    clamped to [eps, 1 - eps]; the sum over positives' count (at least
    1)."""
    p = torch.sigmoid(hm_logits.float()).clamp(eps, 1 - eps)
    pos = hm_true >= 1.0 - 1e-6
    pos_loss = -torch.log(p) * (1 - p) ** 2
    neg_loss = -torch.log(1 - p) * p ** 2 * (1 - hm_true) ** 4
    n_pos = pos.sum().clamp(min=1).float()
    return torch.where(pos, pos_loss, neg_loss).sum() / n_pos


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H·W, C) rows at the (B, M) indices -> (B, M, C)."""
    return torch.gather(feat, 1, ind[..., None].long().expand(
        -1, -1, feat.shape[-1]))


def masked_l1(pred_map: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """``pred_map`` (B, H, W, C) gathered at the centres against ``target``
    (B, M, C), summed over the valid rows and normalised by the expanded
    mask count ``C · n_pos + 1e-4``, as the reference does."""
    B, H, W, C = pred_map.shape
    picked = gather_feat(pred_map.reshape(B, H * W, C).float(), ind)
    l1 = (picked - target).abs().sum(-1)
    n = mask.float().sum() * C + 1e-4
    return torch.where(mask, l1, torch.zeros_like(l1)).sum() / n


def centernet_loss(
    output: torch.Tensor,           # (B, H, W, C + 4) [hm logits, reg, wh]
    targets: CenterNetTargets,
    num_classes: int,
    hm_weight: float = 1.0,
    wh_weight: float = 0.1,
    off_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    C = num_classes
    l_hm = penalty_reduced_focal(output[..., :C], targets.heatmap)
    l_wh = masked_l1(output[..., C + 2:C + 4], targets.wh, targets.ind,
                     targets.mask)
    l_off = masked_l1(output[..., C:C + 2], targets.reg, targets.ind,
                      targets.mask)
    total = hm_weight * l_hm + wh_weight * l_wh + off_weight * l_off
    return total, {"hm_loss": l_hm, "wh_loss": l_wh, "off_loss": l_off}
