"""Segmentation losses, CE and focal with an ignore index (counterpart of
``tpucv/losses/segmentation.py``; the reference's
``core/loss/focal_loss.py:6-22`` and the CE factory of
``core/algorithms/segmentation_2d.py:42-76``).

Logits come NCHW, (B, nc, H, W); labels (B, H, W) ints. Both losses run in
f32. A pixel counts when its label is not ``ignore_index`` and lies in
[0, nc); the loss is the sum over counted pixels over ``max(n_valid, 1)``.
tpucv reduces the log-probabilities with a one-hot product, which picks
exactly one term a pixel: the gather here is the same number.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def _valid_ce(logits: torch.Tensor, labels: torch.Tensor,
              ignore_index: int):
    """(per-pixel CE (B, H, W) f32, the valid mask)."""
    nc = logits.shape[1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < nc)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=1)
    ce = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    return ce, valid


def _masked_mean(terms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = valid.sum().clamp_min(1)
    return torch.where(valid, terms, torch.zeros_like(terms)).sum() / n


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce, valid = _valid_ce(logits, labels, ignore_index)
    loss = _masked_mean(ce, valid)
    return loss, {"ce_loss": loss}


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               ignore_index: int = 255
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``alpha (1 - p_t)^gamma CE`` over the valid pixels."""
    ce, valid = _valid_ce(logits, labels, ignore_index)
    pt = torch.exp(-ce)
    loss = _masked_mean(alpha * (1 - pt) ** gamma * ce, valid)
    return loss, {"focal_loss": loss}
