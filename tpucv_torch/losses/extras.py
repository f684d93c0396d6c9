"""Loss extras (counterpart of ``tpucv/losses/extras.py``). Only the
keypoint loss, which the pose family trains with, is ported; the rest of
tpucv's file waits for its families."""

from __future__ import annotations

import torch


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
