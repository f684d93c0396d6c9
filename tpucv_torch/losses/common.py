"""Shared loss primitives (counterpart of ``tpucv/losses/common.py``)."""

from __future__ import annotations

import torch


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy, elementwise, in
    tpucv's formula: max(x, 0) - x * y + log1p(exp(-|x|))."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
