"""Anchor generation for anchor-free heads (counterpart of
``tpucv/ops/anchors.py:make_anchors``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centre points + per-anchor stride.

    Returns (anchor_points (A, 2) in feature units, strides (A, 1)) on
    ``device``; A = sum HW, x fastest within a level.
    """
    points, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = np.arange(w, dtype=np.float32) + grid_cell_offset
        sy = np.arange(h, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        points.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        strs.append(np.full((h * w, 1), s, dtype=np.float32))
    return (torch.from_numpy(np.concatenate(points)).to(device),
            torch.from_numpy(np.concatenate(strs)).to(device))
