"""Anchor generation for anchor-free heads (counterpart of
``tpucv/ops/anchors.py:make_anchors``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centre points + per-anchor stride.

    Returns (anchor_points (A, 2) in feature units, strides (A, 1)) on
    ``device``; A = sum HW, x fastest within a level. Built on ``device``
    itself: a copy from host memory would make the host wait for the
    device's queue on every call.
    """
    points, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(int(w), dtype=torch.float32, device=device) \
            + grid_cell_offset
        sy = torch.arange(int(h), dtype=torch.float32, device=device) \
            + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strs.append(torch.full((int(h) * int(w), 1), float(s),
                               dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(strs)
