"""Anchor generation (counterpart of ``tpucv/ops/anchors.py``): the
anchor points of the anchor-free heads (``make_anchors``) and the cell
grids of the anchor-based ones (``yolo_anchor_grid``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def yolo_anchor_grid(
    anchors: np.ndarray, feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int], device="cuda",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-level (grid_xy (H, W, 2), anchor_wh (na, 2)) pairs for the
    anchor-based YOLO heads (v3, v7), f32 on ``device``; ``anchors`` is
    (nl, na, 2) in pixels and grid_xy holds each cell's (x, y) index.
    Built on ``device`` itself, as ``make_anchors`` is."""
    f32 = dict(dtype=torch.float32, device=device)
    out = []
    for l, (h, w) in enumerate(feat_shapes):
        gy, gx = torch.meshgrid(torch.arange(int(h), **f32),
                                torch.arange(int(w), **f32), indexing="ij")
        wh = torch.stack([torch.full((), float(v), **f32)
                          for v in np.ravel(anchors[l])]).reshape(-1, 2)
        out.append((torch.stack([gx, gy], -1), wh))
    return out
