"""Anchor generation (counterpart of ``tpucv/ops/anchors.py``): the
anchor points of the anchor-free heads (``make_anchors``), the cell
grids of the anchor-based ones (``yolo_anchor_grid``) and SSD's prior
boxes (``generate_ssd_anchors``)."""

from __future__ import annotations

import math
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


def generate_ssd_anchors(
    input_size: int,
    feature_shapes: Sequence[int],
    anchor_sizes: Sequence[int],
    aspect_ratios: Sequence[Sequence[int]],
) -> np.ndarray:
    """SSD prior boxes, normalised xyxy clipped to [0, 1], (A, 4) f32 in
    numpy (the caller moves them to its device once). Per cell of level k,
    in order: the ``min`` square, the ``sqrt(min * max)`` square, then for
    each aspect ratio ar the ar and 1/ar rectangles; cells row-major. 8,732
    priors at 300, 24,564 at 512."""
    all_boxes: List[np.ndarray] = []
    for k, fs in enumerate(feature_shapes):
        lo, hi = anchor_sizes[k], anchor_sizes[k + 1]
        box_wh = [(lo, lo), (math.sqrt(lo * hi), math.sqrt(lo * hi))]
        for ar in aspect_ratios[k]:
            box_wh.append((lo * math.sqrt(ar), lo / math.sqrt(ar)))
            box_wh.append((lo / math.sqrt(ar), lo * math.sqrt(ar)))
        half = np.array(box_wh, dtype=np.float32) / 2.0        # (P, 2)
        step = input_size / fs
        centers = (np.arange(fs, dtype=np.float32) + 0.5) * step
        cy, cx = np.meshgrid(centers, centers, indexing="ij")
        cxy = np.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1)
        boxes = np.concatenate([cxy[:, None] - half[None],
                                cxy[:, None] + half[None]], axis=-1)
        all_boxes.append(boxes.reshape(-1, 4))
    out = np.concatenate(all_boxes, axis=0) / input_size
    return np.clip(out, 0.0, 1.0)
