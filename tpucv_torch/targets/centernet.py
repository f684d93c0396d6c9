"""CenterNet gaussian-heatmap targets on the device (counterpart of
``tpucv/targets/centernet.py``): every (image, box) pair's full-grid
gaussian, masked to its radius window, max-merged into its class channel
by one ``scatter_reduce(amax)`` onto zeros (tpucv's ``segment_max`` over
the B·M maps, then a max with 0). No host loop; the (B, M, H, W) splat is
17.7 MB at B=16, M=30, 96².

tpucv's details are kept: ``gaussian_radius``'s third root divides by 2,
not by 2·a3, as the reference and the original CenterNet do; sigma is
floored at 1e-6; the window test is ``|dx| <= r and |dy| <= r``; boxes
with no width or height, and padded rows, splat nothing and are masked.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def gaussian_radius(h: torch.Tensor, w: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """The three-case minimum radius of the reference, elementwise."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + (b1 ** 2 - 4 * c1).clamp(min=0).sqrt()) / 2

    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + (b2 ** 2 - 16 * c2).clamp(min=0).sqrt()) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    # (b3 + sq3) / 2, not / (2 a3): the reference's formula, kept
    r3 = (b3 + (b3 ** 2 - 4 * a3 * c3).clamp(min=0).sqrt()) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


class CenterNetTargets(NamedTuple):
    heatmap: torch.Tensor   # (B, H, W, C) in [0, 1], NHWC as tpucv's
    ind: torch.Tensor       # (B, M) int64 flat y·W + x of the centres
    wh: torch.Tensor        # (B, M, 2) box size in feature cells
    reg: torch.Tensor       # (B, M, 2) the centre's sub-cell offset
    mask: torch.Tensor      # (B, M) bool


def build_centernet_targets(
    gt_boxes: torch.Tensor,     # (B, M, 4) xyxy input pixels
    gt_labels: torch.Tensor,    # (B, M) int
    gt_mask: torch.Tensor,      # (B, M) bool
    num_classes: int,
    output_size: Tuple[int, int],
    downsample: int = 4,
) -> CenterNetTargets:
    B, M = gt_labels.shape
    H, W = output_size
    dev = gt_boxes.device
    boxes = gt_boxes.float() / downsample
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cxi = cx.floor().clamp(0, W - 1)
    cyi = cy.floor().clamp(0, H - 1)

    radius = gaussian_radius(h, w).floor().clamp(min=0)          # (B, M)
    sigma = (2 * radius + 1) / 6.0

    # full-grid gaussians (B, M, H, W), zero outside the radius window
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    dx = xs - cxi[..., None, None]
    dy = ys - cyi[..., None, None]
    g = torch.exp(-(dx ** 2 + dy ** 2) /
                  (2 * sigma.clamp(min=1e-6)[..., None, None] ** 2))
    r = radius[..., None, None]
    valid = gt_mask & (w > 0) & (h > 0)
    keep = (dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None]
    g = torch.where(keep, g, torch.zeros_like(g))

    # max-merge into the class channels: (B·M) maps onto (B·C) slots
    seg = (torch.arange(B, device=dev)[:, None] * num_classes
           + gt_labels.long().clamp(0, num_classes - 1)).reshape(-1)
    heat = torch.zeros(B * num_classes, H * W, device=dev).scatter_reduce_(
        0, seg[:, None].expand(-1, H * W), g.reshape(B * M, H * W), "amax",
        include_self=True)
    heatmap = heat.view(B, num_classes, H, W).permute(0, 2, 3, 1)

    ind = (cyi * W + cxi).long()
    wh = torch.stack([w, h], -1)
    reg = torch.stack([cx - cxi, cy - cyi], -1)
    return CenterNetTargets(heatmap, ind, wh, reg, valid)
