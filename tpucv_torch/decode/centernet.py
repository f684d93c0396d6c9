"""CenterNet decode (counterpart of ``tpucv/decode/centernet.py``): the
heatmap's sigmoid, 3x3 max-pool peak suppression, the top K over the
flattened map, the offsets and sizes gathered at the peaks, then DIoU NMS
by the sequential scan (``ops/nms.py:nms(diou=True)``: on the card one
``nms_scan`` launch for the batch, the scan kernel's DIoU variant;
``nms_keep``'s criterion is plain IoU, so it cannot take this one).

The top K follows ``lax.top_k``: the map is flattened in tpucv's NHWC
order (flat index ``(y·W + x)·C + c``) and sorted stably, so ties (the
zeros when fewer than K peaks are positive) come out lowest index first.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpucv_torch.nn.blocks import max_pool_same
from tpucv_torch.ops.nms import nms


def decode_centernet(
    output: torch.Tensor,        # (B, H, W, C + 4)
    num_classes: int,
    downsample: int = 4,
    K: int = 100,
    conf_threshold: float = 0.1,
    use_diou_nms: bool = True,
    iou_threshold: float = 0.5,
) -> Tuple[torch.Tensor, ...]:
    """Returns (boxes (B, K, 4) xyxy input pixels, scores, classes int32,
    valid)."""
    B, H, W, _ = output.shape
    C = num_classes
    hm = torch.sigmoid(output[..., :C].float())
    reg = output[..., C:C + 2].float().reshape(B, H * W, 2)
    wh = output[..., C + 2:C + 4].float().reshape(B, H * W, 2)

    # keep the local 3x3 maxima only
    peak = max_pool_same(hm.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    hm = torch.where((peak - hm).abs() < 1e-6, hm, torch.zeros_like(hm))

    scores, idx = torch.sort(hm.reshape(B, -1), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :K], idx[:, :K]
    cls = (idx % C).to(torch.int32)
    pos = idx // C
    ys = (pos // W).float()
    xs = (pos % W).float()
    at = pos[..., None].expand(-1, -1, 2)
    wh_k = torch.gather(wh, 1, at)
    reg_k = torch.gather(reg, 1, at)

    cx = (xs + reg_k[..., 0]) * downsample
    cy = (ys + reg_k[..., 1]) * downsample
    bw = wh_k[..., 0] * downsample
    bh = wh_k[..., 1] * downsample
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    valid = scores > conf_threshold
    zero = torch.zeros_like(scores)
    if not use_diou_nms:
        return boxes, torch.where(valid, scores, zero), cls, valid
    keep_idx, keep_valid = nms(boxes, torch.where(valid, scores, zero),
                               iou_threshold, K, diou=True)
    keep_idx = keep_idx.long()
    s = torch.gather(scores, 1, keep_idx)
    boxes = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    return (boxes, torch.where(keep_valid, s, zero),
            torch.gather(cls, 1, keep_idx),
            keep_valid & (s > conf_threshold))
