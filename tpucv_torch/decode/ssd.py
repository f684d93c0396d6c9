"""SSD decode (counterpart of ``tpucv/decode/ssd.py``): raw (loc, conf) ->
fixed-shape detections. f32 softmax with the background class dropped,
the offsets decoded against the priors, clipped to [0, 1] and scaled to
the input size, then the multilabel NMS (at SSD's K = 1,024 through
``nms_keep`` on the card)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpucv_torch.ops.nms import batched_non_max_suppression_multilabel
from tpucv_torch.targets.ssd import decode_boxes as decode_loc


def decode_ssd(
    loc: torch.Tensor,          # (B, A, 4)
    conf: torch.Tensor,         # (B, A, nc) logits, background class 0
    priors: torch.Tensor,       # (A, 4) xyxy normalised
    input_size: int,
    conf_threshold: float = 0.5,
    iou_threshold: float = 0.45,
    max_det: int = 100,
    pre_nms_topk: int = 1024,
    variances: Sequence[float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, ...]:
    """Returns (boxes (B, max_det, 4) xyxy px, scores, classes int32 in
    [0, nc - 1), valid)."""
    scores = torch.softmax(conf.float(), -1)[..., 1:]
    boxes = decode_loc(loc.float(), priors[None], variances)
    boxes = boxes.clamp(0.0, 1.0) * input_size
    return batched_non_max_suppression_multilabel(
        boxes, scores, conf_threshold, iou_threshold, max_det, pre_nms_topk)
