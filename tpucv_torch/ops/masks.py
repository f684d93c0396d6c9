"""Instance-mask ops (counterpart of ``tpucv/ops/masks.py``; reference
``core/utils/ultralytics_ops.py`` mask region :540-651): crop_mask,
process_mask (+ _upsample, _native), scale_image, masks2segments.

The prototype product runs in f32 with autocast off, as tpucv casts to f32
first: under ``torch.autocast`` a matmul would run in bf16 even on f32
inputs. tpucv's ``jax.image.resize(..., "bilinear")`` is
``F.interpolate(mode="bilinear", align_corners=False)``; jax antialiases
when it shrinks an axis, so ``antialias=True`` is asked for then.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each box.

    masks: (N, H, W); boxes: (N, 4) xyxy in mask pixels.
    """
    n, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None].split(1, dim=1)        # (N, 1, 1)
    c = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    r = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    keep = (c >= x1) & (c < x2) & (r >= y1) & (r < y2)
    return masks * keep


def _combine(protos: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """sigmoid(coefs @ protos): (N, nm) x (Hp, Wp, nm) -> (N, Hp, Wp), f32."""
    with torch.autocast(protos.device.type, enabled=False):
        return torch.sigmoid(torch.einsum("nm,hwm->nhw", coefs.float(),
                                          protos.float()))


def _resize(masks: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of (N, H, W) to (N, *hw), half-pixel centres,
    antialiased when an axis shrinks (jax.image.resize's default)."""
    h, w = masks.shape[-2:]
    hw = (int(hw[0]), int(hw[1]))
    if masks.shape[0] == 0:               # interpolate refuses no channels
        return masks.new_zeros((0, *hw))
    return F.interpolate(masks[None], size=hw, mode="bilinear",
                         align_corners=False,
                         antialias=hw[0] < h or hw[1] < w)[0]


def process_mask(protos: torch.Tensor, coefs: torch.Tensor,
                 boxes: torch.Tensor, input_hw,
                 upsample: bool = False) -> torch.Tensor:
    """Combine prototypes (Hp, Wp, nm) with per-detection coefficients
    (N, nm): sigmoid(coefs @ protos), cropped to the (N, 4) xyxy boxes
    given in input pixels; bilinear to ``input_hw`` when ``upsample``."""
    hp, wp, _ = protos.shape
    masks = _combine(protos, coefs)
    ih, iw = input_hw
    scale = torch.tensor([wp / iw, hp / ih, wp / iw, hp / ih],
                         dtype=masks.dtype, device=masks.device)
    masks = crop_mask(masks, boxes * scale)
    if upsample:
        masks = _resize(masks, (ih, iw))
    return masks


def process_mask_upsample(protos, coefs, boxes, input_hw):
    """Reference process_mask_upsample (ultralytics_ops.py:558-577):
    upsample the combined prototypes to input resolution first, then crop
    at full resolution."""
    return crop_mask(_resize(_combine(protos, coefs), input_hw), boxes)


def process_mask_native(protos, coefs, boxes, dst_hw, input_hw=None):
    """Reference process_mask_native (ultralytics_ops.py:611-635): combine
    prototypes, undo the letterbox (crop the pad, resize to the original
    image), then crop to boxes given in original-image pixels."""
    hp, wp, _ = protos.shape
    masks = _combine(protos, coefs)
    dh, dw = dst_hw
    gain = min(hp / dh, wp / dw)
    ph, pw = hp - dh * gain, wp - dw * gain      # total pad at proto scale
    # the reference's plain int truncation on both edges
    top, left = int(ph / 2), int(pw / 2)
    bottom, right = int(hp - ph / 2), int(wp - pw / 2)
    masks = masks[:, top:bottom, left:right]
    return crop_mask(_resize(masks, (dh, dw)), boxes)


def scale_image(masks, im0_shape, ratio_pad=None):
    """Undo the letterbox on a full-resolution mask/image array
    (ultralytics_ops.py:305-341): crop the pad, resize to im0. Host-side
    (numpy + cv2)."""
    import cv2

    masks = np.asarray(masks)
    im1_shape = masks.shape
    if im1_shape[:2] == tuple(im0_shape[:2]):
        return masks
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = ((im1_shape[1] - im0_shape[1] * gain) / 2,
               (im1_shape[0] - im0_shape[0] * gain) / 2)
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom, right = int(im1_shape[0] - pad[1]), int(im1_shape[1] - pad[0])
    masks = masks[top:bottom, left:right]
    return cv2.resize(masks, (im0_shape[1], im0_shape[0]))


def masks2segments(masks, strategy: str = "largest"):
    """Binary masks (N, H, W) -> list of (K, 2) float32 contours
    (ultralytics_ops.py:669-692). Host-side cv2.findContours; 'largest'
    keeps the biggest contour, 'concat' joins all."""
    import cv2

    segments = []
    for m in np.asarray(masks).astype(np.uint8):
        contours = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                    cv2.CHAIN_APPROX_SIMPLE)[0]
        if contours:
            if strategy == "concat":
                c = np.concatenate([c.reshape(-1, 2) for c in contours])
            else:
                c = max(contours, key=len).reshape(-1, 2)
        else:
            c = np.zeros((0, 2))
        segments.append(c.astype(np.float32))
    return segments
