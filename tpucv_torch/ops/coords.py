"""Coordinate-format conversions and letterbox box / keypoint rescaling
(counterpart of ``tpucv/ops/coords.py``).

The box and point functions take torch tensors (any leading shape, on any
device) and compute in tpucv's operation order, in the tensor's dtype; the
segment functions are host numpy, for ragged polygons.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpucv_torch.ops.boxes import xyxy2xywh


# ------------------------------------------------------------ clip / scale
def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to the image bounds ``shape`` = (h, w, ...)."""
    h, w = shape[:2]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


def clip_coords(coords: torch.Tensor, shape) -> torch.Tensor:
    """Clip (..., 2) xy points to the image bounds (h, w)."""
    h, w = shape[:2]
    return torch.stack([coords[..., 0].clamp(0, w),
                        coords[..., 1].clamp(0, h)], -1)


def _letterbox_gain_pad(img1_shape, img0_shape, ratio_pad=None):
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    return gain, pad


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape,
                ratio_pad=None) -> torch.Tensor:
    """xyxy boxes on the letterboxed canvas ``img1_shape`` -> the original
    image ``img0_shape``, clipped to it."""
    gain, pad = _letterbox_gain_pad(img1_shape, img0_shape, ratio_pad)
    off = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype,
                       device=boxes.device)
    return clip_boxes((boxes - off) / gain, img0_shape)


def scale_coords(img1_shape, coords: torch.Tensor, img0_shape,
                 ratio_pad=None, normalize: bool = False) -> torch.Tensor:
    """The same for (..., 2+) keypoints, clipped; with ``normalize`` the
    xy are divided by the image's (w, h). Channels past the second
    (visibility) pass through."""
    gain, pad = _letterbox_gain_pad(img1_shape, img0_shape, ratio_pad)
    xy = (coords[..., :2] - torch.tensor(pad, dtype=coords.dtype,
                                         device=coords.device)) / gain
    xy = clip_coords(xy, img0_shape)
    if normalize:
        xy = xy / torch.tensor([img0_shape[1], img0_shape[0]],
                               dtype=coords.dtype, device=coords.device)
    return torch.cat([xy, coords[..., 2:]], -1) if coords.shape[-1] > 2 \
        else xy


# ------------------------------------------------------------- xy families
def xywhn2xyxy(x: torch.Tensor, w=640, h=640, padw=0, padh=0) -> torch.Tensor:
    """Normalised (cx, cy, w, h) -> pixel xyxy."""
    cx, cy, bw, bh = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh],
                       -1)


def xyxy2xywhn(x: torch.Tensor, w=640, h=640, clip=False,
               eps=0.0) -> torch.Tensor:
    """Pixel xyxy -> normalised (cx, cy, w, h), the boxes first clipped to
    (h - eps, w - eps) when ``clip``."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([(x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                        (x2 - x1) / w, (y2 - y1) / h], -1)


def xyn2xy(x: torch.Tensor, w=640, h=640, padw=0, padh=0) -> torch.Tensor:
    """Normalised xy segment points -> pixels."""
    return torch.stack([w * x[..., 0] + padw, h * x[..., 1] + padh], -1)


def xywh2ltwh(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0] - x[..., 2] / 2, x[..., 1] - x[..., 3] / 2,
                        x[..., 2], x[..., 3]], -1)


def xyxy2ltwh(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0], x[..., 1],
                        x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]], -1)


def ltwh2xywh(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0] + x[..., 2] / 2, x[..., 1] + x[..., 3] / 2,
                        x[..., 2], x[..., 3]], -1)


def ltwh2xyxy(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0], x[..., 1],
                        x[..., 0] + x[..., 2], x[..., 1] + x[..., 3]], -1)


# -------------------------------------------------------------- segments
def segment2box(segment, width=640, height=640) -> np.ndarray:
    """Polygon (N, 2) -> the xyxy box (f32) of its points inside the
    image, zeros when none is."""
    seg = np.asarray(segment, np.float32)
    x, y = seg[:, 0], seg[:, 1]
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    if not len(x):
        return np.zeros(4, np.float32)
    return np.array([x.min(), y.min(), x.max(), y.max()], np.float32)


def segments2boxes(segments) -> np.ndarray:
    """Polygons -> (N, 4) f32 (cx, cy, w, h) boxes; an empty polygon's is
    zeros."""
    boxes = []
    for s in segments:
        s = np.asarray(s, np.float32)
        boxes.append([s[:, 0].min(), s[:, 1].min(), s[:, 0].max(),
                      s[:, 1].max()] if len(s) else [0.0, 0.0, 0.0, 0.0])
    return xyxy2xywh(torch.from_numpy(np.asarray(boxes, np.float32)
                                      .reshape(-1, 4))).numpy()


def resample_segments(segments, n=1000):
    """Each polygon resampled to ``n`` points, evenly in index along its
    closed contour, by linear interpolation (float64 points)."""
    out = []
    for s in segments:
        s = np.asarray(s, np.float32)
        s = np.concatenate([s, s[0:1]], axis=0)     # close the loop
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, 0]),
                             np.interp(x, xp, s[:, 1])], axis=-1))
    return out


def make_divisible(x, divisor) -> int:
    """``x`` rounded up to a multiple of ``divisor``."""
    return math.ceil(x / divisor) * divisor
