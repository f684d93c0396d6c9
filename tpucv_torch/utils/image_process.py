"""Host-side image IO and letterbox geometry (counterpart of
``tpucv/utils/image_process.py``). ``cv2`` is imported only by the functions
that decode files or resize on the host."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC, EXIF orientation ignored.

    JPEGs take the native decode (``native/imagepipe.cpp``: libjpeg
    straight to RGB, bit-identical to cv2's decode and conversion); what
    it cannot read (PNG, CMYK, corrupt files) and every file when the
    library is unavailable go through cv2."""
    path = str(path)
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        from tpucv_torch.native import imagepipe
        img = imagepipe.decode_jpeg(path)
        if img is not None:
            return img
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def letter_box(
    image: np.ndarray, size: Tuple[int, int], fill: int = 128
) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving INTER_NEAREST resize onto an (H, W) canvas padded
    with ``fill``, centred. Returns (canvas uint8, scale, (pad_x, pad_y))."""
    import cv2

    h, w = image.shape[:2]
    H, W = size
    scale = min(W / w, H / h)
    nw, nh = int(w * scale), int(h * scale)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_NEAREST)
    canvas = np.full((H, W, 3), fill, dtype=image.dtype)
    px, py = (W - nw) // 2, (H - nh) // 2
    canvas[py:py + nh, px:px + nw] = resized
    return canvas, scale, (px, py)


def reverse_letter_box(
    boxes: np.ndarray, scale, pad: Tuple[int, int],
    orig_shape: Tuple[int, int], clip: bool = True,
) -> np.ndarray:
    """Map xyxy boxes from letterboxed-input pixels back to original-image
    pixels. ``scale`` is a scalar or a per-axis (sx, sy) pair.
    ``clip=False`` keeps boxes that extend past the image, as the
    evaluation protocol does."""
    px, py = pad
    sx, sy = scale if isinstance(scale, (tuple, list)) else (scale, scale)
    out = boxes.astype(np.float32).copy()
    out[..., [0, 2]] = (out[..., [0, 2]] - px) / sx
    out[..., [1, 3]] = (out[..., [1, 3]] - py) / sy
    if clip:
        h, w = orig_shape
        out[..., [0, 2]] = out[..., [0, 2]].clip(0, w)
        out[..., [1, 3]] = out[..., [1, 3]].clip(0, h)
    return out
