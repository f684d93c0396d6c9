"""Composable host-side transforms (counterpart of
``tpucv/data/transforms.py``; reference ``core/data/transforms.py:
15-76``: Compose / ToTensor / Resize-letterbox / ImageColorJitter /
TargetPadding). The trainers use the fused dataset/device paths; these exist
for library users building custom pipelines."""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from tpucv_torch.data.detection_dataset import hsv_jitter
from tpucv_torch.utils.image_process import letter_box


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, image, boxes, labels):
        for t in self.transforms:
            image, boxes, labels = t(image, boxes, labels)
        return image, boxes, labels


class ToFloat:
    """uint8 -> float32 in [0,1] (the reference's ToTensor analogue;
    device-side normalisation is preferred for the hot path)."""

    def __call__(self, image, boxes, labels):
        return image.astype(np.float32) / 255.0, boxes, labels


class ResizeLetterbox:
    """Aspect-preserving resize+pad with box adjustment
    (reference Resize :34-55)."""

    def __init__(self, size: int, fill: int = 128):
        self.size = size
        self.fill = fill

    def __call__(self, image, boxes, labels):
        canvas, scale, (px, py) = letter_box(
            image, (self.size, self.size), self.fill)
        if len(boxes):
            boxes = boxes * scale
            boxes[:, [0, 2]] += px
            boxes[:, [1, 3]] += py
        return canvas, boxes, labels


class ImageColorJitter:
    """HSV jitter (reference :57-63)."""

    def __init__(self, hgain=0.1, sgain=0.7, vgain=0.4, seed: int = 0):
        self.gains = (hgain, sgain, vgain)
        self._rng = np.random.default_rng(seed)

    def __call__(self, image, boxes, labels):
        return hsv_jitter(image, self._rng, *self.gains), boxes, labels


class TargetPadding:
    """Pad boxes/labels to a fixed count (reference :65-76)."""

    def __init__(self, max_num: int = 100):
        self.max_num = max_num

    def __call__(self, image, boxes, labels):
        m = self.max_num
        out_b = np.zeros((m, 4), np.float32)
        out_l = np.full((m,), -1, np.int32)
        n = min(len(boxes), m)
        if n:
            out_b[:n] = boxes[:n]
            out_l[:n] = labels[:n]
        return image, out_b, out_l
