"""Detection drawing (counterpart of ``tpucv/utils/visualize.py``; reference
``core/utils/visualize.py``): an 80-colour palette, ``class: conf`` labels,
``name@timestamp.jpg`` save names."""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np


def _palette(n: int = 80):
    rng = np.random.default_rng(12345)
    return [tuple(int(c) for c in rng.integers(64, 255, 3)) for _ in range(n)]


PALETTE = _palette()


def draw_detections(
    image_rgb: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    class_names: Sequence[str],
) -> np.ndarray:
    """A copy of ``image_rgb`` with each xyxy box, its class name and its
    score drawn on it."""
    import cv2

    img = image_rgb.copy()
    for box, score, cls in zip(boxes, scores, classes):
        c = int(cls) % len(PALETTE)
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        cv2.rectangle(img, (x1, y1), (x2, y2), PALETTE[c], 2)
        label = f"{class_names[int(cls)]}: {score:.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x1, y1 - th - 4), (x1 + tw, y1), PALETTE[c], -1)
        cv2.putText(img, label, (x1, y1 - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 0), 1, cv2.LINE_AA)
    return img


def show_detection_results(
    image_rgb: np.ndarray, boxes, scores, classes, class_names,
    save_dir: str = "detect_results", name: str = "result",
) -> str:
    """Draw the detections and write them to
    ``save_dir/name@<timestamp>.jpg``; returns the path."""
    import cv2

    img = draw_detections(image_rgb, boxes, scores, classes, class_names)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}@{time.strftime('%Y%m%d%H%M%S')}.jpg")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return path
