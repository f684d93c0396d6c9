"""Unified detection dataset + augmentation stack, host side (counterpart
of ``tpucv/data/detection_dataset.py``, whose samples it reproduces byte
for byte).

Behavioural parity with the reference ``DetectionDataset``
(``core/data/detection_dataset.py``): per-image random path = jittered
aspect/scale resize, random placement on a 128-gray canvas, hflip, HSV LUT
jitter (h=.1, s=.7, v=.4) (get_random_data :132-220); mosaic-4 gated by prob
and ``special_aug_ratio`` x epochs (:60-99, :222-449); eval path = centred
letterbox (:137-166).

Deltas from the reference, as tpucv has them:
  * outputs are FIXED SHAPE: uint8 (S,S,3) image + (max_boxes, 5) padded
    [class, x1, y1, x2, y2 pixels] + valid mask — no ragged collate, the
    batch goes straight to the device.
  * normalisation happens on the device (tpucv_torch.ops.preprocess or
    tpucv_torch.ops.augment), not here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

import cv2

from tpucv_torch.utils.image_process import letter_box, read_image


def _rand(rng, a: float = 0.0, b: float = 1.0) -> float:
    return float(rng.random()) * (b - a) + a


def hsv_jitter(image: np.ndarray, rng, hgain=0.1, sgain=0.7, vgain=0.4):
    """HSV LUT jitter, same gains/LUT construction as the reference
    (detection_dataset.py:200-214)."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(image, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    img_hsv = cv2.merge(
        (cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
    return cv2.cvtColor(img_hsv, cv2.COLOR_HSV2RGB)


class DetectionDataset:
    """Wraps an index (VOCDetectionIndex / COCOIndex / synthetic) and yields
    fixed-shape augmented samples."""

    def __init__(
        self,
        index,
        input_size: int = 640,
        max_boxes: int = 100,
        train: bool = True,
        mosaic_prob: float = 0.5,
        special_aug_ratio: float = 0.7,
        epochs: int = 100,
        jitter: float = 0.3,
        scale_range: Tuple[float, float] = (0.25, 2.0),
        seed: int = 0,
        device_aug: bool = False,
    ):
        self.index = index
        self.size = input_size
        self.max_boxes = max_boxes
        self.train = train
        self.mosaic_prob = mosaic_prob
        self.special_aug_ratio = special_aug_ratio
        self.epochs = epochs
        self.jitter = jitter
        self.scale_range = scale_range
        self.epoch = 0
        self._rng = np.random.default_rng(seed)
        # device_aug: the host only decodes + letterboxes (and builds the
        # occasional mosaic); per-sample affine/flip/HSV run on the device
        # through tpucv_torch.ops.augment.
        self.device_aug = device_aug

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------------ API
    def __getitem__(self, i: int):
        if self.train:
            use_mosaic = (
                self._rng.random() < self.mosaic_prob
                and self.epoch < self.epochs * self.special_aug_ratio
            )
            if use_mosaic:
                img, boxes, labels = self._mosaic4(i)
            elif self.device_aug:
                img, boxes, labels = self._eval_single(i)
            else:
                img, boxes, labels = self._random_single(i)
            if self.device_aug:
                # host_aug flags samples already fully augmented on the host
                # (mosaic, which ends in its own HSV jitter like the
                # reference); the trainer neutralises the device affine/HSV
                # for them so mosaics are not double-augmented — the
                # reference applies NO further aug after mosaic.
                return img, *self._pad(boxes, labels), bool(use_mosaic)
        else:
            img, boxes, labels = self._eval_single(i)
        return img, *self._pad(boxes, labels)

    def _pad(self, boxes: np.ndarray, labels: np.ndarray):
        m = self.max_boxes
        out = np.zeros((m, 5), np.float32)
        mask = np.zeros((m,), bool)
        n = min(len(boxes), m)
        if n:
            out[:n, 0] = labels[:n]
            out[:n, 1:] = boxes[:n]
            mask[:n] = True
        return out, mask

    # ------------------------------------------------------------ eval path
    def _eval_single(self, i: int):
        path, boxes, labels = self.index[i]
        img = read_image(path) if isinstance(path, str) else path
        canvas, scale, (px, py) = letter_box(img, (self.size, self.size))
        if len(boxes):
            boxes = boxes * scale
            boxes[:, [0, 2]] += px
            boxes[:, [1, 3]] += py
        return canvas, boxes, labels

    # --------------------------------------------------------- random path
    def _random_single(self, i: int, canvas_fill: int = 128):
        """Jittered resize + random placement + hflip + HSV
        (reference get_random_data :132-220)."""
        rng = self._rng
        path, boxes, labels = self.index[i]
        img = read_image(path) if isinstance(path, str) else path
        h, w = img.shape[:2]
        S = self.size

        new_ar = (w / h) * _rand(rng, 1 - self.jitter, 1 + self.jitter) / \
            _rand(rng, 1 - self.jitter, 1 + self.jitter)
        scale = _rand(rng, *self.scale_range)
        if new_ar < 1:
            nh = int(scale * S)
            nw = int(nh * new_ar)
        else:
            nw = int(scale * S)
            nh = int(nw / new_ar)
        nw, nh = max(nw, 1), max(nh, 1)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)

        dx = int(_rand(rng, 0, max(S - nw, 0))) if S > nw else int(_rand(rng, S - nw, 0))
        dy = int(_rand(rng, 0, max(S - nh, 0))) if S > nh else int(_rand(rng, S - nh, 0))
        canvas = np.full((S, S, 3), canvas_fill, np.uint8)
        # paste with clipping
        sx0, sy0 = max(-dx, 0), max(-dy, 0)
        tx0, ty0 = max(dx, 0), max(dy, 0)
        cw = min(nw - sx0, S - tx0)
        ch = min(nh - sy0, S - ty0)
        if cw > 0 and ch > 0:
            canvas[ty0:ty0 + ch, tx0:tx0 + cw] = img[sy0:sy0 + ch, sx0:sx0 + cw]

        if len(boxes):
            b = boxes.copy()
            b[:, [0, 2]] = b[:, [0, 2]] * nw / w + dx
            b[:, [1, 3]] = b[:, [1, 3]] * nh / h + dy
        else:
            b = boxes

        flip = rng.random() < 0.5
        if flip:
            canvas = canvas[:, ::-1].copy()
            if len(b):
                b[:, [0, 2]] = S - b[:, [2, 0]]

        canvas = hsv_jitter(canvas, rng)
        b, labels = self._clip_filter(b, labels)
        return canvas, b, labels

    def _clip_filter(self, boxes: np.ndarray, labels: np.ndarray,
                     min_wh: float = 2.0):
        """Clip to canvas and drop degenerate boxes (reference :216-220)."""
        if not len(boxes):
            return boxes, labels
        S = self.size
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, S)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, S)
        keep = ((boxes[:, 2] - boxes[:, 0]) > min_wh) & \
               ((boxes[:, 3] - boxes[:, 1]) > min_wh)
        return boxes[keep], labels[keep]

    # -------------------------------------------------------------- mosaic
    def _mosaic4(self, i: int):
        """4-image mosaic (reference :222-449): one quadrant per image around
        a jittered centre point."""
        rng = self._rng
        S = self.size
        idxs = [i] + list(rng.integers(0, len(self.index), 3))
        cx = int(_rand(rng, 0.3, 0.7) * S)
        cy = int(_rand(rng, 0.3, 0.7) * S)
        canvas = np.full((S, S, 3), 128, np.uint8)
        all_boxes, all_labels = [], []
        # quadrant target regions: (x0, y0, x1, y1)
        regions = [(0, 0, cx, cy), (cx, 0, S, cy), (0, cy, cx, S), (cx, cy, S, S)]
        for k, idx in enumerate(idxs):
            path, boxes, labels = self.index[idx]
            img = read_image(path) if isinstance(path, str) else path
            if rng.random() < 0.5:
                img = img[:, ::-1].copy()
                if len(boxes):
                    boxes = boxes.copy()
                    w0 = img.shape[1]
                    boxes[:, [0, 2]] = w0 - boxes[:, [2, 0]]
            x0, y0, x1, y1 = regions[k]
            tw, th = x1 - x0, y1 - y0
            if tw <= 0 or th <= 0:
                continue
            h, w = img.shape[:2]
            scale = max(tw / w, th / h) * _rand(rng, 0.8, 1.2)
            nw, nh = max(int(w * scale), 1), max(int(h * scale), 1)
            img = cv2.resize(img, (nw, nh))
            # align the image so it covers the region (anchor at region corner
            # nearest the mosaic centre, like the reference's seam alignment)
            ox = x1 - nw if k in (0, 2) else x0
            oy = y1 - nh if k in (0, 1) else y0
            sx0, sy0 = max(x0 - ox, 0), max(y0 - oy, 0)
            sx1, sy1 = min(x1 - ox, nw), min(y1 - oy, nh)
            if sx1 > sx0 and sy1 > sy0:
                canvas[oy + sy0:oy + sy1, ox + sx0:ox + sx1] = \
                    img[sy0:sy1, sx0:sx1]
            if len(boxes):
                # EFFECTIVE per-axis ratios (int truncation of nw/nh): the
                # exact float scale misaligned boxes with the resized
                # pixels by up to 1 px (_random_single already used
                # nw/w, nh/h)
                b = boxes.astype(np.float32)   # astype copies
                b[:, [0, 2]] *= nw / w
                b[:, [1, 3]] *= nh / h
                b[:, [0, 2]] += ox
                b[:, [1, 3]] += oy
                b[:, [0, 2]] = b[:, [0, 2]].clip(x0, x1)
                b[:, [1, 3]] = b[:, [1, 3]].clip(y0, y1)
                keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
                all_boxes.append(b[keep])
                all_labels.append(labels[keep])
        if all_boxes:
            boxes = np.concatenate(all_boxes)
            labels = np.concatenate(all_labels)
            if len(boxes) > self.max_boxes:
                # _pad truncates to max_boxes in deterministic order, which
                # would ALWAYS drop the later quadrants on dense scenes —
                # shuffle first so the cut is unbiased
                perm = rng.permutation(len(boxes))
                boxes, labels = boxes[perm], labels[perm]
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        canvas = hsv_jitter(canvas, rng)
        return canvas, boxes, labels


class SyntheticDetectionIndex:
    """Procedural dataset for tests/smoke runs — random coloured rectangles on
    noise backgrounds, deterministic per index. Fills the role real VOC/COCO
    data plays on machines that have it."""

    def __init__(self, n: int = 64, image_size: int = 320, num_classes: int = 20,
                 max_objects: int = 6, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.max_objects = max_objects
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100003 + i)
        S = self.image_size
        # tile a small noise patch instead of S^2 rng draws: full-frame noise
        # was 60%+ of loader benchmark time and adds nothing for tests
        t = min(64, S)
        patch = rng.integers(0, 60, (t, t, 3), dtype=np.uint8)
        reps = -(-S // t)
        img = np.tile(patch, (reps, reps, 1))[:S, :S].copy()
        n_obj = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n_obj):
            w = int(rng.integers(S // 8, S // 2))
            h = int(rng.integers(S // 8, S // 2))
            x = int(rng.integers(0, S - w))
            y = int(rng.integers(0, S - h))
            c = int(rng.integers(0, self.num_classes))
            color = (int(80 + 170 * c / max(self.num_classes - 1, 1)),
                     int(rng.integers(100, 255)), int(rng.integers(100, 255)))
            img[y:y + h, x:x + w] = color
            boxes.append([x, y, x + w, y + h])
            labels.append(c)
        return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)
