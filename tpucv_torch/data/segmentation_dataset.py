"""Semantic-segmentation datasets (counterpart of
``tpucv/data/segmentation_dataset.py``; the reference's
``core/data/segmentation_dataset.py``): VOC (and the SBD and Cityscapes
layouts) with the RGB -> class-index 256^3 colour LUT (:70-79, :200-209),
the scale jitter, random crop and flip of training and the centre crop of
evaluation; the ImageNet normalisation runs on the device. A synthetic
fallback is included. numpy and cv2 only: the loader's workers run it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

# VOC colour table (reference segmentation_dataset.py:14-36)
VOC_COLORMAP = [
    [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
    [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0], [192, 0, 0],
    [64, 128, 0], [192, 128, 0], [64, 0, 128], [192, 0, 128], [64, 128, 128],
    [192, 128, 128], [0, 64, 0], [128, 64, 0], [0, 192, 0], [128, 192, 0],
    [0, 64, 128],
]


def colormap2label() -> np.ndarray:
    """256^3 LUT mapping packed RGB -> class index
    (reference :200-209); unknown colours -> 255 (ignore)."""
    lut = np.full(256**3, 255, np.uint8)
    for i, (r, g, b) in enumerate(VOC_COLORMAP):
        lut[(r * 256 + g) * 256 + b] = i
    return lut


_LUT = None


def label_indices(mask_rgb: np.ndarray) -> np.ndarray:
    global _LUT
    if _LUT is None:
        _LUT = colormap2label()
    idx = (mask_rgb[..., 0].astype(np.int32) * 256
           + mask_rgb[..., 1].astype(np.int32)) * 256 \
        + mask_rgb[..., 2].astype(np.int32)
    return _LUT[idx]


class SegmentationDataset:
    """Yields fixed-shape (image uint8 (S, S, 3), label int32 (S, S), a
    True flag). Training scales the image by S / its short side times a
    jitter in [0.75, 1.5), crops at random and flips half the time, all
    drawn from ``_rng`` (which the loader reseeds each batch); evaluation
    scales the short side to S and centre-crops."""

    def __init__(self, samples, crop_size: int = 513, train: bool = True,
                 seed: int = 0, ignore_index: int = 255):
        self.samples = samples      # list of (img_path|array, mask_path|array)
        self.crop = crop_size
        self.train = train
        self.ignore_index = ignore_index
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int):
        pass

    def __len__(self):
        return len(self.samples)

    def _load(self, item):
        img, mask = item
        if isinstance(img, str):
            bgr = cv2.imread(img, cv2.IMREAD_COLOR)
            img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if isinstance(mask, str):
            m = cv2.imread(mask, cv2.IMREAD_UNCHANGED)
            if m is None:
                raise FileNotFoundError(mask)
            if m.ndim == 3:  # colour png -> class indices via LUT
                m = label_indices(cv2.cvtColor(m, cv2.COLOR_BGR2RGB))
            mask = m.astype(np.uint8)
        return img, mask

    def __getitem__(self, i):
        img, mask = self._load(self.samples[i])
        S = self.crop
        h, w = img.shape[:2]
        # the short side to >= S (training jitters the scale)
        scale = S / min(h, w)
        if self.train:
            scale *= float(self._rng.uniform(0.75, 1.5))
        nh, nw = max(int(h * scale), S), max(int(w * scale), S)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask, (nw, nh), interpolation=cv2.INTER_NEAREST)
        if self.train:
            y0 = int(self._rng.integers(0, nh - S + 1))
            x0 = int(self._rng.integers(0, nw - S + 1))
        else:
            y0, x0 = (nh - S) // 2, (nw - S) // 2
        img = img[y0:y0 + S, x0:x0 + S]
        mask = mask[y0:y0 + S, x0:x0 + S]
        if self.train and self._rng.random() < 0.5:
            img = img[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
        return img, mask.astype(np.int32), np.ones((), bool)


# Cityscapes 19-class train-id palette (reference segmentation_dataset.py:38-67)
CITYSCAPES_COLORMAP = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32],
]

# cityscapes full label id -> train id (255 = ignore)
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def cityscapes_id_lut() -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for k, v in _CITYSCAPES_ID_TO_TRAIN.items():
        lut[k] = v
    return lut


def build_cityscapes_samples(root: str, split: str) -> List[Tuple[str, str]]:
    """leftImg8bit/<split>/<city>/*.png + gtFine labelIds
    (reference get_cityscapes_dataloader :212-253)."""
    img_root = os.path.join(root, "leftImg8bit", split)
    samples = []
    for city in sorted(os.listdir(img_root)):
        for f in sorted(os.listdir(os.path.join(img_root, city))):
            if not f.endswith("_leftImg8bit.png"):
                continue
            mask = f.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
            samples.append((
                os.path.join(img_root, city, f),
                os.path.join(root, "gtFine", split, city, mask)))
    return samples


def build_sbd_samples(root: str, split: str) -> List[Tuple[str, str]]:
    """SBD benchmark layout: img/*.jpg + cls/*.mat-derived pngs (we expect
    pre-converted pngs under cls_png/, the common preprocessing)
    (reference get_sbd_dataloader :296-337)."""
    split_file = os.path.join(root, f"{split}.txt")
    with open(split_file) as f:
        ids = [l.strip() for l in f if l.strip()]
    return [(os.path.join(root, "img", f"{i}.jpg"),
             os.path.join(root, "cls_png", f"{i}.png")) for i in ids]


def build_voc_seg_samples(root: str, split: str) -> List[Tuple[str, str]]:
    split_file = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
    with open(split_file) as f:
        ids = [l.strip() for l in f if l.strip()]
    return [(os.path.join(root, "JPEGImages", f"{i}.jpg"),
             os.path.join(root, "SegmentationClass", f"{i}.png")) for i in ids]


class SyntheticSegIndex:
    """Random polygons with exact masks — synthetic stand-in for VOC seg."""

    def __init__(self, n=32, size=128, num_classes=21, seed=0):
        self.n, self.size, self.nc, self.seed = n, size, num_classes, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 7919 + i)
        S = self.size
        img = rng.integers(0, 50, (S, S, 3), dtype=np.uint8)
        mask = np.zeros((S, S), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(1, self.nc))
            w, h = int(rng.integers(S // 6, S // 2)), int(rng.integers(S // 6, S // 2))
            x, y = int(rng.integers(0, S - w)), int(rng.integers(0, S - h))
            img[y:y + h, x:x + w] = (40 + 10 * c) % 255
            mask[y:y + h, x:x + w] = c
        return img, mask


def synthetic_seg_samples(n=32, size=128, num_classes=21, seed=0):
    idx = SyntheticSegIndex(n, size, num_classes, seed)
    return [idx[i] for i in range(n)]
