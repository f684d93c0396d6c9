"""Image-classification data (counterpart of
``tpucv/data/classification_dataset.py``: the same samples, byte for
byte): a folder-per-class index and a synthetic fallback. Layout follows
the torchvision ImageFolder convention::

    root/train/<class_name>/*.jpg
    root/val/<class_name>/*.jpg
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageFolderIndex:
    """Index of a folder-per-class tree: samples are (path, label)."""

    def __init__(self, root: str, split: str = "train",
                 classes: Optional[List[str]] = None):
        split_dir = os.path.join(root, split)
        self.classes = classes or sorted(
            d for d in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, d)))
        self.cls_to_id = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(split_dir, c)
            if not os.path.isdir(cdir):   # pinned class absent in this split
                continue
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, f),
                                         self.cls_to_id[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class SyntheticClsIndex:
    """Learnable synthetic classes: class k = background hue k plus k+1
    bright blobs — separable by both color and count."""

    def __init__(self, n: int, size: int, nc: int, seed: int = 0):
        self.n, self.size, self.nc = n, size, nc
        self.rng_seed = seed
        self.classes = [f"c{k}" for k in range(nc)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.rng_seed * 100003 + i)
        k = i % self.nc
        s = self.size
        img = np.full((s, s, 3), 20, np.uint8)
        img[..., k % 3] = 40 + 15 * (k // 3)
        for _ in range(k + 1):
            w = int(rng.integers(s // 8, s // 3))
            x = int(rng.integers(0, s - w))
            y = int(rng.integers(0, s - w))
            img[y:y + w, x:x + w] = rng.integers(150, 255, 3)
        return img, k


class ClassificationDataset:
    """Wraps an index; yields fixed-shape {"images" uint8, "labels" int32}.
    Train-time augmentation: random horizontal flip + random resized crop
    (host-side; the heavy normalize runs on-chip in the trainer)."""

    def __init__(self, index, size: int, train: bool = False):
        self.index = index
        self.size = size
        self.train = train

    def __len__(self):
        return len(self.index)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, i):
        import cv2

        item = self.index[i]
        if isinstance(item[0], str):
            from tpucv_torch.utils.image_process import read_image
            img, label = read_image(item[0]), item[1]
        else:
            img, label = item
        s = self.size
        if self.train:
            rng = np.random.default_rng(
                (getattr(self, "_epoch", 0) * 1000003 + i) & 0x7FFFFFFF)
            h, w = img.shape[:2]
            scale = rng.uniform(0.7, 1.0)
            ch, cw = int(h * scale), int(w * scale)
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            img = img[y0:y0 + ch, x0:x0 + cw]
            if rng.random() < 0.5:
                img = img[:, ::-1]
        if img.shape[:2] != (s, s):
            img = cv2.resize(np.ascontiguousarray(img), (s, s),
                             interpolation=cv2.INTER_LINEAR)
        return {"images": img.astype(np.uint8),
                "labels": np.int32(label)}


def classification_collate(items: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {
        "images": np.stack([it["images"] for it in items]),
        "labels": np.asarray([it["labels"] for it in items], np.int32),
    }
