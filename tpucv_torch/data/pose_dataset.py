"""Pose data (counterpart of ``tpucv/data/pose_dataset.py``, whose items
it reproduces byte for byte): a COCO person-keypoints index, a synthetic
fallback and the fixed-shape dataset."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from tpucv_torch.utils.image_process import read_image


class COCOKeypointIndex:
    """person_keypoints_*2017.json: samples are (path, boxes, labels=0),
    with per-sample keypoints (n, 17, 3). Crowd and keypoint-less persons
    are left out of the samples and kept for evaluation."""

    cat_ids = (1,)                       # COCO person category
    contig_to_cat = {0: 1}

    def __init__(self, annotation_file: str, image_root: str):
        with open(annotation_file) as f:
            data = json.load(f)
        images = {im["id"]: im for im in data["images"]}
        by_img: Dict[int, list] = {}       # trainable anns
        all_by_img: Dict[int, list] = {}   # every ann, for the eval protocol
        for a in data.get("annotations", []):
            all_by_img.setdefault(a["image_id"], []).append(a)
            if a.get("iscrowd", 0) or a.get("num_keypoints", 0) == 0:
                continue
            by_img.setdefault(a["image_id"], []).append(a)
        self.samples = []
        self.kpts: List[np.ndarray] = []
        self.ids: List[int] = []
        self._eval_anns: List[list] = []
        for img_id, anns in by_img.items():
            im = images[img_id]
            boxes = np.asarray(
                [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                 for a in anns], np.float32)
            labels = np.zeros(len(anns), np.int32)       # person only
            self.samples.append(
                (os.path.join(image_root, im["file_name"]), boxes, labels))
            self.kpts.append(np.asarray(
                [a["keypoints"] for a in anns],
                np.float32).reshape(len(anns), 17, 3))
            self.ids.append(img_id)
            self._eval_anns.append(all_by_img[img_id])

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def keypoints(self, i) -> np.ndarray:
        return self.kpts[i]

    def image_id(self, i) -> int:
        return self.ids[i]

    def eval_gt_records(self, i) -> List[dict]:
        """Full-protocol GT dicts: crowd and keypoint-less persons are kept
        (the evaluator treats them as ignore regions), as pycocotools
        does."""
        recs = []
        for a in self._eval_anns[i]:
            recs.append({
                "image_id": self.ids[i], "category_id": 1,
                "bbox": [float(v) for v in a["bbox"]],
                "area": float(a.get("area",
                                    a["bbox"][2] * a["bbox"][3])),
                "iscrowd": int(a.get("iscrowd", 0)),
                "keypoints": np.asarray(
                    a.get("keypoints", [0.0] * 51), np.float32),
                "num_keypoints": int(a.get("num_keypoints", 0)),
            })
        return recs


class SyntheticPoseIndex:
    """Rectangles whose keypoints sit at fixed fractional positions inside
    the box, learnable from box appearance alone."""

    # fractional (x, y) anchors inside the box, tiled to nk points
    _FRACS = np.array([[.5, .1], [.3, .3], [.7, .3], [.5, .5],
                       [.2, .7], [.8, .7], [.35, .9], [.65, .9]], np.float32)
    cat_ids = (1,)
    contig_to_cat = {0: 1}

    def __init__(self, n: int, size: int, nk: int = 17, seed: int = 0):
        self.n, self.size, self.nk, self.seed = n, size, nk, seed

    def __len__(self):
        return self.n

    def _fracs(self):
        reps = -(-self.nk // len(self._FRACS))
        return np.tile(self._FRACS, (reps, 1))[:self.nk]

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 99991 + i)
        S = self.size
        img = rng.integers(0, 50, (32, 32, 3), dtype=np.uint8)
        img = np.tile(img, (-(-S // 32), -(-S // 32), 1))[:S, :S].copy()
        n_obj = int(rng.integers(1, 4))
        boxes, labels = [], []
        for _ in range(n_obj):
            w = int(rng.integers(S // 6, S // 2))
            h = int(rng.integers(S // 6, S // 2))
            x = int(rng.integers(0, S - w))
            y = int(rng.integers(0, S - h))
            img[y:y + h, x:x + w] = rng.integers(120, 255, 3)
            boxes.append([x, y, x + w, y + h])
            labels.append(0)
        return (img, np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32))

    def keypoints(self, i) -> np.ndarray:
        _, boxes, _ = self[i]
        f = self._fracs()
        wh = boxes[:, 2:] - boxes[:, :2]
        xy = boxes[:, None, :2] + f[None] * wh[:, None]
        vis = np.full((len(boxes), self.nk, 1), 2.0, np.float32)
        return np.concatenate([xy, vis], -1).astype(np.float32)

    def image_id(self, i) -> int:
        return i

    def eval_gt_records(self, i) -> List[dict]:
        _, boxes, _ = self[i]
        kpts = self.keypoints(i)
        recs = []
        for b, kp in zip(boxes, kpts):
            recs.append({
                "image_id": i, "category_id": 1,
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])],
                "area": float((b[2] - b[0]) * (b[3] - b[1])),
                "iscrowd": 0,
                "keypoints": kp.reshape(-1),
                "num_keypoints": self.nk,
            })
        return recs


class PoseDataset:
    """Plain-resize items: images + padded boxes / labels / keypoints."""

    def __init__(self, index, input_size: int, max_boxes: int,
                 nk: int = 17, train: bool = False):
        self.index = index
        self.size = input_size
        self.max_boxes = max_boxes
        self.nk = nk
        self.train = train

    def __len__(self):
        return len(self.index)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, i):
        import cv2

        path, boxes, labels = self.index[i]
        img = read_image(path) if isinstance(path, str) else path
        h, w = img.shape[:2]
        S = self.size
        sx, sy = S / w, S / h
        if (h, w) != (S, S):
            img = cv2.resize(img, (S, S), interpolation=cv2.INTER_LINEAR)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4) \
            * np.asarray([sx, sy, sx, sy], np.float32)
        kpts = self.index.keypoints(i).copy()
        kpts[..., 0] *= sx
        kpts[..., 1] *= sy

        M, nk = self.max_boxes, self.nk
        n = min(len(boxes), M)
        out = {
            "images": img.astype(np.uint8),
            "gt_bboxes": np.zeros((M, 4), np.float32),
            "gt_labels": np.zeros((M,), np.int32),
            "gt_mask": np.zeros((M,), bool),
            "gt_kpts": np.zeros((M, nk, 3), np.float32),
        }
        out["gt_bboxes"][:n] = boxes[:n]
        out["gt_labels"][:n] = np.asarray(labels, np.int32)[:n]
        out["gt_mask"][:n] = True
        out["gt_kpts"][:n] = kpts[:n, :nk]
        return out


def pose_collate(items: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
