"""COCO detection annotations — pure-json index (counterpart of
``tpucv/data/coco.py``).

The reference depends on pycocotools' C extension for both dataset loading
(``core/data/detection_dataset.py``) and evaluation (``core/metrics/mAP.py``).
This index needs no pycocotools: it parses instances_*.json with the stdlib
and exposes the same facts (images, per-image anns, category mapping).
The evaluation side is tpucv's ``metrics/coco_map.py``, still to be ported.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


class COCOIndex:
    def __init__(self, annotation_file: str, image_root: str,
                 min_box: float = 1e-3, keep_polys: bool = False):
        with open(annotation_file) as f:
            data = json.load(f)
        self.image_root = image_root
        self.images = {im["id"]: im for im in data["images"]}
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]          # 80 official ids
        self.cat_to_contig = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.contig_to_cat = {i: cid for i, cid in enumerate(self.cat_ids)}
        self.cat_names = [c["name"] for c in cats]

        # Crowd annotations are KEPT but flagged: excluded from training
        # targets (the reference's dataset also trains on non-crowd only),
        # yet preserved for evaluation, where pycocotools treats them as
        # ignore regions (``core/algorithms/yolo_v8.py:330-381`` evaluates
        # through pycocotools, whose matcher ignores iscrowd GTs).
        anns_by_img = defaultdict(list)
        crowd_by_img = defaultdict(list)
        degen_by_img = defaultdict(list)
        for a in data.get("annotations", []):
            x, y, w, h = a["bbox"]
            if a.get("iscrowd", 0):
                crowd_by_img[a["image_id"]].append(a)
            elif w < min_box or h < min_box:
                # degenerate boxes are useless as TRAINING targets, but
                # pycocotools keeps every annotation in the eval GT set
                # (an unmatched recall-denominator entry) — dropping them
                # from eval_gt_records diverged from the reference
                # protocol
                degen_by_img[a["image_id"]].append(a)
            else:
                anns_by_img[a["image_id"]].append(a)

        def _pack(anns):
            if not anns:
                return (np.zeros((0, 4), np.float32),
                        np.zeros((0,), np.int32), np.zeros((0,), np.float32))
            boxes = np.asarray(
                [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                 for a in anns], np.float32)
            labels = np.asarray(
                [self.cat_to_contig[a["category_id"]] for a in anns],
                np.int32)
            areas = np.asarray(
                [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns],
                np.float32)
            return boxes, labels, areas

        self.samples: List[Tuple[str, np.ndarray, np.ndarray, int]] = []
        self.areas: List[np.ndarray] = []       # official ann areas (seg area)
        self.crowd: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # degenerate (sub-min_box) non-crowd anns: eval-only GT records
        self._degen: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # per-sample, per-ann polygon lists for instance segmentation
        # (list-format COCO "segmentation" only; RLE crowds are eval-only)
        self._polys: Optional[List[list]] = [] if keep_polys else None
        for img_id, im in self.images.items():
            anns = anns_by_img.get(img_id, [])
            boxes, labels, areas = _pack(anns)
            path = os.path.join(image_root, im["file_name"])
            self.samples.append((path, boxes, labels, img_id))
            self.areas.append(areas)
            self.crowd.append(_pack(crowd_by_img.get(img_id, [])))
            self._degen.append(_pack(degen_by_img.get(img_id, [])))
            if self._polys is not None:
                self._polys.append([
                    a.get("segmentation")
                    if isinstance(a.get("segmentation"), list) else None
                    for a in anns])

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i][:3]

    def image_id(self, i) -> int:
        return self.samples[i][3]

    def polygons(self, i, j):
        """Polygon list of the j-th kept annotation of image i (or None).
        Requires ``keep_polys=True`` at construction."""
        return self._polys[i][j] if self._polys is not None else None

    def eval_gt_records(self, i) -> List[dict]:
        """All GT records for image i in COCO-eval form — non-crowd first
        (incl. degenerate boxes pycocotools keeps as GTs), then crowd with
        ``iscrowd: 1`` — with the annotation's official ``area``
        (segmentation area on real COCO, which pycocotools uses for the
        small/medium/large range filter, not the bbox area)."""
        _, boxes, labels, img_id = self.samples[i]
        recs = []

        def emit(bxs, lbls, areas, iscrowd):
            for j, (b, l) in enumerate(zip(bxs, lbls)):
                recs.append({
                    "image_id": img_id,
                    "category_id": self.contig_to_cat[int(l)],
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "area": float(areas[j]), "iscrowd": iscrowd,
                })

        emit(boxes, labels, self.areas[i], 0)
        emit(*self._degen[i], 0)
        emit(*self.crowd[i], 1)
        return recs
