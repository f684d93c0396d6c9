"""VOC detection annotations — xml parsing (counterpart of
``tpucv/data/voc.py``; reference ``core/data/voc.py:11-76``)."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpucv_torch.configs.dataset_cfg import VOC_CLASSES


class VOCDetectionIndex:
    """Index of a VOCdevkit split: image paths + parsed boxes.

    Unlike the reference Dataset (which re-parses xml in __getitem__), the
    index is built once; samples are (path, boxes xyxy pixels, labels).
    """

    def __init__(self, root: str, split: str = "train",
                 classes: Optional[List[str]] = None,
                 keep_difficult: bool = False):
        self.root = root
        self.classes = classes or VOC_CLASSES
        self.cls_to_id = {c: i for i, c in enumerate(self.classes)}
        self.keep_difficult = keep_difficult
        split_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            ids = [line.strip().split()[0] for line in f if line.strip()]
        # All objects are parsed and the difficult mask retained: training
        # drops difficult objects (reference ``core/data/voc.py`` default),
        # but evaluation must see them as IGNORE regions (the reference's
        # engine skips difficult GTs without counting matches as FP,
        # ``core/metrics/mAP.py:352-386``) — so the index can't discard them.
        self.samples = []
        self._eval = []     # (boxes_all, labels_all, difficult_mask)
        for img_id in ids:
            xml_path = os.path.join(root, "Annotations", f"{img_id}.xml")
            img_path = os.path.join(root, "JPEGImages", f"{img_id}.jpg")
            boxes, labels, difficult = self._parse(xml_path)
            keep = np.ones(len(boxes), bool) if keep_difficult else ~difficult
            self.samples.append((img_path, boxes[keep], labels[keep]))
            self._eval.append((boxes, labels, difficult))

    def _parse(self, xml_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        tree = ET.parse(xml_path)
        boxes, labels, difficult = [], [], []
        for obj in tree.findall("object"):
            name = obj.find("name").text.strip()
            if name not in self.cls_to_id:
                continue
            diff = obj.find("difficult")
            bb = obj.find("bndbox")
            box = [float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
            boxes.append(box)
            labels.append(self.cls_to_id[name])
            # strip(): pretty-printed XML writes "\n1\n"
            difficult.append(diff is not None and diff.text is not None
                             and diff.text.strip() == "1")
        if not boxes:
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                    np.zeros((0,), bool))
        return (np.asarray(boxes, np.float32), np.asarray(labels, np.int32),
                np.asarray(difficult, bool))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def eval_record(self, i) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(boxes, labels, difficult) with difficult objects INCLUDED, for
        the ignore-region eval protocol."""
        return self._eval[i]
