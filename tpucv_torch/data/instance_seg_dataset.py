"""Instance-segmentation data (counterpart of
``tpucv/data/instance_seg_dataset.py``, whose items it reproduces byte for
byte): images + boxes + per-instance masks at prototype resolution, fixed
shapes.

COCO polygons rasterise with cv2.fillPoly (no pycocotools); indices
without polygons (synthetic rectangles, plain VOC) take box-filled masks,
exact for the synthetic data, whose objects are rectangles. Items are a
plain resize to the square input (no mosaic, no letterbox): the masks stay
aligned with the image and polygon coordinates scale linearly.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from tpucv_torch.utils.image_process import read_image


def box_mask(m: np.ndarray, box) -> None:
    """Fill the xyxy ``box`` into the 2-D uint8 ``m`` in place, tpucv's
    rule: rows int(y1) to ceil(y2), at least one, the same for columns."""
    x1, y1, x2, y2 = box
    m[int(y1):max(int(np.ceil(y2)), int(y1) + 1),
      int(x1):max(int(np.ceil(x2)), int(x1) + 1)] = 1


class InstanceSegDataset:
    """Train and eval items are the same (a plain resize): augmentation
    would have to move the instance masks too."""

    def __init__(self, index, input_size: int, max_boxes: int,
                 mask_down: int = 4, train: bool = False):
        del train
        self.index = index
        self.size = input_size
        self.max_boxes = max_boxes
        self.mask_down = mask_down

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
        Hm = S // self.mask_down
        sx, sy = S / w, S / h
        if (h, w) != (S, S):
            img = cv2.resize(img, (S, S), interpolation=cv2.INTER_LINEAR)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4) * \
            np.asarray([sx, sy, sx, sy], np.float32)

        M = self.max_boxes
        n = min(len(boxes), M)
        out_boxes = np.zeros((M, 4), np.float32)
        out_labels = np.zeros((M,), np.int32)
        out_valid = np.zeros((M,), bool)
        masks = np.zeros((M, Hm, Hm), np.uint8)
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = np.asarray(labels, np.int32)[:n]
        out_valid[:n] = True

        polys = getattr(self.index, "polygons", None)
        mscale = np.asarray([sx / self.mask_down, sy / self.mask_down],
                            np.float32)
        for j in range(n):
            poly_list = polys(i, j) if callable(polys) else None
            if poly_list:
                pts = [np.round(np.asarray(p, np.float32).reshape(-1, 2)
                                * mscale).astype(np.int32)
                       for p in poly_list if len(p) >= 6]
                if pts:
                    cv2.fillPoly(masks[j], pts, 1)
                    continue
            box_mask(masks[j], boxes[j] / self.mask_down)

        return {"images": img.astype(np.uint8), "gt_bboxes": out_boxes,
                "gt_labels": out_labels, "gt_mask": out_valid,
                "gt_inst_masks": masks}


def instance_seg_collate(items: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
