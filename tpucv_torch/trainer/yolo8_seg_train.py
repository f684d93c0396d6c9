"""YOLOv8-seg trainer (counterpart of ``tpucv/trainer/yolo8_seg_train.py``).

Data: COCO with polygon segmentations when the root exists (rasterised
with cv2.fillPoly), synthetic rectangles (mask == box) otherwise. Batches
are a plain resize (no mosaic) so the masks stay aligned, and no device
augmentation, which would not move the masks.
"""

from __future__ import annotations

import os

from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
from tpucv_torch.data.instance_seg_dataset import (InstanceSegDataset,
                                                   instance_seg_collate)
from tpucv_torch.data.loader import Loader
from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer


@trainer_registry("yolo8_seg")
class Yolo8SegTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = True    # the det total and the mask term scale by B
    DEVICE_AUG = False          # augment_batch does not move gt_inst_masks

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.yolov8_seg import YOLOv8Seg
        self.algorithm = YOLOv8Seg(self.cfg, device=self.device)

    def load_data(self):
        cfg = self.cfg
        ds_cfg = get_dataset_cfg(cfg.dataset.name)
        root = ds_cfg["root"]
        ann = os.path.join(root, "annotations/instances_%s2017.json")
        if cfg.dataset.name == "coco" and all(
                os.path.isfile(ann % s) for s in ("train", "val")):
            from tpucv_torch.data.coco import COCOIndex
            train_idx = COCOIndex(ann % "train",
                                  os.path.join(root, "train2017"),
                                  keep_polys=True)
            val_idx = COCOIndex(ann % "val", os.path.join(root, "val2017"),
                                keep_polys=True)
        else:
            print(f"dataset root {root!r} not found — using synthetic "
                  f"instance-seg data (mask == box rectangles)")
            s = cfg.dataset.input_size
            nc = ds_cfg["num_classes"]
            train_idx = SyntheticDetectionIndex(64, s, nc, seed=0)
            val_idx = SyntheticDetectionIndex(16, s, nc, seed=1)
        self.val_index = val_idx
        t, nw = cfg.train, cfg.dataset.num_workers
        self.train_loader, self.val_loader = (
            Loader(InstanceSegDataset(idx, cfg.dataset.input_size,
                                      cfg.dataset.max_num_boxes, train=tr),
                   t.batch_size, shuffle=tr, collate=instance_seg_collate,
                   num_workers=nw)
            for idx, tr in ((train_idx, True), (val_idx, False)))
