"""Legacy YOLOv3 (counterpart of ``tpucv/trainer/yolov3_train.py``):
``Yolo3Algorithm`` and ``Yolo3Trainer``, intentionally NOT registered, as
in tpucv and its reference. Reach them directly:

    from tpucv_torch.configs.model_cfgs import Yolo3Config
    from tpucv_torch.trainer.yolov3_train import Yolo3Trainer
    Yolo3Trainer(Yolo3Config()).train()

The algorithm subclasses ``DetectionAlgorithm``, so it has predict and the
batched COCO / VOC evaluation harnesses."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_infer_fn
from tpucv_torch.decode.yolov3 import decode_yolov3
from tpucv_torch.losses.yolov3 import yolov3_loss
from tpucv_torch.models.yolov3 import YoloV3
from tpucv_torch.trainer.base import BaseTrainer
from tpucv_torch.trainer.data_helpers import build_detection_loaders


class Yolo3Algorithm(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes
        self.anchors = np.asarray(cfg.arch.anchors, np.float32)
        self.anchor_mask = cfg.arch.anchor_mask
        self.strides = cfg.arch.strides

    def build_model(self) -> YoloV3:
        return YoloV3(nc=self.nc)

    def build_loss(self):
        """``loss_fn(raw_maps, batch) -> (loss, metrics)``."""

        def loss_fn(raw, batch):
            return yolov3_loss(
                raw, batch["gt_bboxes"], batch["gt_labels"], batch["gt_mask"],
                self.anchors, self.anchor_mask, self.strides, self.nc)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """The config's decode (``pre_nms_topk`` uncapped, as tpucv's)."""
        d = self.cfg.decode
        conf = d.conf_threshold if conf_threshold is None else conf_threshold
        return yolo_infer_fn(self, decode_yolov3, dict(
            anchors=self.anchors, anchor_mask=self.anchor_mask,
            strides=self.strides, nc=self.nc, conf_threshold=conf,
            iou_threshold=d.iou_threshold, max_det=d.max_det,
            pre_nms_topk=d.pre_nms_topk))


class Yolo3Trainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # each term is a mean

    def set_model_algorithm(self):
        self.algorithm = Yolo3Algorithm(self.cfg, device=self.device)

    def load_data(self):
        self.train_loader, self.val_loader, self.val_index = \
            build_detection_loaders(self.cfg)
