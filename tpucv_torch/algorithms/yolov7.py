"""YOLOv7 algorithm façade (counterpart of ``tpucv/algorithms/yolov7.py``):
the anchors stacked by ``anchor_mask``, the model and loss factories and
the batched inference function.

Unlike YOLOv8's, the inference function passes the config's
``pre_nms_topk`` (4096) uncapped at every confidence, as tpucv does, so
at 640² (25,200 anchors) predict, serve and evaluate all take the
sequential-scan NMS; the NMS kernel runs where K <= 1024, i.e. inputs of
128² or less."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_infer_fn
from tpucv_torch.decode.yolov7 import decode_yolov7
from tpucv_torch.losses.yolov7 import yolov7_loss
from tpucv_torch.models.yolov7 import Yolo7
from tpucv_torch.registry import model_registry


@model_registry("yolo7")
class YOLOv7(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes
        a = cfg.arch
        flat = np.asarray(a.anchors, np.float32)
        self.anchors = np.stack(
            [flat[list(m)] for m in a.anchor_mask])    # (nl, na, 2)
        self.strides = a.strides

    def build_model(self) -> Yolo7:
        return Yolo7(nc=self.nc, na=self.anchors.shape[1],
                     phi=self.cfg.arch.phi)

    def build_loss(self):
        """``loss_fn(raw_maps, batch) -> (loss, metrics)`` with the
        config's size- and class-scaled gains (``loss_gains``)."""
        box_g, obj_g, cls_g = self.cfg.loss_gains()
        balance = self.cfg.loss.layer_balance

        def loss_fn(raw, batch):
            return yolov7_loss(
                raw, batch["gt_bboxes"], batch["gt_labels"], batch["gt_mask"],
                anchors=self.anchors, strides=self.strides, nc=self.nc,
                box_gain=box_g, obj_gain=obj_g, cls_gain=cls_g,
                layer_balance=balance)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        d = self.cfg.decode
        conf = d.conf_threshold if conf_threshold is None else conf_threshold
        return yolo_infer_fn(self, decode_yolov7, dict(
            anchors=self.anchors, strides=self.strides, nc=self.nc,
            conf_threshold=conf, iou_threshold=d.iou_threshold,
            max_det=d.max_det, pre_nms_topk=d.pre_nms_topk))
