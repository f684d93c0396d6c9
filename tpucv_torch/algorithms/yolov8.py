"""YOLOv8 algorithm façade (counterpart of ``tpucv/algorithms/yolov8.py``):
model and loss factories and the batched inference function."""

from __future__ import annotations

from typing import Optional

import torch

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.decode.yolov8 import decode_boxes
from tpucv_torch.losses.yolov8 import yolov8_loss
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.ops.preprocess import normalize_images
from tpucv_torch.registry import model_registry


def yolo_decode_args(cfg, nc: int, conf_threshold: Optional[float]) -> dict:
    """Decode-kwarg policy for the YOLOv8 family: predict-style confidences
    (0.25) gate candidates down to a few hundred, so k is capped at 1024
    and NMS takes the kernel; evaluation floods (conf < 0.01) keep the
    config's cap and take the scan NMS."""
    d = cfg.decode
    conf = d.conf_threshold if conf_threshold is None else conf_threshold
    topk = d.pre_nms_topk if conf < 0.01 else min(d.pre_nms_topk, 1024)
    return dict(nc=nc, reg_max=cfg.arch.reg_max, strides=cfg.arch.strides,
                conf_threshold=conf, iou_threshold=d.iou_threshold,
                max_det=d.max_det, pre_nms_topk=topk)


@model_registry("yolo8_det")
class YOLOv8(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes

    def build_model(self) -> Yolo8:
        return Yolo8(scale=self.cfg.arch.model_type, nc=self.nc,
                     reg_max=self.cfg.arch.reg_max)

    def build_loss(self):
        """``loss_fn(raw_maps, batch) -> (loss, metrics)`` over a batch
        dict with ``gt_labels``, ``gt_bboxes`` and ``gt_mask``."""
        l, a = self.cfg.loss, self.cfg.arch

        def loss_fn(raw, batch):
            return yolov8_loss(
                raw, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"],
                nc=self.nc, reg_max=a.reg_max, strides=a.strides,
                box_gain=l.box_gain, cls_gain=l.cls_gain, dfl_gain=l.dfl_gain,
                tal_topk=l.tal_topk)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        kw = yolo_decode_args(self.cfg, self.nc, conf_threshold)
        dtype, amp = self.dtype, self.mixed_precision
        dev_type = self.device.type

        @torch.inference_mode()
        def infer(model, images_u8):
            x = normalize_images(images_u8, dtype)
            with torch.autocast(dev_type, dtype=torch.bfloat16, enabled=amp):
                raw = model(x)
            # decode outside autocast: it would lift the DFL softmax to f32
            return decode_boxes(raw, **kw)

        return infer
