"""YOLOv8 image-classification algorithm, ``yolo8_cls`` (counterpart of
``tpucv/algorithms/yolov8_cls.py``): the CSPDarknet backbone (layers 0-8,
no SPPF, no FPN) and the Classify head at 224²; the loss, predict and
top-1 / top-5 evaluate are ``vit_cls``'s."""

from __future__ import annotations

from torch import nn

from tpucv_torch.algorithms.classification import VitClassification
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.registry import model_registry


@model_registry("yolo8_cls")
class YOLOv8Cls(VitClassification):
    def build_model(self) -> nn.Module:
        return Yolo8(scale=self.cfg.arch.model_type, nc=self.nc,
                     head="classify")
