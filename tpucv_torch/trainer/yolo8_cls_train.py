"""YOLOv8-cls trainer, ``yolo8_cls`` (counterpart of
``tpucv/trainer/yolo8_cls_train.py``): ``vit_cls``'s trainer with the
``YOLOv8Cls`` algorithm."""

from __future__ import annotations

from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.vit_train import VitClsTrainer


@trainer_registry("yolo8_cls")
class Yolo8ClsTrainer(VitClsTrainer):
    def set_model_algorithm(self):
        from tpucv_torch.algorithms.yolov8_cls import YOLOv8Cls
        self.algorithm = YOLOv8Cls(self.cfg, device=self.device)
