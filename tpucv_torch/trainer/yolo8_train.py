"""YOLOv8 trainer (counterpart of ``tpucv/trainer/yolo8_train.py``;
reference ``core/trainer/yolo8_train.py:19-129``)."""

from __future__ import annotations

from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer
from tpucv_torch.trainer.data_helpers import build_detection_loaders


@trainer_registry("yolo8_det")
class Yolo8Trainer(BaseTrainer):
    LOSS_BATCH_SCALED = True    # yolov8_loss returns mean * B

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.yolov8 import YOLOv8
        self.algorithm = YOLOv8(self.cfg, device=self.device)

    def load_data(self):
        self.train_loader, self.val_loader, self.val_index = \
            build_detection_loaders(self.cfg)
