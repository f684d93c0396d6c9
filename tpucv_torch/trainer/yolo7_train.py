"""YOLOv7 trainer (counterpart of ``tpucv/trainer/yolo7_train.py``)."""

from __future__ import annotations

from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer
from tpucv_torch.trainer.data_helpers import build_detection_loaders


@trainer_registry("yolo7")
class Yolo7Trainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # yolov7_loss has no batch-size factor

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.yolov7 import YOLOv7
        self.algorithm = YOLOv7(self.cfg, device=self.device)

    def load_data(self):
        self.train_loader, self.val_loader, self.val_index = \
            build_detection_loaders(self.cfg)
