"""CenterNet trainer (counterpart of ``tpucv/trainer/centernet_train.py``):
the detection loaders as they are; the targets are built inside the
loss."""

from __future__ import annotations

from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer
from tpucv_torch.trainer.data_helpers import build_detection_loaders


@trainer_registry("centernet")
class CenterNetTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # centernet_loss is normalised by positives

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.centernet import CenterNetA
        self.algorithm = CenterNetA(self.cfg, device=self.device)

    def load_data(self):
        self.train_loader, self.val_loader, self.val_index = \
            build_detection_loaders(self.cfg)
