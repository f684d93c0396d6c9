"""SSD trainer (counterpart of ``tpucv/trainer/ssd_train.py``): the
detection loaders as they are; the targets are assigned inside the loss."""

from __future__ import annotations

from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer
from tpucv_torch.trainer.data_helpers import build_detection_loaders


@trainer_registry("ssd")
class SsdTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # multibox_loss is normalised by positives

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.ssd import Ssd
        self.algorithm = Ssd(self.cfg, device=self.device)

    def load_data(self):
        self.train_loader, self.val_loader, self.val_index = \
            build_detection_loaders(self.cfg)
