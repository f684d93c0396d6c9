"""ViT classification trainer, ``vit_cls`` (counterpart of
``tpucv/trainer/vit_train.py``): a folder-per-class tree at
``TPUCV_CLS_ROOT`` (``root/{train,val}/<class>/*.jpg``; its classes set
``n_classes``), 64 synthetic train and 16 val images otherwise. The host
crops and flips (``ClassificationDataset``); on the device the images are
only normalised (a batch without ``gt_bboxes`` takes no device
augmentation). ``evaluate_loop`` is the base's: the mean val loss and
top-1 accuracy (``val_loss``, ``val_acc``)."""

from __future__ import annotations

import os

from tpucv_torch.data.classification_dataset import (
    ClassificationDataset, ImageFolderIndex, SyntheticClsIndex,
    classification_collate)
from tpucv_torch.data.loader import Loader
from tpucv_torch.registry import trainer_registry
from tpucv_torch.trainer.base import BaseTrainer


@trainer_registry("vit_cls")
class VitClsTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # the loss is a mean over the batch

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.classification import VitClassification
        self.algorithm = VitClassification(self.cfg, device=self.device)

    def load_data(self):
        cfg = self.cfg
        root = os.environ.get("TPUCV_CLS_ROOT", "")
        s = cfg.dataset.input_size
        if root and os.path.isdir(os.path.join(root, "train")):
            train_idx = ImageFolderIndex(root, "train")
            val_idx = ImageFolderIndex(root, "val",
                                       classes=train_idx.classes)
            cfg.n_classes = len(train_idx.classes)
            self.algorithm.nc = cfg.n_classes
            self.algorithm.class_names = list(train_idx.classes)
        else:
            print(f"TPUCV_CLS_ROOT {root!r} not found — using synthetic "
                  f"classification data")
            nc = cfg.num_classes
            train_idx = SyntheticClsIndex(64, s, nc, seed=0)
            val_idx = SyntheticClsIndex(16, s, nc, seed=1)
        self.val_index = val_idx
        nw = cfg.dataset.num_workers
        self.train_loader = Loader(
            ClassificationDataset(train_idx, s, train=True),
            cfg.train.batch_size, shuffle=True,
            collate=classification_collate, num_workers=nw)
        self.val_loader = Loader(
            ClassificationDataset(val_idx, s, train=False),
            cfg.train.batch_size, shuffle=False,
            collate=classification_collate, num_workers=nw)
