"""DeepLabV3+ trainer (counterpart of
``tpucv/trainer/segmentation_trainer.py``; the reference's
``core/trainer/segmentation_trainer.py:21-158``): the VOC
``SegmentationClass`` loaders, or a synthetic set when the root lacks
them; the images are only normalised on the device (the augmentation is
the dataset's, on the host); the evaluation is the mIoU and pixel
accuracy of ``SegmentationMetrics``, its histograms on the device, over
every val image (tpucv's val loader drops the last partial batch)."""

from __future__ import annotations

import os
from typing import Dict

import torch

from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.data.loader import Loader, segmentation_collate
from tpucv_torch.data.segmentation_dataset import (
    SegmentationDataset, build_voc_seg_samples, synthetic_seg_samples)
from tpucv_torch.metrics.seg_metrics import SegmentationMetrics
from tpucv_torch.ops.preprocess import imagenet_normalize
from tpucv_torch.registry import trainer_registry
from tpucv_torch.train.state import forward
from tpucv_torch.trainer.base import BaseTrainer


@trainer_registry("deeplabv3plus")
class DeeplabV3PlusTrainer(BaseTrainer):
    LOSS_BATCH_SCALED = False   # the losses are means over valid pixels
    DEVICE_AUG = False          # the dataset crops and flips on the host

    def set_model_algorithm(self):
        from tpucv_torch.algorithms.segmentation_2d import DeeplabV3PlusA
        self.algorithm = DeeplabV3PlusA(self.cfg, device=self.device)

    def load_data(self):
        cfg = self.cfg
        root = get_dataset_cfg("voc")["root"]
        crop = cfg.arch.crop_size
        if os.path.isdir(os.path.join(root, "SegmentationClass")):
            train_s = build_voc_seg_samples(root, "train")
            val_s = build_voc_seg_samples(root, "val")
        else:
            print(f"dataset root {root!r} not found — using synthetic seg "
                  f"data")
            train_s = synthetic_seg_samples(32, crop, cfg.num_classes, 0)
            val_s = synthetic_seg_samples(8, crop, cfg.num_classes, 1)
        nw = getattr(cfg.dataset, "num_workers", 0)
        self.train_loader = Loader(
            SegmentationDataset(train_s, crop, train=True),
            cfg.train.batch_size, shuffle=True, collate=segmentation_collate,
            num_workers=nw)
        # every val image counts: tpucv's loader drops the last partial
        # batch, and its 8 synthetic val images at B=16 score nothing
        self.val_loader = Loader(
            SegmentationDataset(val_s, crop, train=False),
            cfg.train.batch_size, shuffle=False, collate=segmentation_collate,
            num_workers=nw, drop_last=False)

    def device_batch(self, batch, train: bool = False):
        out = super().device_batch(batch, train)
        out["images"] = imagenet_normalize(out["images"])
        return out

    @torch.no_grad()
    def evaluate_loop(self, state) -> Dict[str, float]:
        """mIoU and pixel accuracy on the val split (reference
        :109-158), the model in eval mode (its running statistics)."""
        model = state.model.eval()
        metrics = SegmentationMetrics(self.cfg.num_classes,
                                      self.cfg.loss.ignore_index)
        for batch in self.val_loader:
            db = self.device_batch(batch)
            logits = forward(model, db["images"],
                             self.cfg.train.mixed_precision)
            metrics.update(logits.argmax(dim=1), db["labels"])
        out = metrics.compute()
        return {"val_mIoU": out["mIoU"], "val_acc": out["overall_acc"]}
