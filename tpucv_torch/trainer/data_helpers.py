"""Dataset construction shared by trainers (counterpart of
``tpucv/trainer/data_helpers.py``): real VOC/COCO indices when the
configured roots exist, synthetic fallback otherwise (keeps smoke training
and CI runnable on machines without the datasets)."""

from __future__ import annotations

import os
from typing import Tuple

from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.data.detection_dataset import (
    DetectionDataset, SyntheticDetectionIndex)
from tpucv_torch.data.loader import Loader


def build_detection_indices(cfg, logger=None):
    ds_cfg = get_dataset_cfg(cfg.dataset.name)
    root = ds_cfg["root"]
    note = (logger.info if logger else print)
    if cfg.dataset.name == "voc" and os.path.isdir(
            os.path.join(root, "Annotations")):
        from tpucv_torch.data.voc import VOCDetectionIndex
        return (VOCDetectionIndex(root, "train"),
                VOCDetectionIndex(root, "val"))
    if cfg.dataset.name == "coco" and all(os.path.isfile(
            os.path.join(root, f"annotations/instances_{s}2017.json"))
            for s in ("train", "val")):
        from tpucv_torch.data.coco import COCOIndex
        return (
            COCOIndex(os.path.join(root, "annotations/instances_train2017.json"),
                      os.path.join(root, "train2017")),
            COCOIndex(os.path.join(root, "annotations/instances_val2017.json"),
                      os.path.join(root, "val2017")),
        )
    note(f"dataset root {root!r} not found — using synthetic data")
    nc = ds_cfg["num_classes"]
    s = cfg.dataset.input_size
    return (SyntheticDetectionIndex(64, s, nc, seed=0),
            SyntheticDetectionIndex(16, s, nc, seed=1))


def build_detection_loaders(cfg, logger=None) -> Tuple[Loader, Loader, object]:
    """(train_loader, val_loader, val_index) — the raw val index is what
    tpucv's in-training mAP harness reads (train.eval_map, not ported)."""
    train_idx, val_idx = build_detection_indices(cfg, logger)
    t = cfg.train
    train_ds = DetectionDataset(
        train_idx, cfg.dataset.input_size, cfg.dataset.max_num_boxes,
        train=True, mosaic_prob=t.mosaic_prob,
        special_aug_ratio=t.special_aug_ratio, epochs=t.epochs,
        device_aug=t.device_aug)
    val_ds = DetectionDataset(
        val_idx, cfg.dataset.input_size, cfg.dataset.max_num_boxes,
        train=False)
    nw = cfg.dataset.num_workers
    return (Loader(train_ds, t.batch_size, shuffle=True, num_workers=nw),
            Loader(val_ds, t.batch_size, shuffle=False, num_workers=nw),
            val_idx)
