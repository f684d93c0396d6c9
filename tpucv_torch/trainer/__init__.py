"""Trainers (counterpart of ``tpucv/trainer``); importing the package
registers them. Only the YOLOv8 detection trainer is ported so far."""

from tpucv_torch.trainer.base import BaseTrainer, MeanMetric  # noqa: F401
from tpucv_torch.trainer.yolo8_train import Yolo8Trainer  # noqa: F401
