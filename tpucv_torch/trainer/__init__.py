"""Trainers (counterpart of ``tpucv/trainer``); importing the package
registers them: YOLOv8 detect, seg and pose, and YOLOv7."""

from tpucv_torch.trainer.base import BaseTrainer, MeanMetric  # noqa: F401
from tpucv_torch.trainer.yolo8_pose_train import Yolo8PoseTrainer  # noqa: F401
from tpucv_torch.trainer.yolo8_seg_train import Yolo8SegTrainer  # noqa: F401
from tpucv_torch.trainer.yolo8_train import Yolo8Trainer  # noqa: F401
from tpucv_torch.trainer.yolo7_train import Yolo7Trainer  # noqa: F401
