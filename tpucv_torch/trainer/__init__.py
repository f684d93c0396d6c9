"""Trainers (counterpart of ``tpucv/trainer``); importing the package
registers them: YOLOv8 detect, seg, pose and cls, YOLOv7, SSD, CenterNet,
DeepLabV3+ and ViT."""

from tpucv_torch.trainer.base import BaseTrainer, MeanMetric  # noqa: F401
from tpucv_torch.trainer.yolo8_pose_train import Yolo8PoseTrainer  # noqa: F401
from tpucv_torch.trainer.yolo8_seg_train import Yolo8SegTrainer  # noqa: F401
from tpucv_torch.trainer.yolo8_train import Yolo8Trainer  # noqa: F401
from tpucv_torch.trainer.yolo7_train import Yolo7Trainer  # noqa: F401
from tpucv_torch.trainer.ssd_train import SsdTrainer  # noqa: F401
from tpucv_torch.trainer.centernet_train import CenterNetTrainer  # noqa: F401
from tpucv_torch.trainer.segmentation_trainer import DeeplabV3PlusTrainer  # noqa: F401,E501
from tpucv_torch.trainer.vit_train import VitClsTrainer  # noqa: F401
from tpucv_torch.trainer.yolo8_cls_train import Yolo8ClsTrainer  # noqa: F401
