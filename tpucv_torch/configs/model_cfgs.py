"""Per-model configs (counterpart of ``tpucv/configs/model_cfgs.py``), with
tpucv's hyperparameter values. Only the families the port has so far are
here: YOLOv8 detect, seg and pose, and YOLOv7."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from tpucv_torch.configs.base import (BaseConfig, DatasetCfg, DecodeCfg,
                                      OptimizerCfg)
from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.registry import config_registry


@dataclass
class Yolo8Arch:
    model_type: str = "n"            # n/s/m/l/x
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)


@dataclass
class Yolo8Loss:
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_topk: int = 10


@config_registry("yolo8_det")
@dataclass
class Yolo8DetConfig(BaseConfig):
    arch: Yolo8Arch = field(default_factory=Yolo8Arch)
    loss: Yolo8Loss = field(default_factory=Yolo8Loss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="coco", input_size=640, max_num_boxes=100))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1e-3, warmup_iters=1000, milestones=(60, 80)))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.25, iou_threshold=0.7, max_det=300))

    @property
    def model_name(self) -> str:
        return "yolo8_det"

    @property
    def num_classes(self) -> int:
        return get_dataset_cfg(self.dataset.name)["num_classes"]


@dataclass
class Yolo8SegArch:
    model_type: str = "n"
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    n_masks: int = 32


@dataclass
class Yolo8SegLoss:
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    mask_gain: float = 2.5
    tal_topk: int = 10
    mask_topk: int = 64      # foreground anchors the mask BCE takes


@config_registry("yolo8_seg")
@dataclass
class Yolo8SegConfig(BaseConfig):
    """YOLOv8 instance segmentation: ultralytics v8-seg semantics on the
    detection stack."""

    arch: Yolo8SegArch = field(default_factory=Yolo8SegArch)
    loss: Yolo8SegLoss = field(default_factory=Yolo8SegLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="coco", input_size=640, max_num_boxes=48))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1e-3, warmup_iters=1000, milestones=(60, 80)))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.25, iou_threshold=0.7, max_det=300))

    @property
    def model_name(self) -> str:
        return "yolo8_seg"

    @property
    def num_classes(self) -> int:
        return get_dataset_cfg(self.dataset.name)["num_classes"]


@dataclass
class Yolo8PoseArch:
    model_type: str = "n"
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    kpt_shape: Tuple[int, int] = (17, 3)


@dataclass
class Yolo8PoseLoss:
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    kpt_gain: float = 12.0
    kobj_gain: float = 1.0
    tal_topk: int = 10
    pose_topk: int = 64      # foreground anchors the keypoint loss takes


@config_registry("yolo8_pose")
@dataclass
class Yolo8PoseConfig(BaseConfig):
    """YOLOv8 pose estimation (person keypoints): ultralytics v8-pose
    semantics on the detection stack."""

    arch: Yolo8PoseArch = field(default_factory=Yolo8PoseArch)
    loss: Yolo8PoseLoss = field(default_factory=Yolo8PoseLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="coco", input_size=640, max_num_boxes=32))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1e-3, warmup_iters=1000, milestones=(60, 80)))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.25, iou_threshold=0.7, max_det=300))

    @property
    def model_name(self) -> str:
        return "yolo8_pose"

    @property
    def num_classes(self) -> int:
        return 1                      # person


# ------------------------------------------------------------------- YOLOv7
YOLO7_ANCHORS: Tuple[Tuple[int, int], ...] = (
    (12, 16), (19, 36), (40, 28),
    (36, 75), (76, 55), (72, 146),
    (142, 110), (192, 243), (459, 401),
)


@dataclass
class Yolo7Arch:
    phi: str = "l"                    # l | x
    anchors: Tuple[Tuple[int, int], ...] = YOLO7_ANCHORS
    anchor_mask: Tuple[Tuple[int, ...], ...] = ((0, 1, 2), (3, 4, 5), (6, 7, 8))
    strides: Tuple[int, ...] = (8, 16, 32)


@dataclass
class Yolo7Loss:
    # base ratios; the effective obj and cls gains scale with the input
    # size and the class count (``Yolo7Config.loss_gains``)
    box_gain: float = 0.05
    obj_gain: float = 1.0
    cls_gain: float = 0.5
    label_smoothing: float = 0.0
    layer_balance: Tuple[float, float, float] = (4.0, 1.0, 0.4)


@config_registry("yolo7")
@dataclass
class Yolo7Config(BaseConfig):
    arch: Yolo7Arch = field(default_factory=Yolo7Arch)
    loss: Yolo7Loss = field(default_factory=Yolo7Loss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="voc", input_size=640, max_num_boxes=100))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1e-3, warmup_iters=1000, milestones=(100, 200)))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.5, iou_threshold=0.3, max_det=100))

    @property
    def model_name(self) -> str:
        return "yolo7"

    @property
    def num_classes(self) -> int:
        return get_dataset_cfg(self.dataset.name)["num_classes"]

    def loss_gains(self) -> Tuple[float, float, float]:
        """(box, obj, cls) gains: obj scales by S²/640², cls by nc/80."""
        s = self.dataset.input_size
        return (self.loss.box_gain,
                self.loss.obj_gain * (s * s) / 640.0 ** 2,
                self.loss.cls_gain * self.num_classes / 80.0)
