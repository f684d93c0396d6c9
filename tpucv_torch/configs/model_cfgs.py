"""Per-model configs (counterpart of ``tpucv/configs/model_cfgs.py``), with
tpucv's hyperparameter values: all nine registered families, YOLOv8
detect, seg, pose and cls, YOLOv7, SSD, CenterNet, DeepLabV3+ and
ViT, and the unregistered legacy YOLOv3."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from tpucv_torch.configs.base import (BaseConfig, DatasetCfg, DecodeCfg,
                                      OptimizerCfg, TrainCfg)
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


# ---------------------------------------------------------------------- SSD
def ssd_tables(size: int) -> dict:
    """The prior and feature tables of SSD300 / SSD512: aspect ratios,
    feature-map edges, feature channels and anchor sizes (px) per level."""
    if size == 300:
        return dict(
            aspect_ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
            feature_shapes=[38, 19, 10, 5, 3, 1],
            feature_channels=[512, 1024, 512, 256, 256, 256],
            anchor_sizes=[30, 60, 111, 162, 213, 264, 315],
        )
    if size == 512:
        return dict(
            aspect_ratios=[[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]],
            feature_shapes=[64, 32, 16, 8, 4, 2, 1],
            feature_channels=[512, 1024, 512, 256, 256, 256, 256],
            anchor_sizes=[36, 77, 154, 230, 307, 384, 461, 538],
        )
    raise ValueError(f"SSD input size must be 300 or 512, got {size}")


@dataclass
class SsdArch:
    backbone: str = "vgg16"
    input_size: int = 300
    variances: Tuple[float, float] = (0.1, 0.2)

    @property
    def tables(self) -> dict:
        return ssd_tables(self.input_size)


@dataclass
class SsdLoss:
    # total = conf * (1 - alpha) + loc * alpha; at 1.0 the classification
    # term, and with it its gradient, vanishes
    alpha: float = 0.5
    neg_pos_ratio: int = 3
    overlap_threshold: float = 0.5


@config_registry("ssd")
@dataclass
class SsdConfig(BaseConfig):
    arch: SsdArch = field(default_factory=SsdArch)
    loss: SsdLoss = field(default_factory=SsdLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="voc", input_size=300, max_num_boxes=100))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1e-3, warmup_iters=1000, milestones=(100, 150)))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.7, iou_threshold=0.5, max_det=100,
        pre_nms_topk=1024))

    @property
    def model_name(self) -> str:
        return "ssd"

    @property
    def num_classes(self) -> int:
        """The dataset's classes plus the background, class 0."""
        return get_dataset_cfg(self.dataset.name)["num_classes"] + 1


# ---------------------------------------------------------------- CenterNet
@dataclass
class CenterNetArch:
    backbone: str = "dla34"
    input_size: int = 384
    downsample: int = 4
    head_channels: int = 256


@dataclass
class CenterNetLoss:
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0


@dataclass
class CenterNetDecode(DecodeCfg):
    K: int = 100
    conf_threshold: float = 0.1
    use_diou_nms: bool = True
    iou_threshold: float = 0.5


@config_registry("centernet")
@dataclass
class CenterNetConfig(BaseConfig):
    arch: CenterNetArch = field(default_factory=CenterNetArch)
    loss: CenterNetLoss = field(default_factory=CenterNetLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="voc", input_size=384, max_num_boxes=30))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=1.25e-4, warmup_iters=1000, milestones=(90, 120)))
    decode: CenterNetDecode = field(default_factory=CenterNetDecode)

    @property
    def model_name(self) -> str:
        return "centernet"

    @property
    def num_classes(self) -> int:
        return get_dataset_cfg(self.dataset.name)["num_classes"]


# -------------------------------------------------------------- DeepLabV3+
@dataclass
class DeeplabArch:
    backbone: str = "resnet101"
    output_stride: int = 16
    input_size: int = 513
    crop_size: int = 513


@dataclass
class DeeplabLoss:
    name: str = "focal"               # "ce" | "focal"
    alpha: float = 0.25
    gamma: float = 2.0
    ignore_index: int = 255


@config_registry("deeplabv3plus")
@dataclass
class DeeplabV3PlusConfig(BaseConfig):
    arch: DeeplabArch = field(default_factory=DeeplabArch)
    loss: DeeplabLoss = field(default_factory=DeeplabLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="voc", input_size=513, max_num_boxes=0))
    optimizer: OptimizerCfg = field(default_factory=lambda: OptimizerCfg(
        name="adam", lr=7e-4, warmup_iters=1000, milestones=(60, 80)))
    train: TrainCfg = field(default_factory=lambda: TrainCfg(eval_interval=5))

    @property
    def model_name(self) -> str:
        return "deeplabv3plus"

    @property
    def num_classes(self) -> int:
        return 21                     # VOC's 20 classes and the background


# --------------------------------------------------------------- ViT (cls)
@dataclass
class VitClsArch:
    patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6


@dataclass
class VitClsLoss:
    label_smoothing: float = 0.1


@config_registry("vit_cls")
@dataclass
class VitClsConfig(BaseConfig):
    """ViT-S/16 image classification at 224². Dataset: a folder-per-class
    tree at ``TPUCV_CLS_ROOT`` (``root/{train,val}/<class>/*.jpg``), the
    synthetic fallback otherwise."""

    arch: VitClsArch = field(default_factory=VitClsArch)
    loss: VitClsLoss = field(default_factory=VitClsLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="folder", input_size=224, max_num_boxes=0))
    n_classes: int = 10          # overridden by the folder tree when present

    @property
    def model_name(self) -> str:
        return "vit_cls"

    @property
    def num_classes(self) -> int:
        return self.n_classes


# ------------------------------------------------------------ YOLOv8-cls
@dataclass
class Yolo8ClsArch:
    model_type: str = "n"


@config_registry("yolo8_cls")
@dataclass
class Yolo8ClsConfig(BaseConfig):
    """YOLOv8-cls: the CSPDarknet backbone (layers 0-8) and the Classify
    head at 224²; the same dataset contract as ``vit_cls``."""

    arch: Yolo8ClsArch = field(default_factory=Yolo8ClsArch)
    loss: VitClsLoss = field(default_factory=VitClsLoss)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="folder", input_size=224, max_num_boxes=0))
    n_classes: int = 10          # overridden by the folder tree when present

    @property
    def model_name(self) -> str:
        return "yolo8_cls"

    @property
    def num_classes(self) -> int:
        return self.n_classes


# ---------------------------------------------------------- YOLOv3 (legacy)
YOLO3_ANCHORS: Tuple[Tuple[int, int], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


@dataclass
class Yolo3Arch:
    anchors: Tuple[Tuple[int, int], ...] = YOLO3_ANCHORS
    anchor_mask: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5),
                                                (0, 1, 2))
    strides: Tuple[int, ...] = (32, 16, 8)


@dataclass
class Yolo3Config(BaseConfig):
    """Darknet-53 YOLOv3 at 416², COCO (tpucv's ``Yolo3Config``). Not
    registered, as in tpucv: build it directly and train it through
    ``trainer.yolov3_train.Yolo3Trainer``."""

    arch: Yolo3Arch = field(default_factory=Yolo3Arch)
    dataset: DatasetCfg = field(default_factory=lambda: DatasetCfg(
        name="coco", input_size=416, max_num_boxes=100))
    decode: DecodeCfg = field(default_factory=lambda: DecodeCfg(
        conf_threshold=0.5, iou_threshold=0.45, max_det=100))

    @property
    def model_name(self) -> str:
        return "yolov3"

    @property
    def num_classes(self) -> int:
        return get_dataset_cfg(self.dataset.name)["num_classes"]
