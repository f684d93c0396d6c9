"""Per-model configs (counterpart of ``tpucv/configs/model_cfgs.py``), with
tpucv's hyperparameter values. Only the families the port has so far are here."""

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
