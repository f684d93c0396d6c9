"""Config schema — the sub-objects of tpucv's ``configs/base.py`` that the
serving path reads. Loss and optimizer sections arrive with the training
slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class DatasetCfg:
    name: str = "coco"                  # "voc" | "coco"
    input_size: int = 640               # square model input


@dataclass
class TrainCfg:
    mixed_precision: bool = True        # bf16 autocast for the forward


@dataclass
class DecodeCfg:
    conf_threshold: float = 0.25
    iou_threshold: float = 0.7
    max_det: int = 300
    # candidate cap before NMS; k > 1024 routes to the memory-light scan NMS
    pre_nms_topk: int = 4096


@dataclass
class BaseConfig:
    """Every model config carries the same sub-object schema."""

    arch: Any = None
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    decode: DecodeCfg = field(default_factory=DecodeCfg)
