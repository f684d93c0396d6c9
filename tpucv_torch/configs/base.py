"""Config schema — the sub-objects of tpucv's ``configs/base.py`` that the
serving path and the training step read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class DatasetCfg:
    name: str = "coco"                  # "voc" | "coco"
    input_size: int = 640               # square model input


@dataclass
class TrainCfg:
    mixed_precision: bool = True        # bf16 autocast for the forward


@dataclass
class OptimizerCfg:
    name: str = "adam"
    lr: float = 1e-3
    weight_decay: float = 0.0
    warmup_iters: int = 1000
    milestones: Tuple[int, ...] = ()    # epochs; converted to iters by trainer
    gamma: float = 0.1
    ema_decay: float = 0.0              # 0 disables


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
    loss: Any = None
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    decode: DecodeCfg = field(default_factory=DecodeCfg)
