"""Config schema (counterpart of tpucv's ``configs/base.py``): the nested
sub-objects arch / dataset / train / loss / optimizer / log / decode, with
tpucv's fields and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class DatasetCfg:
    name: str = "coco"                  # "voc" | "coco"
    input_size: int = 640               # square model input
    max_num_boxes: int = 100            # static GT pad per image
    num_workers: int = 0                # >0: forked shared-memory loader workers


@dataclass
class TrainCfg:
    epochs: int = 100
    batch_size: int = 16
    mixed_precision: bool = True        # bf16 autocast for the forward
    resume_training: bool = False
    last_epoch: int = -1
    eval_interval: int = 10
    save_interval: int = 10
    # in-training detection mAP on the val split every eval_interval epochs
    eval_map: bool = False
    eval_map_conf: float = 0.01         # conf floor for the in-training pass
    save_path: str = "saves"
    pretrained_weights: str = ""
    mosaic_prob: float = 0.5
    special_aug_ratio: float = 0.7
    device_aug: bool = True             # affine/flip/HSV on the device
    # model-axis size of tpucv's (data, model) mesh; >1 channel-shards the
    # largest conv kernels
    n_model: int = 1
    # ZeRO-1: shard the Adam moments over the data axis
    zero_opt: bool = False
    # gradient accumulation: G sequential micro-batches a step; batch_size
    # must be divisible by G
    grad_accum: int = 1


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
class LogCfg:
    root: str = "log"
    print_interval: int = 50
    tensorboard_on: bool = True
    tensorboard_dir: str = "runs"


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
    log: LogCfg = field(default_factory=LogCfg)
    decode: DecodeCfg = field(default_factory=DecodeCfg)

    @property
    def model_name(self) -> str:
        raise NotImplementedError
