"""CenterNet algorithm façade (counterpart of
``tpucv/algorithms/centernet.py``): the model and loss factories and the
batched inference function. The gaussian targets are built on the device
inside the loss from the batch's GT boxes (``targets/centernet.py``), so
the loader carries no heatmaps; the decode is the max-pool peak + top-K
path with the DIoU scan (``decode/centernet.py``)."""

from __future__ import annotations

from typing import Optional

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_infer_fn
from tpucv_torch.decode.centernet import decode_centernet
from tpucv_torch.losses.centernet import centernet_loss
from tpucv_torch.models.centernet import CenterNet
from tpucv_torch.registry import model_registry
from tpucv_torch.targets.centernet import build_centernet_targets


@model_registry("centernet")
class CenterNetA(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes
        self.down = cfg.arch.downsample
        self.out_hw = (cfg.dataset.input_size // self.down,
                       cfg.dataset.input_size // self.down)

    def build_model(self) -> CenterNet:
        return CenterNet(num_classes=self.nc,
                         head_channels=self.cfg.arch.head_channels)

    def build_loss(self):
        """``loss_fn(raw, batch) -> (loss, metrics)``: the gaussian targets
        of the batch's GT boxes (px), then ``centernet_loss`` with the
        config's weights."""
        l = self.cfg.loss
        nc, out_hw, down = self.nc, self.out_hw, self.down

        def loss_fn(raw, batch):
            targets = build_centernet_targets(
                batch["gt_bboxes"], batch["gt_labels"], batch["gt_mask"],
                nc, out_hw, down)
            return centernet_loss(raw, targets, nc, l.hm_weight,
                                  l.wh_weight, l.off_weight)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """``infer(model, uint8 NHWC batch)``: /255, the forward under bf16
        autocast when mixed precision is on, then ``decode_centernet`` with
        the config's settings (K 100, conf 0.1, DIoU NMS at IoU 0.5 as
        shipped) at every confidence."""
        d = self.cfg.decode
        conf = d.conf_threshold if conf_threshold is None else conf_threshold
        return yolo_infer_fn(self, decode_centernet, dict(
            num_classes=self.nc, downsample=self.down, K=d.K,
            conf_threshold=conf, use_diou_nms=d.use_diou_nms,
            iou_threshold=d.iou_threshold))
