"""SSD algorithm façade (counterpart of ``tpucv/algorithms/ssd.py``): the
priors, the model and loss factories and the batched inference function.
The priors are built in numpy once and kept on the algorithm's device;
the loss assigns its targets on the device from the batch's GT boxes
(``targets/ssd.py``), so the loader carries no encoded targets."""

from __future__ import annotations

from typing import Optional

import torch

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_infer_fn
from tpucv_torch.decode.ssd import decode_ssd
from tpucv_torch.losses.multibox import multibox_loss
from tpucv_torch.models.ssd import SSD
from tpucv_torch.ops.anchors import generate_ssd_anchors
from tpucv_torch.registry import model_registry
from tpucv_torch.targets.ssd import assign_ssd_targets


def _decode_raw(raw, **kw):
    return decode_ssd(*raw, **kw)


@model_registry("ssd")
class Ssd(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes            # includes the background
        t = cfg.arch.tables
        self.priors = torch.from_numpy(generate_ssd_anchors(
            cfg.arch.input_size, t["feature_shapes"], t["anchor_sizes"],
            t["aspect_ratios"])).to(self.device)

    def build_model(self) -> SSD:
        return SSD(num_classes=self.nc, input_size=self.cfg.arch.input_size)

    def build_loss(self):
        """``loss_fn((loc, conf), batch) -> (loss, metrics)``: the batch's
        GT boxes (px) normalised by the input size, targets assigned on the
        device, then ``multibox_loss``."""
        l, a = self.cfg.loss, self.cfg.arch
        priors = self.priors
        # XLA compiles tpucv's division by the size as its f32 reciprocal
        inv_size = float(torch.tensor(1.0) / torch.tensor(float(a.input_size)))

        def loss_fn(raw, batch):
            loc_pred, conf_pred = raw
            targets = assign_ssd_targets(
                batch["gt_bboxes"] * inv_size, batch["gt_labels"],
                batch["gt_mask"], priors,
                l.overlap_threshold, a.variances)
            return multibox_loss(loc_pred, conf_pred, *targets,
                                 neg_pos_ratio=l.neg_pos_ratio, alpha=l.alpha)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """``infer(model, uint8 NHWC batch)``: /255, the forward under bf16
        autocast when mixed precision is on, then ``decode_ssd`` with the
        config's settings (conf 0.7, IoU 0.5, ``max_det`` 100, K 1,024 as
        shipped) at every confidence."""
        d, a = self.cfg.decode, self.cfg.arch
        conf = d.conf_threshold if conf_threshold is None else conf_threshold
        return yolo_infer_fn(self, _decode_raw, dict(
            priors=self.priors, input_size=a.input_size,
            conf_threshold=conf, iou_threshold=d.iou_threshold,
            max_det=d.max_det, pre_nms_topk=d.pre_nms_topk,
            variances=a.variances))
