"""Shared detection-algorithm skeleton (counterpart of
``tpucv/algorithms/base.py``): the batched serving/evaluation loop.

Where tpucv passes a flax ``variables`` pytree, the port passes the model
itself: an ``nn.Module`` holding its weights on the algorithm's device,
from :meth:`DetectionAlgorithm.init_variables`. ``infer_fn(model, uint8
NHWC batch) -> (boxes xyxy px, scores, classes, valid)`` has fixed shapes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.ops.preprocess import host_letterbox_geom, letterbox_images
from tpucv_torch.utils.image_process import read_image, reverse_letter_box


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a machine without it
    rather than moving to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available here; pass device='cpu' "
                           "to run on the CPU")
    return dev


class DetectionAlgorithm:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.input_size = cfg.dataset.input_size
        # bf16 autocast for the forward when mixed precision is on, as
        # tpucv computes in bf16 with f32 params
        self.mixed_precision = cfg.train.mixed_precision
        self.dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        self.class_names = get_dataset_cfg(cfg.dataset.name)["classes"]

    # -------- subclass contract ------------------------------------------
    def build_model(self) -> nn.Module:
        raise NotImplementedError

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        raise NotImplementedError

    def init_variables(self, seed: int = 0) -> nn.Module:
        """The model with random weights drawn from ``torch.Generator``
        seeded with ``seed``, in eval mode on the algorithm's device
        (``channels_last`` on CUDA). Load trained weights into it with
        ``load_state_dict``."""
        model = self.build_model()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    # -------- shared inference plumbing ----------------------------------
    # raw-image canvas edge for the device-side letterbox; COCO and VOC
    # images never exceed 640 on a side
    RAW_CANVAS = 640

    @property
    def raw_canvas(self) -> int:
        return max(self.RAW_CANVAS, self.input_size)

    def _fill_canvases(self, index, idxs, batch_size: int, C: int):
        """Place one batch of images top-left on fixed uint8 canvases,
        nearest pre-shrinking images larger than C. Each index item is a
        tuple whose first entry is an RGB ndarray or an image path.

        Returns (canvases (batch_size, C, C, 3), hw (batch_size, 2) placed
        dims, oshapes original dims, prescales per-axis pre-shrink ratios).
        """
        canvases = np.zeros((batch_size, C, C, 3), np.uint8)
        hw = np.ones((batch_size, 2), np.int32)
        oshapes = [None] * len(idxs)
        prescales = [None] * len(idxs)
        for j, i in enumerate(idxs):
            src = index[i][0]
            img = read_image(src) if isinstance(src, str) else src
            oh, ow = img.shape[:2]
            if oh > C or ow > C:
                # rare: nearest pre-shrink on the host so the image fits the
                # canvas, keeping one resampling family end to end
                import cv2
                pre = C / max(oh, ow)
                img = cv2.resize(img, (int(ow * pre), int(oh * pre)),
                                 interpolation=cv2.INTER_NEAREST)
            h, w = img.shape[:2]
            canvases[j, :h, :w] = img
            hw[j] = (h, w)
            oshapes[j] = (oh, ow)
            prescales[j] = (w / ow, h / oh)
        return canvases, hw, oshapes, prescales

    def _batched_detections(self, model: nn.Module, index, batch_size: int,
                            conf_threshold: float):
        """Batched loop with the letterbox on the device: the host places
        each raw image on a fixed uint8 canvas; resize, pad, normalise,
        forward, decode and NMS run on ``self.device``. Yields
        (i, boxes xyxy in original pixels, scores, classes) per image."""
        s = self.input_size
        C = self.raw_canvas
        dev = self.device
        infer = self.make_infer_fn(conf_threshold=conf_threshold)
        n = len(index)
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            canvases, hw, oshapes, prescales = self._fill_canvases(
                index, idxs, batch_size, C)
            # f64 letterbox geometry on host: exact reference arithmetic
            geom, hscale = host_letterbox_geom(hw, s)
            with torch.inference_mode():
                lb, scale, pad = letterbox_images(
                    torch.from_numpy(canvases).to(dev),
                    torch.from_numpy(hw).to(dev), s,
                    geom=torch.from_numpy(geom).to(dev),
                    scale=torch.from_numpy(hscale).to(dev))
                outs = infer(model, lb)
            boxes_b, scores_b, classes_b, valid_b, scale_b, pad_b = (
                t.cpu().numpy() for t in (*outs, scale, pad))
            for j, i in enumerate(idxs):
                v = valid_b[j]
                pre_x, pre_y = prescales[j]
                # clip=False: the evaluation protocol never clips boxes
                boxes = reverse_letter_box(
                    boxes_b[j][v],
                    (float(scale_b[j]) * pre_x, float(scale_b[j]) * pre_y),
                    tuple(pad_b[j]), oshapes[j], clip=False)
                yield i, boxes, scores_b[j][v], classes_b[j][v]
