"""DeepLabV3+ algorithm façade (counterpart of
``tpucv/algorithms/segmentation_2d.py``; the reference's
``core/algorithms/segmentation_2d.py:42-177``): the model and loss (CE or
focal) factories, the batched class-map inference, the colour map and
blended overlay of predict (:20-39) and the VOC mIoU evaluation
(:115-166). It is not a ``DetectionAlgorithm``: no boxes, no letterbox,
no NMS. Its evaluation scores every image; tpucv's drops the last
partial batch.

As elsewhere in the port, the model itself (an ``nn.Module`` holding its
weights on the algorithm's device) stands where tpucv passes its flax
``variables``. ``infer(model, uint8 NHWC batch) -> (B, H, W) int32`` class
indices.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tpucv_torch import quant
from tpucv_torch.algorithms.base import resolve_device, seeded_model
from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.data.segmentation_dataset import VOC_COLORMAP
from tpucv_torch.losses.segmentation import cross_entropy_loss, focal_loss
from tpucv_torch.metrics.seg_metrics import SegmentationMetrics
from tpucv_torch.models.deeplabv3plus import DeeplabV3Plus
from tpucv_torch.ops.preprocess import imagenet_normalize, normalize_images
from tpucv_torch.registry import model_registry
from tpucv_torch.utils.image_process import read_image


def postprocess_seg2d(class_map: np.ndarray) -> np.ndarray:
    """Class indices -> the RGB colour-map image (reference :20-29)."""
    cm = np.asarray(VOC_COLORMAP, np.uint8)
    return cm[np.clip(class_map, 0, len(cm) - 1)]


def blend(image_rgb: np.ndarray, seg_rgb: np.ndarray,
          alpha: float = 0.6) -> np.ndarray:
    """The colour map laid over the image (reference :32-39)."""
    return (image_rgb * (1 - alpha) + seg_rgb * alpha).astype(np.uint8)


@model_registry("deeplabv3plus")
class DeeplabV3PlusA:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.nc = cfg.num_classes
        self.input_size = cfg.dataset.input_size
        self.mixed_precision = cfg.train.mixed_precision
        self.dtype = torch.bfloat16 if self.mixed_precision else torch.float32

    def build_model(self) -> DeeplabV3Plus:
        a = self.cfg.arch
        return DeeplabV3Plus(num_classes=self.nc, backbone=a.backbone,
                             output_stride=a.output_stride)

    def init_variables(self, seed: int = 0) -> nn.Module:
        """The model with random weights drawn from ``torch.Generator``
        seeded with ``seed``, in eval mode on the algorithm's device
        (``channels_last`` on CUDA)."""
        return seeded_model(self.build_model(), seed, self.device)

    def build_loss(self):
        """``loss_fn(logits NCHW, batch) -> (loss, metrics)`` over the
        batch's ``labels`` (B, H, W): the config's focal or CE loss."""
        l = self.cfg.loss

        def loss_fn(raw, batch):
            if l.name == "focal":
                return focal_loss(raw, batch["labels"], l.alpha, l.gamma,
                                  l.ignore_index)
            return cross_entropy_loss(raw, batch["labels"], l.ignore_index)

        return loss_fn

    # -------- inference ---------------------------------------------------
    def make_infer_fn(self, **_):
        """``infer(model, uint8 NHWC batch)``: /255 and the ImageNet
        normalisation in the compute dtype, the forward under bf16 autocast
        when mixed precision is on, then the argmax over the classes
        (int32; ties take the lowest class, as ``jnp.argmax`` does)."""
        dtype, amp, dev_type = self.dtype, self.mixed_precision, \
            self.device.type

        @torch.inference_mode()
        def infer(model, images_u8):
            x = imagenet_normalize(normalize_images(images_u8, dtype))
            with torch.autocast(dev_type, dtype=torch.bfloat16, enabled=amp):
                logits = model(x)
            return logits.argmax(dim=1).to(torch.int32)

        return infer

    def make_predict_infer_fn(self, **_):
        """The predict CLI's infer fn: the class-map one."""
        return self.make_infer_fn()

    def _resized(self, img: np.ndarray) -> np.ndarray:
        import cv2

        s = self.cfg.arch.crop_size
        return cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)

    def predict(self, model: nn.Module, image_path: str, infer_fn=None,
                save_dir: Optional[str] = "detect_results"):
        """One image: resized to crop² on the host (no letterbox), the class
        map on the device, coloured, resized back with nearest and blended
        over the image; written to ``save_dir`` as
        ``<name>@<timestamp>.jpg`` unless it is None."""
        import cv2

        infer_fn = infer_fn or self.make_infer_fn()
        img = read_image(image_path)
        x = torch.from_numpy(self._resized(img)[None]).to(self.device)
        cls_map = infer_fn(model, x)[0].cpu().numpy()
        seg_full = cv2.resize(postprocess_seg2d(cls_map),
                              (img.shape[1], img.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
        out = blend(img, seg_full)
        path = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(image_path))[0]
            path = os.path.join(
                save_dir, f"{name}@{time.strftime('%Y%m%d%H%M%S')}.jpg")
            cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        return {"class_map": cls_map, "overlay": out, "saved": path}

    # -------- int8 post-training quantization -----------------------------
    def quantize_variables(self, model: nn.Module, index, n_images: int = 8,
                           batch_size: int = 4) -> nn.Module:
        """int8 PTQ (``tpucv_torch/quant.py``): calibrate on the first
        ``n_images`` of ``index`` through the predict path's resize and
        normalisation (the forward under the algorithm's autocast) and
        return a quantized copy of ``model``. Index items may be paths,
        ndarrays or (image, ...) tuples."""
        n = min(n_images, len(index))
        if n == 0 or batch_size <= 0:
            raise ValueError("int8 calibration needs at least one image")

        def batches():
            for start in range(0, n, batch_size):
                buf = []
                for i in range(start, min(start + batch_size, n)):
                    item = index[i]
                    img = item[0] if isinstance(item, (tuple, list)) else item
                    img = read_image(img) if isinstance(img, str) else \
                        np.asarray(img)
                    if img.dtype != np.uint8:
                        img = np.clip(img, 0, 255).astype(np.uint8)
                    buf.append(self._resized(img))
                u8 = torch.from_numpy(np.stack(buf)).to(self.device)
                yield imagenet_normalize(normalize_images(u8, self.dtype))

        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            qmodel = quant.quantize_for_inference(model, batches())
        if quant.count_quantized(qmodel) == 0:
            raise ValueError(
                "DeeplabV3Plus produced no quantizable convs; refusing to "
                "silently run float")
        return qmodel

    # -------- evaluate-CLI contract ---------------------------------------
    def build_eval_index(self, subset: str = "val"):
        """The evaluate CLI's samples: VOC ``SegmentationClass`` pairs when
        the dataset root has them, else 8 synthetic samples."""
        from tpucv_torch.data.segmentation_dataset import (
            build_voc_seg_samples, synthetic_seg_samples)

        ds = get_dataset_cfg(self.cfg.dataset.name)
        if os.path.isdir(os.path.join(ds["root"], "SegmentationClass")):
            return build_voc_seg_samples(ds["root"], subset)
        print(f"dataset root {ds['root']!r} not found — synthetic seg data")
        return synthetic_seg_samples(8, self.cfg.arch.crop_size, self.nc, 1)

    def run_eval(self, model: nn.Module, samples, batch_size: int = 32,
                 plots: bool = False, **kw) -> Dict[str, float]:
        if plots:
            print("--plots follows the VOC detection protocol; ignored "
                  "for segmentation eval")
        from tpucv_torch.data.loader import Loader, segmentation_collate
        from tpucv_torch.data.segmentation_dataset import SegmentationDataset

        # every image counts, the last partial batch too (tpucv's loader
        # drops it: VOC val's 1,449 at B=32 would lose 9)
        loader = Loader(
            SegmentationDataset(samples, self.cfg.arch.crop_size,
                                train=False),
            batch_size, shuffle=False, collate=segmentation_collate,
            drop_last=False)
        return self.evaluate_on_voc(model, loader, **kw)

    def evaluate_on_voc(self, model: nn.Module, loader,
                        verbose: bool = True, **_) -> Dict[str, float]:
        """mIoU and accuracies over a segmentation ``Loader``: each batch's
        class map and its histogram on the device; only the (nc, nc)
        histogram reaches the host."""
        infer = self.make_infer_fn()
        metrics = SegmentationMetrics(self.nc, self.cfg.loss.ignore_index)
        for batch in loader:
            images = torch.from_numpy(batch["images"]).to(self.device)
            labels = torch.from_numpy(batch["labels"]).to(self.device)
            metrics.update(infer(model, images), labels)
        out = metrics.compute()
        if verbose:
            print({k: v for k, v in out.items() if k != "per_class_iou"})
        return out
