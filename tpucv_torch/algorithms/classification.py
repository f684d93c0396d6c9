"""Image-classification algorithm façade, ViT (counterpart of
``tpucv/algorithms/classification.py``): build_model / build_loss /
make_infer_fn / predict / evaluate. It is not a ``DetectionAlgorithm``: no
boxes, no letterbox, no NMS, and no ``quantize_variables``, so the predict
and evaluate CLIs refuse ``--int8`` for it, as tpucv's do.

As elsewhere in the port, the model itself (an ``nn.Module`` holding its
weights on the algorithm's device) stands where tpucv passes its flax
``variables``. ``infer(model, uint8 NHWC batch) -> (B, nc)`` f32 softmax
probabilities.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.algorithms.base import seeded_model
from tpucv_torch.models.vit import ViT
from tpucv_torch.ops.preprocess import normalize_images
from tpucv_torch.registry import model_registry
from tpucv_torch.utils.device import resolve_device
from tpucv_torch.utils.image_process import read_image


@model_registry("vit_cls")
class VitClassification:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.nc = cfg.num_classes
        self.input_size = cfg.dataset.input_size
        self.mixed_precision = cfg.train.mixed_precision
        self.dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        self.class_names = [f"c{i}" for i in range(self.nc)]

    def build_model(self) -> nn.Module:
        a = self.cfg.arch
        return ViT(num_classes=self.nc, patch=a.patch, dim=a.dim,
                   depth=a.depth, heads=a.heads, img_size=self.input_size)

    def init_variables(self, seed: int = 0) -> nn.Module:
        """The model with random weights drawn from ``torch.Generator``
        seeded with ``seed``, in eval mode on the algorithm's device
        (``channels_last`` on CUDA)."""
        return seeded_model(self.build_model(), seed, self.device)

    def build_loss(self):
        """``loss_fn(logits (B, nc), batch) -> (loss, {"acc"})``: the
        cross-entropy in f32 against the smoothed one-hot labels
        ``onehot·(1-s) + s/nc``, averaged over the batch; ``acc`` is the
        share of rows whose argmax is the label."""
        smoothing, nc = self.cfg.loss.label_smoothing, self.nc

        def loss_fn(logits, batch):
            labels = batch["labels"].long()
            onehot = F.one_hot(labels, nc).float()
            soft = onehot * (1 - smoothing) + smoothing / nc
            ce = -(soft * torch.log_softmax(logits.float(), -1)).sum(-1)
            acc = (logits.argmax(-1) == labels).float().mean()
            return ce.mean(), {"acc": acc}

        return loss_fn

    # -------- inference ---------------------------------------------------
    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """``infer(model, uint8 NHWC batch)``: /255 in the compute dtype,
        the forward under bf16 autocast when mixed precision is on, and
        the softmax of the logits in f32."""
        dtype, amp, dev_type = self.dtype, self.mixed_precision, \
            self.device.type

        @torch.inference_mode()
        def infer(model, images_u8):
            x = normalize_images(images_u8, dtype)
            with torch.autocast(dev_type, dtype=torch.bfloat16, enabled=amp):
                logits = model(x)
            return torch.softmax(logits.float(), dim=-1)

        return infer

    def make_predict_infer_fn(self, conf_threshold: Optional[float] = None):
        """The predict CLI's infer fn: the same softmax probabilities."""
        return self.make_infer_fn(conf_threshold)

    def _resized(self, img: np.ndarray) -> np.ndarray:
        import cv2

        s = self.input_size
        return cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)

    def predict(self, model: nn.Module, image_path, infer_fn=None,
                save_dir: Optional[str] = None, topk: int = 5):
        """The top-``topk`` classes of one image (a path or an RGB
        ndarray), resized to s² with INTER_LINEAR on the host; printed
        one a line. ``boxes`` is (0, 4) and nothing is drawn."""
        infer_fn = infer_fn or self.make_infer_fn()
        img = read_image(image_path) if isinstance(image_path, str) \
            else image_path
        x = torch.from_numpy(self._resized(img)[None]).to(self.device)
        probs = infer_fn(model, x)[0].cpu().numpy()
        k = min(topk, self.nc)
        top = np.argsort(-probs)[:k]
        result = {
            "classes": top,
            "scores": probs[top],
            "labels": [self.class_names[int(i)] for i in top],
            "boxes": np.zeros((0, 4), np.float32),
            "saved": None,
        }
        for i in top:
            print(f"  {self.class_names[int(i)]:>12s}: {probs[int(i)]:.4f}")
        return result

    # -------- evaluate-CLI contract ---------------------------------------
    def build_eval_index(self, subset: str = "val"):
        """An ImageFolder index under ``TPUCV_CLS_ROOT``, its classes pinned
        to the train split's listing (what the checkpoint's logits mean);
        32 synthetic images otherwise."""
        from tpucv_torch.data.classification_dataset import (
            ImageFolderIndex, SyntheticClsIndex)

        root = os.environ.get("TPUCV_CLS_ROOT", "")
        if root and os.path.isdir(os.path.join(root, subset)):
            classes = None
            if os.path.isdir(os.path.join(root, "train")):
                classes = ImageFolderIndex(root, "train").classes
            index = ImageFolderIndex(root, subset, classes=classes)
            if len(index.classes) != self.nc:
                raise SystemExit(
                    f"folder tree has {len(index.classes)} classes but the "
                    f"config (and checkpoint) use {self.nc}; set "
                    f"n_classes to match the dataset")
            self.class_names = list(index.classes)
            return index
        print(f"TPUCV_CLS_ROOT {root!r} not found — synthetic data")
        return SyntheticClsIndex(32, self.input_size, self.nc, seed=1)

    def run_eval(self, model: nn.Module, index, batch_size: int = 64,
                 plots: bool = False, **kw):
        if plots:
            print("--plots follows the VOC protocol; ignored for "
                  "classification eval")
        return self.evaluate(model, index, batch_size, **kw)

    def evaluate(self, model: nn.Module, index, batch_size: int = 64,
                 verbose: bool = True) -> Dict[str, float]:
        """Top-1 / top-5 accuracy over an (image, label) index: fixed-size
        batches (the last filled with zeros), the softmax on the device,
        the ranking on the host (``np.argsort(-probs)``, tpucv's)."""
        infer = self.make_infer_fn()
        s = self.input_size
        n = len(index)
        top1 = top5 = 0
        for start in range(0, n, batch_size):
            idxs = range(start, min(start + batch_size, n))
            imgs = np.zeros((batch_size, s, s, 3), np.uint8)
            labels = np.zeros(batch_size, np.int64)
            for j, i in enumerate(idxs):
                img, labels[j] = index[i][:2]
                if isinstance(img, str):
                    img = read_image(img)
                imgs[j] = img if img.shape[:2] == (s, s) else \
                    self._resized(img)
            probs = infer(model, torch.from_numpy(imgs).to(
                self.device)).cpu().numpy()
            k = min(5, self.nc)
            topk_idx = np.argsort(-probs, axis=-1)[:, :k]
            for j in range(len(idxs)):
                top1 += int(topk_idx[j, 0] == labels[j])
                top5 += int(labels[j] in topk_idx[j])
        res = {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}
        if verbose:
            print(f"top-1 {res['top1'] * 100:.2f}%  "
                  f"top-5 {res['top5'] * 100:.2f}%  ({n} images)")
        return res
