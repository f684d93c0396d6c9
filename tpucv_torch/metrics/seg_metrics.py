"""Segmentation metrics through a confusion matrix (counterpart of
``tpucv/metrics/seg_metrics.py``; the reference's
``core/metrics/seg_metrics.py:4-38``): overall accuracy, mean per-class
accuracy, frequency-weighted IoU, mIoU and the per-class IoU.

The histogram is an integer ``torch.bincount`` on the tensors' device, so
an evaluation moves only the (nc, nc) matrix to the host: a float-weighted
count would sum in an unordered way on the card. The host accumulates it
in float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """Integer maps of one shape -> the (nc, nc) int64 histogram, rows the
    label, columns the prediction (clipped to [0, nc)). Pixels whose label
    is ``ignore_index`` or outside [0, nc) go to one extra bin, which is
    dropped."""
    nc = num_classes
    valid = (label >= 0) & (label < nc) & (label != ignore_index)
    idx = nc * label.long() + pred.long().clamp(0, nc - 1)
    idx = torch.where(valid, idx, torch.full_like(idx, nc * nc))
    hist = torch.bincount(idx.reshape(-1), minlength=nc * nc + 1)
    return hist[:nc * nc].reshape(nc, nc)


class SegmentationMetrics:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.nc = num_classes
        self.ignore_index = ignore_index
        self.hist = np.zeros((num_classes, num_classes), np.float64)

    def update(self, pred, label) -> None:
        """Add one batch: tensors (on any device) or arrays."""
        pred, label = torch.as_tensor(pred), torch.as_tensor(label)
        self.hist += confusion_matrix(
            pred, label.to(pred.device), self.nc,
            self.ignore_index).cpu().numpy()

    def reset(self) -> None:
        self.hist[:] = 0

    def compute(self) -> Dict[str, float]:
        h = self.hist
        eps = 1e-9
        acc = np.diag(h).sum() / (h.sum() + eps)
        # absent classes (no GT and no prediction) are NaN and left out by
        # nanmean, the reference's rule: a 0 there would deflate the mIoU
        # of a split that lacks classes
        with np.errstate(divide="ignore", invalid="ignore"):
            acc_cls = np.diag(h) / h.sum(axis=1)
            denom = h.sum(axis=1) + h.sum(axis=0) - np.diag(h)
            iou = np.where(denom > 0, np.diag(h) / np.where(denom > 0, denom, 1),
                           np.nan)
        freq = h.sum(axis=1) / (h.sum() + eps)
        valid = (freq > 0) & np.isfinite(iou)
        fwavacc = (freq[valid] * iou[valid]).sum()
        return {
            "overall_acc": float(acc),
            "mean_acc": float(np.nanmean(acc_cls)),
            "freq_weighted_acc": float(fwavacc),
            "mIoU": float(np.nanmean(iou)),
            "per_class_iou": iou.tolist(),
        }
