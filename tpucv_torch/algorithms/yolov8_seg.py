"""YOLOv8-seg algorithm (counterpart of ``tpucv/algorithms/yolov8_seg.py``):
instance segmentation on the YOLOv8 detection stack. The shared eval
harness gives bbox mAP through the boxes-only infer fn; ``predict`` adds
each detection's mask and draws it; ``evaluate_mask_ap`` scores the masks
with the COCO segm protocol."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_decode_args, yolo_infer_fn
from tpucv_torch.data.instance_seg_dataset import box_mask
from tpucv_torch.decode.yolov8_seg import decode_seg
from tpucv_torch.losses.yolov8_seg import yolov8_seg_loss
from tpucv_torch.metrics.coco_map import COCOMaskAP
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.ops.masks import process_mask
from tpucv_torch.registry import model_registry
from tpucv_torch.utils.image_process import (letter_box, read_image,
                                             reverse_letter_box)
from tpucv_torch.utils.visualize import show_detection_results


@model_registry("yolo8_seg")
class YOLOv8Seg(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes

    def build_model(self) -> Yolo8:
        a = self.cfg.arch
        return Yolo8(scale=a.model_type, nc=self.nc, reg_max=a.reg_max,
                     head="segment", n_masks=a.n_masks)

    def build_loss(self):
        """``loss_fn(raw, batch)`` over ``gt_labels``, ``gt_bboxes``,
        ``gt_mask`` and ``gt_inst_masks``."""
        l, a = self.cfg.loss, self.cfg.arch

        def loss_fn(raw, batch):
            return yolov8_seg_loss(
                raw, batch["gt_labels"], batch["gt_bboxes"],
                batch["gt_mask"], batch["gt_inst_masks"],
                nc=self.nc, reg_max=a.reg_max, strides=a.strides,
                box_gain=l.box_gain, cls_gain=l.cls_gain,
                dfl_gain=l.dfl_gain, mask_gain=l.mask_gain,
                tal_topk=l.tal_topk, mask_topk=l.mask_topk)

        return loss_fn

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """Boxes only, the shared eval harness's contract."""
        return yolo_infer_fn(
            self, decode_seg,
            yolo_decode_args(self.cfg, self.nc, conf_threshold), n_out=4)

    def make_seg_infer_fn(self, conf_threshold: Optional[float] = None):
        """(boxes, scores, classes, valid, mask coefficients, prototypes)."""
        return yolo_infer_fn(
            self, decode_seg,
            yolo_decode_args(self.cfg, self.nc, conf_threshold))

    make_predict_infer_fn = make_seg_infer_fn

    def _masks(self, protos, coefs, boxes, valid) -> np.ndarray:
        """The valid detections' masks on the (s, s) input canvas,
        thresholded at 0.5: (n, s, s) bool on the host."""
        s = self.input_size
        m = process_mask(protos, coefs[valid], boxes[valid], (s, s),
                         upsample=True)
        return (m > 0.5).cpu().numpy()

    def evaluate_mask_ap(self, model, index, batch_size: int = 8,
                         conf_threshold: float = 0.001,
                         verbose: bool = True):
        """Mask AP: the COCO iouType='segm' protocol at the letterboxed
        canvas resolution over dense masks (``COCOMaskAP``).

        Detection masks are the prototypes combined, cropped and
        upsampled to the (s, s) canvas and thresholded at 0.5; GT masks
        are rasterised on the same canvas, from polygons when the index
        has them (``index.polygons``), box-filled otherwise (exact for the
        synthetic data, whose objects are rectangles)."""
        import cv2

        s = self.input_size
        infer = self.make_seg_infer_fn(conf_threshold)
        polys = getattr(index, "polygons", None)

        gts, dts, canvases = [], [], []
        for i in range(len(index)):
            img, boxes, labels = index[i][:3]
            if isinstance(img, str):
                img = read_image(img)
            canvas, scale, pad = letter_box(img, (s, s))
            canvases.append(canvas)
            for j, (b, l) in enumerate(zip(boxes, labels)):
                m = np.zeros((s, s), np.uint8)
                pts = None
                if callable(polys):
                    pl = polys(i, j)
                    if pl:
                        pts = [np.round(
                            np.asarray(p, np.float32).reshape(-1, 2)
                            * scale + np.asarray(pad, np.float32)
                        ).astype(np.int32) for p in pl if len(p) >= 6]
                if pts:
                    cv2.fillPoly(m, pts, 1)
                else:
                    x1, y1, x2, y2 = np.asarray(b, np.float32) * scale
                    box_mask(m, (x1 + pad[0], y1 + pad[1],
                                 x2 + pad[0], y2 + pad[1]))
                gts.append({"image_id": i, "category_id": int(l),
                            "mask": m, "area": float(m.sum()),
                            "iscrowd": 0})

        for start in range(0, len(canvases), batch_size):
            chunk = canvases[start:start + batch_size]
            nb = len(chunk)
            # the last batch padded to the full batch size, as tpucv's
            # static shape has it
            chunk = chunk + [np.zeros((s, s, 3), np.uint8)] * (batch_size - nb)
            boxes_b, scores_b, classes_b, valid_b, coefs_b, protos_b = infer(
                model, torch.from_numpy(np.stack(chunk)).to(self.device))
            valid_h = valid_b.cpu().numpy()
            scores_h = scores_b.cpu().numpy()
            classes_h = classes_b.cpu().numpy()
            for bi in range(nb):
                v = valid_h[bi]
                if not v.any():
                    continue
                masks = self._masks(protos_b[bi], coefs_b[bi], boxes_b[bi],
                                    valid_b[bi])
                for m, k in zip(masks, np.flatnonzero(v)):
                    dts.append({
                        "image_id": start + bi,
                        "category_id": int(classes_h[bi][k]),
                        "score": float(scores_h[bi][k]), "mask": m})

        cat_ids = list(range(len(self.class_names)))
        ev = COCOMaskAP(gts, dts, cat_ids).accumulate()
        stats = ev.summarize()
        if verbose:
            print("Mask AP (COCO segm protocol, canvas resolution):")
            ev.print_summary(stats)
        return stats

    def predict(self, model, image_path, infer_fn=None,
                save_dir: Optional[str] = "detect_results"):
        """Detections and their masks on one image (a path or an RGB
        array): the masks at the input canvas (thresholded at 0.5) and
        drawn over the image with its boxes into ``save_dir``."""
        import cv2

        infer_fn = infer_fn or self.make_seg_infer_fn()
        img = read_image(image_path) if isinstance(image_path, str) \
            else image_path
        s = self.input_size
        canvas, scale, pad = letter_box(img, (s, s))
        boxes, scores, classes, valid, coefs, protos = infer_fn(
            model, torch.from_numpy(canvas[None]).to(self.device))
        masks_v = self._masks(protos[0], coefs[0], boxes[0], valid[0])
        v = valid[0].cpu().numpy()
        boxes_img = reverse_letter_box(boxes[0].cpu().numpy()[v], scale,
                                       pad, img.shape[:2])
        scores_v = scores[0].cpu().numpy()[v]
        classes_v = classes[0].cpu().numpy()[v]

        overlay = img.copy()
        rng = np.random.default_rng(0)
        for m in masks_v:
            # undo the letterbox on the mask: crop the pad, resize
            mh = m[int(pad[1]):s - int(pad[1]) or s,
                   int(pad[0]):s - int(pad[0]) or s]
            mi = cv2.resize(mh.astype(np.uint8),
                            (img.shape[1], img.shape[0])) > 0
            color = rng.integers(60, 255, 3)
            overlay[mi] = (0.5 * overlay[mi] + 0.5 * color).astype(np.uint8)
        saved = None
        if save_dir:
            name = (os.path.splitext(os.path.basename(image_path))[0]
                    if isinstance(image_path, str) else "array")
            saved = show_detection_results(
                overlay, boxes_img, scores_v, classes_v, self.class_names,
                save_dir, name + "_seg")
        return {"boxes": boxes_img, "scores": scores_v, "classes": classes_v,
                "masks": masks_v, "image": img, "saved": saved}
