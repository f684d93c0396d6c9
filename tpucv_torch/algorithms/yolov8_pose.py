"""YOLOv8-pose algorithm (counterpart of
``tpucv/algorithms/yolov8_pose.py``): person keypoints on the YOLOv8
detection stack. The shared harness gives person-box mAP through the
boxes-only infer fn; ``evaluate_on_coco`` adds OKS keypoint AP;
``predict`` draws the keypoints."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from tpucv_torch.algorithms.base import DetectionAlgorithm
from tpucv_torch.algorithms.yolov8 import yolo_decode_args, yolo_infer_fn
from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.decode.yolov8_pose import decode_pose
from tpucv_torch.losses.yolov8_pose import yolov8_pose_loss
from tpucv_torch.metrics.coco_map import (COCOKeypointAP, COCOMeanAP,
                                          OKS_SIGMAS)
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.registry import model_registry
from tpucv_torch.utils.image_process import (letter_box, read_image,
                                             reverse_letter_box)
from tpucv_torch.utils.profile import span
from tpucv_torch.utils.visualize import show_detection_results


@model_registry("yolo8_pose")
class YOLOv8Pose(DetectionAlgorithm):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.nc = cfg.num_classes
        self.class_names = ["person"]

    def build_model(self) -> Yolo8:
        a = self.cfg.arch
        return Yolo8(scale=a.model_type, nc=self.nc, reg_max=a.reg_max,
                     head="pose", kpt_shape=tuple(a.kpt_shape))

    def build_loss(self):
        """``loss_fn(raw, batch)`` over ``gt_labels``, ``gt_bboxes``,
        ``gt_mask`` and ``gt_kpts``."""
        l, a = self.cfg.loss, self.cfg.arch

        def loss_fn(raw, batch):
            return yolov8_pose_loss(
                raw, batch["gt_labels"], batch["gt_bboxes"],
                batch["gt_mask"], batch["gt_kpts"],
                nc=self.nc, reg_max=a.reg_max, strides=a.strides,
                box_gain=l.box_gain, cls_gain=l.cls_gain,
                dfl_gain=l.dfl_gain, kpt_gain=l.kpt_gain,
                kobj_gain=l.kobj_gain, tal_topk=l.tal_topk,
                pose_topk=l.pose_topk)

        return loss_fn

    def _decode_args(self, conf_threshold):
        kw = yolo_decode_args(self.cfg, self.nc, conf_threshold)
        kw["kpt_shape"] = tuple(self.cfg.arch.kpt_shape)
        return kw

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        """Boxes only, the shared eval harness's contract."""
        return yolo_infer_fn(self, decode_pose,
                             self._decode_args(conf_threshold), n_out=4)

    def make_pose_infer_fn(self, conf_threshold: Optional[float] = None):
        """(boxes, scores, classes, valid, keypoints)."""
        return yolo_infer_fn(self, decode_pose,
                             self._decode_args(conf_threshold))

    make_predict_infer_fn = make_pose_infer_fn

    # ------------------------------------------------------------ evaluate
    def _batched_pose_detections(self, model, index, batch_size: int,
                                 conf_threshold: float):
        """The base harness's batched loop (``_detect_batches``, its five
        spans) with the keypoints as well; boxes and keypoints mapped back
        to the original image. Yields (i, boxes, scores, classes, kpts)."""
        infer = self.make_pose_infer_fn(conf_threshold)
        for idxs, outs, scale_b, pad_b, oshapes, prescales in \
                self._detect_batches(model, index, batch_size, infer):
            boxes_b, scores_b, classes_b, valid_b, kpts_b = outs
            with span("tpucv.detect.unbox"):
                results = []
                for j, i in enumerate(idxs):
                    v = valid_b[j]
                    boxes, sx, sy = self._to_image(
                        boxes_b[j][v], scale_b[j], pad_b[j], oshapes[j],
                        prescales[j])
                    kv = kpts_b[j][v].copy()
                    px, py = (float(p) for p in pad_b[j])
                    kv[..., 0] = (kv[..., 0] - px) / max(sx, 1e-9)
                    kv[..., 1] = (kv[..., 1] - py) / max(sy, 1e-9)
                    results.append((i, boxes, scores_b[j][v],
                                    classes_b[j][v], kv))
            yield from results

    def build_eval_index(self, subset: str = "val"):
        """The person_keypoints COCO index under the dataset root when it
        is there, else 16 synthetic pose images."""
        from tpucv_torch.data.pose_dataset import (COCOKeypointIndex,
                                                   SyntheticPoseIndex)
        ds = get_dataset_cfg(self.cfg.dataset.name)
        ann = os.path.join(
            ds["root"], f"annotations/person_keypoints_{subset}2017.json")
        img_root = os.path.join(ds["root"], f"{subset}2017")
        if os.path.isfile(ann) and os.path.isdir(img_root):
            return COCOKeypointIndex(ann, img_root)
        print(f"person_keypoints not found under {ds['root']!r} — "
              f"synthetic pose data")
        return SyntheticPoseIndex(16, self.input_size,
                                  nk=self.cfg.arch.kpt_shape[0], seed=1)

    def run_eval(self, model, index, batch_size: int = 32,
                 plots: bool = False, **kw):
        if plots:
            print("--plots follows the VOC protocol; ignored for pose eval")
        return self.evaluate_on_coco(model, index, batch_size, **kw)

    def evaluate_on_coco(self, model, index, batch_size: int = 32,
                         conf_threshold: float = 0.001,
                         result_dir: str = "result",
                         verbose: bool = True):
        """Person-box stats (COCOeval bbox) and OKS keypoint stats
        (COCOeval keypoints, ``kpt_``-prefixed) over a keypoint index; the
        keypoint detections go to ``result_dir/eval_results.json``."""
        nk = self.cfg.arch.kpt_shape[0]
        dts_box, dts_kpt = [], []
        for i, boxes, scores, classes, kpts in self._batched_pose_detections(
                model, index, batch_size, conf_threshold):
            img_id = index.image_id(i)
            for b, s_, kp in zip(boxes, scores, kpts):
                dts_box.append({
                    "image_id": img_id, "category_id": 1,
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "score": float(s_)})
                dts_kpt.append({
                    "image_id": img_id, "category_id": 1,
                    "keypoints": np.asarray(kp, np.float32).reshape(-1),
                    "score": float(s_)})
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, "eval_results.json"), "w") as f:
            json.dump([{**d, "keypoints": d["keypoints"].tolist()}
                       for d in dts_kpt], f)
        gts = [r for i in range(len(index)) for r in index.eval_gt_records(i)]
        box_stats = COCOMeanAP(gts, dts_box, index.cat_ids) \
            .accumulate().summarize()
        sigmas = OKS_SIGMAS if nk == len(OKS_SIGMAS) else np.full(nk, 0.05)
        kp_ev = COCOKeypointAP(gts, dts_kpt, index.cat_ids,
                               sigmas=sigmas).accumulate()
        kpt_stats = kp_ev.summarize()
        if verbose:
            print(f"person bbox: AP={box_stats['AP']:.3f}  "
                  f"AP50={box_stats['AP50']:.3f}")
            print("keypoints (OKS):")
            kp_ev.print_summary(kpt_stats)
        stats = dict(box_stats)
        stats.update({f"kpt_{k}": v for k, v in kpt_stats.items()})
        return stats

    def predict(self, model, image_path, infer_fn=None,
                save_dir: Optional[str] = "detect_results"):
        """Detections and their keypoints on one image (a path or an RGB
        array), mapped back to the image; keypoints with visibility over
        0.5 drawn with the boxes into ``save_dir``."""
        import cv2

        infer_fn = infer_fn or self.make_pose_infer_fn()
        img = read_image(image_path) if isinstance(image_path, str) \
            else image_path
        s = self.input_size
        canvas, scale, pad = letter_box(img, (s, s))
        boxes, scores, classes, valid, kpts = (
            t.cpu().numpy() for t in infer_fn(
                model, torch.from_numpy(canvas[None]).to(self.device)))
        v = valid[0]
        boxes_img = reverse_letter_box(boxes[0][v], scale, pad,
                                       img.shape[:2])
        kv = kpts[0][v].copy()                       # canvas px
        kv[..., 0] = (kv[..., 0] - pad[0]) / scale
        kv[..., 1] = (kv[..., 1] - pad[1]) / scale
        overlay = img.copy()
        for inst in kv:
            for x, y, c in inst:
                if c > 0.5:
                    cv2.circle(overlay, (int(x), int(y)), 3, (0, 255, 0), -1)
        saved = None
        if save_dir:
            name = (os.path.splitext(os.path.basename(image_path))[0]
                    if isinstance(image_path, str) else "array")
            saved = show_detection_results(
                overlay, boxes_img, scores[0][v], classes[0][v],
                self.class_names, save_dir, name + "_pose")
        return {"boxes": boxes_img, "scores": scores[0][v],
                "classes": classes[0][v], "keypoints": kv, "image": img,
                "saved": saved}
