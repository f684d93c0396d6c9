"""Shared detection-algorithm skeleton (counterpart of
``tpucv/algorithms/base.py``): predict, int8 calibration
(``quantize_variables``), the batched serving / evaluation loop, and the
COCO and VOC evaluation harnesses.

Where tpucv passes a flax ``variables`` pytree, the port passes the model
itself: an ``nn.Module`` holding its weights on the algorithm's device,
from :meth:`DetectionAlgorithm.init_variables`. ``infer_fn(model, uint8
NHWC batch) -> (boxes xyxy px, scores, classes, valid)`` has fixed shapes.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tpucv_torch import quant
from tpucv_torch.configs.dataset_cfg import get_dataset_cfg
from tpucv_torch.ops.preprocess import (host_letterbox_geom, letterbox_images,
                                        normalize_images)
from tpucv_torch.utils.device import resolve_device
from tpucv_torch.utils.image_process import (letter_box, read_image,
                                             reverse_letter_box)
from tpucv_torch.utils.profile import span
from tpucv_torch.utils.visualize import show_detection_results


def seeded_model(model: nn.Module, seed: int, device) -> nn.Module:
    """``model`` with random weights drawn from ``torch.Generator`` seeded
    with ``seed`` (its ``reset_parameters``), in eval mode on ``device``
    (``channels_last`` on CUDA)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


class CanvasStaging:
    """The host side of a batched detect call's upload, reused batch after
    batch: ``canvases`` (B, C, C, 3) uint8, which ``_fill_canvases`` fills
    in place, and room for the letterbox's ``hw`` / ``geom`` / ``hscale``.

    On a CUDA device all four are page-locked, so ``upload`` issues its
    copies without blocking the host, and an event recorded after them
    makes ``wait`` hold the next fill off until they have read the bytes.
    On the CPU they are plain memory that ``upload`` hands on uncopied.

    Process-wide counters: ``allocations`` (stagings made), ``reuses``
    (batches filled into one already made) and ``pinned_bytes`` (bytes
    page-locked by the allocations).
    """

    allocations = 0
    reuses = 0
    pinned_bytes = 0

    def __init__(self, batch_size: int, C: int, device: torch.device):
        self.key = (batch_size, C)
        pinned = device.type == "cuda"
        self._host = [torch.empty(shape, dtype=dtype, pin_memory=pinned)
                      for shape, dtype in (
                          ((batch_size, C, C, 3), torch.uint8),
                          ((batch_size, 2), torch.int32),
                          ((batch_size, 4), torch.int32),
                          ((batch_size,), torch.float32))]
        self.canvases = self._host[0].numpy()
        self._copied = torch.cuda.Event() if pinned else None
        CanvasStaging.allocations += 1
        if pinned:
            CanvasStaging.pinned_bytes += sum(t.nbytes for t in self._host)

    def wait(self) -> None:
        """Return once the last ``upload``'s copies have read the buffers."""
        if self._copied is not None:
            self._copied.synchronize()

    def upload(self, device: torch.device, hw, geom, hscale):
        """``canvases``, ``hw``, ``geom`` and ``hscale`` on ``device``."""
        if self._copied is None:
            return tuple(torch.from_numpy(a).to(device)
                         for a in (self.canvases, hw, geom, hscale))
        for t, a in zip(self._host[1:], (hw, geom, hscale)):
            t.numpy()[:] = a
        out = tuple(t.to(device, non_blocking=True) for t in self._host)
        self._copied.record(torch.cuda.current_stream(device))
        return out


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
        # the batched detect loop's staging (newest (B, C) only), held by
        # one thread at a time, and the pool that places its images
        self._staging: Optional[CanvasStaging] = None
        self._staging_lock = threading.Lock()
        self._placer: Optional[ThreadPoolExecutor] = None

    # -------- subclass contract ------------------------------------------
    def build_model(self) -> nn.Module:
        raise NotImplementedError

    def make_infer_fn(self, conf_threshold: Optional[float] = None):
        raise NotImplementedError

    def make_predict_infer_fn(self, conf_threshold: Optional[float] = None):
        """The infer fn the predict CLI hands to ``predict``: the
        boxes-only one here; the segment and pose families return their
        masks' and keypoints' outputs as well."""
        return self.make_infer_fn(conf_threshold)

    def init_variables(self, seed: int = 0) -> nn.Module:
        """The model with random weights drawn from ``torch.Generator``
        seeded with ``seed``, in eval mode on the algorithm's device
        (``channels_last`` on CUDA). Load trained weights into it with
        ``load_state_dict``."""
        return seeded_model(self.build_model(), seed, self.device)

    # -------- int8 post-training quantization -----------------------------
    def quantize_variables(self, model: nn.Module, index, n_images: int = 32,
                           batch_size: int = 8) -> nn.Module:
        """PTQ entry point for the eval / predict / serve harness: calibrate
        on the first ``n_images`` of ``index`` through the production
        letterbox path (the forward under the algorithm's autocast) and
        return a copy of ``model`` with its int8 buffers (see
        ``tpucv_torch/quant.py``); ``model`` is not changed."""
        s, dev = self.input_size, self.device
        n = min(n_images, len(index))
        if n == 0 or batch_size <= 0:
            raise ValueError("int8 calibration needs at least one image")

        def batches():
            # one calibration batch on the device at a time, the staging
            # read before it is yielded
            for start in range(0, n, batch_size):
                idxs = list(range(start, min(start + batch_size, n)))
                with self._staged_batch(index, idxs, batch_size) as (
                        canvases, hw, geom, hscale, _, _):
                    lb, _, _ = letterbox_images(canvases, hw, s, geom=geom,
                                                scale=hscale)
                    x = normalize_images(lb, self.dtype)
                yield x

        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            qmodel = quant.quantize_for_inference(model, batches())
        if quant.count_quantized(qmodel) == 0:
            raise ValueError(
                f"{type(model).__name__} has no quantizable convs: its "
                f"blocks lack the ConvBnAct hooks (see "
                f"tpucv_torch/quant.py); refusing to silently run float")
        return qmodel

    # -------- shared inference plumbing ----------------------------------
    def predict(self, model: nn.Module, image_path: str, infer_fn=None,
                save_dir: Optional[str] = "detect_results"):
        """Detections on one image file: letterboxed on the host, one-image
        inference on ``self.device``, boxes mapped back to the image and
        clipped to it; drawn into ``save_dir`` unless it is None."""
        infer_fn = infer_fn or self.make_infer_fn()
        img = read_image(image_path)
        s = self.input_size
        canvas, scale, pad = letter_box(img, (s, s))
        boxes, scores, classes, valid = (
            t.cpu().numpy() for t in infer_fn(
                model, torch.from_numpy(canvas[None]).to(self.device)))
        v = valid[0]
        boxes = reverse_letter_box(boxes[0][v], scale, pad, img.shape[:2])
        scores, classes = scores[0][v], classes[0][v]
        out_path = None
        if save_dir:
            name = os.path.splitext(os.path.basename(image_path))[0]
            out_path = show_detection_results(
                img, boxes, scores, classes, self.class_names, save_dir, name)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "image": img, "saved": out_path}

    # raw-image canvas edge for the device-side letterbox; COCO and VOC
    # images never exceed 640 on a side
    RAW_CANVAS = 640

    @property
    def raw_canvas(self) -> int:
        return max(self.RAW_CANVAS, self.input_size)

    def _fill_canvases(self, index, idxs, batch_size: int, C: int,
                       out: np.ndarray):
        """Place one batch of images top-left on ``out``, a C-contiguous
        (batch_size, C, C, 3) uint8 array, whatever it held, nearest
        pre-shrinking images larger than C; every byte outside the placed
        images is zeroed, the rows past the batch's images included. Each
        index item is a tuple whose first entry is an RGB ndarray or an
        image path.

        Returns (canvases, which is ``out``, hw (batch_size, 2) placed
        dims, oshapes original dims, prescales per-axis pre-shrink ratios).

        Fast path: one threaded native call decodes a batch of JPEG paths
        (``native/imagepipe.cpp``, bit-identical to the loop below); what
        it cannot take (ndarrays, non-JPEG files) goes through
        ``read_image`` and cv2. Reading, placing and zeroing run an image
        a task on the algorithm's thread pool.
        """
        from tpucv_torch.native import imagepipe

        if not (out.shape == (batch_size, C, C, 3) and out.dtype == np.uint8
                and out.flags.c_contiguous):
            raise ValueError(
                f"out must be C-contiguous uint8 ({batch_size}, {C}, {C}, "
                f"3); got {out.dtype} {out.shape}")
        canvases = out
        hw = np.ones((batch_size, 2), np.int32)
        oshapes = [None] * len(idxs)
        prescales = [None] * len(idxs)
        done = [False] * len(idxs)
        # each item fetched once: a synthetic index renders its image in
        # __getitem__
        srcs = [index[i][0] for i in idxs]
        if all(isinstance(p, str) for p in srcs) and imagepipe.available():
            # the native code writes each decoded image and nothing else
            _, nhw, norig, ok = imagepipe.decode_to_canvas(
                srcs, C, out=canvases)
            for j in np.flatnonzero(ok):
                hw[j] = nhw[j]
                oh, ow = int(norig[j, 0]), int(norig[j, 1])
                oshapes[j] = (oh, ow)
                prescales[j] = (nhw[j, 1] / ow, nhw[j, 0] / oh)
                done[j] = True

        def place(j):
            canvas = canvases[j]
            if j >= len(srcs):
                canvas[...] = 0
                return
            if not done[j]:
                src = srcs[j]
                img = read_image(src) if isinstance(src, str) else src
                oh, ow = img.shape[:2]
                if oh > C or ow > C:
                    # rare: nearest pre-shrink on the host so the image
                    # fits the canvas, keeping one resampling family end
                    # to end
                    import cv2
                    pre = C / max(oh, ow)
                    img = cv2.resize(img, (int(ow * pre), int(oh * pre)),
                                     interpolation=cv2.INTER_NEAREST)
                h, w = img.shape[:2]
                canvas[:h, :w] = img
                hw[j] = (h, w)
                oshapes[j] = (oh, ow)
                prescales[j] = (w / ow, h / oh)
            h, w = hw[j]
            canvas[:h, w:] = 0
            canvas[h:] = 0

        if self._placer is None:
            # the copies are bound by the host's memory: on the H100's
            # 8-core host 4 threads fill a batch of 32 COCO-shaped images
            # as fast as 8
            self._placer = ThreadPoolExecutor(
                max(1, len(os.sched_getaffinity(0)) // 2),
                thread_name_prefix="tpucv-canvas")
        futures = [self._placer.submit(place, j) for j in range(batch_size)]
        wait(futures)
        for f in futures:
            f.result()
        return canvases, hw, oshapes, prescales

    def _canvas_staging(self, batch_size: int, C: int) -> CanvasStaging:
        """This algorithm's staging for (batch_size, C), reused while the
        shape holds; another shape replaces it. Call under
        ``_staging_lock``."""
        stage = self._staging
        if stage is not None and stage.key == (batch_size, C):
            CanvasStaging.reuses += 1
            return stage
        self._staging = stage = CanvasStaging(batch_size, C, self.device)
        return stage

    @contextmanager
    def _staged_batch(self, index, idxs, batch_size: int):
        """Items ``idxs`` of ``index`` filled into the algorithm's
        ``CanvasStaging`` for (batch_size, C), with the letterbox geometry
        (span ``tpucv.detect.fill``), and uploaded (``tpucv.detect.upload``):
        yields (canvases, hw, geom, hscale) on the device, oshapes and
        prescales. ``_staging_lock`` is held until the block exits, so read
        the staging inside it (the CPU's upload hands it on uncopied)."""
        C = self.raw_canvas
        with self._staging_lock:
            with span("tpucv.detect.fill"):
                stage = self._canvas_staging(batch_size, C)
                stage.wait()
                _, hw, oshapes, prescales = self._fill_canvases(
                    index, idxs, batch_size, C, out=stage.canvases)
                # f64 letterbox geometry on host: exact reference arithmetic
                geom, hscale = host_letterbox_geom(hw, self.input_size)
            with span("tpucv.detect.upload"):
                uploaded = stage.upload(self.device, hw, geom, hscale)
            yield (*uploaded, oshapes, prescales)

    def _detect_batches(self, model: nn.Module, index, batch_size: int,
                        infer):
        """``infer`` over ``index`` in batches of ``_staged_batch``, the
        letterbox on the device (span ``tpucv.detect.queue``), fetched
        (``tpucv.detect.download``): yields, a batch at a time, (idxs,
        ``infer``'s outputs, the letterbox's scale and pad, oshapes,
        prescales), the tensors as arrays, for the caller to map back to
        image pixels in ``tpucv.detect.unbox``."""
        n = len(index)
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            with torch.inference_mode(), self._staged_batch(
                    index, idxs, batch_size) as (
                    canvases, hw, geom, hscale, oshapes, prescales):
                with span("tpucv.detect.queue"):
                    lb, scale, pad = letterbox_images(
                        canvases, hw, self.input_size, geom=geom,
                        scale=hscale)
                    outs = infer(model, lb)
            with span("tpucv.detect.download"):
                *outs, scale, pad = (t.cpu().numpy()
                                     for t in (*outs, scale, pad))
            yield idxs, outs, scale, pad, oshapes, prescales

    @staticmethod
    def _to_image(boxes, scale, pad, oshape, prescale):
        """Letterboxed ``boxes`` in the original image's pixels (unclipped:
        the evaluation protocol never clips boxes), and the per-axis
        scales (sx, sy) from the image to the letterbox."""
        sx, sy = float(scale) * prescale[0], float(scale) * prescale[1]
        return (reverse_letter_box(boxes, (sx, sy), tuple(pad), oshape,
                                   clip=False), sx, sy)

    def _batched_detections(self, model: nn.Module, index, batch_size: int,
                            conf_threshold: float):
        """Detections over ``index`` in batches (``_detect_batches``), the
        canvases the algorithm's ``CanvasStaging``, page-locked on CUDA.
        Yields (i, boxes xyxy in original pixels, scores, classes) per
        image.

        Five spans (``utils.profile.span``) tile each batch: ``fill`` (the
        canvases and the letterbox geometry), ``upload`` (the host-to-
        device copies), ``queue`` (the host's issue of letterbox, forward,
        decode and NMS), ``download`` (the fetches, which wait for the
        device) and ``unbox`` (every image's boxes back to original
        pixels), each ``tpucv.detect.<stage>``. A batch's results are all
        made before the first is yielded, so no span covers the caller."""
        infer = self.make_infer_fn(conf_threshold=conf_threshold)
        for idxs, outs, scale_b, pad_b, oshapes, prescales in \
                self._detect_batches(model, index, batch_size, infer):
            boxes_b, scores_b, classes_b, valid_b = outs
            with span("tpucv.detect.unbox"):
                results = []
                for j, i in enumerate(idxs):
                    v = valid_b[j]
                    boxes, _, _ = self._to_image(
                        boxes_b[j][v], scale_b[j], pad_b[j], oshapes[j],
                        prescales[j])
                    results.append((i, boxes, scores_b[j][v],
                                    classes_b[j][v]))
            yield from results

    # -------- evaluate-CLI contract ---------------------------------------
    def build_eval_index(self, subset: str = "val"):
        """The dataset index the evaluate CLI reads: COCO or VOC by the
        config's dataset name, under that dataset's root
        (``TPUCV_COCO_ROOT`` / ``TPUCV_VOC_ROOT`` override it)."""
        ds = get_dataset_cfg(self.cfg.dataset.name)
        if self.cfg.dataset.name == "coco":
            from tpucv_torch.data.coco import COCOIndex
            return COCOIndex(
                os.path.join(ds["root"],
                             f"annotations/instances_{subset}2017.json"),
                os.path.join(ds["root"], f"{subset}2017"))
        from tpucv_torch.data.voc import VOCDetectionIndex
        return VOCDetectionIndex(ds["root"], subset)

    def run_eval(self, model: nn.Module, index, batch_size: int = 32,
                 plots: bool = False, **kw):
        """The dataset's evaluation over a ``build_eval_index`` result."""
        if self.cfg.dataset.name == "coco":
            if plots:
                print("--plots follows the VOC protocol (reference "
                      "mAP.py:208-300); ignored for COCO eval")
            return self.evaluate_on_coco(model, index, batch_size, **kw)
        return self.evaluate_on_voc(model, index, batch_size, plots=plots,
                                    **kw)

    # -------- evaluation harnesses ---------------------------------------
    def evaluate_on_coco(self, model: nn.Module, index, batch_size: int = 32,
                         conf_threshold: float = 0.001,
                         result_dir: str = "result",
                         verbose: bool = True) -> Dict[str, float]:
        """COCOeval's 12 stats over a ``COCOIndex``; the detections are
        written to ``result_dir/eval_results.json``. GTs are the index's
        ``eval_gt_records`` (official areas, crowd GTs as ignore
        regions)."""
        from tpucv_torch.metrics.coco_map import COCOMeanAP

        dts = []
        for i, boxes, scores, classes in self._batched_detections(
                model, index, batch_size, conf_threshold):
            img_id = index.image_id(i)
            for b, s_, c in zip(boxes, scores, classes):
                dts.append({
                    "image_id": img_id,
                    "category_id": index.contig_to_cat[int(c)],
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "score": float(s_),
                })
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, "eval_results.json"), "w") as f:
            json.dump(dts, f)
        gts = [r for i in range(len(index)) for r in index.eval_gt_records(i)]
        ev = COCOMeanAP(gts, dts, index.cat_ids).accumulate()
        stats = ev.summarize()
        if verbose:
            ev.print_summary(stats)
        return stats

    @staticmethod
    def _coco_cross_summary(gts, dts) -> Dict[str, float]:
        """COCO 0.5:0.95 summary over VOC-format records ({image_id,
        class_id, bbox xyxy[, difficult]}); difficult GTs become crowd
        (ignore) GTs."""
        from tpucv_torch.metrics.coco_map import COCOMeanAP

        cat_ids = sorted({g["class_id"] for g in gts} |
                         {d["class_id"] for d in dts})
        if not cat_ids:
            return {}
        coco_gts = []
        for g in gts:
            x1, y1, x2, y2 = g["bbox"]
            coco_gts.append({
                "image_id": g["image_id"], "category_id": g["class_id"],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": float((x2 - x1) * (y2 - y1)),
                "iscrowd": 1 if g.get("difficult", False) else 0,
            })
        coco_dts = []
        for d in dts:
            x1, y1, x2, y2 = d["bbox"]
            coco_dts.append({
                "image_id": d["image_id"], "category_id": d["class_id"],
                "bbox": [x1, y1, x2 - x1, y2 - y1], "score": d["score"],
            })
        return COCOMeanAP(coco_gts, coco_dts, cat_ids).accumulate() \
            .summarize()

    def evaluate_on_voc(self, model: nn.Module, index, batch_size: int = 32,
                        conf_threshold: float = 0.001,
                        iou_threshold: float = 0.5,
                        verbose: bool = True,
                        plots: bool = False,
                        plot_dir: str = "result/plots") -> Dict:
        """Per-class VOC AP and mAP at ``iou_threshold`` (difficult objects
        as ignore regions), with the COCO 0.5:0.95 summary of the same
        detections and GTs under ``"coco"``."""
        from tpucv_torch.metrics.voc_map import evaluate_voc_map, print_voc_map

        dts, gts = [], []
        for i, boxes, scores, classes in self._batched_detections(
                model, index, batch_size, conf_threshold):
            for b, s_, c in zip(boxes, scores, classes):
                dts.append({"image_id": i, "class_id": int(c),
                            "bbox": b.tolist(), "score": float(s_)})
        eval_record = getattr(index, "eval_record", None)
        for i in range(len(index)):
            if eval_record is not None:
                boxes, labels, difficult = eval_record(i)
            else:
                _, boxes, labels = index[i]
                difficult = np.zeros(len(boxes), bool)
            for b, l, dif in zip(boxes, labels, difficult):
                gts.append({"image_id": i, "class_id": int(l),
                            "bbox": np.asarray(b).tolist(),
                            "difficult": bool(dif)})
        res = evaluate_voc_map(gts, dts, self.class_names, iou_threshold)
        res["coco"] = self._coco_cross_summary(gts, dts)
        if verbose:
            print_voc_map(res)
            print("COCO-protocol cross-summary (same detections/GTs):")
            for k in ("AP", "AP50", "AP75"):
                if k in res["coco"]:
                    print(f"  {k}: {res['coco'][k]:.4f}")
        if plots:
            from tpucv_torch.metrics.voc_map import save_plots
            save_plots(res, plot_dir)
            print(f"AP/PR plots written to {plot_dir}/")
        return res
