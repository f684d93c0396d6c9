#!/usr/bin/env python3
"""Drive tpucv_torch's paths once on one NVIDIA GPU: the yolo8_det serving
path, the bench entry point's inference program, the four measurement
probes and the YOLOv8 training step.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. card     the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    builds every CUDA source of the port (one nvcc each, in
            parallel) and prints the build time and ptxas report.
3. kernel   the NMS kernels against their plain PyTorch versions on the
            cases of tpucv_torch/ops/nms_cases.py: those of
            tests/test_pallas_nms.py, the 60/120-deep chains, the 32-box
            block edges and class-offset sets at B=128, K=512/1024, IoU
            0.5/0.7: keep masks must be identical, the build's mask words
            (overlap_words) bit-equal to overlap_words_reference, and the
            walk alone over them must give the same keep mask.
4. serve    YOLOv8n, nc=80, 640 input, bf16 autocast, random weights from
            torch.Generator seed 0 with the class biases zeroed and the
            class kernels scaled by CLS_GAIN. First the f32 forward on the
            card is held against the CPU's. Then a server (make_server,
            batch 8) answers 16 concurrent raw-RGB requests; launch counts
            are zeroed just before the requests and read just after. The
            served images' NMS candidates, through the kernels and through
            their plain versions, must give identical keep masks and mask
            words, and the plain route the server's detections (count and
            classes). A batch of 8 is then timed stage by stage.
5. bench    the bench.py:main program as tpucv_torch.bench runs it: B=128
            uint8 480x640, letterbox_static, forward, decode_boxes
            (pre_nms_topk=512), timed with CUDA events, device-resident and
            with the H2D copy; the kernels' and the plain version's times
            at the main path's shapes, the build and the walk timed apart,
            and the least time the card could take.
6. probe_bw python -m tpucv_torch.probes.probe_bw's main at full size
            (add_one's count zeroed just before, read just after); then
            add_one on the 1,638,400x128 bf16 array in its six views, bit
            for bit against x + 1, timed against it and its bound, with
            the launch (threads, CTAs, index width) the library reports.
7. probe_conv  the main of probe_conv, probe_conv_parts and probe_conv_v2
            at full size (conv3x3's count zeroed before each, read after);
            then conv3x3 at the six shapes in both modes, and the five
            timing-only variants at 64ch 320^2 B32, each against its plain
            definition (no element further than 2^-7 of its largest
            value) and the full conv against F.conv2d (relerr <= 2e-2),
            timed against the plain version, F.conv2d and the bound.
8. train_parity  the port's train step on the card against the same step
            on the CPU (YOLOv8n, B=2, 128², M=4, f32, TF32 off, a GT over
            the lowest-index anchors): TAL fg mask and GT rows bit-equal,
            loss and components within 1e-4 relative, BatchNorm statistics
            and parameters after one step within the CPU tests' bounds.
9. train    the train step at full width as tpucv_torch.bench runs it
            (YOLOv8n, B=128, 640², M=32, bf16 autocast, channels_last,
            Adam 1e-3, EMA 0.9999): 3 warm-up and 10 timed steps (CUDA
            events), img/s, the last loss and num_fg (finite), peak
            memory, one step split into forward / loss / backward /
            optimizer + EMA (median of 5, a sync after each stage), and
            the compute bound (3 x the forward's convolution FLOPs over
            the dense bf16 rate) as a share of the step (mfu).

The line before the last holds {"kernels": [...]} (nms_keep, add_one,
conv3x3); the last line is
{"ok": true, "device": {...}}. The whole output is also written to
chiprun_out/chip_smoke.log. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # non-tensor f32, H100 SXM data sheet
IOU_OPS = 14       # min, max, sub, clamp per axis (8), mul, add, sub, add,
AREA_OPS = 5       # div, compare; area: two sub, two clamp, one mul
CLS_GAIN = 3000.0  # the init's class logits are ~1e-4: scores would all
                   # round to 0.5 in bf16; scaled up they spread


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


class Tee:
    """Standard output, copied line for line into a log file."""

    def __init__(self, stream, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.stream, self.log = stream, open(path, "w")

    def write(self, text):
        self.log.write(text)
        return self.stream.write(text)

    def flush(self):
        self.log.flush()
        self.stream.flush()


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases --

class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.mismatches = 0
        self.word_mismatches = 0
        self.max_abs_err = 0.0
        self.shapes = []          # kernel timings at the main path's shapes

    def sync(self):
        self.torch.cuda.synchronize()

    def compare_keep(self, sb, ss, thr, tag):
        """Kernels vs plain keep mask on the same CUDA tensors; the build's
        words bit for bit against their plain twin, and the walk alone over
        them."""
        from tpucv_torch.ops.cuda_nms import (nms_keep, nms_keep_reference,
                                              overlap_words,
                                              overlap_words_reference,
                                              walk_words)

        torch = self.torch
        keep = nms_keep(sb, ss, thr)
        self.sync()
        ref = nms_keep_reference(sb, ss, thr)
        words = overlap_words(sb, thr)
        self.sync()
        bad_words = int((words != overlap_words_reference(sb, thr)).sum())
        self.word_mismatches += bad_words
        check(bad_words == 0, f"{tag}: the build's mask and its plain twin "
                              f"differ in {bad_words} words")
        walked = walk_words(words, ss)
        self.sync()
        check(torch.equal(walked, ref), f"{tag}: the walk alone differs from "
                                        f"the plain keep mask")
        bad = int((keep != ref).sum())
        err = float((keep.float() - ref.float()).abs().max()) \
            if keep.numel() else 0.0
        self.mismatches += bad
        self.max_abs_err = max(self.max_abs_err, err)
        check(bad == 0, f"{tag}: kernel and plain keep masks differ in "
                        f"{bad} places")
        return keep

    def phase_kernel(self):
        from tpucv_torch.ops.nms_cases import chain_keep, kernel_cases

        torch = self.torch
        rows = {}
        for name, ((boxes, scores), thr) in kernel_cases().items():
            order = np.argsort(-scores, axis=-1, kind="stable")
            sb = torch.from_numpy(np.take_along_axis(
                boxes, order[..., None], 1)).to(self.dev)
            ss = torch.from_numpy(np.take_along_axis(scores, order, 1)) \
                .to(self.dev)
            keep = self.compare_keep(sb, ss, thr, name)
            if name.startswith("chain"):
                got = torch.nonzero(keep[0]).flatten().tolist()
                check(got == chain_keep(name),
                      f"{name}: greedy keeps every second box, got {got}")
            rows[name] = int(keep.sum())
        emit({"phase": "kernel", "cases": len(rows), "kept": rows,
              "mismatches": self.mismatches,
              "word_mismatches": self.word_mismatches,
              "max_abs_err": self.max_abs_err})

    def serving_setup(self):
        from tpucv_torch.builder import export_from_registry

        torch = self.torch
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        check(cfg.arch.model_type == "n" and cfg.dataset.input_size == 640
              and cfg.num_classes == 80 and cfg.train.mixed_precision,
              "yolo8_det config is not YOLOv8n/640/nc80/bf16")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables(seed=0)
        with torch.no_grad():
            for head in model.model[22].cv3:
                head[-1].bias.zero_()
                head[-1].weight.mul_(CLS_GAIN)
        return algo, model

    def phase_forward_f32(self, model):
        """The f32 forward on the card (TF32 off) against the same weights
        on the CPU, on a small input."""
        import copy

        torch = self.torch
        x = torch.from_numpy(np.random.default_rng(3).random(
            (2, 128, 128, 3), dtype=np.float32))
        with torch.inference_mode():
            gpu = model(x.to(self.dev))
            cpu = copy.deepcopy(model).cpu().to(
                memory_format=torch.contiguous_format)(x)
        rel = max(float((g.float().cpu() - c).abs().max() / c.abs().max())
                  for g, c in zip(gpu, cpu))
        check(all(torch.isfinite(g).all() for g in gpu), "non-finite maps")
        check(rel < 1e-3, f"f32 forward on the card differs from the CPU by "
                          f"{rel} of the largest value")
        emit({"phase": "forward_f32", "shapes": [list(g.shape) for g in gpu],
              "max_rel_err_vs_cpu": rel})

    def _images(self, n):
        rng = np.random.default_rng(0)
        sizes = [(480, 640), (427, 640), (300, 500)]
        imgs = []
        for k in range(n):
            h, w = sizes[k % len(sizes)]
            yy, xx = np.mgrid[0:h, 0:w]
            base = np.stack([xx * 255 // w, yy * 255 // h,
                             (xx + yy) * 255 // (h + w)], -1)
            noise = rng.integers(-40, 41, (h, w, 3))
            imgs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        return imgs

    def phase_serve(self, algo, model):
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.serving import make_server

        imgs = self._images(16)
        t0 = time.perf_counter()
        server = make_server(algo, model, host="127.0.0.1", port=0,
                             batch_size=8, model_name="yolo8_det")
        warm_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        results = [None] * len(imgs)
        try:
            port = server.server_address[1]

            def post(k):
                h, w = imgs[k].shape[:2]
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict",
                    data=imgs[k].tobytes(),
                    headers={"Content-Type": "application/x-raw-rgb",
                             "X-Height": str(h), "X-Width": str(w)})
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        results[k] = (r.status, json.loads(r.read()))
                except Exception as e:  # noqa: BLE001 - reported below
                    results[k] = (getattr(e, "code", -1), str(e))

            posters = [threading.Thread(target=post, args=(k,))
                       for k in range(len(imgs))]
            nms_keep.launches = 0            # just before the main path
            t0 = time.perf_counter()
            for p in posters:
                p.start()
            for p in posters:
                p.join(timeout=600)
            wall = time.perf_counter() - t0
            launches = nms_keep.launches     # just after
            check(not any(p.is_alive() for p in posters), "requests hung")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                        timeout=60) as r:
                stats = json.loads(r.read())
        finally:
            server.shutdown()
            server.batcher.stop()
            server.server_close()
            thread.join(timeout=30)
        statuses = [r[0] for r in results]
        check(all(s == 200 for s in statuses), f"statuses {statuses}: "
              f"{[r[1] for r in results if r[0] != 200][:2]}")
        n_dets = [len(r[1]["detections"]) for r in results]
        check(max(n_dets) > 0, "no request got a detection")
        check(launches > 0, "the NMS kernel was not launched while serving")
        emit({"phase": "serve", "requests": len(imgs), "statuses_ok": True,
              "detections": n_dets, "nms_launches": launches,
              "warmup_s": warm_s, "wall_s": wall, "stats": stats})
        return imgs, results, launches

    def phase_serve_vs_plain(self, algo, model, imgs, results):
        """The served images' NMS candidates, again through the kernel and
        through its plain version: identical keep masks, and the plain
        route's detections (count and classes per image) equal the
        server's."""
        from tpucv_torch.algorithms.yolov8 import yolo_decode_args
        from tpucv_torch.decode.yolov8 import topk_candidates
        from tpucv_torch.ops.cuda_nms import nms_keep_reference, select_kept
        from tpucv_torch.ops.preprocess import (host_letterbox_geom,
                                                letterbox_images,
                                                normalize_images)

        torch = self.torch
        kw = yolo_decode_args(algo.cfg, algo.nc, None)
        thr, conf = kw["iou_threshold"], kw["conf_threshold"]
        index = [(im,) for im in imgs]
        valid_cands, kept = [], []
        capture = None
        for start in range(0, len(imgs), 8):
            idxs = list(range(start, start + 8))
            canv, hw, _, _ = algo._fill_canvases(index, idxs, 8,
                                                 algo.raw_canvas)
            geom, hs = host_letterbox_geom(hw, algo.input_size)
            with torch.inference_mode():
                lb, _, _ = letterbox_images(
                    torch.from_numpy(canv).to(self.dev),
                    torch.from_numpy(hw).to(self.dev), algo.input_size,
                    geom=torch.from_numpy(geom).to(self.dev),
                    scale=torch.from_numpy(hs).to(self.dev))
                x = normalize_images(lb, algo.dtype)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    raw = model(x)
                boxes, scores, cls = topk_candidates(
                    raw, kw["reg_max"], kw["strides"], conf,
                    kw["pre_nms_topk"])
                off = (boxes + cls[..., None].float() * 7680.0).contiguous()
                self.compare_keep(off, scores, thr,
                                  f"served batch {start // 8}")
                idx, valid = select_kept(nms_keep_reference(off, scores, thr),
                                         scores, None, kw["max_det"])
                idx = idx.long()
                valid = valid & (torch.gather(scores, 1, idx) > conf)
                plain_cls = torch.gather(cls, 1, idx)
            for j, i in enumerate(idxs):
                served = sorted(d["class_id"]
                                for d in results[i][1]["detections"])
                plain = sorted(plain_cls[j][valid[j]].tolist())
                check(served == plain, f"image {i}: served classes {served} "
                                       f"!= plain NMS classes {plain}")
            if capture is None:
                capture = (off, scores)
            valid_cands += (scores > 0).sum(1).tolist()
            kept += valid.sum(1).tolist()
        check(all(v > 0 for v in valid_cands), "no valid candidates")
        check(any(k < v for k, v in zip(kept, valid_cands)),
              "NMS suppressed nothing")
        emit({"phase": "serve_vs_plain", "K": kw["pre_nms_topk"],
              "valid_candidates": valid_cands, "kept": kept,
              "identical": True})
        return capture, thr

    def phase_breakdown(self, algo, model, imgs, reps=5):
        """Where a served batch of 8 spends its time, on the host clock with
        a device sync after each stage (median of ``reps``), beside one
        whole ``_batched_detections`` batch without HTTP."""
        from tpucv_torch.algorithms.yolov8 import yolo_decode_args
        from tpucv_torch.decode.yolov8 import decode_boxes
        from tpucv_torch.ops.preprocess import (host_letterbox_geom,
                                                letterbox_images,
                                                normalize_images)

        torch = self.torch
        kw = yolo_decode_args(algo.cfg, algo.nc, None)
        index = [(im,) for im in imgs[:8]]
        stages = {}

        def lap(name, t0):
            self.sync()
            t1 = time.perf_counter()
            stages.setdefault(name, []).append((t1 - t0) * 1e3)
            return t1

        for _ in range(reps):
            with torch.inference_mode():
                t = time.perf_counter()
                canv, hw, _, _ = algo._fill_canvases(index, range(8), 8,
                                                     algo.raw_canvas)
                geom, hs = host_letterbox_geom(hw, algo.input_size)
                t = lap("fill_canvases", t)
                dev = [torch.from_numpy(a).to(self.dev)
                       for a in (canv, hw, geom, hs)]
                t = lap("h2d", t)
                lb, _, _ = letterbox_images(dev[0], dev[1], algo.input_size,
                                            geom=dev[2], scale=dev[3])
                t = lap("letterbox", t)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    raw = model(normalize_images(lb, algo.dtype))
                t = lap("normalize_forward", t)
                out = decode_boxes(raw, **kw)
                t = lap("decode_nms", t)
                [o.cpu().numpy() for o in out]
                lap("d2h", t)
                t = time.perf_counter()
            list(algo._batched_detections(model, index, 8, 0.25))
            lap("direct_batch_total", t)
        med = {k: float(np.median(v)) for k, v in stages.items()}
        emit({"phase": "breakdown", "batch": 8, "reps": reps, "median_ms": med,
              "runs_ms": stages})

    def phase_bench(self, model):
        """The bench entry point's inference program
        (``tpucv_torch.bench.bench_inference``) on the served model; then
        the forward of its first batch again, for the NMS's candidate
        sets at K=512 and 1024."""
        from tpucv_torch import bench
        from tpucv_torch.decode.yolov8 import topk_candidates
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        shapes = bench.FULL
        nms_keep.launches = 0
        res = bench.bench_inference(model, self.dev, shapes)
        nms_launches = nms_keep.launches
        calls = 3 + (1 + shapes.infer_iters) + (1 + shapes.h2d_iters)
        check(nms_launches == calls, "bench skipped NMS")
        out = res.pop("outputs")
        check(all(torch.isfinite(o.float()).all() for o in out),
              "non-finite bench output")
        fwd, _ = bench.inference_program(model, shapes.size, amp=True)
        with torch.inference_mode():
            raw = fwd(bench.raw_batches(shapes, 1)[0].to(self.dev))
            c512 = topk_candidates(raw, pre_nms_topk=512,
                                   conf_threshold=0.25)
            c1024 = topk_candidates(raw, pre_nms_topk=1024,
                                    conf_threshold=0.25)
        emit({"phase": "bench", "batch": shapes.batch,
              "iters": shapes.infer_iters, "nms_launches": nms_launches,
              **res,
              "detections_mean": float(out[3].sum(1).float().mean())})
        offs = [((c[0] + c[2][..., None].float() * 7680.0).contiguous(),
                 c[1]) for c in (c512, c1024)]
        return offs, 0.7

    def phase_train_parity(self):
        """The port's train step on the card against the same step on the
        CPU: YOLOv8n (nc=80) from torch.Generator seed 0, B=2, 128², M=4,
        f32 with TF32 off. GT row 0 is a strip 5 px tall along the top:
        every anchor inside it has CIoU <= 0 with the init's large
        predictions, so its top-10 are zero-metric ties, and lowest-index
        order selects anchors 0-9 (``torch.topk``'s order would not). The
        TAL assignment (fg mask and GT rows) of the first forward must be
        bit-equal, the step's loss and components within 1e-4 relative,
        and after it the BatchNorm statistics within 1e-5 and the
        parameters as the CPU tests bound them: within 2.1 * lr, all but
        0.1% of elements within 1e-5."""
        import copy

        from tpucv_torch import bench
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.losses.yolov8 import yolov8_loss
        from tpucv_torch.train.state import (TrainState, forward,
                                             make_train_step)

        torch = self.torch
        cpu = torch.device("cpu")
        B, S, M, lr = 2, 128, 4, 1e-3
        model = bench.yolo8n(cpu)
        batch = bench.synthetic_batch(B, S, M, cpu, S * 0.9, torch.float32,
                                      seed=1)
        xy = batch["gt_bboxes"][..., :2]
        batch["gt_bboxes"][..., 2:] = xy + (batch["gt_bboxes"][..., 2:] -
                                            xy).abs() + 4.0
        batch["gt_bboxes"][:, 0] = torch.tensor([0.0, 0.0, float(S), 5.0])
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        loss_fn = algo_cls(cfg, device=cpu).build_loss()
        runs = []
        for dev in (cpu, self.dev):
            m = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                raw = forward(copy.deepcopy(m).train(), b["images"], False)
                _, _, aux = yolov8_loss(raw, b["gt_labels"], b["gt_bboxes"],
                                        b["gt_mask"], return_aux=True)
            state = TrainState.create(m, lr, use_ema=True)
            step = make_train_step(loss_fn, device=dev, ema_decay=0.9999,
                                   mixed_precision=False)
            state, sm = step(state, b)
            runs.append({
                "fg": aux["fg"].cpu(), "gt_idx": aux["gt_idx"].cpu(),
                "step": {k: float(v) for k, v in sm.items()},
                "sd": {k: v.detach().cpu().double() for k, v in
                       state.model.state_dict().items()}})
        c, g = runs
        check(torch.equal(c["fg"], g["fg"]), "TAL fg masks differ between "
                                             "the card and the CPU")
        check(torch.equal(c["gt_idx"], g["gt_idx"]),
              "TAL GT rows differ between the card and the CPU")
        check(bool(c["fg"][:, :10].all()),
              "the top strip's zero-metric ties were not anchors 0-9")
        rel = {}
        for k, v in c["step"].items():
            rel[k] = abs(g["step"][k] - v) / max(abs(v), 1e-12)
            check(rel[k] <= 1e-4, f"{k}: card {g['step'][k]} against CPU {v}")
        bn = max(float((g["sd"][k] - c["sd"][k]).abs().max())
                 for k in c["sd"] if "running" in k)
        check(bn <= 1e-5, f"BatchNorm statistics differ by {bn}")
        diffs = torch.cat([(g["sd"][k] - c["sd"][k]).abs().flatten()
                           for k in c["sd"] if "running" not in k
                           and "num_batches" not in k])
        pmax, frac = float(diffs.max()), float((diffs > 1e-5).double().mean())
        check(pmax <= 2.1 * lr and frac <= 1e-3,
              f"parameters differ by up to {pmax}, {frac} of them > 1e-5")
        emit({"phase": "train_parity", "B": B, "S": S, "M": M,
              "fg": int(c["fg"].sum()), "fg_bit_equal": True,
              "gt_idx_bit_equal": True,
              "tie_selected": "anchors 0-9 of each image",
              "loss_cpu": c["step"]["loss"], "loss_card": g["step"]["loss"],
              "max_rel_err": max(rel.values()), "rel_err": rel,
              "bn_max_abs_err": bn, "param_max_abs_err": pmax,
              "param_frac_over_1e-5": frac})

    def phase_train(self):
        """The bench entry point's train step at full width
        (``tpucv_torch.bench.bench_train``): YOLOv8n, B=128, 640², M=32,
        bf16 autocast, channels_last, Adam 1e-3, EMA 0.9999; 3 warm-up
        and 10 timed steps, then one step split into its stages."""
        import dataclasses

        from tpucv_torch import bench

        shapes = dataclasses.replace(bench.FULL, train_iters=10)
        res = bench.bench_train(self.dev, shapes)
        emit({"phase": "train", "batch": shapes.train_batch,
              "size": shapes.size, "max_boxes": shapes.max_boxes,
              "warmup": shapes.train_warmup, "iters": shapes.train_iters,
              **res, "nvidia_smi": nvidia_smi()})
        return res

    def bound(self, sb, ss, keep, thr):
        """Least time for the greedy keep mask on these inputs: bytes (boxes
        and scores read once, the mask written once) over HBM bandwidth,
        and the f32 operations this data needs over the f32 peak: each
        valid box is tested against the kept boxes above it, up to the
        first one that suppresses it."""
        torch = self.torch
        B, K = ss.shape
        nbytes = B * K * (16 + 4 + 1)
        x1, y1, x2, y2 = sb.unbind(-1)
        area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        ix = (torch.minimum(x2[:, :, None], x2[:, None]) -
              torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
        iy = (torch.minimum(y2[:, :, None], y2[:, None]) -
              torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
        inter = ix * iy
        iou = inter / (area[:, :, None] + area[:, None] - inter + 1e-7)
        lower = torch.ones(K, K, dtype=torch.bool, device=sb.device).tril(-1)
        cand = lower & keep[:, None, :]               # kept j above i
        tested = cand.cumsum(-1)
        hit = cand & (iou > thr)
        first = hit.float().argmax(-1, keepdim=True)
        n_tests = torch.where(hit.any(-1), tested.gather(-1, first)[..., 0],
                              tested[..., -1])
        valid = ss > 0
        pairs = int((n_tests * valid).sum())
        ops = pairs * IOU_OPS + int(valid.sum()) * AREA_OPS
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_FLOPS * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations", pairs)

    def time_kernel(self, sb, ss, thr, tag):
        from tpucv_torch.ops.cuda_nms import (nms_keep, nms_keep_reference,
                                              library_plan, timing_launchers)
        from tpucv_torch.probes.common import timed_queued

        torch = self.torch

        def timed(fn, iters):
            return timed_queued(fn, iters, self.dev)

        keep = self.compare_keep(sb, ss, thr, tag)
        build, walk = timing_launchers(sb, ss, thr)
        build()
        check(torch.equal(walk(), keep), f"{tag}: the split launches differ")
        # in turns, on one card: plain, kernel, build, walk, and back
        p1 = timed(lambda: nms_keep_reference(sb, ss, thr), 3)
        k1 = timed(lambda: nms_keep(sb, ss, thr), 50)
        b1 = timed(build, 50)
        w1 = timed(walk, 50)
        w2 = timed(walk, 50)
        b2 = timed(build, 50)
        k2 = timed(lambda: nms_keep(sb, ss, thr), 50)
        p2 = timed(lambda: nms_keep_reference(sb, ss, thr), 3)
        bound_ms, bound_by, pairs = self.bound(sb, ss, keep, thr)
        B, K = ss.shape
        plan = library_plan(B, K)        # what the built library launches
        row = {"tag": tag, "B": B, "K": K, "ms": min(k1, k2),
               "ms_runs": [k1, k2], "build_ms": min(b1, b2),
               "build_ms_runs": [b1, b2], "walk_ms": min(w1, w2),
               "walk_ms_runs": [w1, w2], "plain_ms": min(p1, p2),
               "plain_ms_runs": [p1, p2], "bound_ms": bound_ms,
               "bound_by": bound_by, "iou_pairs_needed": pairs,
               "build_ctas": plan.build_grid[0] * plan.build_grid[1],
               "walk_ctas": plan.walk_ctas,
               "scratch_bytes": plan.scratch_bytes,
               "valid": int((ss > 0).sum()), "kept": int(keep.sum())}
        self.shapes.append(row)
        emit({"phase": "kernel_time", **row})
        return row


def in_turns(plain, kernel, dev, n_plain, n_kernel):
    """Plain, kernel, kernel, plain on one card; the lower of each pair."""
    from tpucv_torch.probes.common import timed

    p1 = timed(plain, n_plain, dev)
    k1 = timed(kernel, n_kernel, dev)
    k2 = timed(kernel, n_kernel, dev)
    p2 = timed(plain, n_plain, dev)
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2]}


def phase_probe_bw(torch) -> dict:
    """probe_bw's main path, then add_one bit for bit against x + 1 in the
    six views of the probe's array, timed against it and its bound."""
    from tpucv_torch.ops.stream import (add_one, add_one_reference,
                                        library_plan)
    from tpucv_torch.probes import probe_bw
    from tpucv_torch.probes.common import stream_bound_ms, timed

    dev = torch.device("cuda")
    add_one.launches = 0                 # just before the main path
    probe_rows = probe_bw.main([])
    launches = add_one.launches          # just after
    check(launches > 0, "probe_bw did not launch add_one")
    emit({"phase": "probe_bw_main", "add_one_launches": launches,
          "rows": probe_rows})

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((probe_bw.TOT, 128), generator=g, device=dev) \
        .to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()
    bound_ms = stream_bound_ms(nbytes)
    rows = []
    for r, c, bh in probe_bw.views(probe_bw.TOT):
        xx = x.view(r, c)
        bad = probe_bw.mismatches(xx)
        check(bad == 0, f"add_one ({r}x{c}): {bad} elements differ from x + 1")
        row = {"view": [r, c], "tpu_bh": bh, "mismatches": bad,
               **in_turns(lambda: add_one_reference(xx), lambda: add_one(xx),
                          dev, 50, 50),
               "library_ms": timed(lambda: torch.add(xx, 1), 50, dev),
               "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}
        row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        row["library_gb_per_s"] = nbytes / (row["library_ms"] * 1e-3) / 1e9
        rows.append(row)
    plan = library_plan(x.numel())       # what the built library launches
    chosen = {"threads": plan.threads, "ctas": plan.grid,
              "index_bits": plan.index_bits}
    emit({"phase": "probe_bw", **chosen, "views": rows})
    main_row = rows[0]
    return {"name": "add_one", "route": "cuda",
            "source": "tpucv_torch/csrc/stream.cu",
            "replaces": "scripts/probe_pallas_bw.py:86 ident_kernel "
                        "(pallas_call :94)",
            "launches": launches, "mismatches": 0, "max_abs_err": 0.0,
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            "gb_per_s": main_row["gb_per_s"], **chosen, "shapes": rows}


# the five timing-only decompositions: (the script's name, variant), halo
# mode, the scripts' bhp=1280 (8 rows at 64ch 320^2)
TIMING_VARIANTS = [("parts nohalo", "nohalo"), ("parts noshift", "noshift"),
                   ("parts gemm1", "gemm1"), ("v2 fullnomask", "nomask"),
                   ("v2 slab2nomask", "nomask")]


def phase_probe_conv(torch) -> dict:
    """The three conv probes' main paths, then conv3x3 against its plain
    definitions at the probes' shapes, timed against them, F.conv2d and
    the bound."""
    from tpucv_torch.ops.conv3x3 import (MODES, _ctas_on_card, conv3x3,
                                         conv3x3_reference, plan)
    from tpucv_torch.probes import probe_conv, probe_conv_parts, probe_conv_v2
    from tpucv_torch.probes.common import (compare, conv_bound, conv_inputs,
                                           library_conv, tile_rows_of, timed)

    dev = torch.device("cuda")
    launches = {}
    for mod in (probe_conv, probe_conv_parts, probe_conv_v2):
        name = mod.__name__.rsplit(".", 1)[-1]
        conv3x3.launches = 0             # just before the main path
        probe_rows = mod.main([])
        launches[name] = conv3x3.launches    # just after
        check(launches[name] > 0, f"{name} did not launch conv3x3")
        emit({"phase": f"{name}_main", "conv3x3_launches": launches[name],
              "rows": probe_rows})

    rows = []

    def check_and_time(tag, x, w, plain, mode, variant, tile, lib=None):
        got = conv3x3(x, w, mode=mode, variant=variant, tile_rows=tile)
        bad, err, scale = compare(got, plain)
        check(bad == 0, f"conv3x3 {tag} {mode} {variant}: {bad} elements "
                        f"off the plain version (max {err} at max {scale})")
        B, S, _, C = x.shape
        bound_ms, bound_by = conv_bound(B, S, C)
        p = plan(S, C)
        row = {"tag": tag, "B": B, "S": S, "C": C, "mode": mode,
               "variant": variant, "tile_rows": tile, "mismatches": bad,
               "max_abs_err": err, "max_abs_plain": scale,
               "smem_bytes": p.smem_bytes, "ring_rows": p.ring_rows,
               "col_tile": p.col_tile, "warps": p.warps,
               "products": "wgmma" if p.wgmma else "mma.sync",
               "ctas_per_sm": _ctas_on_card(C, dev.index or 0)[1],
               "bound_ms": bound_ms,
               "bound_by": bound_by,
               **in_turns(lambda: conv3x3_reference(x, w, variant, tile),
                          lambda: conv3x3(x, w, mode=mode, variant=variant,
                                          tile_rows=tile), dev, 2, 20)}
        if lib is not None:
            _, lerr, lscale = compare(got, lib)
            row["relerr_vs_library"] = lerr / lscale
            check(lerr / lscale <= probe_conv.LIBRARY_RELERR,
                  f"conv3x3 {tag} {mode}: relerr {lerr / lscale} against "
                  f"F.conv2d")
            row["library_ms"] = timed(lambda: library_conv(x, w), 20, dev)
        rows.append(row)
        emit({"phase": "probe_conv", **row})
        return row

    for tag, B, S, C, bhp in probe_conv.SHAPES:
        x, w = conv_inputs(B, S, C, dev, seed=1)
        plain, lib = conv3x3_reference(x, w), library_conv(x, w)
        for mode in MODES:
            tile = tile_rows_of(bhp, C, S) if mode == "halo" else None
            row = check_and_time(tag, x, w, plain, mode, "full", tile, lib)
        del plain, lib
    main_row = row                       # probe 64ch 320^2 B32, rolling
    B, S, C = probe_conv_parts.B, probe_conv_parts.S, probe_conv_parts.C
    x, w = conv_inputs(B, S, C, dev, seed=1)
    tile = tile_rows_of(1280, C, S)
    for tag, variant in TIMING_VARIANTS:
        check_and_time(tag, x, w, conv3x3_reference(x, w, variant, tile),
                       "halo", variant, tile)
    return {"name": "conv3x3", "route": "cuda",
            "source": "tpucv_torch/csrc/conv3x3.cu",
            "replaces": "scripts/probe_pallas_conv_parts.py:54 "
                        "make(BHP, mode).kernel (pallas_call :96); "
                        "scripts/probe_pallas_conv_v2.py:69 "
                        "make_roll(BHP).kernel (pallas_call :108) and :134 "
                        "make(BHP, mode).kernel (pallas_call :203); "
                        "scripts/probe_pallas_conv.py:81 "
                        "build_packed_conv(B, S, C, BHP).kernel "
                        "(pallas_call :122)",
            "launches": sum(launches.values()), "launches_by_probe": launches,
            "mismatches": sum(r["mismatches"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "main_shape":
                f"{main_row['tag']} {main_row['mode']}", "shapes": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # the port: absent when this file is copied out of the repository
    from tpucv_torch import _build

    # the whole output, beside the end that a caller may keep
    sys.stdout = Tee(sys.stdout,
                     Path(__file__).resolve().parent / "chiprun_out" /
                     "chip_smoke.log")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = _build.build(["nms", "stream", "conv3x3"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": [_build.lib_path(k).name for k in logs],
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "ptxas info" in ln or "spill" in ln]})

    smoke = Smoke(torch)
    smoke.phase_kernel()
    algo, model = smoke.serving_setup()
    smoke.phase_forward_f32(model)
    imgs, results, launches = smoke.phase_serve(algo, model)
    (serve_off, serve_scores), thr = smoke.phase_serve_vs_plain(
        algo, model, imgs, results)
    smoke.phase_breakdown(algo, model, imgs)
    bench_offs, bench_thr = smoke.phase_bench(model)

    main_row = smoke.time_kernel(serve_off, serve_scores, thr,
                                 "serve_B8_K1024")
    smoke.time_kernel(*bench_offs[0], bench_thr, "bench_B128_K512")
    smoke.time_kernel(*bench_offs[1], bench_thr, "bench_B128_K1024")

    bw = phase_probe_bw(torch)
    conv = phase_probe_conv(torch)
    smoke.phase_train_parity()
    smoke.phase_train()

    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "nms_keep", "route": "cuda",
        "source": "tpucv_torch/csrc/nms.cu",
        "replaces": "tpucv/ops/pallas_nms.py:28 _nms_kernel",
        "launches": launches, "mismatches": smoke.mismatches,
        "word_mismatches": smoke.word_mismatches,
        "max_abs_err": smoke.max_abs_err,
        "ms": main_row["ms"], "build_ms": main_row["build_ms"],
        "walk_ms": main_row["walk_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "shapes": smoke.shapes}, bw, conv]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
