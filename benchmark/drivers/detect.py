"""Batched detection: ``DetectionAlgorithm._batched_detections`` called back
to back, one call a batch of raw RGB uint8 images held in host memory, as
the program's evaluate and serving loops call it. A call ends when every
image's detections (boxes in original pixels, scores, classes) are numpy
arrays on the host.

End to end: ``detect_img_s``, the images of every call that finished in
the window over the window's seconds, and ``setup_s``. Traced
(``--trace 1``): a window of ``trace_batches`` calls under the profiler,
with the benchmark's probes around the program's layers (the host canvas
fill, the network's forward, each NMS call); the per-layer readers in
``benchmark/metrics`` take their numbers from it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import common, judge, reference, traffic, weights
from benchmark.reference import detect as ref_detect
from benchmark.reference.nn import fp32
from benchmark.trace import Profiled


class Cell:
    """The program's algorithm and model with the seed's weights, the
    image pool and its batch order."""

    def __init__(self, cell: dict, cfg: dict, seed: int, dev: torch.device,
                 small: bool, variant: Optional[str] = None):
        from tpucv_torch.builder import export_from_registry

        self.cell, self.cfg, self.seed, self.dev = cell, cfg, seed, dev
        sizes = dict(cell["sizes"], **(cell["small"] if small else {}))
        self.B = sizes["batch"]
        self.sizes = sizes
        pcfg, algo_cls, _ = export_from_registry(cfg["registry"])
        common.apply_overrides(pcfg, cfg["overrides"])
        pcfg.dataset.input_size = sizes["input_size"]
        self.algo = algo_cls(pcfg, device=dev)
        with torch.device("meta"):
            shapes = weights.shapes_of(reference.build(cfg))
        self.state = weights.make(shapes, seed, cfg["weights"]["detect"], dev)
        weights.normalize_outputs(cfg, self.state, seed, dev,
                                  sizes["input_size"],
                                  cfg["weights"]["detect_logit_std"])
        with torch.device(dev):
            model = self.algo.build_model()
        model.load_state_dict(self.state)
        model = model.eval()
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.pool = traffic.detect_pool(cell["shapes"], sizes["per_shape"],
                                        seed, dev,
                                        sizes.get("shape_divisor", 1))
        if variant == "int8":
            model = self.algo.quantize_variables(
                model, [(im,) for im in self.pool], n_images=32, batch_size=8)
        self.model = model
        self.order = traffic.batch_order(len(self.pool), self.B, seed)

    def call(self, idxs: List[int]) -> List[tuple]:
        index = [(self.pool[i],) for i in idxs]
        return [(b, s, c) for _, b, s, c in self.algo._batched_detections(
            self.model, index, self.B, None)]


class Probes:
    """The traced window's probes: a host-clock wrapper around the canvas
    fill, CUDA events from forward pre- and post-hooks on the network, and
    CUDA events around each call into ``dispatch_batched_nms`` (whose
    inputs are kept for the NMS's least time)."""

    def __init__(self, cell: Cell):
        import tpucv_torch.decode.yolov8 as dec8
        import tpucv_torch.ops.nms as ops_nms

        self.fill_s, self.fills = 0.0, 0
        self.forward: List[tuple] = []
        self.nms: List[tuple] = []
        self.nms_inputs: List[tuple] = []
        algo, cuda = cell.algo, cell.dev.type == "cuda"
        fill = algo._fill_canvases

        def timed_fill(*a, **k):
            with torch.profiler.record_function("bench.fill"):
                t0 = time.perf_counter()
                out = fill(*a, **k)
                self.fill_s += time.perf_counter() - t0
                self.fills += 1
            return out

        algo._fill_canvases = timed_fill
        self._undo: List[Callable[[], None]] = [
            lambda: delattr(algo, "_fill_canvases")]

        def event():
            e = torch.cuda.Event(enable_timing=True) if cuda else None
            if e is not None:
                e.record()
            return e

        state = {}

        def pre(mod, inp):
            state["rf"] = torch.profiler.record_function("bench.forward")
            state["rf"].__enter__()
            state["e0"] = event()

        def post(mod, inp, out):
            self.forward.append((state["e0"], event()))
            state["rf"].__exit__(None, None, None)

        hooks = [cell.model.register_forward_pre_hook(pre),
                 cell.model.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in hooks])

        orig = ops_nms.dispatch_batched_nms

        def nms(off_boxes, scores, iou_threshold, max_det):
            self.nms_inputs.append((off_boxes.detach().clone(),
                                    scores.detach().clone(), iou_threshold))
            with torch.profiler.record_function("bench.nms"):
                e0 = event()
                out = orig(off_boxes, scores, iou_threshold, max_det)
                self.nms.append((e0, event()))
            return out

        for mod in (dec8, ops_nms):
            setattr(mod, "dispatch_batched_nms", nms)
            self._undo.append(
                lambda m=mod: setattr(m, "dispatch_batched_nms", orig))

    def remove(self) -> None:
        for undo in self._undo:
            undo()

    @staticmethod
    def ms(pairs) -> List[float]:
        return [a.elapsed_time(b) for a, b in pairs if a is not None]


def reference_detections(cell: Cell, batches: List[List[int]],
                         bf16: bool = False) -> List[ref_detect.Detections]:
    """The reference's detections for every image of ``batches``; with
    ``bf16`` its forward under bfloat16 autocast, the configuration's
    precision, whose own distance from the float32 reference is the
    rounding noise of this seed's network."""
    cfg, dev, S = cell.cfg, cell.dev, cell.sizes["input_size"]
    d = cfg["decode"]
    with torch.device(dev):
        net = reference.build(cfg)
    net.load_state_dict(cell.state)
    net.eval()
    out = []
    with torch.no_grad(), fp32():
        for idxs in batches:
            boxes = [ref_detect.letterbox(cell.pool[i], S) for i in idxs]
            x = torch.as_tensor(np.stack([b[0] for b in boxes]),
                                device=dev).float() / 255.0
            with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
                raw = net(x)
            dense_boxes, dense_scores, best = reference.dense(cfg, raw)
            for j, (_, scale, pad) in enumerate(boxes):
                out.append(ref_detect.detect_image(
                    dense_boxes[j], dense_scores[j], best[j], d["conf"],
                    d["iou"], d["max_det"], d["topk"], float(scale), pad))
    return out


def judge_sample(cell: Cell, done: List[tuple], seed: int) -> Dict[str, float]:
    """The compared numbers over ``check_batches`` of the window's finished
    calls, drawn from the seed: ``done`` holds (pool indices, outputs)."""
    k = min(cell.sizes["check_batches"], len(done))
    rng = np.random.default_rng([seed, 3])
    picks = sorted(rng.choice(len(done), k, replace=False).tolist())
    program = [o for i in picks for o in done[i][1]]
    return judge_outputs(cell, [done[i][0] for i in picks], program)


def judge_outputs(cell: Cell, batches: List[List[int]],
                  program: List[tuple]) -> Dict[str, float]:
    """The program's answers for the images of ``batches`` against the
    reference, and in units of the reference's own bfloat16 noise: over
    the whole sample and image by image."""
    c, d = cell.cell["compare"], cell.cfg["decode"]

    def numbers(answers, ref):
        return judge.detection_numbers(answers, ref, d["conf"], d["iou"],
                                       d["max_det"], c["cover_margin"],
                                       c["cover_slack"])

    ref = reference_detections(cell, batches)
    out = numbers(program, ref)
    noise = numbers([(r.boxes, r.scores, r.classes) for r in
                     reference_detections(cell, batches, bf16=True)], ref)
    out["noise_ratio_p90"] = (out["answer_gap_p90"]
                              / max(noise["answer_gap_p90"], 1e-12))
    ratios = judge.image_ratios(out.pop("image_p90"), noise["image_p90"],
                                noise["answer_gap_p90"])
    out["image_ratio_max"] = max(ratios)
    out["image_ratio_median"] = float(np.median(ratios))
    return out


def run(cell_spec: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, small: bool, t0: float) -> dict:
    from tpucv_torch.ops.cuda_nms import nms_keep

    cuda = dev.type == "cuda"
    common.mark(t0, "imports")
    cell = Cell(cell_spec, cfg, seed, dev, small)
    common.mark(t0, "model_weights_inputs")
    for _ in range(cell.sizes["warmup_batches"]):
        cell.call(next(cell.order))
    if cuda:
        torch.cuda.synchronize(dev)
    common.mark(t0, "warmup")
    done, launches0 = [], nms_keep.launches
    probes = ctx = None
    if not trace:
        start = time.perf_counter()
        setup_s = start - t0
        while time.perf_counter() - start < seconds:
            idxs = next(cell.order)
            done.append((idxs, cell.call(idxs)))
        window_s = time.perf_counter() - start
    else:
        probes = Probes(cell)
        with Profiled(dev) as prof:
            with prof.window():
                start = time.perf_counter()
                for _ in range(cell.sizes["trace_batches"]):
                    idxs = next(cell.order)
                    with torch.profiler.record_function("bench.call"):
                        done.append((idxs, cell.call(idxs)))
                window_s = time.perf_counter() - start
        probes.remove()
        setup_s = None
    images = len(done) * cell.B
    launches = nms_keep.launches - launches0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        tr = prof.trace
        ctx = {"kind": "detect", "trace": tr, "images": images,
               "batches": len(done), "window_s": tr.window_s or window_s,
               "busy_s": tr.busy_s(), "fill_s": probes.fill_s,
               "fills": probes.fills, "forward_ms": Probes.ms(probes.forward),
               "nms_ms": Probes.ms(probes.nms),
               "nms_inputs": probes.nms_inputs,
               "flops_per_image": cfg["flops"]["forward_per_image"],
               "ranks": 1}
    del probes
    cell.model = None
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge_sample(cell, done, seed)
    return {"kind": "detect", "numbers": numbers, "setup_s": setup_s,
            "window_s": window_s, "images": images, "attempted": images,
            "failed": 0, "peak": peak, "count": 1, "trace_ctx": ctx,
            "counters": {"nms_keep_launches": launches,
                         "batches": len(done)},
            "e2e": {"detect_img_s": (images / window_s, "img/s")}}
