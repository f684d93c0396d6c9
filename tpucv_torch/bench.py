"""The port's benchmark: the program of ``bench.py:main`` on one CUDA card,
YOLOv8n inference end to end and then the training step.

    python -m tpucv_torch.bench                    # on the card
    python -m tpucv_torch.bench --device cpu --small   # wiring, tiny shapes

Prints one JSON line with ``bench.py``'s keys:

- ``value``: img/s of the inference program on device-resident uint8
  batches: B=128 480x640 -> ``letterbox_static`` -> bf16 normalize ->
  forward under bf16 autocast (channels_last) -> ``decode_boxes`` (conf
  0.25, IoU 0.7, ``max_det`` 300, ``pre_nms_topk`` 512), whose NMS
  launches the CUDA ``nms_keep``.
- ``h2d_img_per_sec``: the same program with each batch copied from host
  memory per call; ``h2d_gbytes_per_sec``: one batch's copy alone, timed
  before any program runs.
- ``train_img_per_sec`` / ``train_step_ms``: ``train.state``'s step
  (forward, YOLOv8 loss with the TAL assigner, backward, Adam 1e-3, EMA
  0.9999) at B=128, 640², M=32 GT rows, on a batch made on the device as
  ``bench.py:78-85`` makes it, from a ``torch.Generator``.
- ``int8_img_per_sec``: the same program over the int8 PTQ model
  (``quant.quantize_for_inference``, calibrated on the first resident
  batch letterboxed and normalized as the program does it), timed as
  ``value`` is.
- ``host_decode_img_per_sec_per_core`` / ``host_decode_threads``: the
  native JPEG decode (``native/imagepipe.decode_to_canvas``) of 160
  noise JPEGs of 480x640 onto 640² canvases at 1, 2 and 4 threads, on the
  host clock; ``feed_limited_img_per_sec_this_host`` = min(the 1-thread
  rate x this host's cores, ``value``) and ``cores_to_feed_chip`` =
  ceil(``value`` / the 1-thread rate), as ``bench.py:main`` reckons them.
  Where the native library is unavailable (it needs libjpeg's headers to
  build) the four stay null and ``notes`` says why.

``--model ssd|centernet|yolo7|deeplabv3plus`` (or ``yolo7x`` / ``ssd512``,
the shipped YOLOv7-x and SSD512 at their family's batches) runs
``bench.py:bench_family`` instead, the headline left as it is: the registered
algorithm's own uint8 inference function (``make_infer_fn``) on two
device-resident batches, 20 timed calls, and ``train.state``'s step
(Adam 1e-3, EMA 0.9999, bf16 autocast) on a batch made on the device,
15 timed steps, at tpucv's batches (inference 64 / 64 / 32 / 32, training
64 / 32 / 32 / 16). DeepLab trains on dense label maps, the detectors on
32 GT rows an image. One JSON line: ``{name}_{S}_e2e_images_per_sec_per_
chip`` (``per_cpu`` with ``--device cpu``), ``infer_batch``,
``train_img_per_sec``, ``train_step_ms`` and ``train_batch``.

``--scale s|m|l|x`` runs ``bench.py:bench_scale`` instead: YOLOv8 at a
wider scale (the registered yolo8_det config with ``arch.model_type`` set),
the headline's program (uint8 480x640 -> ``letterbox_static`` ->
normalize -> forward under bf16 autocast -> ``decode_boxes`` with
``pre_nms_topk`` 512, whose NMS launches ``nms_keep``) on two
device-resident batches, 20 timed calls, then the headline's step (Adam
1e-3, EMA 0.9999, 32 GT rows an image) at 640², 15 timed steps, at
tpucv's batches (inference 64 / 32 / 32 / 16, training 64 / 32 / 16 / 8).
One JSON line with ``bench_scale``'s keys: ``yolov8{scale}_640_e2e_
images_per_sec_per_chip``, ``infer_batch``, ``train_img_per_sec``,
``train_step_ms``, ``train_batch``, and the port's ``device``.

Card times come from CUDA events around many calls after warm-up
(``probes.common.timed``); the train step's split into stages from the
host clock with a sync after each stage. With
``--device cpu`` the times are the host clock's and the line's ``device``
is ``cpu``: they say nothing of the card. Nothing falls back to the CPU:
on a machine without CUDA the default run exits with an error.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tpucv_torch import quant
from tpucv_torch.builder import export_from_registry
from tpucv_torch.configs.base import OptimizerCfg
from tpucv_torch.decode.yolov8 import decode_boxes
from tpucv_torch.ops.preprocess import letterbox_static, normalize_images
from tpucv_torch.probes.common import H100_BF16_FLOPS, card, timed
from tpucv_torch.train.state import TrainState, make_train_step
from tpucv_torch.utils.device import resolve_device

# bench.py:bench_train_step's optimizer: optax.adam(1e-3) at a constant lr
# (no warmup, no milestones) and an EMA of decay 0.9999
OPTIMIZER = OptimizerCfg(name="adam", lr=1e-3, warmup_iters=0,
                         ema_decay=0.9999)
SPLIT_REPS = 5                   # steps the split takes the median of
BASELINE_IMG_PER_S = 5000.0      # BASELINE.json's target, as bench.py uses
DECODE_THREADS = (1, 2, 4)        # bench.py:bench_host_decode's counts
NO_NATIVE_DECODE = (
    "host_decode_img_per_sec_per_core, host_decode_threads, "
    "feed_limited_img_per_sec_this_host and cores_to_feed_chip: null, the "
    "native JPEG decode (tpucv_torch/native/imagepipe) is unavailable on "
    "this host (its build needs libjpeg's headers, and its decode must "
    "match cv2's)")


@dataclass(frozen=True)
class Shapes:
    batch: int = 128            # inference batch
    height: int = 480           # raw uint8 images (COCO val's usual shape)
    width: int = 640
    size: int = 640             # model input
    infer_iters: int = 40
    h2d_iters: int = 2
    train_batch: int = 128
    max_boxes: int = 32         # GT rows an image
    box_scale: float = 300.0    # GT coordinates uniform in [0, box_scale)
    train_warmup: int = 3
    train_iters: int = 30
    decode_images: int = 160    # JPEGs of height x width for the host decode


FULL = Shapes()
SMALL = Shapes(batch=2, height=48, width=64, size=64, infer_iters=2,
               h2d_iters=1, train_batch=2, max_boxes=4, box_scale=30.0,
               train_warmup=1, train_iters=2, decode_images=8)


def _algo(dev: torch.device):
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    return algo_cls(cfg, device=dev)


def yolo8n(dev: torch.device) -> nn.Module:
    """The registered yolo8_det model (YOLOv8n, nc=80) with random weights
    from ``torch.Generator`` seed 0, in eval mode on ``dev``."""
    return _algo(dev).init_variables(seed=0)


def prep(raw_u8: torch.Tensor, size: int, amp: bool) -> torch.Tensor:
    """The program's input: ``letterbox_static``, then normalized to bf16
    (f32 without ``amp``)."""
    lb, _, _ = letterbox_static(raw_u8, size)
    return normalize_images(lb, torch.bfloat16 if amp else torch.float32)


def inference_program(model: nn.Module, size: int, amp: bool):
    """``bench.py:main``'s program: (forward, program) over uint8 NHWC
    batches whose longer side is ``size``."""

    def fwd(raw_u8):
        x = prep(raw_u8, size, amp)
        with torch.autocast(raw_u8.device.type, dtype=torch.bfloat16,
                            enabled=amp):
            return model(x)

    def program(raw_u8):
        return decode_boxes(fwd(raw_u8), conf_threshold=0.25,
                            iou_threshold=0.7, max_det=300,
                            pre_nms_topk=512)

    return fwd, program


def raw_batches(shapes: Shapes = FULL, n: int = 4):
    """``n`` uint8 NHWC host batches from numpy seed 0, as bench.py's."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(
        0, 255, (shapes.batch, shapes.height, shapes.width, 3),
        dtype=np.uint8)) for _ in range(n)]


def bench_inference(model: nn.Module, dev: torch.device,
                    shapes: Shapes = FULL) -> Dict[str, object]:
    """Device-resident and H2D-included throughput of the program (3
    warm-up calls, then ``infer_iters`` and ``h2d_iters`` timed calls, each
    run after one more warm-up call), the last call's outputs included."""
    amp = dev.type == "cuda"
    _, program = inference_program(model, shapes.size, amp)
    host = raw_batches(shapes)
    # a batch's copy alone, before any program runs
    copy_ms = timed(lambda: host[0].to(dev), 1, dev)
    resident = [h.to(dev) for h in host]
    out = []

    def run(batches):
        n = itertools.count()
        return lambda: out.append(program(batches[next(n) % 4].to(dev)))

    with torch.inference_mode():
        for _ in range(3):
            program(resident[0])
        ms = timed(run(resident), shapes.infer_iters, dev)
        h2d_ms = timed(run(host), shapes.h2d_iters, dev)
    return {"ms_per_batch": ms, "img_per_s": shapes.batch * 1e3 / ms,
            "h2d_img_per_s": shapes.batch * 1e3 / h2d_ms,
            "h2d_gbytes_per_s": host[0].numel() / (copy_ms * 1e-3) / 1e9,
            "outputs": out[-1]}


def quantize_int8(model: nn.Module, raw_u8: torch.Tensor, size: int,
                  amp: bool) -> nn.Module:
    """``bench.py:403-426``'s int8 model: PTQ calibrated on one uint8
    batch through the program's own letterbox and normalize, the forward
    under its autocast."""
    with torch.autocast(raw_u8.device.type, dtype=torch.bfloat16,
                        enabled=amp):
        return quant.quantize_for_inference(model, [prep(raw_u8, size, amp)])


def bench_int8(model: nn.Module, dev: torch.device,
               shapes: Shapes = FULL) -> Dict[str, object]:
    """The program over ``quantize_int8(model)`` on the resident batches,
    timed as ``bench_inference`` times ``value`` (3 warm-up calls, then
    ``infer_iters``)."""
    amp = dev.type == "cuda"
    resident = [h.to(dev) for h in raw_batches(shapes)]
    qmodel = quantize_int8(model, resident[0], shapes.size, amp)
    _, program = inference_program(qmodel, shapes.size, amp)
    n = itertools.count()
    with torch.inference_mode():
        for _ in range(3):
            program(resident[0])
        ms = timed(lambda: program(resident[next(n) % 4]),
                   shapes.infer_iters, dev)
    return {"int8_ms_per_batch": ms,
            "int8_img_per_s": shapes.batch * 1e3 / ms,
            "int8_convs": quant.count_quantized(qmodel)}


def bench_host_decode(shapes: Shapes = FULL) -> Optional[Dict[int, float]]:
    """``bench.py:bench_host_decode``: images/s of the native JPEG decode
    onto canvases at each of ``DECODE_THREADS`` (host clock), over
    ``decode_images`` full-frame noise JPEGs of height x width (quality 90,
    the densest a photo's size gets: a worst case), 32 distinct files
    repeated. None where the native library is unavailable."""
    import cv2

    from tpucv_torch.native import imagepipe

    if not imagepipe.available():
        return None
    rng = np.random.default_rng(0)
    n = shapes.decode_images
    with tempfile.TemporaryDirectory(prefix="tpucv_benchjpg_") as tmp:
        uniq = []
        for i in range(32):
            img = rng.integers(0, 255, (shapes.height, shapes.width, 3),
                               dtype=np.uint8)
            path = os.path.join(tmp, f"{i}.jpg")
            cv2.imwrite(path, img[..., ::-1],
                        [int(cv2.IMWRITE_JPEG_QUALITY), 90])
            uniq.append(path)
        paths = (uniq * -(-n // len(uniq)))[:n]
        rates = {}
        for nt in DECODE_THREADS:
            t0 = time.perf_counter()
            _, _, _, ok = imagepipe.decode_to_canvas(paths, shapes.size,
                                                     n_threads=nt)
            dt = time.perf_counter() - t0
            if not ok.all():
                raise RuntimeError(f"native decode failed on "
                                   f"{int((~ok).sum())} of {n} JPEGs")
            rates[nt] = n / dt
    return rates


def feed_limits(rates: Optional[Dict[int, float]],
                ips: float) -> Dict[str, object]:
    """``bench.py:main``'s feed-limit keys from the host decode rates and
    the device rate ``ips``."""
    per_core = rates[1] if rates else None
    return {
        "host_decode_img_per_sec_per_core": per_core,
        "host_decode_threads": ({str(k): v for k, v in rates.items()}
                                if rates else None),
        "feed_limited_img_per_sec_this_host":
            min(per_core * (os.cpu_count() or 1), ips) if per_core else None,
        "cores_to_feed_chip": int(np.ceil(ips / per_core))
        if per_core else None,
    }


def synthetic_batch(B: int, S: int, M: int, dev: torch.device,
                    box_scale: float, images_dtype: torch.dtype,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """``bench.py:78-85``'s batch, made on ``dev``: images uniform in
    [0, 1), labels uniform over the 80 classes, xyxy coordinates uniform in
    [0, box_scale) (some boxes inverted, as there), every row real."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "images": torch.rand((B, S, S, 3), generator=g, device=dev)
        .to(images_dtype),
        "gt_labels": torch.randint(0, 80, (B, M), generator=g, device=dev,
                                   dtype=torch.int32),
        "gt_bboxes": torch.rand((B, M, 4), generator=g, device=dev)
        * box_scale,
        "gt_mask": torch.ones((B, M), dtype=torch.bool, device=dev),
    }


def conv_flops(model: nn.Module, size: int, dev: torch.device) -> int:
    """Forward FLOPs of one ``size``² image: 2 * MACs of every convolution
    (the rest of the network is elementwise)."""
    total = [0]

    def hook(m, _, y):
        k = m.weight[0].numel()                  # Cin/groups * kh * kw
        total[0] += 2 * k * y[0].numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, 3), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def train_setup(dev: torch.device, shapes: Shapes = FULL):
    """(state, step, batch): YOLOv8n from seed 0 with the ``OPTIMIZER``
    section's Adam and EMA, the step of ``train.state`` (bf16 autocast on
    CUDA) and the synthetic batch from seed 0."""
    algo = _algo(dev)
    amp = dev.type == "cuda"
    state = TrainState.from_config(algo.init_variables(seed=0), OPTIMIZER)
    step = make_train_step(algo.build_loss(), device=dev,
                           ema_decay=OPTIMIZER.ema_decay,
                           mixed_precision=amp)
    batch = synthetic_batch(shapes.train_batch, shapes.size,
                            shapes.max_boxes, dev, shapes.box_scale,
                            torch.bfloat16 if amp else torch.float32)
    return state, step, batch


def train_split(state: TrainState, step, batch,
                dev: torch.device) -> Dict[str, float]:
    """The timed step itself cut into its stages (``make_train_step``'s
    ``lap``): forward / loss (TAL included) / backward / optimizer + EMA
    on the host clock, with a device sync as each stage ends; the median
    ms of ``SPLIT_REPS`` steps. The syncs expose what the whole step's
    overlap of host and device hides, so the stages sum to a little more
    than ``train_step_ms``."""
    laps: Dict[str, list] = {}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t = 0.0

    def lap(stage):
        nonlocal t
        sync()
        t1 = time.perf_counter()
        laps.setdefault(stage, []).append((t1 - t) * 1e3)
        t = t1

    for _ in range(SPLIT_REPS):
        sync()
        t = time.perf_counter()
        state, _ = step(state, batch, lap)
    return {k: float(np.median(v)) for k, v in laps.items()}


def bench_train(dev: torch.device,
                shapes: Shapes = FULL) -> Dict[str, object]:
    """``train_warmup`` warm-up steps, then ``train_iters`` timed steps:
    step ms, img/s, the last loss and ``num_fg`` (checked finite), the
    peak memory, the compute bound and its share of the step (``mfu``),
    and one step's split (``train_split``)."""
    state, step, batch = train_setup(dev, shapes)
    flops = 3 * conv_flops(state.model, shapes.size, dev) * shapes.train_batch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    last = {}

    def one():
        nonlocal state, last
        state, last = step(state, batch)

    for _ in range(shapes.train_warmup - 1):     # timed() makes the last
        one()
    ms = timed(one, shapes.train_iters, dev)
    metrics = {k: float(v) for k, v in last.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite training metrics {metrics}")
    bound_ms = flops / H100_BF16_FLOPS * 1e3
    out = {"train_step_ms": ms,
           "train_img_per_s": shapes.train_batch * 1e3 / ms,
           "train_loss": metrics["loss"], "train_num_fg": metrics["num_fg"],
           "train_metrics": metrics, "train_steps": state.step,
           "train_flops_per_step": flops,
           "train_bound_ms": bound_ms,
           "train_mfu_share": bound_ms / ms if dev.type == "cuda" else None}
    if dev.type == "cuda":
        out["train_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["train_split_ms"] = train_split(state, step, batch, dev)
    return out


# bench.py:bench_family's batches: (inference, training)
FAMILY_BATCHES = {"ssd": (64, 64), "centernet": (64, 32), "yolo7": (32, 32),
                  "deeplabv3plus": (32, 16)}
FAMILY_GT_ROWS = 32
FAMILY_ITERS = (20, 15)           # timed inference calls, timed steps


def family_batch(name: str, cfg, B: int, S: int, dev: torch.device,
                 images_dtype: torch.dtype, seed: int = 0):
    """``bench.py:bench_family``'s train batch, made on ``dev`` from a
    ``torch.Generator``: images uniform in [0, 1); DeepLab's labels uniform
    over its classes, a classifier's one label an image, the detectors'
    ``FAMILY_GT_ROWS`` GT rows of boxes uniform in [0, 0.45 S) (some
    inverted, as there), every row real, labels uniform over the object
    classes. SSD's ``num_classes`` counts its background, so its labels
    stop one short of it: tpucv draws them up to ``num_classes``, and its
    gather clamps the class one past the end where the port's raises."""
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((B, S, S, 3), generator=g, device=dev).to(
        images_dtype)
    nc = cfg.num_classes
    if name == "deeplabv3plus":
        return {"images": images,
                "labels": torch.randint(0, nc, (B, S, S), generator=g,
                                        device=dev, dtype=torch.int32)}
    if name in ("vit_cls", "yolo8_cls"):
        return {"images": images,
                "labels": torch.randint(0, nc, (B,), generator=g,
                                        device=dev, dtype=torch.int32)}
    M = FAMILY_GT_ROWS
    if name == "ssd":
        nc -= 1
    return {"images": images,
            "gt_labels": torch.randint(0, nc, (B, M), generator=g,
                                       device=dev, dtype=torch.int32),
            "gt_bboxes": torch.rand((B, M, 4), generator=g, device=dev)
            * (S * 0.45),
            "gt_mask": torch.ones((B, M), dtype=torch.bool, device=dev)}


# the shipped variants beside each family's registered config: the name
# their bench line carries, the family and the config fields they set
VARIANTS = {"yolo7x": ("yolo7", {"arch.phi": "x"}),
            "ssd512": ("ssd", {"arch.input_size": 512,
                               "dataset.input_size": 512})}


def configured(name: str):
    """``export_from_registry`` for a family or one of ``VARIANTS``: (the
    family's name, its config with the variant's fields set, the algorithm
    class)."""
    family, fields = VARIANTS.get(name, (name, {}))
    cfg, algo_cls, _ = export_from_registry(family)
    for path, value in fields.items():
        section, field = path.split(".")
        setattr(getattr(cfg, section), field, value)
    return family, cfg, algo_cls


def bench_family(name: str, dev: torch.device,
                 small: bool = False) -> Dict[str, object]:
    """``bench.py:bench_family`` for one of ``FAMILY_BATCHES``' families,
    or one of their shipped ``VARIANTS`` (YOLOv7-x, SSD512) at the
    family's batches: its inference function and its train step, timed
    with ``probes.common.timed`` (CUDA events on the card). ``small``:
    batch 2 and a small input (SSD keeps its priors' size; DeepLab on
    ResNet-50), 2 calls each, for a run on the CPU."""
    label = name
    name, cfg, algo_cls = configured(name)
    amp = dev.type == "cuda"
    cfg.train.mixed_precision = amp
    seg = name == "deeplabv3plus"
    B_inf, B_tr = FAMILY_BATCHES[name]
    n_inf, n_tr = FAMILY_ITERS
    if small:
        B_inf = B_tr = 2
        n_inf = n_tr = 2
        if seg:
            cfg.arch.backbone = "resnet50"
            cfg.arch.crop_size = cfg.arch.input_size = 65
        if name != "ssd":
            cfg.dataset.input_size = 65 if seg else 128
    algo = algo_cls(cfg, device=dev)
    S = cfg.arch.crop_size if seg else cfg.dataset.input_size
    model = algo.init_variables(seed=0)
    infer = algo.make_infer_fn()
    rng = np.random.default_rng(0)
    resident = [torch.from_numpy(rng.integers(
        0, 255, (B_inf, S, S, 3), dtype=np.uint8)).to(dev) for _ in range(2)]
    n = itertools.count()
    ms = timed(lambda: infer(model, resident[next(n) % 2]), n_inf, dev)

    state = TrainState.create(model, 1e-3, use_ema=True)
    step = make_train_step(algo.build_loss(), device=dev, ema_decay=0.9999,
                           mixed_precision=amp)
    batch = family_batch(name, cfg, B_tr, S, dev,
                         torch.bfloat16 if amp else torch.float32)
    last = {}

    def one():
        nonlocal state, last
        state, last = step(state, batch)

    step_ms = timed(one, n_tr, dev)
    loss = float(last["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"{name}: non-finite training loss {loss}")
    where = "chip" if dev.type == "cuda" else "cpu"
    return {"metric": f"{label}_{S}_e2e_images_per_sec_per_{where}",
            "value": B_inf * 1e3 / ms, "unit": "img/s",
            "infer_batch": B_inf,
            "train_img_per_sec": B_tr * 1e3 / step_ms,
            "train_step_ms": step_ms, "train_batch": B_tr,
            "train_loss": loss, "device": card(dev)}


# bench.py:bench_scale's batches: (inference, training)
SCALE_BATCHES = {"s": (64, 64), "m": (32, 32), "l": (32, 16), "x": (16, 8)}
SCALE_ITERS = (20, 15)            # timed inference calls, timed steps


def scale_algo(scale: str, dev: torch.device, size: Optional[int] = None):
    """The registered yolo8_det algorithm at YOLOv8 scale ``scale``
    (``size``: its input, else the config's 640)."""
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    cfg.arch.model_type = scale
    if size is not None:
        cfg.dataset.input_size = size
    return algo_cls(cfg, device=dev)


def bench_scale(scale: str, dev: torch.device,
                small: bool = False) -> Dict[str, object]:
    """``bench.py:bench_scale``: the headline's inference program and
    train step for YOLOv8 at ``scale``, timed with
    ``probes.common.timed`` (CUDA events on the card). ``small``: batch 2
    at 64² (uint8 48x64), 2 calls each, for a run on the CPU."""
    B_inf, B_tr = SCALE_BATCHES[scale]
    n_inf, n_tr = SCALE_ITERS
    shapes = FULL
    if small:
        B_inf = B_tr = n_inf = n_tr = 2
        shapes = SMALL
    S = shapes.size
    amp = dev.type == "cuda"
    algo = scale_algo(scale, dev, S)
    model = algo.init_variables(seed=0)
    _, program = inference_program(model, S, amp)
    rng = np.random.default_rng(0)
    resident = [torch.from_numpy(rng.integers(
        0, 255, (B_inf, shapes.height, shapes.width, 3),
        dtype=np.uint8)).to(dev) for _ in range(2)]
    n = itertools.count()
    with torch.inference_mode():
        ms = timed(lambda: program(resident[next(n) % 2]), n_inf, dev)
    del resident

    state = TrainState.from_config(model, OPTIMIZER)
    step = make_train_step(algo.build_loss(), device=dev,
                           ema_decay=OPTIMIZER.ema_decay,
                           mixed_precision=amp)
    batch = synthetic_batch(B_tr, S, shapes.max_boxes, dev,
                            shapes.box_scale,
                            torch.bfloat16 if amp else torch.float32)
    last = {}

    def one():
        nonlocal state, last
        state, last = step(state, batch)

    step_ms = timed(one, n_tr, dev)
    loss = float(last["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"yolov8{scale}: non-finite training loss {loss}")
    where = "chip" if dev.type == "cuda" else "cpu"
    return {"metric": f"yolov8{scale}_{S}_e2e_images_per_sec_per_{where}",
            "value": B_inf * 1e3 / ms, "unit": "img/s",
            "infer_batch": B_inf,
            "train_img_per_sec": B_tr * 1e3 / step_ms,
            "train_step_ms": step_ms, "train_batch": B_tr,
            "train_loss": loss, "device": card(dev)}


def main(argv: Optional[list] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true",
                   help="tiny shapes, for a run on the CPU")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--scale", default=None, choices=sorted(SCALE_BATCHES),
                       help="YOLOv8 scale variant (bench.py:bench_scale) "
                            "instead of the n headline")
    which.add_argument("--model", default=None,
                       choices=sorted(FAMILY_BATCHES) + sorted(VARIANTS),
                       help="per-family bench (bench.py:bench_family) "
                            "instead of the YOLOv8 headline; yolo7x and "
                            "ssd512 are YOLOv7-x and SSD512")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.scale:
        line = bench_scale(args.scale, dev, args.small)
        print(json.dumps(line), flush=True)
        return line
    if args.model:
        line = bench_family(args.model, dev, args.small)
        print(json.dumps(line), flush=True)
        return line
    shapes = SMALL if args.small else FULL

    model = yolo8n(dev)
    inf = bench_inference(model, dev, shapes)
    int8 = bench_int8(model, dev, shapes)
    del model
    tr = bench_train(dev, shapes)
    rates = bench_host_decode(shapes)
    ips = inf["img_per_s"]
    where = "chip" if dev.type == "cuda" else "cpu"
    line = {
        "metric": f"yolov8n_{shapes.size}_e2e_images_per_sec_per_{where}",
        "value": ips,
        "unit": "img/s",
        "vs_baseline": ips / BASELINE_IMG_PER_S,
        "h2d_img_per_sec": inf["h2d_img_per_s"],
        "h2d_gbytes_per_sec": inf["h2d_gbytes_per_s"],
        "int8_img_per_sec": int8["int8_img_per_s"],
        "train_img_per_sec": tr["train_img_per_s"],
        "train_step_ms": tr["train_step_ms"],
        **feed_limits(rates, ips),
        "pipeline": f"uint8 {shapes.height}x{shapes.width} -> letterbox(pad)"
                    f"+normalize+forward+decode+NMS on {dev.type}",
        "notes": "" if rates else NO_NATIVE_DECODE,
        "int8_convs": int8["int8_convs"],
        "host_cores": os.cpu_count(),
        "device": card(dev),
        "infer_batch": shapes.batch, "train_batch": shapes.train_batch,
        **{k: v for k, v in tr.items() if k not in (
            "train_img_per_s", "train_step_ms")},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
