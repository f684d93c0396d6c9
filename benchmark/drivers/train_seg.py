"""Segmentation training: the step of ``train.state.make_train_step`` with
the configuration's loss (the focal loss of the program's
``algo.build_loss()``) and optimizer (``TrainState.from_config``) on a
ring of device-resident batches of images and label maps
(``benchmark/traffic_seg.py``), the ASPP dropout live.

The protocol is ``drivers/train.py``'s, on one card: set-up builds the
step and its state and drives it through its first ``check_steps`` steps
and ``warmup_steps`` more; the window runs the same step on the ring;
the reference (``reference/deeplabv3plus.py``) follows the program from
the seed's weights through set-up's checked steps, the warm-up's and the
window's first ``window_check_steps`` on the same batches, and
``judge.training_numbers`` compares each step's loss, the first step's
gradient and the weights and BatchNorm statistics after set-up's checked
steps and after the window's (with ``detail``, so that the median leaf's
gradient gap, ``grad_median``, is one of them). Traced: ``trace_steps``
steps under the profiler.

The compared numbers of sound runs and of the control, for the cell's
limits, in one process:

    python -m benchmark.drivers.train_seg --control \\
        --workload deeplabv3plus-train-b16 --seeds 1-4 --variants program,fp8

Each line is {"seed", "variant", numbers...}: ``program``, the program
against the float32 reference; ``fp8``, the control, the reference with
every convolution's operands and result rounded to float8 e4m3 in the
program's place.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from benchmark import common, judge, traffic_seg, weights
from benchmark.drivers.train import (Laps, first_gradient, followed,
                                     followed_batches, sizes_of, state_copy)
from benchmark.reference import deeplabv3plus as ref
from benchmark.trace import Profiled


def program_main(cell: dict, cfg: dict, seed: int, seconds: float,
                 trace: bool, dev: torch.device, small: bool,
                 t0: float) -> dict:
    """The program's run: its readings and what the check needs
    (``checked``: the first steps' results, and their batches)."""
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.train.state import TrainState, make_train_step

    cuda = dev.type == "cuda"
    sz = sizes_of(cell, small)
    common.mark(t0, "imports")
    pcfg, algo_cls, _ = export_from_registry(cfg["registry"])
    common.apply_overrides(pcfg, cfg["overrides"])
    S = sz["input_size"]
    algo = algo_cls(pcfg, device=dev)
    with torch.device("meta"):
        shapes = weights.shapes_of(ref.build(cfg["network"]))
    start_state = weights.make(shapes, seed, cfg["weights"]["train"], dev)
    with torch.device(dev):
        model = algo.build_model()
    model.load_state_dict(start_state)
    model = model.train()
    if cuda:
        model = model.to(memory_format=torch.channels_last)
    ts = TrainState.from_config(model, pcfg.optimizer,
                                iters_per_epoch=sz["iters_per_epoch"])
    amp = cuda and pcfg.train.mixed_precision
    step = make_train_step(algo.build_loss(), device=dev,
                           ema_decay=pcfg.optimizer.ema_decay,
                           mixed_precision=amp)
    B = sz["batch"]
    ring = traffic_seg.train_ring(cell["traffic"], seed, dev, B, S,
                                  cfg["network"]["nc"],
                                  torch.bfloat16 if amp else torch.float32)
    R = len(ring)
    n_check, total = followed(sz)
    n_window = total - n_check - sz["warmup_steps"]
    common.mark(t0, "model_weights_inputs")

    losses, states = [], {}
    grads, hook = first_gradient(ts)
    k = n_check + sz["warmup_steps"]
    for t in range(k):
        _, metrics = step(ts, ring[t % R])
        losses.append(metrics["loss"])
        if t == 0:
            hook.remove()
        if t + 1 == n_check:
            states[n_check] = state_copy(model)
    if cuda:
        torch.cuda.synchronize(dev)
    common.mark(t0, "checked_steps_warmup")

    steps, ctx, laps = 0, None, Laps()
    if not trace:
        start = time.perf_counter()
        while steps < n_window or time.perf_counter() - start < seconds:
            _, metrics = step(ts, ring[k % R])
            k += 1
            steps += 1
            if steps <= n_window:
                losses.append(metrics["loss"])
                if steps == n_window:
                    states[total] = state_copy(model)
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - start
        setup_s: Optional[float] = start - t0
    else:
        for _ in range(n_window):
            _, metrics = step(ts, ring[k % R])
            losses.append(metrics["loss"])
            k += 1
        states[total] = state_copy(model)
        if cuda:
            torch.cuda.synchronize(dev)
        with Profiled(dev) as prof:
            with prof.window():
                start = time.perf_counter()
                for _ in range(sz["trace_steps"]):
                    laps.begin()
                    _, metrics = step(ts, ring[k % R], laps)
                    k += 1
                    steps += 1
                if cuda:
                    torch.cuda.synchronize(dev)
                window_s = time.perf_counter() - start
        setup_s = None
        tr = prof.trace
        ctx = {"kind": "train", "trace": tr, "steps": steps,
               "images": steps * B, "window_s": tr.window_s or window_s,
               "busy_s": tr.busy_s(),
               "flops_per_image": cfg["flops"]["train_step_per_image"],
               "ranks": 1}
    last_loss = float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = {"steps": steps, "window_s": window_s, "setup_s": setup_s,
           "images": steps * B, "peak": peak, "last_loss": last_loss,
           "trace_ctx": ctx,
           "checked": {"losses": [float(x) for x in losses],
                       "grads": grads, "states": states},
           "start_state": start_state,
           "batches": followed_batches(ring, total)}
    del ts, model, step, ring
    return out


def reference_run(cfg: dict, start_state, batches, n_check: int,
                  dev: torch.device, prec: str = "f32") -> dict:
    """The reference's run from the same weights on the same batches."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.device(dev):
        net = ref.build(cfg["network"])
    opt, loss = cfg["optimizer"], cfg["loss"]
    kw = {k: loss[k] for k in ("alpha", "gamma", "ignore_index")}
    return ref.run(net, start_state, batches, kw, opt["lr"],
                   opt["warmup_iters"], prec, keep=(n_check,))


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, small: bool, t0: float) -> dict:
    main = program_main(cell, cfg, seed, seconds, trace, dev, small, t0)
    n_check = sizes_of(cell, small)["check_steps"]
    start = main.pop("start_state")
    base = reference_run(cfg, start, main.pop("batches"), n_check, dev)
    numbers = judge.training_numbers(main.pop("checked"), base, start,
                                     n_check, detail=True)
    return {"kind": "train", "numbers": numbers, "setup_s": main["setup_s"],
            "window_s": main["window_s"], "attempted": main["steps"],
            "failed": 0 if np.isfinite(main["last_loss"]) else 1,
            "peak": main["peak"], "count": 1,
            "trace_ctx": main["trace_ctx"],
            "counters": {"steps": main["steps"]},
            "e2e": {"train_img_s": (main["images"] / main["window_s"],
                                    "img/s")}}


def control(cell: dict, cfg: dict, seeds, variants, dev: torch.device,
            small: bool) -> None:
    """Print the compared numbers of each seed and variant, one JSON line
    each (``detail``: each step's loss gap and the worst leaves too)."""
    n_check = sizes_of(cell, small)["check_steps"]
    for seed in seeds:
        main = program_main(cell, cfg, seed, 0.0, False, dev, small,
                            time.perf_counter())
        start, batches = main["start_state"], main["batches"]
        base = reference_run(cfg, start, batches, n_check, dev)
        for v in variants:
            got = main["checked"] if v == "program" else reference_run(
                cfg, start, batches, n_check, dev, v)
            print(json.dumps({"seed": seed, "variant": v,
                              **judge.training_numbers(got, base, start,
                                                       n_check,
                                                       detail=True)}),
                  flush=True)
        del main, base
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    from benchmark.control import parse_seeds

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--control", action="store_true", required=True,
                   help="print the compared numbers of sound runs and "
                        "of the control")
    p.add_argument("--workload", default="deeplabv3plus-train-b16")
    p.add_argument("--seeds", required=True, help="e.g. 1-4 or 5,9")
    p.add_argument("--variants", default="program,fp8",
                   help="program and / or fp8")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    common.set_cache_dirs()
    cell = common.load_json("workloads", args.workload)
    cfg = common.load_json("configs", cell["config"])
    common.require_device(args.device, 1)
    seeds = [common.seed_of(s) for s in parse_seeds(args.seeds)]
    control(cell, cfg, seeds, args.variants.split(","),
            torch.device(args.device), args.small)


if __name__ == "__main__":
    main()
