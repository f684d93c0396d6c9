"""Training: the step of ``train.state.make_train_step`` with the
configuration's loss and optimizer (``TrainState.from_config``) on a ring
of device-resident batches made at set-up.

Set-up builds the one step and its state, drives it through its first
``check_steps`` steps on ring batches 0, 1, 2 (rows that all differ) and
``warmup_steps`` more; then the window runs the same step on the ring.
The check follows the program from the start to the end of the window's
first ``window_check_steps`` steps (``followed``: all on ring batches
that differ) and keeps what they produced: each step's loss, the
gradient the optimizer gets at the first step (read by a hook on its
``step``), the weights and BatchNorm statistics after set-up's checked
steps and after the window's. A traced run takes the window's compared
steps just before its profiled window, so that the copies of the state
stay out of the trace.

End to end: ``train_img_s``, the images of every step in the window (all
ranks) over its seconds, and ``setup_s``. Traced: ``trace_steps`` steps
under the profiler, each stage of the step in a span (``lap``).

Across ranks (``world > 1``) each rank runs this with its rows of every
global batch through ``parallel.mesh.DataMesh``; rank 0 ends the window
and the others follow at a step it names (``stop_margin`` steps ahead),
through a key of a ``torch.distributed`` store.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import common, judge, reference, traffic, weights
from benchmark.reference import train as ref_train
from benchmark.trace import Profiled

STAGES = {"forward": "bench.loss", "loss": "bench.backward",
          "backward": "bench.optimizer", "optimizer_ema": None}


class Laps:
    """``lap`` for the step: each stage of the step in its own span."""

    def __init__(self):
        self.rf = None

    def _enter(self, name):
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()

    def begin(self):
        self._enter("bench.forward")

    def __call__(self, stage: str):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if STAGES.get(stage):
            self._enter(STAGES[stage])


def sizes_of(cell: dict, small: bool) -> dict:
    return dict(cell["sizes"], **(cell["small"] if small else {}))


def followed(sz: dict) -> tuple:
    """(set-up's checked steps, every step the check follows)."""
    n_check = sz["check_steps"]
    return n_check, n_check + sz["warmup_steps"] + sz["window_check_steps"]


def followed_batches(ring: list, total: int) -> list:
    """The global batches of the followed steps, as the window feeds them."""
    return [ring[t % len(ring)] for t in range(total)]


def first_gradient(ts) -> tuple:
    """A hook on the optimizer's ``step`` that copies the gradient each
    parameter holds when the optimizer is called: (the copies, the hook's
    handle, to remove after the first step). A step that never calls the
    optimizer leaves every copy 0."""
    grads = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in ts.params.items()}

    def take(opt, args, kwargs):
        for n, p in ts.params.items():
            if p.grad is not None:
                grads[n] = p.grad.detach().float().clone()

    return grads, ts.optimizer.register_step_pre_hook(take)


def state_copy(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def loss_kwargs(cfg: dict) -> dict:
    net = cfg["network"]
    return dict(nc=net["nc"], reg_max=net["reg_max"],
                strides=tuple(net["strides"]), **cfg["loss"])


def rank_main(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
              dev: torch.device, small: bool, t0: float, world: int = 1,
              rank: int = 0, store=None) -> dict:
    """One rank's run. Returns its readings and, on rank 0, what the
    check needs (``checked``: the first steps' results and batches)."""
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.parallel.mesh import DataMesh
    from tpucv_torch.train.state import TrainState, make_train_step

    cuda = dev.type == "cuda"
    sz = sizes_of(cell, small)
    if rank == 0:
        common.mark(t0, "imports")
    pcfg, algo_cls, _ = export_from_registry(cfg["registry"])
    common.apply_overrides(pcfg, cfg["overrides"])
    S = pcfg.dataset.input_size = sz["input_size"]
    algo = algo_cls(pcfg, device=dev)
    with torch.device("meta"):
        shapes = weights.shapes_of(reference.build(cfg))
    start_state = weights.make(shapes, seed, cfg["weights"]["train"], dev)
    with torch.device(dev):
        model = algo.build_model()
    model.load_state_dict(start_state)
    model = model.train()
    if cuda:
        model = model.to(memory_format=torch.channels_last)
    mesh = DataMesh.current(1) if world > 1 else None
    ts = TrainState.from_config(model, pcfg.optimizer,
                                iters_per_epoch=sz["iters_per_epoch"])
    amp = cuda and pcfg.train.mixed_precision
    step = make_train_step(algo.build_loss(), device=dev,
                           ema_decay=pcfg.optimizer.ema_decay,
                           mixed_precision=amp, mesh=mesh)
    B = sz["batch_per_rank"] * world
    ring = traffic.train_ring(cell["traffic"], seed, dev, B, S,
                              pcfg.dataset.max_num_boxes, cfg["network"]["nc"],
                              torch.bfloat16 if amp else torch.float32)
    rows = mesh.rows(B) if mesh is not None else np.arange(B)
    rows_t = torch.as_tensor(rows, device=dev)
    local = [{k: v.index_select(0, rows_t) for k, v in b.items()} for b in ring]
    R = len(local)
    n_check, total = followed(sz)
    n_window = total - n_check - sz["warmup_steps"]
    if rank == 0:
        common.mark(t0, "model_weights_inputs")

    losses, states = [], {}
    grads, hook = first_gradient(ts)
    k = n_check + sz["warmup_steps"]
    for t in range(k):
        _, metrics = step(ts, local[t % R])
        losses.append(metrics["loss"])
        if t == 0:
            hook.remove()
        if t + 1 == n_check and rank == 0:
            states[n_check] = state_copy(model)
    if cuda:
        torch.cuda.synchronize(dev)
    if world > 1:
        torch.distributed.barrier()
        if cuda:
            torch.cuda.synchronize(dev)
    if rank == 0:
        common.mark(t0, "checked_steps_warmup")

    steps, ctx, laps = 0, None, Laps()
    if not trace:
        start = time.perf_counter()
        stop_at: Optional[int] = None
        while True:
            if stop_at is None:
                if rank == 0 and time.perf_counter() - start >= seconds:
                    stop_at = steps + (sz["stop_margin"] if world > 1 else 0)
                    if store is not None:
                        store.set("bench/stop", str(stop_at))
                elif rank != 0 and store.check(["bench/stop"]):
                    stop_at = int(store.get("bench/stop"))
            if stop_at is not None and steps >= max(stop_at, n_window):
                break
            _, metrics = step(ts, local[k % R])
            k += 1
            steps += 1
            if steps <= n_window:
                losses.append(metrics["loss"])
                if steps == n_window and rank == 0:
                    states[total] = state_copy(model)
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - start
        setup_s = start - t0
    else:
        for _ in range(n_window):
            _, metrics = step(ts, local[k % R])
            losses.append(metrics["loss"])
            k += 1
        if rank == 0:
            states[total] = state_copy(model)
        if cuda:
            torch.cuda.synchronize(dev)
        with Profiled(dev) as prof:
            with prof.window():
                start = time.perf_counter()
                for _ in range(sz["trace_steps"]):
                    laps.begin()
                    _, metrics = step(ts, local[k % R], laps)
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
               "ranks": world}
    last_loss = float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = {"steps": steps, "window_s": window_s, "setup_s": setup_s,
           "images": steps * B, "peak": peak, "last_loss": last_loss,
           "trace_ctx": ctx}
    if rank == 0:
        out["checked"] = {"losses": [float(x) for x in losses],
                          "grads": grads, "states": states}
        out["start_state"] = start_state
        out["batches"] = followed_batches(ring, total)
    del ts, model, step, local, ring
    return out


def check(cfg: dict, start_state, batches, checked, n_check: int,
          dev: torch.device) -> Dict[str, float]:
    """The reference's run from the same weights on the same global
    batches, against the program's ``checked`` results."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.device(dev):
        net = reference.build(cfg)
    opt = cfg["optimizer"]
    ref = ref_train.run(net, start_state, batches, loss_kwargs(cfg),
                        opt["lr"], opt["warmup_iters"], keep=(n_check,))
    return judge.training_numbers(checked, ref, start_state, n_check)


def result(cfg: dict, cell: dict, main: dict, others: list,
           dev: torch.device, world: int, small: bool) -> dict:
    numbers = check(cfg, main.pop("start_state"), main.pop("batches"),
                    main.pop("checked"), sizes_of(cell, small)["check_steps"],
                    dev)
    finite = np.isfinite(main["last_loss"]) and all(
        np.isfinite(o["last_loss"]) for o in others)
    ctx = main["trace_ctx"]
    if ctx is not None and others:
        ctx["busy_s"] = float(np.mean([ctx["busy_s"]] +
                                      [o["busy_s"] for o in others]))
    return {"kind": "train", "numbers": numbers, "setup_s": main["setup_s"],
            "window_s": main["window_s"], "attempted": main["steps"],
            "failed": 0 if finite else 1,
            "peak": max([main["peak"]] + [o["peak"] for o in others]),
            "count": world, "trace_ctx": ctx,
            "counters": {"steps": main["steps"]},
            "e2e": {"train_img_s": (main["images"] / main["window_s"],
                                    "img/s")}}


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, small: bool, t0: float) -> dict:
    main = rank_main(cell, cfg, seed, seconds, trace, dev, small, t0)
    return result(cfg, cell, main, [], dev, 1, small)


def summary_for_rank0(out: dict) -> str:
    """What a rank other than 0 sends to rank 0."""
    ctx = out["trace_ctx"]
    return json.dumps({"peak": out["peak"], "last_loss": out["last_loss"],
                       "busy_s": None if ctx is None else ctx["busy_s"]})
