"""Where a train step's time goes between the host and the device: one
family's step (``make_train_step`` with the config's loss, bf16 autocast
on the card) on a batch that already lies on the device.

The size is the config's own (640 for the YOLOs, 513 for DeepLab, whose
batch holds label maps: ``bench.family_batch``'s). For each model it reports the step's time
(CUDA events over back-to-back steps), its kernels' time (torch.profiler,
device time summed), the host's time to launch one step from an idle
device (the median over the steps; near the step's time when the host,
not the device, sets the pace), and, a step, the host's waits for the
device (runtime calls named ``*Synchronize``), the copies from host
memory to the device (``Memcpy HtoD``) and the kernel launches
(``*LaunchKernel*``). A step that waits for the device cannot queue its
launches under the kernels before them.

    python -m tpucv_torch.probes.train_step --model yolo7        # the card
    python -m tpucv_torch.probes.train_step --model deeplabv3plus
    python -m tpucv_torch.probes.train_step --device cpu --small
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from tpucv_torch.bench import family_batch
from tpucv_torch.builder import export_from_registry
from tpucv_torch.probes.common import card, parser, resolve_device, timed
from tpucv_torch.train.state import TrainState, make_train_step


def synthetic_batch(B: int, S: int, M: int, dev, dtype, seed: int = 0):
    """Images in [0, 1) and M GT rows an image (a third of them live),
    made from ``seed`` with numpy and put on ``dev``."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.1 * S, 0.9 * S, (B, M, 2))
    wh = rng.uniform(0.02 * S, 0.6 * S, (B, M, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, S)
    host = {"images": rng.random((B, S, S, 3), np.float32),
            "gt_bboxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, 20, (B, M)),
            "gt_mask": rng.random((B, M)) < 1 / 3}
    out = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    out["images"] = out["images"].to(dtype)
    return out


def _host_waits(step, state, batch, n: int, dev) -> dict:
    """A step's host waits and host-to-device copies, counted by
    torch.profiler over ``n`` steps, and its kernels' ms (None on the
    CPU)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n):
            step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    events = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {
        "syncs_a_step": sum(e.count for e in events
                            if "Synchronize" in e.key) / n,
        "h2d_copies_a_step": sum(e.count for e in events
                                 if "Memcpy HtoD" in e.key) / n,
        "launches_a_step": sum(e.count for e in events
                               if "LaunchKernel" in e.key) / n,
        "kernel_ms": kernel_us / n / 1e3 if kernel_us > 0 else None}


def measure(model_name: str, dev, B: int, S: Optional[int],
            n: int) -> dict:
    """One family's step at B x S² (S None: the config's own size, the
    crop for DeepLab)."""
    cfg, algo_cls, _ = export_from_registry(model_name)
    seg = model_name == "deeplabv3plus"
    if seg:
        S = S or cfg.arch.crop_size
        cfg.arch.crop_size = cfg.arch.input_size = S
    S = S or cfg.dataset.input_size
    cfg.dataset.input_size = S
    algo = algo_cls(cfg, device=dev)
    model = algo.init_variables(seed=0).train()
    state = TrainState.from_config(model, cfg.optimizer)
    amp = dev.type == "cuda" and cfg.train.mixed_precision
    step = make_train_step(algo.build_loss(), device=dev,
                           ema_decay=cfg.optimizer.ema_decay,
                           mixed_precision=amp)
    dtype = torch.bfloat16 if amp else torch.float32
    batch = (family_batch(model_name, cfg, B, S, dev, dtype) if seg else
             synthetic_batch(B, S, cfg.dataset.max_num_boxes, dev, dtype))
    step_ms = timed(lambda: step(state, batch), n, dev)
    host = []
    for _ in range(n):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"model": model_name, "B": B, "S": S, "step_ms": step_ms,
            "host_ms_from_idle": float(np.median(host)),
            **_host_waits(step, state, batch, max(2, n // 2), dev)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = parser(__doc__)
    p.add_argument("--model", action="append",
                   help="a registered model; repeat for more "
                        "(default: yolo7)")
    p.add_argument("--batch", type=int, default=16)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"train step on {card(dev)}", flush=True)
    B, S, n = (2, 64, 2) if args.small else (args.batch, None, 10)
    rows = []
    for name in args.model or ["yolo7"]:
        row = measure(name, dev, B, S, n)
        print(row, flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
