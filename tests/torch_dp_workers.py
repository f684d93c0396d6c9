"""Rank processes for ``tests/test_torch_parallel.py``.

Spawned processes import this module (not the test file, which imports
JAX): ``Ranks`` starts W ranks over gloo on the CPU, each runs one of the
``case_*`` functions on the inputs the test passed, and the test reads what
each rank saved. Everything a rank returns is numpy or plain Python.
"""

from __future__ import annotations

import socket
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``fn(rank, world, **kw)`` started in ``world`` gloo ranks; the
    caller may work meanwhile, then reads ``results()``."""

    def __init__(self, fn, world: int, out_dir: Path, **kw):
        self.world, self.out_dir = world, Path(out_dir)
        port = free_port()
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, port, str(out_dir), kw))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        """Each rank's result, in rank order, once all have exited."""
        for p in self.procs:
            p.join(TIMEOUT_S)
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in self.procs]
        if alive or any(codes):
            raise RuntimeError(f"ranks exited with {codes} "
                               f"({len(alive)} killed at the time limit)")
        return [torch.load(self.out_dir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def _entry(fn, rank, world, port, out_dir, kw):
    import torch.distributed as dist

    from tpucv_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                         backend="gloo")
    try:
        out = fn(rank, world, **kw)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


# ------------------------------------------------------------- the models
class NHWC(torch.nn.Module):
    """A NCHW stack fed NHWC images, as the port's networks are."""

    def __init__(self, *layers):
        super().__init__()
        self.m = torch.nn.Sequential(*layers)

    def forward(self, x):
        return self.m(x.permute(0, 3, 1, 2))


def bn_net(seed=0):
    """conv (no bias) - BatchNorm - SiLU - StepDropout - conv."""
    from tpucv_torch.nn.blocks import BatchNorm2d, StepDropout

    torch.manual_seed(seed)
    return NHWC(torch.nn.Conv2d(3, 8, 3, padding=1, bias=False),
                BatchNorm2d(8, eps=1e-3, momentum=0.03), torch.nn.SiLU(),
                StepDropout(0.3), torch.nn.Conv2d(8, 4, 1))


def wide_net(seed=0):
    """Four 64-wide 1x1 convs and a BatchNorm: equal parameter tensors, so
    ZeRO's partition can halve the moments."""
    from tpucv_torch.nn.blocks import BatchNorm2d

    torch.manual_seed(seed)
    layers = [torch.nn.Conv2d(64, 64, 1, bias=False) for _ in range(4)]
    return NHWC(layers[0], BatchNorm2d(64, eps=1e-3, momentum=0.03),
                torch.nn.ReLU(), *layers[1:], torch.nn.Conv2d(64, 4, 1))


def plain_net(seed=0):
    """No BatchNorm (tpucv's grad_accum case)."""
    torch.manual_seed(seed)
    return NHWC(torch.nn.Conv2d(16, 32, 1), torch.nn.ReLU(),
                torch.nn.Conv2d(32, 4, 1))


def mse_loss(raw, batch):
    """A loss whose normaliser spans the batch (the weights' sum)."""
    err = ((raw - batch["y"]) ** 2).mean((1, 2, 3))
    return (err * batch["w"]).sum() / batch["w"].sum(), {
        "w": batch["w"].sum()}


def mse_mean(raw, batch):
    """A plain mean: the mean of micro-batch means is the batch mean."""
    return ((raw - batch["y"]) ** 2).mean(), {}


def mse_scaled(raw, batch):
    """The YOLOv8 family's convention: a mean times the batch size."""
    return ((raw - batch["y"]) ** 2).mean() * raw.shape[0], {}


def tiny_batch(n=8, cin=3, hw=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, hw, hw, cin)).astype(np.float32),
            "y": rng.normal(size=(n, 4, hw, hw)).astype(np.float32),
            "w": rng.uniform(0.5, 1.0, n).astype(np.float32)}


NETS = {"bn": (bn_net, 3), "wide": (wide_net, 64), "plain": (plain_net, 16)}
LOSSES = {"mse": mse_loss, "mean": mse_mean, "scaled": mse_scaled}


def snapshot(state, metrics):
    """What a test compares: the metrics, the state_dict, the EMA, the
    gradients left by the step and the moments this rank holds (tensors:
    ``torch.save`` writes them quickly, where numpy goes through pickle)."""
    from tpucv_torch.parallel import mesh as pmesh

    opt = state.optimizer
    inner = opt.optim if pmesh.is_zero(opt) else opt
    names = {id(p): n for n, p in state.params.items()}
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "sd": {k: v.detach().clone()
               for k, v in state.model.state_dict().items()},
        "ema": ({k: v.clone() for k, v in state.ema.items()}
                if state.ema is not None else None),
        "grads": {n: p.grad.clone() for n, p in state.params.items()
                  if p.grad is not None},
        "moments": {names[id(p)]: {k: v.clone() for k, v in s.items()
                                   if k in ("exp_avg", "exp_avg_sq")}
                    for p, s in inner.state.items()},
        "moment_bytes": pmesh.moment_bytes(opt),
    }


def brief(snaps):
    """A family run's snapshots cut to what its test reads: every step's
    metrics, the first step's gradients and BatchNorm statistics, the last
    step's state_dict."""
    first = snaps[0]
    return {"metrics": [s["metrics"] for s in snaps],
            "grads": first["grads"],
            "stats": {k: v for k, v in first["sd"].items() if "running" in k},
            "sd": snaps[-1]["sd"]}


def run_steps(model, batch, loss_fn, steps, mesh=None, zero=False, G=1,
              scaled=False, lr=1e-2, ema=0.9, device="cpu"):
    """``steps`` steps of the port's train step on ``device``; a
    ``snapshot`` (on the CPU) after each."""
    from tpucv_torch.train.state import TrainState, make_train_step

    state = TrainState.create(model.to(device), lr, use_ema=ema > 0,
                              zero_opt=zero)
    step = make_train_step(loss_fn, device=device, ema_decay=ema,
                           grad_accum=G, loss_batch_scaled=scaled,
                           mixed_precision=False, mesh=mesh)
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append(cpu(snapshot(state, m)))
    return state, out


def cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: cpu(v) for k, v in tree.items()}
    return tree


def local(batch, rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}


def case_tiny(rank, world, runs, device="cpu"):
    """Each ``(net, loss, G, zero, steps)`` of ``runs`` on this rank's rows
    of ``tiny_batch`` for that net, on ``device`` (f32, TF32 off)."""
    from tpucv_torch.parallel.mesh import DataMesh

    torch.backends.cudnn.allow_tf32 = False
    mesh = DataMesh.current()
    out = {}
    for net, loss, G, zero, steps in runs:
        make, cin = NETS[net]
        batch = {k: v.to(device) for k, v in
                 local(tiny_batch(cin=cin), mesh.rows(8, G)).items()}
        _, snaps = run_steps(make(), batch, LOSSES[loss], steps, mesh, zero,
                             G, scaled=loss == "scaled", device=device)
        out[(net, loss, G, zero)] = snaps
    return out


def case_checkpoint(rank, world, tmp, ckpt_in):
    """A ZeRO run of ``wide_net``: 2 steps, saved to ``tmp/zero.ckpt``;
    then the one-process bundle ``ckpt_in`` loaded into a fresh ZeRO
    state (this rank's moments) and one more step from it."""
    from tpucv_torch.ckpt.checkpoint import CheckPoint
    from tpucv_torch.parallel.mesh import DataMesh

    mesh = DataMesh.current()
    batch = local(tiny_batch(cin=64), mesh.rows(8))
    state, snaps = run_steps(wide_net(), batch, mse_loss, 2, mesh, True)
    CheckPoint.save(state, str(Path(tmp) / "zero.ckpt"))
    fresh, _ = run_steps(wide_net(seed=1), batch, mse_loss, 0, mesh, True)
    CheckPoint.load(ckpt_in, fresh)
    loaded = snapshot(fresh, {})
    _, after = run_steps_from(fresh, batch, mesh)
    return {"saved": snaps[-1], "loaded": loaded, "after": after}


def run_steps_from(state, batch, mesh, steps=1):
    from tpucv_torch.train.state import make_train_step

    step = make_train_step(mse_loss, device="cpu", ema_decay=0.9,
                           mixed_precision=False, mesh=mesh)
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append(snapshot(state, m))
    return state, out


def detection_family(name):
    """(model, loss_fn) of a registered family on the CPU in f32, seed 0."""
    from tpucv_torch.builder import export_from_registry

    cfg, algo_cls, _ = export_from_registry(name)
    cfg.train.mixed_precision = False
    if name == "yolo8_det":
        cfg.dataset.input_size = 64
    algo = algo_cls(cfg, device="cpu")
    return algo.init_variables(seed=0), algo.build_loss()


def case_family(rank, world, name, batch, steps, lr):
    """``steps`` data-parallel steps of family ``name`` on this rank's rows
    of ``batch``, with and without ZeRO."""
    from tpucv_torch.parallel.mesh import DataMesh

    mesh = DataMesh.current()
    B = batch["images"].shape[0]
    out = {}
    for zero in (False, True):
        model, loss_fn = detection_family(name)
        _, snaps = run_steps(model, local(batch, mesh.rows(B)), loss_fn,
                             steps, mesh, zero, lr=lr, ema=0.99)
        out[zero] = brief(snaps)
    return out


def trainer(root, zero_opt=False):
    """yolo8_det's trainer at 64², B=4 (M 4, device augmentation and
    mosaic as shipped, synthetic data, f32), writing under ``root``."""
    from tpucv_torch.builder import export_from_registry

    cfg, _, cls = export_from_registry("yolo8_det")
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.zero_opt = zero_opt
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.train.save_path = str(Path(root) / "saves")
    cfg.log.root = str(Path(root) / "log")
    return cls(cfg, device="cpu")


TRAINER_STEPS = 2


def case_trainer(rank, world, tmp):
    """The trainer's run of ``TRAINER_STEPS`` steps under ``world`` ranks,
    with and without ZeRO: the final state_dict and step."""
    out = {}
    for zero in (False, True):
        state = trainer(Path(tmp) / f"trainer_{zero}", zero).train(
            max_steps=TRAINER_STEPS)
        out[zero] = {"sd": {k: v.clone()
                            for k, v in state.model.state_dict().items()},
                     "step": state.step}
    return out


def case_all(rank, world, tmp, tiny_runs, ckpt_in, families):
    """Every case in one world: ``case_tiny``, ``case_checkpoint``,
    ``case_trainer`` and ``case_family`` for each ``(name, batch, steps,
    lr)`` of ``families``."""
    return {"tiny": case_tiny(rank, world, tiny_runs),
            "checkpoint": case_checkpoint(rank, world, tmp, ckpt_in),
            "trainer": case_trainer(rank, world, tmp),
            **{name: case_family(rank, world, name, batch, steps, lr)
               for name, batch, steps, lr in families}}
