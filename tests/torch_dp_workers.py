"""Rank processes for ``tests/test_torch_parallel.py``,
``tests/test_torch_model_axis.py`` and ``tests/test_torch_spatial.py``.

Spawned processes import this module (not the test file, which imports
JAX): ``Ranks`` starts W ranks over gloo on the CPU, each runs one of the
``case_*`` functions on the inputs the test passed, and the test reads what
each rank saved. Everything a rank returns is numpy or plain Python.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 240


def rendezvous(out_dir: Path) -> str:
    """A ``file://`` rendezvous in a directory of its own under
    ``out_dir``: the ranks meet in a ``FileStore``, so no other process can
    take their address between its choice and their start, as it can take
    a TCP port that was bound, released and then bound again."""
    return "file://" + str(Path(tempfile.mkdtemp(dir=out_dir)) / "store")


class Ranks:
    """``fn(rank, world, **kw)`` started in ``world`` gloo ranks; the
    caller may work meanwhile, then reads ``results()``."""

    def __init__(self, fn, world: int, out_dir: Path, **kw):
        self.world, self.out_dir = world, Path(out_dir)
        init = rendezvous(self.out_dir)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, init, str(out_dir), kw))
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


def _entry(fn, rank, world, init, out_dir, kw):
    import torch.distributed as dist

    from tpucv_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, backend="gloo")
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
    gradients left by the step (kernels sharded over the model axis
    gathered whole: a collective) and the moments this rank holds
    (tensors: ``torch.save`` writes them quickly, where numpy goes through
    pickle)."""
    from tpucv_torch.parallel import mesh as pmesh

    opt = state.optimizer
    inner = opt.optim if pmesh.is_zero(opt) else opt
    names = {id(p): n for n, p in state.params.items()}
    shards = pmesh.model_shards(state.model)
    whole = lambda tree: pmesh.whole_tensors(  # noqa: E731
        {k: v.detach().clone() for k, v in tree.items()}, shards)
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "sd": whole(state.model.state_dict()),
        "ema": whole(state.ema) if state.ema is not None else None,
        "grads": whole({n: p.grad for n, p in state.params.items()
                        if p.grad is not None}),
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
                              zero_opt=zero, mesh=mesh)
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


def trainer(root, zero_opt=False, n_model=1):
    """yolo8_det's trainer at 64², B=4 (M 4, device augmentation and
    mosaic as shipped, synthetic data, f32), writing under ``root``; with
    ``n_model > 1`` on a model axis, evaluating every epoch."""
    from tpucv_torch.builder import export_from_registry

    cfg, _, cls = export_from_registry("yolo8_det")
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.zero_opt = zero_opt
    cfg.train.n_model = n_model
    if n_model > 1:
        cfg.train.eval_interval = 1
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


# ------------------------------------------------------------ model axis
class ShardNet(torch.nn.Module):
    """tpucv's ``test_channel_sharded_grads_match_single_device`` net
    (``tests/test_parallel.py:70-80``): a 1x1 conv to 64, ReLU, a 3x3 SAME
    conv to 128 (73,728 elements: the rule shards it), ReLU, a BatchNorm
    whose output is dropped (only its statistics move) and a 1x1 conv to
    1, flax's biases and BatchNorm (momentum 0.99, eps 1e-5); NHWC in and
    out."""

    def __init__(self):
        from tpucv_torch.nn.blocks import BatchNorm2d

        super().__init__()
        self.c0 = torch.nn.Conv2d(3, 64, 1)
        self.c1 = torch.nn.Conv2d(64, 128, 3, padding=1)
        self.bn = BatchNorm2d(128, eps=1e-5, momentum=0.01)
        self.c2 = torch.nn.Conv2d(128, 1, 1)

    def forward(self, x):
        x = torch.relu(self.c0(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.c1(x))
        self.bn(x)
        return self.c2(x).permute(0, 2, 3, 1)


def grouped_net(seed=0):
    """A ConvTranspose2d, a grouped conv and a grouped ConvTranspose2d,
    each of 73,728 elements (sharded), around a BatchNorm."""
    from tpucv_torch.nn.blocks import BatchNorm2d

    torch.manual_seed(seed)
    nn_ = torch.nn
    return NHWC(nn_.Conv2d(3, 64, 1),
                nn_.ConvTranspose2d(64, 128, 3, padding=1),
                BatchNorm2d(128, eps=1e-3, momentum=0.03), nn_.SiLU(),
                nn_.Conv2d(128, 256, 3, padding=1, groups=4),
                nn_.ConvTranspose2d(256, 128, 3, padding=1, groups=4),
                nn_.SiLU(), nn_.Conv2d(128, 4, 1))


def ckpt_net(seed=0):
    """A sharded 3x3 conv (73,728 elements), BatchNorm, ReLU, a 1x1 conv."""
    from tpucv_torch.nn.blocks import BatchNorm2d

    torch.manual_seed(seed)
    return NHWC(torch.nn.Conv2d(64, 128, 3, padding=1, bias=False),
                BatchNorm2d(128, eps=1e-3, momentum=0.03), torch.nn.ReLU(),
                torch.nn.Conv2d(128, 4, 1))


def sgd_state(model, lr=0.1):
    """tpucv's ``optax.sgd`` case: plain SGD, no EMA."""
    from tpucv_torch.train.state import TrainState

    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=lr)
    return TrainState(model, opt, lambda step: lr, None)


def case_shardnet(mesh, weights, x, y):
    """tpucv's channel-sharded case: one SGD step of ``ShardNet`` from
    ``weights`` on this rank's rows; the loss, the whole parameters after
    it and the names of the sharded kernels."""
    from tpucv_torch.parallel import mesh as pmesh
    from tpucv_torch.train.state import make_train_step

    model = ShardNet()
    model.load_state_dict(weights)
    pmesh.shard_model(model, mesh)
    rows = mesh.rows(x.shape[0])
    step = make_train_step(mse_mean, device="cpu", mixed_precision=False,
                           mesh=mesh)
    state, m = step(sgd_state(model), local({"images": x, "y": y}, rows))
    shards = pmesh.model_shards(model)
    return {"loss": float(m["loss"]), "sharded": sorted(shards),
            "params": pmesh.whole_tensors(
                {k: v.detach().clone() for k, v in
                 state.model.named_parameters()}, shards),
            "param_bytes": pmesh.param_bytes(model)}


def case_ckpt_layouts(mesh22, mesh41, tmp, one_ckpt):
    """Checkpoints across layouts: a (2, 2) ZeRO run of ``ckpt_net`` saved
    to ``mesh22.ckpt``, loaded under (4, 1) and saved again
    (``resaved41.ckpt``); the one-process bundle ``one_ckpt`` loaded under
    (2, 2), saved again (``resaved22.ckpt``) and one more step taken."""
    import torch.distributed as dist

    from tpucv_torch.ckpt.checkpoint import CheckPoint
    from tpucv_torch.parallel.mesh import shard_model

    tmp = Path(tmp)
    batch = tiny_batch(cin=64)
    state, snaps = run_steps(shard_model(ckpt_net(), mesh22),
                             local(batch, mesh22.rows(8)), mse_loss, 2,
                             mesh22, True)
    CheckPoint.save(state, str(tmp / "mesh22.ckpt"))
    dist.barrier()                       # rank 0 has written it
    fresh41, _ = run_steps(ckpt_net(seed=1), local(batch, mesh41.rows(8)),
                           mse_loss, 0, mesh41, True)
    CheckPoint.load(str(tmp / "mesh22.ckpt"), fresh41)
    CheckPoint.save(fresh41, str(tmp / "resaved41.ckpt"))
    fresh22, _ = run_steps(shard_model(ckpt_net(seed=1), mesh22),
                           local(batch, mesh22.rows(8)), mse_loss, 0,
                           mesh22, True)
    CheckPoint.load(one_ckpt, fresh22)
    CheckPoint.save(fresh22, str(tmp / "resaved22.ckpt"))
    _, after = run_steps_from(fresh22, local(batch, mesh22.rows(8)), mesh22)
    dist.barrier()
    return {"saved": snaps[-1], "after": after}


def case_model_axis(rank, world, tmp, shardnet, grouped_runs, one_ckpt,
                    families, trainer_root):
    """Every model-axis case in one world of four ranks: tpucv's
    channel-sharded net on a (2, 2) mesh, ``grouped_net`` on (2, 2) and
    (1, 4), the checkpoint layouts, on (2, 2) each ``(name, batch, steps,
    lr)`` of ``families``, and yolo8_det's trainer with ``n_model=2``
    under ``trainer_root``."""
    from tpucv_torch.parallel.mesh import DataMesh, shard_model

    torch.set_num_threads(1)
    meshes = {(2, 2): DataMesh.current(2), (1, 4): DataMesh.current(4),
              (4, 1): DataMesh.current(1)}
    m22 = meshes[(2, 2)]
    out = {"shardnet": case_shardnet(m22, **shardnet), "grouped": {}}
    batch = tiny_batch()
    for shape, steps in grouped_runs:
        mesh = meshes[shape]
        _, snaps = run_steps(shard_model(grouped_net(), mesh),
                             local(batch, mesh.rows(8)), mse_loss, steps,
                             mesh)
        out["grouped"][shape] = snaps
    out["ckpt"] = case_ckpt_layouts(m22, meshes[(4, 1)], tmp, one_ckpt)
    for name, fam_batch, steps, lr in families:
        model, loss_fn = detection_family(name)
        B = fam_batch["images"].shape[0]
        _, snaps = run_steps(shard_model(model, m22),
                             local(fam_batch, m22.rows(B)), loss_fn, steps,
                             m22, lr=lr, ema=0.99)
        out[name] = brief(snaps)
    t = trainer(trainer_root, n_model=2)
    state = t.train(max_steps=TRAINER_STEPS)
    out["trainer"] = {"sd": snapshot(state, {})["sd"], "step": state.step,
                      "evaluated": hasattr(t, "last_eval")}
    return out


# ---------------------------------------------------------------- spatial
class SpatialNet(torch.nn.Module):
    """tpucv's spatial-partitioning net (``tests/test_parallel.py:
    302-310``): a 3x3 stride-2 SAME conv to 8, ReLU, a 3x3 stride-2 SAME
    conv to 16, a 2x2 average pool and a 3x3 SAME conv to 16, flax's
    asymmetric SAME padding; NHWC in and out. ``forward(x, split)`` takes
    this rank's rows of the height (``split`` None: every row)."""

    def __init__(self, weights):
        super().__init__()
        for i in range(3):
            self.register_parameter(f"w{i}", torch.nn.Parameter(
                weights[f"Conv_{i}.weight"].clone()))
            self.register_parameter(f"b{i}", torch.nn.Parameter(
                weights[f"Conv_{i}.bias"].clone()))

    def forward(self, x, split=None):
        from tpucv_torch.parallel import spatial as sp

        x = x.permute(0, 3, 1, 2)
        H = x.shape[2] * (split.n if split is not None else 1)
        W = x.shape[3]
        for i, s in ((0, 2), (1, 2)):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            x = sp.conv2d(x, w, b, s, sp.same_padding(H, 3, s),
                          sp.same_padding(W, 3, s), split)
            H, W = H // 2, W // 2
            if i == 0:
                x = torch.relu(x)
        x = sp.avg_pool2d(x, 2, 2, split)
        H, W = H // 2, W // 2
        x = sp.conv2d(x, self.w2, self.b2, 1, sp.same_padding(H, 3, 1),
                      sp.same_padding(W, 3, 1), split)
        return x.permute(0, 2, 3, 1)


def yolo_spatial_model(sd):
    """YOLOv8n (nc 80) in train mode with the weights ``sd``."""
    from tpucv_torch.models.yolov8 import Yolo8

    model = Yolo8("n", nc=80)
    model.load_state_dict(sd)
    return model.train()


def maps_loss(out):
    """The mean square of every output map, summed."""
    return sum(o.square().mean() for o in out)


def spatial_run(model, x, mesh, loss_fn, forward):
    """``forward(model, rows, split)`` on this rank's rows of the batch
    (data axis) and of the height (model axis; ``mesh`` None: one process
    on everything), the outputs gathered, ``loss_fn`` of them, its
    gradients summed over the world: (loss, outputs, gradients, BatchNorm
    statistics)."""
    from tpucv_torch.parallel import mesh as pmesh
    from tpucv_torch.parallel import spatial as sp

    split = None if mesh is None else sp.HeightSplit.of(mesh)
    x = torch.from_numpy(np.ascontiguousarray(x))
    if mesh is not None:
        x = sp.split_height(x[mesh.rows(x.shape[0])], split, 1)
    out = forward(model, x, split)
    if mesh is not None:
        out = pmesh.gather_rows(sp.gather_height(out, split, 1), mesh)
    loss = loss_fn(out)
    loss.backward()
    if mesh is not None:
        pmesh.all_reduce_grads(model.parameters())
    outs = out if isinstance(out, (tuple, list)) else [out]
    return {"loss": float(loss), "out": [o.detach() for o in outs],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k}}


def spatial_net_forward(model, x, split):
    return model(x, split)


def yolo_forward(model, x, split):
    return model(x)


def case_spatial(mesh, spatial_weights, x, yolo_sd, yolo_x):
    """tpucv's spatial net and YOLOv8n (``enable_spatial``) with the
    height split over ``mesh``'s model axis."""
    from tpucv_torch.parallel.spatial import enable_spatial

    return {
        "net": spatial_run(SpatialNet(spatial_weights), x, mesh,
                           lambda o: o.square().sum(), spatial_net_forward),
        "yolo": spatial_run(enable_spatial(yolo_spatial_model(yolo_sd), mesh),
                            yolo_x, mesh, maps_loss, yolo_forward)}


def det_algo():
    """tpucv's batch-sharded inference case (``tests/test_parallel.py:
    332-365``): YOLOv8n at 64², nc 8, f32, ``pre_nms_topk`` 64,
    ``max_det`` 16, on the CPU."""
    from tpucv_torch.algorithms.yolov8 import YOLOv8
    from tpucv_torch.configs.model_cfgs import Yolo8DetConfig

    cfg = Yolo8DetConfig()
    cfg.dataset.input_size = 64
    cfg.train.mixed_precision = False
    cfg.decode.pre_nms_topk = 64
    cfg.decode.max_det = 16
    algo = YOLOv8(cfg, device="cpu")
    algo.nc = 8
    return algo


def case_sharded_infer(mesh, det_sd, imgs):
    """``sharded_infer`` of ``det_algo``'s infer function (conf 0.05) on
    ``imgs`` over ``mesh``'s data axis: the global outputs."""
    from tpucv_torch.parallel.mesh import sharded_infer

    algo = det_algo()
    model = algo.build_model()
    model.load_state_dict(det_sd)
    model.eval()
    out = sharded_infer(algo.make_infer_fn(conf_threshold=0.05), model,
                        torch.from_numpy(imgs), mesh)
    return [t.clone() for t in out]


def case_spatial_world(rank, world, shapes, spatial, det_sd, imgs):
    """Every case of ``tests/test_torch_spatial.py`` in one world: for
    each ``(n_data, n_model)`` of ``shapes`` the spatial cases and the
    batch-sharded inference."""
    from tpucv_torch.parallel.mesh import DataMesh

    torch.set_num_threads(1)
    out = {}
    for shape in shapes:
        mesh = DataMesh.current(shape[1])
        out[shape] = {"spatial": case_spatial(mesh, **spatial),
                      "infer": case_sharded_infer(mesh, det_sd, imgs)}
    return out
