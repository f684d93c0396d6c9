"""Train state and the train / eval step factories (counterpart of
``tpucv/train/state.py``).

Where tpucv threads a functional ``TrainState`` (params, batch_stats, the
optax state, EMA params) through one jitted step, the port holds the same
parts as objects that the step updates in place: the model (its
parameters and BatchNorm buffers), a ``torch.optim.Adam`` over the
trainable parameters with optax's defaults, and an EMA copy of those
parameters. On CUDA the forward runs under bf16 autocast, on the NHWC
images (a ``channels_last`` view for the network); the loss runs in f32.
No GradScaler: the step is bf16.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from tpucv_torch.algorithms.base import resolve_device
from tpucv_torch.configs.base import OptimizerCfg
from tpucv_torch.nn.blocks import seed_dropout
from tpucv_torch.train.schedules import Schedule, warmup_multistep

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# signature: loss_fn(raw_outputs, batch) -> (scalar, metrics dict)


class TrainState:
    """The model, Adam over its trainable parameters, the EMA of those
    parameters (or None) and the number of updates taken.

    The frozen DFL projection (``requires_grad=False``) is neither updated
    nor averaged. The EMA covers parameters only, not BatchNorm buffers, as
    tpucv's ``ema_params`` does."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, ema: Optional[Dict[str, torch.Tensor]]):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.ema = ema
        self.step = 0
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}

    @classmethod
    def create(cls, model: nn.Module, lr: Union[float, Schedule] = 1e-3,
               use_ema: bool = False,
               weight_decay: float = 0.0) -> "TrainState":
        """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8); ``lr``
        is a constant or a ``step -> lr`` schedule (``train.schedules``).
        ``weight_decay`` adds ``wd * p`` to each gradient before Adam, as
        ``optax.chain(optax.add_decayed_weights(wd), optax.adam(lr))``
        does."""
        schedule = lr if callable(lr) else (lambda step: lr)
        params = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=weight_decay)
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()
                if p.requires_grad} if use_ema else None)
        return cls(model, opt, schedule, ema)

    @classmethod
    def from_config(cls, model: nn.Module, opt: OptimizerCfg,
                    iters_per_epoch: int = 1) -> "TrainState":
        """The optimizer of a config's ``optimizer`` section, as tpucv's
        trainer builds it (``set_optimizer``): Adam at ``warmup_multistep``
        of ``lr`` (milestones in epochs of ``iters_per_epoch`` steps) with
        ``weight_decay``, and an EMA when ``ema_decay`` > 0; the train
        step takes ``opt.ema_decay``."""
        if opt.name != "adam":
            raise ValueError(f"optimizer {opt.name!r}: only adam is ported")
        schedule = warmup_multistep(
            opt.lr, opt.warmup_iters,
            [m * iters_per_epoch for m in opt.milestones], opt.gamma)
        return cls.create(model, schedule, use_ema=opt.ema_decay > 0,
                          weight_decay=opt.weight_decay)

    def apply_gradients(self, ema_decay: float = 0.0) -> None:
        """One Adam update at ``schedule(step)`` from the gradients in the
        parameters' ``.grad``, then the EMA ``e*d + p*(1-d)`` of the
        updated parameters."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        if self.ema is not None and ema_decay > 0:
            ema = list(self.ema.values())
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, list(self.params.values()),
                                    alpha=1.0 - ema_decay)
        self.step += 1


def forward(model: nn.Module, images: torch.Tensor,
            mixed_precision: bool) -> Tuple[torch.Tensor, ...]:
    """The network on NHWC images, under bf16 autocast when asked."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=mixed_precision):
        return model(images)


def _to(batch: Dict[str, torch.Tensor], dev: torch.device):
    return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


def _no_lap(stage: str) -> None:
    pass


def make_train_step(loss_fn: LossFn, device="cuda", ema_decay: float = 0.0,
                    grad_accum: int = 1, loss_batch_scaled: bool = False,
                    mixed_precision: Optional[bool] = None):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``images`` (B, H, W, 3) and whatever ``loss_fn`` reads;
    it is moved to ``device``, the device the state's model lives on.
    ``mixed_precision`` (default: on CUDA) runs the forward under bf16
    autocast.

    ``grad_accum``: G > 1 splits the batch into G sequential micro-batches,
    each forward and backward in turn, before the one optimizer update;
    the BatchNorm statistics thread through the micro-batches.
    ``loss_batch_scaled``: set True when ``loss_fn`` scales with the batch
    size (the YOLOv8 family's ``mean * B``): the micro-gradients are then
    summed and the logged loss is the sum, which is the gradient of one
    full-batch step. Otherwise both are averaged over G. Metrics are the
    mean over the micro-batches.

    Metrics (``loss`` and those of ``loss_fn``) are detached 0-d tensors on
    the device, so the step does not wait for the device.

    Dropout (``nn.blocks.StepDropout``) draws its mask from the seed
    ``state.step * G + i`` in micro-batch ``i``: a function of the step,
    as tpucv's ``fold_in(PRNGKey(0), step)`` is.

    ``step(state, batch, lap)`` calls ``lap(stage)`` as each stage ends:
    ``forward`` (the batch's move and ``zero_grad`` included), ``loss``,
    ``backward`` (each once a micro-batch) and ``optimizer_ema``. The
    bench's split of the step into stages times them with it.
    """
    dev = resolve_device(device)
    amp = dev.type == "cuda" if mixed_precision is None else mixed_precision

    def compute(model, mb, lap, seed):
        seed_dropout(model, seed)
        raw = forward(model, mb["images"], amp)
        lap("forward")
        loss, metrics = loss_fn(raw, mb)
        lap("loss")
        loss.backward()
        lap("backward")
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             lap: Callable[[str], None] = _no_lap):
        model = state.model.train()
        batch = _to(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum <= 1:
            loss, metrics = compute(model, batch, lap, state.step)
        else:
            G = grad_accum
            micro = [dict(zip(batch, parts)) for parts in
                     zip(*(v.chunk(G) for v in batch.values()))]
            losses, metricss = zip(*(
                compute(model, mb, lap, state.step * G + i)
                for i, mb in enumerate(micro)))
            losses = torch.stack(losses)
            if loss_batch_scaled:
                loss = losses.sum()
            else:
                grads = [p.grad for p in state.params.values()
                         if p.grad is not None]
                torch._foreach_div_(grads, G)
                loss = losses.mean()
            metrics = {k: torch.stack([m[k] for m in metricss]).mean()
                       for k in metricss[0]}
        state.apply_gradients(ema_decay)
        lap("optimizer_ema")
        metrics["loss"] = loss
        return state, metrics

    return step


def make_eval_step(loss_fn: LossFn, device="cuda",
                   mixed_precision: Optional[bool] = None):
    """Build ``step(state, batch) -> metrics``: the model in eval mode (its
    running BatchNorm statistics), no gradient, the loss and its metrics;
    the forward under bf16 autocast when ``mixed_precision`` (default: on
    CUDA)."""
    dev = resolve_device(device)
    amp = dev.type == "cuda" if mixed_precision is None else mixed_precision

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = _to(batch, dev)
        raw = forward(state.model.eval(), batch["images"], amp)
        loss, metrics = loss_fn(raw, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step
