"""One training run of the reference: the network in train mode on the
global batch, YOLOv8's loss, the backward, and Adam (b1 0.9, b2 0.999,
eps 1e-8, no weight decay) at the linear warm-up's rate, lr ·
min((t + 1) / warmup, 1) at update t = 0, 1, ... (the configuration ships
no EMA: ``ema_decay`` 0). float32, TF32 off; each layer's activations
are recomputed in the backward (``torch.utils.checkpoint``), which
changes no value.

``run`` takes the starting weights and the batches and returns what the
benchmark compares: each step's loss, the gradient of the first step,
and the weights and BatchNorm statistics after the steps it is asked to
keep (by default the last).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference.loss import yolov8_loss
from benchmark.reference.nn import arm_batchnorm, fp32, set_precision


def lr_at(t: int, lr: float, warmup: int) -> float:
    return lr * min((t + 1.0) / max(warmup, 1), 1.0)


def run(model: torch.nn.Module, state: Dict[str, torch.Tensor],
        batches: List[Dict[str, torch.Tensor]], loss_kw: dict,
        lr: float, warmup: int, prec: str = "f32",
        keep: Sequence[int] = ()) -> dict:
    """``model`` (a reference network on the device) loaded with ``state``
    and trained on ``batches`` (images NHWC in [0, 1], gt_labels,
    gt_bboxes xyxy px, gt_mask). Returns {"losses", "grads" (step 1),
    "states" ({t: the state after t steps} for each t of ``keep`` and the
    last)}, tensors on the device."""
    model.load_state_dict(state)
    model.train()
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grads, states = [], None, {}
    keep = set(keep) | {len(batches)}
    set_precision(model, prec)
    with fp32():
        for t, batch in enumerate(batches):
            arm_batchnorm(model)
            for p in params.values():
                p.grad = None
            raw = model(batch["images"].float(), recompute=True)
            loss = yolov8_loss(raw, batch["gt_labels"], batch["gt_bboxes"],
                               batch["gt_mask"], **loss_kw)
            loss.backward()
            losses.append(float(loss.detach()))
            if grads is None:
                grads = {n: p.grad.detach().clone()
                         for n, p in params.items()}
            lr_t = lr_at(t, lr, warmup)
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            with torch.no_grad():
                for n, p in params.items():
                    g = p.grad
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(c2)).add_(eps)
                    p.addcdiv_(m[n], denom, value=-lr_t / c1)
            if t + 1 in keep:
                states[t + 1] = {k: x.detach().clone()
                                 for k, x in model.state_dict().items()}
    set_precision(model, "f32")
    return {"losses": losses, "grads": grads, "states": states}
