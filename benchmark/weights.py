"""Weights made on the device from the seed, for the program and the
reference alike.

Every convolution kernel is drawn LeCun-normal (std 1/sqrt(fan in)) from
one ``torch.randn`` call on the device; conv biases are 0, BatchNorm is
the identity (weight 1, bias 0, running mean 0, running variance 1), the
DFL projection is ``arange(reg_max)``. Then the configuration's rules set
biases and BatchNorm weights (``weights.train`` or ``weights.detect`` in
its file), each {"match": a glob over ``state_dict`` keys, "fill": the
value}.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict, List

import torch


def make(names_shapes: Dict[str, torch.Size], seed: int, rules: List[dict],
         device) -> Dict[str, torch.Tensor]:
    """A float32 ``state_dict`` for the keys and shapes given."""
    dev = torch.device(device)
    kernels = [k for k, s in names_shapes.items()
               if len(s) == 4 and not k.endswith("dfl.conv.weight")]
    total = sum(math.prod(names_shapes[k]) for k in kernels)
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=dev)
    out, at = {}, 0
    for k in kernels:
        shape = names_shapes[k]
        n = math.prod(shape)
        out[k] = flat[at:at + n].view(shape).mul_(
            1.0 / math.sqrt(math.prod(shape[1:])))
        at += n
    for k, shape in names_shapes.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if k.endswith("dfl.conv.weight"):
            out[k] = torch.arange(shape[1], dtype=torch.float32,
                                  device=dev).view(shape)
        elif leaf == "num_batches_tracked":
            out[k] = torch.zeros(shape, dtype=torch.long, device=dev)
        elif leaf in ("running_var",) or (leaf == "weight" and len(shape) == 1):
            out[k] = torch.ones(shape, device=dev)
        else:                      # biases, BatchNorm bias, running mean
            out[k] = torch.zeros(shape, device=dev)
    for rule in rules:
        hits = [k for k in out if fnmatch.fnmatchcase(k, rule["match"])]
        if not hits:
            raise ValueError(f"weight rule {rule} matches no key")
        for k in hits:
            out[k].fill_(float(rule["fill"]))
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, torch.Size]:
    """Keys and shapes of a module's ``state_dict`` (a module on the meta
    device costs nothing to build)."""
    return {k: v.shape for k, v in module.state_dict().items()}



def normalize_outputs(cfg: dict, state: Dict[str, torch.Tensor], seed: int,
                      device, size: int, targets: List[dict]) -> None:
    """Scale output convs so that their logits have a set spread whatever
    the seed: one float32 eval-mode forward of the reference over two
    images uniform in [0, 1) at ``size``² drawn from the seed, then each
    target {"output": level, "channels": [lo, hi], "weight": key, "bias":
    key, "std": s} has ``weight`` scaled so that the level's channels
    lo..hi, less their bias, have standard deviation s. Nothing of the
    program takes part."""
    from benchmark import reference
    from benchmark.reference.nn import fp32

    dev = torch.device(device)
    with torch.device(dev):
        net = reference.build(cfg)
    net.load_state_dict(state)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.rand((2, size, size, 3), generator=g, device=dev)
    with torch.no_grad(), fp32():
        raw = net.eval()(x)
    for t in targets:
        lo, hi = t["channels"]
        logits = raw[t["output"]][..., lo:hi] - state[t["bias"]][None, None,
                                                                  None]
        state[t["weight"]].mul_(t["std"] / float(logits.std()))
