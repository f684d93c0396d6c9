"""FLOPs of the segmentation reference (``reference/deeplabv3plus.py``) at a
configuration's input size, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only) and stored in the configuration file:

- ``forward_per_image``: the eval-mode forward on one image;
- ``train_step_per_image``: the train-mode forward, the focal loss and
  the backward, on one image of a batch.

    python -m benchmark.flops_seg deeplabv3plus-r101-voc513   # prints both

The dropout's mask costs no counted operation, and the meta device draws
no random numbers, so the count runs the network without it.
"""

from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common
from benchmark.reference import deeplabv3plus as ref

BATCH = 2


def count(cfg: dict, size: int) -> dict:
    loss = cfg["loss"]
    with torch.device("meta"):
        net = ref.build(dict(cfg["network"], aspp_dropout=0.0))
        x = torch.empty(BATCH, size, size, 3)
        labels = torch.zeros(BATCH, size, size, dtype=torch.int32)
    out = {}
    net.eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(x)
    out["forward_per_image"] = fc.get_total_flops() // BATCH
    net.train()
    with FlopCounterMode(display=False) as fc:
        ref.focal_loss(net(x), labels, loss["alpha"], loss["gamma"],
                       loss["ignore_index"]).backward()
    out["train_step_per_image"] = fc.get_total_flops() // BATCH
    return out


if __name__ == "__main__":
    cfg = common.load_json("configs", sys.argv[1])
    print(count(cfg, cfg["input_size"]))
