"""FLOPs of the reference at a configuration's shapes, counted once by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only, nothing computed) and stored in the configuration file:

- ``forward_per_image``: the network's forward on one image;
- ``train_step_per_image``: the forward, YOLOv8's loss and the backward
  (input gradients where a weight needs them, weight gradients), on one
  image of a batch.

    python -m benchmark.flops yolov8l-coco640      # prints both counts
"""

from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, reference
from benchmark.reference.loss import yolov8_loss

BATCH = 2


def count(cfg: dict, size: int) -> dict:
    net_cfg = cfg["network"]
    with torch.device("meta"):
        net = reference.build(cfg)
        x = torch.empty(BATCH, size, size, 3)
        M = cfg["max_num_boxes"]
        gt = (torch.zeros(BATCH, M, dtype=torch.long),
              torch.empty(BATCH, M, 4),
              torch.zeros(BATCH, M, dtype=torch.bool))
    out = {}
    net.eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(x)
    out["forward_per_image"] = fc.get_total_flops() // BATCH
    if net_cfg["family"] == "yolov8":
        net.train()
        with FlopCounterMode(display=False) as fc:
            loss = yolov8_loss(net(x), *gt, nc=net_cfg["nc"],
                               reg_max=net_cfg["reg_max"],
                               strides=tuple(net_cfg["strides"]),
                               **cfg["loss"])
            loss.backward()
        out["train_step_per_image"] = fc.get_total_flops() // BATCH
    return out


if __name__ == "__main__":
    cfg = common.load_json("configs", sys.argv[1])
    print(count(cfg, cfg["input_size"]))
