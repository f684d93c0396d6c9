"""YOLOv8 detection network, n/s/m/l/x (counterpart of
``tpucv/models/yolov8.py``).

The graph is ultralytics' 23-layer CSPDarknet + C2f + SPPF backbone and
PAN-FPN head, kept as ``self.model[0..22]`` so ``state_dict`` keys are the
ultralytics ones (``model.{i}...``, ``model.22.cv2.{lv}...``). The forward
takes tpucv's NHWC input and returns tpucv's NHWC raw maps; inside it runs
NCHW modules on a ``channels_last`` tensor, so both permutes are views.
Scaling follows ultralytics: n has 3,157,200 parameters at nc=80.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tpucv_torch.nn.blocks import (C2f, Concat, ConvBnAct, SPPF, Upsample,
                                   init_weights)
from tpucv_torch.nn.heads import DetectHead

# (depth_multiple, width_multiple, max_channels) per model scale
SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}


def _c(ch: int, width: float, max_ch: int) -> int:
    """Scaled channel count, rounded to a multiple of 8 (ultralytics rule)."""
    return int(math.ceil(min(ch, max_ch) * width / 8) * 8)


def _n(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class Yolo8(nn.Module):
    """YOLOv8 backbone + PAN-FPN + decoupled detect head.

    ``forward`` maps (B, H, W, 3) images to raw maps
    ``((B, H/8, W/8, no), (B, H/16, W/16, no), (B, H/32, W/32, no))``,
    ``no = 4*reg_max + nc``.
    """

    def __init__(self, scale: str = "n", nc: int = 80, reg_max: int = 16):
        super().__init__()
        d, w, mc = SCALES[scale]
        c = lambda ch: _c(ch, w, mc)          # noqa: E731
        n = lambda k: _n(k, d)                # noqa: E731
        self.scale, self.nc, self.reg_max = scale, nc, reg_max
        self.model = nn.ModuleList([
            ConvBnAct(3, c(64), 3, 2),                          # 0  P1/2
            ConvBnAct(c(64), c(128), 3, 2),                     # 1  P2/4
            C2f(c(128), c(128), n(3), True),                    # 2
            ConvBnAct(c(128), c(256), 3, 2),                    # 3  P3/8
            C2f(c(256), c(256), n(6), True),                    # 4
            ConvBnAct(c(256), c(512), 3, 2),                    # 5  P4/16
            C2f(c(512), c(512), n(6), True),                    # 6
            ConvBnAct(c(512), c(1024), 3, 2),                   # 7  P5/32
            C2f(c(1024), c(1024), n(3), True),                  # 8
            SPPF(c(1024), c(1024), 5),                          # 9
            Upsample(),                                         # 10
            Concat(),                                           # 11
            C2f(c(1024) + c(512), c(512), n(3), False),         # 12
            Upsample(),                                         # 13
            Concat(),                                           # 14
            C2f(c(512) + c(256), c(256), n(3), False),          # 15 P3 out
            ConvBnAct(c(256), c(256), 3, 2),                    # 16
            Concat(),                                           # 17
            C2f(c(256) + c(512), c(512), n(3), False),          # 18 P4 out
            ConvBnAct(c(512), c(512), 3, 2),                    # 19
            Concat(),                                           # 20
            C2f(c(512) + c(1024), c(1024), n(3), False),        # 21 P5 out
            DetectHead(nc, reg_max, (8, 16, 32),
                       (c(256), c(512), c(1024))),              # 22
        ])

    def reset_parameters(self, generator: torch.Generator) -> "Yolo8":
        """Random weights drawn from ``generator`` (see ``init_weights``),
        then the head's bias init and frozen DFL projection."""
        init_weights(self, generator)
        self.model[22].reset_biases()
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        m = self.model
        x = x.permute(0, 3, 1, 2)                # NHWC -> NCHW view
        for i in range(4):
            x = m[i](x)
        p3 = m[4](x)
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        h12 = m[12](m[11]([m[10](p5), p4]))
        h15 = m[15](m[14]([m[13](h12), p3]))
        h18 = m[18](m[17]([m[16](h15), h12]))
        h21 = m[21](m[20]([m[19](h18), p5]))
        return m[22]([h15, h18, h21])


def build_yolo8(scale: str, nc: int = 80) -> Yolo8:
    return Yolo8(scale=scale, nc=nc)


def get_yolo8_n(nc: int = 80) -> Yolo8:
    return build_yolo8("n", nc)


def get_yolo8_s(nc: int = 80) -> Yolo8:
    return build_yolo8("s", nc)


def get_yolo8_m(nc: int = 80) -> Yolo8:
    return build_yolo8("m", nc)


def get_yolo8_l(nc: int = 80) -> Yolo8:
    return build_yolo8("l", nc)


def get_yolo8_x(nc: int = 80) -> Yolo8:
    return build_yolo8("x", nc)
