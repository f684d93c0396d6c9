"""YOLOv8 detect network, plain PyTorch (ultralytics ``yolov8.yaml``,
23 layers: CSPDarknet with C2f, SPPF, PAN-FPN, the decoupled head), with
ultralytics' ``state_dict`` keys (``model.{i}...``, ``model.22.cv2.{lv}``,
``model.22.cv3.{lv}``, ``model.22.dfl.conv.weight``).

Takes NHWC images in [0, 1] and returns the head's raw maps NHWC
``(B, H/s, W/s, 4*reg_max + nc)`` for s = 8, 16, 32. Departures from the
published network are those of ``reference.nn`` (BatchNorm's running
variance); the DFL projection is kept as the frozen 1x1 conv ultralytics
keeps, and the decode projects with ``arange(reg_max)`` itself.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.nn import (C2f, Conv2d, ConvBnAct, SPPF,
                                    upsample2x)

# depth, width, max channels (ultralytics' scales)
SCALES = {"n": (1 / 3, 0.25, 1024), "s": (1 / 3, 0.50, 1024),
          "m": (2 / 3, 0.75, 768), "l": (1.0, 1.0, 512),
          "x": (1.0, 1.25, 512)}


class DFL(nn.Module):
    def __init__(self, reg_max: int):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)


class Detect(nn.Module):
    def __init__(self, nc: int, reg_max: int, ch):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))

        def branch(c, mid, out):
            return nn.Sequential(ConvBnAct(c, mid, 3), ConvBnAct(mid, mid, 3),
                                 Conv2d(mid, out, 1))

        self.cv2 = nn.ModuleList(branch(c, c2, 4 * reg_max) for c in ch)
        self.cv3 = nn.ModuleList(branch(c, c3, nc) for c in ch)
        self.dfl = DFL(reg_max)

    def forward(self, feats):
        return tuple(torch.cat([b(x), c(x)], 1).permute(0, 2, 3, 1)
                     for x, b, c in zip(feats, self.cv2, self.cv3))


class YOLOv8(nn.Module):
    def __init__(self, scale: str = "l", nc: int = 80, reg_max: int = 16):
        super().__init__()
        d, w, mc = SCALES[scale]

        def c(ch):
            return int(math.ceil(min(ch, mc) * w / 8) * 8)

        def n(k):
            return max(round(k * d), 1)

        self.nc, self.reg_max, self.strides = nc, reg_max, (8, 16, 32)
        none = nn.Identity
        self.model = nn.ModuleList([
            ConvBnAct(3, c(64), 3, 2), ConvBnAct(c(64), c(128), 3, 2),
            C2f(c(128), c(128), n(3), True), ConvBnAct(c(128), c(256), 3, 2),
            C2f(c(256), c(256), n(6), True), ConvBnAct(c(256), c(512), 3, 2),
            C2f(c(512), c(512), n(6), True),
            ConvBnAct(c(512), c(1024), 3, 2),
            C2f(c(1024), c(1024), n(3), True), SPPF(c(1024), c(1024)),
            none(), none(), C2f(c(1024) + c(512), c(512), n(3), False),
            none(), none(), C2f(c(512) + c(256), c(256), n(3), False),
            ConvBnAct(c(256), c(256), 3, 2), none(),
            C2f(c(256) + c(512), c(512), n(3), False),
            ConvBnAct(c(512), c(512), 3, 2), none(),
            C2f(c(512) + c(1024), c(1024), n(3), False),
            Detect(nc, reg_max, (c(256), c(512), c(1024))),
        ])

    def forward(self, images: torch.Tensor, recompute: bool = False):
        """``recompute``: keep only each layer's output for the backward
        and run the layer again there (``torch.utils.checkpoint``), so a
        batch of 64 at 640² fits the card in float32."""
        m = self.model

        def run(i, *xs):
            if recompute and torch.is_grad_enabled():
                return checkpoint(m[i], *xs, use_reentrant=False)
            return m[i](*xs)

        x = images.permute(0, 3, 1, 2)
        for i in range(4):
            x = run(i, x)
        p3 = run(4, x)
        p4 = run(6, run(5, p3))
        p5 = run(9, run(8, run(7, p4)))
        h12 = run(12, torch.cat([upsample2x(p5), p4], 1))
        h15 = run(15, torch.cat([upsample2x(h12), p3], 1))
        h18 = run(18, torch.cat([run(16, h15), h12], 1))
        h21 = run(21, torch.cat([run(19, h18), p5], 1))
        head = m[22]
        return tuple(
            torch.cat([run_seq(b, x, recompute), run_seq(c, x, recompute)],
                      1).permute(0, 2, 3, 1)
            for x, b, c in zip((h15, h18, h21), head.cv2, head.cv3))


def run_seq(seq: nn.Module, x: torch.Tensor, recompute: bool):
    if recompute and torch.is_grad_enabled():
        return checkpoint(seq, x, use_reentrant=False)
    return seq(x)
