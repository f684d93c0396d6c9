"""YOLOv3 (counterpart of ``tpucv/models/yolov3.py``; legacy and
unregistered, as in tpucv and its reference).

Darknet-53: ``DarkConv`` (conv without bias, BatchNorm, leaky ReLU 0.1),
stride-2 convs padded one row and column at the top and left only (the
reference's ``ZeroPad2d((1, 0, 1, 0))`` and a valid conv), residual blocks
of a 1x1 halving conv and a 3x3 conv, then three FPN-style YOLO blocks
whose 1x1 biased convs give the raw maps of strides 32, 16 and 8.

tpucv has no importer for YOLOv3, so the port keeps tpucv's flax names
(``c0``, ``down{s}``, ``res{s}_{r}/cv{1,2}``, ``y{5,4,3}_{a,b}{0,1}``,
``y*_c``, ``y*_d``, ``y*_out``, ``up5``, ``up4``; each ``DarkConv`` holds
``conv`` and ``bn``), and ``ckpt.convert.from_flax_variables`` carries a
tpucv tree in as it is. BatchNorm takes flax's momentum 0.9 (the port's
0.1) and eps 1e-5, with flax's running statistics (``nn.blocks.
BatchNorm2d``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import BatchNorm2d, init_weights, upsample2x

#: Darknet-53's stages: (width, residual blocks)
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


class DarkConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int = 3, s: int = 1):
        super().__init__()
        self.s = s
        self.conv = nn.Conv2d(in_ch, out_ch, k, s,
                              0 if s == 2 else k // 2, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s == 2:
            x = F.pad(x, (1, 0, 1, 0))
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class Residual(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.cv1 = DarkConv(ch, ch // 2, 1)
        self.cv2 = DarkConv(ch // 2, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.cv2(self.cv1(x))


class YoloV3(nn.Module):
    """Darknet-53 YOLOv3. ``forward`` maps (B, S, S, 3) NHWC images to the
    NHWC raw maps ``((B, S/32, S/32, na*(5+nc)), S/16, S/8)``."""

    def __init__(self, nc: int = 80, na: int = 3):
        super().__init__()
        self.nc, self.na = nc, na
        self.c0 = DarkConv(3, 32, 3)
        prev = 32
        for si, (ch, nres) in enumerate(STAGES):
            setattr(self, f"down{si}", DarkConv(prev, ch, 3, 2))
            for ri in range(nres):
                setattr(self, f"res{si}_{ri}", Residual(ch))
            prev = ch
        no = na * (5 + nc)
        for name, cin, ch in (("y5", 1024, 512), ("y4", 256 + 512, 256),
                              ("y3", 128 + 256, 128)):
            for i in range(2):
                setattr(self, f"{name}_a{i}",
                        DarkConv(cin if i == 0 else ch * 2, ch, 1))
                setattr(self, f"{name}_b{i}", DarkConv(ch, ch * 2, 3))
            setattr(self, f"{name}_c", DarkConv(ch * 2, ch, 1))
            setattr(self, f"{name}_d", DarkConv(ch, ch * 2, 3))
            setattr(self, f"{name}_out", nn.Conv2d(ch * 2, no, 1))
        self.up5 = DarkConv(512, 256, 1)
        self.up4 = DarkConv(256, 128, 1)

    def reset_parameters(self, generator: torch.Generator) -> "YoloV3":
        """Random weights drawn from ``generator`` (``init_weights``)."""
        init_weights(self, generator)
        return self

    def _block(self, x: torch.Tensor, name: str):
        g = lambda part: getattr(self, f"{name}_{part}")   # noqa: E731
        for i in range(2):
            x = g(f"b{i}")(g(f"a{i}")(x))
        branch = g("c")(x)
        return branch, g("out")(g("d")(branch))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.c0(x.permute(0, 3, 1, 2))          # NHWC -> NCHW view
        feats = {}
        for si, (ch, nres) in enumerate(STAGES):
            x = getattr(self, f"down{si}")(x)
            for ri in range(nres):
                x = getattr(self, f"res{si}_{ri}")(x)
            feats[ch] = x
        b5, o5 = self._block(feats[1024], "y5")
        up = upsample2x(self.up5(b5))
        b4, o4 = self._block(torch.cat([up, feats[512]], 1), "y4")
        up = upsample2x(self.up4(b4))
        _, o3 = self._block(torch.cat([up, feats[256]], 1), "y3")
        return tuple(o.permute(0, 2, 3, 1) for o in (o5, o4, o3))
