"""Detection head (counterpart of ``tpucv/nn/heads.py``).

The head is a pure network: it returns per-level raw maps in tpucv's
layout ``(B, H, W, 4*reg_max+nc)``; anchors, the DFL expectation and
dist2bbox live in ``tpucv_torch.decode``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from tpucv_torch.nn.blocks import ConvBnAct


class DFL(nn.Module):
    """The frozen DFL projection, kept as ultralytics keeps it (a 1x1 conv
    weight ``arange(reg_max)`` that never trains) so parameter counts and
    ``state_dict`` keys match the published model. Decode projects with
    :func:`dfl_project` and does not read it."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(
                self.conv.in_channels, dtype=torch.float32).view(1, -1, 1, 1))


class DetectHead(nn.Module):
    """YOLOv8 decoupled anchor-free head. Per level: a box branch (two 3x3
    ConvBnAct + 1x1 conv -> 4*reg_max) and a class branch (two 3x3
    ConvBnAct + 1x1 conv -> nc). ``reset_biases`` sets box bias 1.0 and
    class bias log(5/nc/(640/stride)^2), as tpucv and the reference do."""

    def __init__(self, nc: int = 80, reg_max: int = 16,
                 strides: Tuple[int, ...] = (8, 16, 32),
                 ch: Sequence[int] = (64, 128, 256)):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBnAct(x, c2, 3), ConvBnAct(c2, c2, 3),
                          nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBnAct(x, c3, 3), ConvBnAct(c3, c3, 3),
                          nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(reg_max)
        self.reset_biases()

    def reset_biases(self) -> None:
        with torch.no_grad():
            for b, c, s in zip(self.cv2, self.cv3, self.strides):
                b[-1].bias.fill_(1.0)
                c[-1].bias.fill_(math.log(5.0 / self.nc / (640.0 / s) ** 2))
        self.dfl.reset_parameters()

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """NCHW feature maps -> NHWC raw maps (views, no copy on a
        channels_last input)."""
        return tuple(
            torch.cat([b(x), c(x)], 1).permute(0, 2, 3, 1)
            for x, b, c in zip(feats, self.cv2, self.cv3))


def dfl_project(box_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-Focal-Loss expectation decode in f32.

    box_dist: (..., 4*reg_max) raw distances -> (..., 4) expected l/t/r/b
    distances in stride units."""
    x = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max)
    x = torch.softmax(x.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return x @ proj
