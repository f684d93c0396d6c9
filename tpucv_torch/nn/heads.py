"""Detection, segment, pose and classify heads (counterpart of
``tpucv/nn/heads.py``).

The heads are pure networks: they return per-level raw maps in tpucv's
layout ``(B, H, W, 4*reg_max+nc)`` (NHWC); anchors, the DFL expectation
and dist2bbox live in ``tpucv_torch.decode``. ``SegmentHead`` and
``PoseHead`` subclass ``DetectHead`` as ultralytics' ``Segment`` and
``Pose`` subclass ``Detect``, so their ``state_dict`` keys are
``cv2.*``, ``cv3.*``, ``cv4.*``, ``dfl.*`` (and ``proto.*``).
``ClassifyHead`` is ultralytics' ``Classify``: ``conv.*`` and ``linear.*``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from tpucv_torch.nn.blocks import ConvBnAct, Proto


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


def _branches(ch: Sequence[int], mid: int, out: int) -> nn.ModuleList:
    """Per level: two 3x3 ConvBnAct and a 1x1 conv with a bias."""
    return nn.ModuleList(
        nn.Sequential(ConvBnAct(x, mid, 3), ConvBnAct(mid, mid, 3),
                      nn.Conv2d(mid, out, 1)) for x in ch)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC, a view (no copy on a channels_last input)."""
    return x.permute(0, 2, 3, 1)


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
        self.cv2 = _branches(ch, c2, 4 * reg_max)
        self.cv3 = _branches(ch, c3, nc)
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
        return tuple(_nhwc(torch.cat([b(x), c(x)], 1))
                     for x, b, c in zip(feats, self.cv2, self.cv3))


class SegmentHead(DetectHead):
    """Detect + per-level mask-coefficient branches (``cv4``, width
    ``max(ch[0] // 4, n_masks)``) + ``Proto`` on the P3 level.

    ``forward`` returns ``(det_maps, coef_maps, protos)``: the detect maps,
    per-level (B, H, W, n_masks) coefficients and (B, 2*H3, 2*W3, n_masks)
    prototypes, all NHWC."""

    def __init__(self, nc: int = 80, n_masks: int = 32, proto_ch: int = 256,
                 reg_max: int = 16, strides: Tuple[int, ...] = (8, 16, 32),
                 ch: Sequence[int] = (64, 128, 256)):
        super().__init__(nc, reg_max, strides, ch)
        self.cv4 = _branches(ch, max(ch[0] // 4, n_masks), n_masks)
        self.proto = Proto(ch[0], proto_ch, n_masks)

    def forward(self, feats: Sequence[torch.Tensor]):
        det = super().forward(feats)
        coefs = tuple(_nhwc(c(x)) for x, c in zip(feats, self.cv4))
        return det, coefs, _nhwc(self.proto(feats[0]))


class PoseHead(DetectHead):
    """Detect + per-level keypoint branches (``cv4``, width
    ``max(ch[0] // 4, nk)``, nk = kpt_shape[0] * kpt_shape[1]).

    ``forward`` returns ``(det_maps, kpt_maps)``, per-level
    (B, H, W, nk) raw keypoints, all NHWC."""

    def __init__(self, nc: int = 1, kpt_shape: Tuple[int, int] = (17, 3),
                 reg_max: int = 16, strides: Tuple[int, ...] = (8, 16, 32),
                 ch: Sequence[int] = (64, 128, 256)):
        super().__init__(nc, reg_max, strides, ch)
        nk = kpt_shape[0] * kpt_shape[1]
        self.cv4 = _branches(ch, max(ch[0] // 4, nk), nk)

    def forward(self, feats: Sequence[torch.Tensor]):
        det = super().forward(feats)
        return det, tuple(_nhwc(c(x)) for x, c in zip(feats, self.cv4))


class ClassifyHead(nn.Module):
    """Image classification head (tpucv's ``ClassifyHead``, ultralytics'
    ``Classify``): a 1x1 ``ConvBnAct`` to ``mid_ch``, the mean over H and
    W, and a ``Linear`` to ``nc``. Returns the logits (B, nc), not their
    softmax."""

    def __init__(self, in_ch: int, nc: int = 1000, mid_ch: int = 1280):
        super().__init__()
        self.conv = ConvBnAct(in_ch, mid_ch, 1)
        self.linear = nn.Linear(mid_ch, nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.conv(x).mean(dim=(2, 3)))


def dfl_project(box_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-Focal-Loss expectation decode in f32.

    box_dist: (..., 4*reg_max) raw distances -> (..., 4) expected l/t/r/b
    distances in stride units."""
    x = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max)
    x = torch.softmax(x.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return x @ proj
