"""Core convolutional blocks (counterpart of ``tpucv/nn/blocks.py``).

The blocks are NCHW ``nn.Module``s, PyTorch's idiom; ``Yolo8`` is where
tpucv's NHWC layout meets them, and on the card it runs them in the
``channels_last`` memory format, which is NHWC in memory. Submodule names
follow ultralytics (``conv``/``bn``, ``cv1``/``cv2``, ``m.{i}``), so a
``state_dict`` carries ultralytics key names. BatchNorm uses eps 1e-3 and
momentum 0.03, as tpucv and the reference do, and in train mode keeps
flax's running statistics (:class:`BatchNorm2d`).

Only the float path of ``tpucv.quant.conv_bn`` is here; int8 PTQ is later
work.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """Same-shape padding for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode keeps flax's running statistics.

    flax's ``nn.BatchNorm`` (tpucv's) folds the biased batch variance into
    its running variance; ``nn.BatchNorm2d`` folds the unbiased one, so the
    two drift apart a little on every step. Here train mode normalises with
    the biased batch statistics, as both do, and then updates
    ``running = (1 - m) * running + m * stat`` with the biased variance.
    The variance comes back from the fused kernel's saved inverse standard
    deviation, ``var = invstd**-2 - eps``, so no extra pass reads the
    input. Eval mode, the keys and the ``state_dict`` are
    ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).float()
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class ConvBnAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, s, autopad(k, p, d),
                              dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Standard bottleneck: two convs and an optional residual."""

    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True,
                 g: int = 1, k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBnAct(in_ch, c_, k[0], 1)
        self.cv2 = ConvBnAct(c_, out_ch, k[1], 1, g=g)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions, fast: cv1 projects to 2c hidden
    channels split in two, n bottlenecks chain off the second half, and
    every part concatenates into cv2."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(out_ch * e)
        self.cv1 = ConvBnAct(in_ch, 2 * self.c, 1, 1)
        self.cv2 = ConvBnAct((2 + n) * self.c, out_ch, 1, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts: List[torch.Tensor] = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


def max_pool_same(x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """k x k max pool, stride s, symmetric k//2 padding (NCHW)."""
    return F.max_pool2d(x, k, s, k // 2)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained k x k max pools."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 5):
        super().__init__()
        c_ = in_ch // 2
        self.cv1 = ConvBnAct(in_ch, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * 4, out_ch, 1, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y1 = max_pool_same(y, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([y, y1, y2, y3], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Upsample(nn.Module):
    """Parameter-free graph node for ``upsample2x`` (ultralytics layers 10
    and 13), so layer indices match the reference graph."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x)


class Concat(nn.Module):
    """Parameter-free channel concat node (ultralytics layers 11, 14, 17,
    20)."""

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, 1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv weight from ``generator`` with LeCun-normal scale
    (std = 1/sqrt(fan_in), flax's default conv init) and reset BatchNorm to
    the identity. Conv biases are left to their owner (``DetectHead``
    overwrites its own)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
