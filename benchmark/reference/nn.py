"""Plain building blocks of the reference networks: conv + BatchNorm + SiLU
and the YOLO blocks built from it, in float32 on ``torch.nn.functional``.

Submodule names follow ultralytics (``conv`` / ``bn``, ``cv1`` / ``cv2``,
``m.{i}``), so a ``state_dict`` has the keys of the measured program's
networks and one set of weights loads into both.

Departures from the published networks, all shared with the program:

- BatchNorm uses eps 1e-3 and momentum 0.03, and in train mode folds the
  biased batch variance into its running variance (flax's rule; PyTorch's
  ``nn.BatchNorm2d`` folds the unbiased one). Over the >= 6,400 values a
  channel has at the benchmark's sizes the two differ by under 2e-4.
- Each BatchNorm updates its running statistics once a step: a layer that
  ``torch.utils.checkpoint`` runs again in the backward does not update
  them a second time (``arm_batchnorm``).

``set_precision`` selects the arithmetic of a network's convolutions:
``"f32"`` (the reference; TF32 is off while the reference runs, see
``fp32``) or ``"fp8"``, where both operands of each convolution and its
result are rounded to float8 e4m3, each with a per-tensor scale, around
the float32 product: the control of a configuration that states
bfloat16, whose autocast rounds a convolution's operands and result to
bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
FP8_MAX = 448.0                 # largest finite float8 e4m3 value



def _precision_flags():
    """The float32 precision switches of matrix products and convolutions:
    PyTorch's ``fp32_precision`` where it has them ("ieee" turns TF32
    off; ``allow_tf32 = False`` sets them to "none", which defers to a
    default), else the ``allow_tf32`` flags."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    if hasattr(cuda, "fp32_precision") and hasattr(cudnn, "conv"):
        return [(cuda, "fp32_precision", "ieee"),
                (cudnn.conv, "fp32_precision", "ieee")]
    return [(cuda, "allow_tf32", False), (cudnn, "allow_tf32", False)]


@contextlib.contextmanager
def fp32():
    """float32 matrix products and convolutions without TF32."""
    flags = _precision_flags()
    old = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, old):
            setattr(obj, name, value)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in float32; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def set_precision(model: nn.Module, name: str) -> None:
    """Run ``model``'s convolutions in ``name``: "f32" or "fp8"."""
    if name not in ("f32", "fp8"):
        raise ValueError(f"precision {name!r}")
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.fp8 = name == "fp8"


class BatchNorm(nn.BatchNorm2d):
    """Batch statistics in train mode (biased variance, updating the
    running statistics once a step); running statistics in eval mode."""

    fresh = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean((0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
        if self.fresh:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
            self.fresh = False
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
                * self.weight[None, :, None, None]
                + self.bias[None, :, None, None])


def bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def arm_batchnorm(model: nn.Module) -> None:
    """Let every BatchNorm of ``model`` update its running statistics once
    in the next step."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.fresh = True


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in float32, or with ``fp8`` its operands and result
    rounded to float8 (``set_precision``)."""

    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return to_fp8(F.conv2d(to_fp8(x), to_fp8(self.weight), self.bias,
                                   self.stride, self.padding))
        return super().forward(x)


class ConvBnAct(nn.Module):
    """k x k conv (no bias, 'same' padding), BatchNorm, SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = bn(c2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 3)
        self.cv2 = ConvBnAct(c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """ultralytics' C2f: cv1 to 2c split in two halves, n bottlenecks off
    the second, all parts concatenated into cv2."""

    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBnAct(c1, 2 * self.c)
        self.cv2 = ConvBnAct((2 + n) * self.c, c2)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts: List[torch.Tensor] = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


def pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool, k // 2 padding."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c1 // 2)
        self.cv2 = ConvBnAct(c1 // 2 * 4, c2)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(pool_same(y[-1], self.k))
        return self.cv2(torch.cat(y, 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
