"""Core convolutional blocks (counterpart of ``tpucv/nn/blocks.py``).

The blocks are NCHW ``nn.Module``s, PyTorch's idiom; ``Yolo8`` is where
tpucv's NHWC layout meets them, and on the card it runs them in the
``channels_last`` memory format, which is NHWC in memory. Submodule names
follow ultralytics (``conv``/``bn``, ``cv1``/``cv2``, ``m.{i}``), so a
``state_dict`` carries ultralytics key names. BatchNorm uses eps 1e-3 and
momentum 0.03, as tpucv and the reference do, and in train mode keeps
flax's running statistics (:class:`BatchNorm2d`).

``ConvBnAct`` carries the int8 PTQ hooks of ``tpucv.quant.conv_bn``, and
``HookedConv2d`` those of ``conv_bn`` with a conv bias and of
``conv_biased`` (see ``tpucv_torch/quant.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch import quant

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


class StepDropout(nn.Module):
    """Dropout whose training mask is drawn from a ``torch.Generator``
    seeded with ``seed``, which the train step sets before each forward
    (``seed_dropout``): tpucv draws its mask from ``fold_in(PRNGKey(0),
    step)``, so the mask is a function of the step, and a resumed run
    draws the masks an unbroken one would. Kept values are scaled by
    1 / (1 - p), as flax's ``nn.Dropout`` does; eval mode is the
    identity."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.seed = 0

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The boolean keep mask of ``x``'s shape for the current seed."""
        g = torch.Generator(device=x.device).manual_seed(self.seed)
        return torch.rand(x.shape, generator=g, device=x.device) >= self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def seed_dropout(model: nn.Module, seed: int) -> None:
    """Set every ``StepDropout`` of ``model`` to draw from ``seed``."""
    for m in model.modules():
        if isinstance(m, StepDropout):
            m.seed = seed


class Int8Hooks:
    """tpucv's int8 PTQ hooks on one conv (+ BN) pair, shared by
    ``ConvBnAct`` and ``HookedConv2d``: ``conv`` and ``bn`` name the pair
    (``bn`` None for a biased conv without BN), ``qweight``, ``xscale``,
    ``qscale`` and ``qbias`` its quant buffers (``quant.QUANT_BUFFERS``).

    ``pair(x, float_path)``: in eval mode the pair records its input's
    absmax while a ``quant.calibrate`` pass has set ``calibration``, and
    takes ``quant.quantized_conv`` (int8 in, int32 accumulate) when it holds
    the buffers; otherwise, and always in train mode, ``float_path(x)``.
    The PRE-activation output either way. A ``state_dict`` that holds the
    buffers loads into a float-built pair and quantizes it."""

    def _init_hooks(self) -> None:
        self.calibration: Optional[quant.CalibrationSink] = None
        for name in quant.QUANT_BUFFERS:
            self.register_buffer(name, None)

    def pair(self, x: torch.Tensor, float_path) -> torch.Tensor:
        if not self.training and self.calibration is not None:
            self.calibration.record(
                x, self.bn.eps if self.bn is not None else 1e-5)
        if not self.training and self.qweight is not None:
            return quant.quantized_conv(self, x)
        return float_path(x)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a quantized model's state_dict: make room for its buffers first
        for name in quant.QUANT_BUFFERS:
            t = state_dict.get(prefix + name)
            if t is not None and getattr(self, name) is None:
                setattr(self, name, torch.empty_like(
                    t, device=self.conv.weight.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ConvBnAct(Int8Hooks, nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU, with tpucv's int8 PTQ hooks
    (:class:`Int8Hooks`); SiLU follows the float and the int8 path."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, s, autopad(k, p, d),
                              dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act
        self._init_hooks()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pair(x, lambda v: self.bn(self.conv(v)))
        return F.silu(x) if self.act else x


class HookedConv2d(Int8Hooks, nn.Conv2d):
    """A biased ``nn.Conv2d`` with tpucv's int8 PTQ hooks, for reference
    networks whose convs and BatchNorms sit side by side in one
    ``nn.Sequential`` (SSD's VGG, ``backbone.layers.N``), so that the
    ``state_dict`` keeps their names. ``pair_with(bn)``, called by the
    owner (``models/ssd.py:VGG16BN``), makes ``bn`` this conv's BatchNorm
    without registering it here a second time: the forward then runs
    conv + BN as one pair (or its int8 path), ``quant`` folds ``bn`` into
    it, and the owner skips ``bn`` in its own walk. Unpaired, it is tpucv's
    ``conv_biased``: the bias alone folds into the int8 epilogue."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_hooks()
        object.__setattr__(self, "_paired_bn", None)

    def pair_with(self, bn: nn.BatchNorm2d) -> "HookedConv2d":
        object.__setattr__(self, "_paired_bn", bn)
        return self

    @property
    def conv(self) -> nn.Conv2d:
        return self

    @property
    def bn(self) -> Optional[nn.BatchNorm2d]:
        return self._paired_bn

    def _float(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y if self.bn is None else self.bn(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pair(x, self._float)


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


class Proto(nn.Module):
    """Mask prototypes of the segment head: cv1 3x3 -> nearest 2x
    upsample -> cv2 3x3 -> cv3 1x1, all ConvBnAct, ``mid_ch`` wide
    (tpucv's ``Proto``). Ultralytics upsamples with a ``ConvTranspose2d``
    and scales ``mid_ch`` by the model width (64 at n, here 256 at every
    scale, as tpucv has it), so an ultralytics ``yolov8n-seg.pt`` does not
    load into this head."""

    def __init__(self, in_ch: int, mid_ch: int = 256, n_masks: int = 32):
        super().__init__()
        self.cv1 = ConvBnAct(in_ch, mid_ch, 3)
        self.cv2 = ConvBnAct(mid_ch, mid_ch, 3)
        self.cv3 = ConvBnAct(mid_ch, n_masks, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(upsample2x(self.cv1(x))))


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
