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

The rest of tpucv's zoo follows ``Proto``: DWConv, C1, C2, C3, C3x, SPP,
Focus, GhostConv, GhostBottleneck, the attention blocks (ChannelAttention,
SpatialAttention, CBAM), ConvTransposeBnAct, TransformerLayer and
TransformerBlock, BottleneckCSP, C3TR, C3Ghost, DWConvTranspose2d and
Ensemble. No registered network uses them. Their submodules keep tpucv's
flax names (a repeated ``m{i}`` is ``m.{i}``, the unnamed ``ConvBnAct_0``
of DWConv and Focus is ``conv``), so ``from_flax_variables`` carries a
block's tree over as it is; the two transposed convs take their kernels
through their own ``from_flax_kernel`` (flax's ``nn.ConvTranspose`` does
not flip its kernel, and tpucv's DWConvTranspose2d holds a flipped grouped
one).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
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


class GroupRef:
    """A process group held by a module. A deep copy of the module shares
    it: process groups cannot be copied, and the copy runs in the same
    world."""
    __slots__ = ("group",)

    def __init__(self, group=None):
        self.group = group

    def __deepcopy__(self, memo):
        return self


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
    ``nn.BatchNorm2d``'s.

    Under data parallelism (``set_data_parallel`` with W > 1 ranks, each
    holding its rows, or under spatial partitioning its rows of the
    height, of the global batch) the statistics are the global batch's,
    as tpucv's are under a mesh, where XLA reduces across it: the
    per-channel sums and the count, then the sums of squared deviations
    from the global mean, are all-reduced over ``dp_group`` (in f32,
    differentiably), and the global biased variance normalises and feeds
    the running statistics."""

    dp_world = 1            # ranks of the data mesh (set_data_parallel)
    dp_group = GroupRef()   # their process group (None: the world)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.dp_world > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        with torch.no_grad():
            if var is None:
                var = invstd.double().pow(-2).sub(self.eps).float()
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor):
        """(y, mean, biased var) over all ranks' rows of the batch."""
        from tpucv_torch.parallel.mesh import all_reduce_sum as all_reduce

        C = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        total = all_reduce(local, self.dp_group.group)
        count = total[C]
        mean = total[:C] / count
        d = xf - mean[None, :, None, None]
        var = all_reduce(d.square().sum((0, 2, 3)),
                         self.dp_group.group) / count
        y = d * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


class StepDropout(nn.Module):
    """Dropout whose training mask is drawn from a ``torch.Generator``
    seeded with ``seed``, which the train step sets before each forward
    (``seed_dropout``): tpucv draws its mask from ``fold_in(PRNGKey(0),
    step)``, so the mask is a function of the step, and a resumed run
    draws the masks an unbroken one would. Kept values are scaled by
    1 / (1 - p), as flax's ``nn.Dropout`` does; eval mode is the
    identity."""

    dp_world = 1            # ranks of the data mesh (set_data_parallel)
    dp_rank = 0

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.seed = 0

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The boolean keep mask of ``x``'s shape for the current seed.
        Under data parallelism ``x`` holds this rank's rows of the global
        batch: the mask is drawn for the global batch and this rank's rows
        are taken, so it is the one a single process draws."""
        g = torch.Generator(device=x.device).manual_seed(self.seed)
        n = x.shape[0]
        full = torch.rand((n * self.dp_world,) + tuple(x.shape[1:]),
                          generator=g, device=x.device) >= self.p
        return full[self.dp_rank * n:(self.dp_rank + 1) * n]

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


def set_data_parallel(model: nn.Module, world: int, rank: int,
                      group=None) -> None:
    """Tell ``model``'s BatchNorms and dropouts that its train-mode input
    is rank ``rank``'s rows of a global batch split over the ``world``
    ranks of ``group`` (None: the whole world; ``world=1``: the whole
    batch, one process)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.dp_world, m.dp_group = world, GroupRef(group)
        elif isinstance(m, StepDropout):
            m.dp_world, m.dp_rank = world, rank


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

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """One k x k stride-1 max pool (``parallel.spatial`` replaces it
        with its halo-exchanging twin)."""
        return max_pool_same(x, self.k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y1 = self.pool(y)
        y2 = self.pool(y1)
        y3 = self.pool(y2)
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


class Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` as self-attention, no mask,
    no dropout: q, k, v and out are ``nn.Linear`` over the flattened heads
    (``ckpt/convert.py`` reshapes flax's ``DenseGeneral`` kernels), and
    the query is divided by sqrt(head_dim) before q·kᵀ, as flax does."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        H, hd = self.heads, self.head_dim
        q = self.query(x).view(B, L, H, hd).transpose(1, 2)     # (B, H, L, hd)
        k = self.key(x).view(B, L, H, hd).transpose(1, 2)
        v = self.value(x).view(B, L, H, hd).transpose(1, 2)
        q = q / math.sqrt(hd)
        w = torch.softmax(q @ k.transpose(-2, -1), dim=-1)      # (B, H, L, L)
        o = (w @ v).transpose(1, 2).reshape(B, L, H * hd)
        return self.out(o)


def _bn(ch: int) -> BatchNorm2d:
    """A block's bare BatchNorm (eps 1e-3, momentum 0.03)."""
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class DWConv(nn.Module):
    """Depthwise ConvBnAct: groups = gcd(in_ch, out_ch)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = ConvBnAct(in_ch, out_ch, k, s,
                              g=math.gcd(in_ch, out_ch), act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class C1(nn.Module):
    """CSP bottleneck with 1 conv: cv1, then n 3x3 ConvBnActs, plus cv1's
    output."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1):
        super().__init__()
        self.cv1 = ConvBnAct(in_ch, out_ch, 1, 1)
        self.m = nn.ModuleList(ConvBnAct(out_ch, out_ch, 3, 1)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = z = self.cv1(x)
        for m in self.m:
            z = m(z)
        return z + y


class C2(nn.Module):
    """CSP bottleneck with 2 convs: n bottlenecks on the first half of
    cv1's output, concatenated with the second half into cv2."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(out_ch * e)
        self.cv1 = ConvBnAct(in_ch, 2 * self.c, 1, 1)
        self.cv2 = ConvBnAct(2 * self.c, out_ch, 1, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split(self.c, 1)
        for m in self.m:
            a = m(a)
        return self.cv2(torch.cat([a, b], 1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs: n (1, 3) bottlenecks on cv1's output,
    concatenated with cv2's into cv3."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBnAct(in_ch, c_, 1, 1)
        self.cv2 = ConvBnAct(in_ch, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, out_ch, 1, 1)
        self.m = self.chain(c_, n, shortcut, g)

    def chain(self, c_: int, n: int, shortcut: bool, g: int) -> nn.Module:
        """The modules between cv1 and the concatenation."""
        return nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=(1, 3),
                                          e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class _CrossBottleneck(nn.Module):
    """(1, 3) then (3, 1) conv, each with its BatchNorm and SiLU, and an
    optional residual."""

    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = nn.Conv2d(in_ch, out_ch, (1, 3), padding=(0, 1),
                             bias=False)
        self.bn1 = _bn(out_ch)
        self.cv2 = nn.Conv2d(out_ch, out_ch, (3, 1), padding=(1, 0),
                             bias=False)
        self.bn2 = _bn(out_ch)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.cv1(x)))
        y = F.silu(self.bn2(self.cv2(y)))
        return x + y if self.add else y


class C3x(C3):
    """C3 with cross (1, 3) / (3, 1) bottlenecks."""

    def chain(self, c_, n, shortcut, g):
        return nn.Sequential(*(_CrossBottleneck(c_, c_, shortcut)
                               for _ in range(n)))


class SPP(nn.Module):
    """Classic spatial pyramid pooling: parallel k x k max pools."""

    def __init__(self, in_ch: int, out_ch: int,
                 ks: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = in_ch // 2
        self.cv1 = ConvBnAct(in_ch, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(ks) + 1), out_ch, 1, 1)
        self.ks = tuple(ks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [max_pool_same(y, k)
                                         for k in self.ks], 1))


class Focus(nn.Module):
    """Space-to-depth stem: the four 2x2 phases ((0, 0), (1, 0), (0, 1),
    (1, 1) in (row, column)) concatenated on channels, then a ConvBnAct."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = ConvBnAct(4 * in_ch, out_ch, k, s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat(
            [x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
             x[:, :, 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """Ghost convolution: half the channels from cv1, the other half a
    5x5 depthwise ConvBnAct of them."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1):
        super().__init__()
        c_ = out_ch // 2
        self.cv1 = ConvBnAct(in_ch, c_, k, s)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, g=c_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: g1, a stride-2 depthwise conv when s = 2, g2;
    the shortcut is the input, or a 1x1 ConvBnAct (``scv``) where the
    channels change, after a depthwise stride-2 conv (``sdw``) when
    s = 2."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = out_ch // 2
        self.dw = self.sdw = self.scv = None
        self.g1 = GhostConv(in_ch, c_, 1, 1)
        if s == 2:
            self.dw = DWConv(c_, c_, k, s, act=False)
            self.sdw = DWConv(in_ch, in_ch, k, s, act=False)
        self.g2 = GhostConv(c_, out_ch, 1, 1)
        if s == 2 or in_ch != out_ch:
            self.scv = ConvBnAct(in_ch, out_ch, 1, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.g1(x)
        if self.dw is not None:
            y, x = self.dw(y), self.sdw(x)
        y = self.g2(y)
        return y + (x if self.scv is None else self.scv(x))


class ChannelAttention(nn.Module):
    """x times the sigmoid of a biased 1x1 conv of its spatial mean."""

    def __init__(self, ch: int):
        super().__init__()
        self.fc = nn.Conv2d(ch, ch, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """x times the sigmoid of a biased k x k conv of its channel mean and
    max."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv = nn.Conv2d(2, 1, k, padding=k // 2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv(s))


class CBAM(nn.Module):
    """Convolutional block attention: channel, then spatial."""

    def __init__(self, ch: int, k: int = 7):
        super().__init__()
        self.ca = ChannelAttention(ch)
        self.sa = SpatialAttention(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sa(self.ca(x))


class FlaxConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that takes flax's ``nn.ConvTranspose`` kernel
    (``transpose_kernel=False``): flax runs its (k, k, in, out) kernel
    unflipped over the dilated input, torch flips its own, so the torch
    weight is flax's flipped in space, laid out (in, out, k, k)."""

    @staticmethod
    def from_flax_kernel(hwio: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(hwio[::-1, ::-1].transpose(2, 3, 0, 1))


class ConvTransposeBnAct(nn.Module):
    """Transposed conv (flax's "VALID": output (H - 1)·s + max(k, s)) +
    BatchNorm + SiLU. Where k < s flax's output is s - k rows longer than
    torch's, at the bottom and right: they come back as
    ``output_padding``."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 2, s: int = 2,
                 act: bool = True):
        super().__init__()
        self.conv = FlaxConvTranspose2d(in_ch, out_ch, k, s, 0,
                                        output_padding=max(s - k, 0),
                                        bias=False)
        self.bn = _bn(out_ch)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class TransformerLayer(nn.Module):
    """x + attention(x), then x + fc2(fc1(x)): no LayerNorm and no
    activation, as tpucv's."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.fc2(self.fc1(x))


class TransformerBlock(nn.Module):
    """A 1x1 ConvBnAct where the channels change, then the map's (h, w)
    positions as tokens, a learned linear position term added, and n
    TransformerLayers (``tr{i}``)."""

    def __init__(self, in_ch: int, out_ch: int, heads: int = 4, n: int = 1):
        super().__init__()
        self.conv = (ConvBnAct(in_ch, out_ch, 1, 1) if in_ch != out_ch
                     else None)
        self.linear = nn.Linear(out_ch, out_ch)
        self.n = n
        for i in range(n):
            self.add_module(f"tr{i}", TransformerLayer(out_ch, heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)                      # (B, hw, C)
        seq = seq + self.linear(seq)
        for i in range(self.n):
            seq = getattr(self, f"tr{i}")(seq)
        return seq.transpose(1, 2).reshape(b, c, h, w)


class BottleneckCSP(nn.Module):
    """Classic CSP bottleneck: n bottlenecks on cv1's output then the
    plain 1x1 cv3, beside the plain 1x1 cv2 of the input; one BatchNorm +
    SiLU over both, then cv4."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBnAct(in_ch, c_, 1, 1)
        self.cv2 = nn.Conv2d(in_ch, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, out_ch, 1, 1)
        self.bn = _bn(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv3(self.m(self.cv1(x)))
        y = F.silu(self.bn(torch.cat([a, self.cv2(x)], 1)))
        return self.cv4(y)


class C3TR(C3):
    """C3 whose bottleneck chain is a 4-head TransformerBlock."""

    def chain(self, c_, n, shortcut, g):
        return TransformerBlock(c_, c_, 4, n)


class C3Ghost(C3):
    """C3 whose bottleneck chain is GhostBottlenecks."""

    def chain(self, c_, n, shortcut, g):
        return nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Depthwise transposed conv with a bias, groups = gcd(in_ch, out_ch):
    output (H - 1)·s - 2·p1 + k + p2. torch requires p2 < s.

    tpucv runs it as a forward conv over the s-dilated input with its
    (k, k, in/g, out) kernel flipped; torch's transposed conv flips its own
    (in, out/g, k, k) weight, so the weight is tpucv's kernel unflipped
    and regrouped: ``weight[j·in/g + i, o] = kernel[:, :, i, j·out/g + o]``
    for group j."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1,
                 p1: int = 0, p2: int = 0):
        super().__init__(in_ch, out_ch, k, s, p1, p2,
                         groups=math.gcd(in_ch, out_ch), bias=True)

    def from_flax_kernel(self, hwio: np.ndarray) -> np.ndarray:
        k, _, cg, out = hwio.shape
        g = self.groups
        return np.ascontiguousarray(
            hwio.reshape(k, k, cg, g, out // g).transpose(3, 2, 4, 0, 1)
            .reshape(g * cg, out // g, k, k))


class Ensemble:
    """Detections of several models fused for one NMS: every member (a
    callable, ``member(x) -> (B, A_i, no)``, e.g. a model and its decode)
    runs on the same batch and the outputs are concatenated on ``axis``,
    the candidate axis of the (B, A, no) decode layout."""

    def __init__(self, members=(), axis: int = 1):
        self.members = list(members)
        self.axis = axis

    def append(self, member) -> None:
        self.members.append(member)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.members:
            raise ValueError("Ensemble has no members")
        return torch.cat([m(x) for m in self.members], self.axis)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv and linear weight from ``generator``, in module
    order, with LeCun-normal scale (std = 1/sqrt(fan_in), flax's default
    Conv and Dense init), zero their biases (``DetectHead`` overwrites its
    own) and reset BatchNorm and LayerNorm to the identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
