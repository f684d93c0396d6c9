"""Spatial partitioning (counterpart of ``tpucv/parallel/mesh.py:
spatial_batch_sharding``): (B, H, W, C) images with the batch over the
data axis and the height over the model axis.

tpucv lets XLA's SPMD partitioner insert the halo exchanges; the port
makes them by hand. Each rank of a model group holds ``h = H / n`` rows of
every activation; before a conv or a pool it takes the rows its window
reaches beyond its own from its neighbours (``halo``), then runs the layer
with no padding along the height. For a layer of (effective) kernel ``k``,
stride ``s`` and global top padding ``pt`` that is ``pt`` rows from the
rank above and ``k - s - pt`` from the rank below; at the global edges the
layer's own padding (zeros for a conv, -inf for a max pool) takes their
place, so flax's asymmetric SAME padding (``(0, 1)`` on a stride-2 3x3 over
an even height) exists only at the global bottom. A local height that does
not divide the stride, or that is smaller than a halo, is refused by name.

The halo's backward sends each halo row's gradient back to the rank that
owns the row, where it is added. BatchNorm's statistics span data x model
(every rank holds other pixels): ``enable_spatial`` sets every
``BatchNorm2d`` to reduce over the world. Nearest upsampling and channel
concatenation are local. ``gather_height`` assembles the output rows
(its backward keeps this rank's rows, as ``mesh._GatherRows`` does);
after the backward each rank's gradients are its pixels' share, summed
over the world by ``mesh.all_reduce_grads(params)``.

``enable_spatial`` covers what YOLOv8's backbone, neck and head use:
``nn.Conv2d`` (any stride, symmetric padding), SPPF's max pool, nearest 2x
upsampling and concatenation. ``conv2d``, ``max_pool2d`` and
``avg_pool2d`` take explicit padding for other networks.
"""

from __future__ import annotations

import math
import types
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import SPPF, GroupRef, set_data_parallel
from tpucv_torch.parallel.mesh import DataMesh, _tree_map, all_gather


@dataclass(frozen=True)
class HeightSplit:
    """The height split over ``n`` ranks of the group ``ref`` holds, this
    one holding the ``index``-th part."""
    n: int
    index: int
    ref: GroupRef = field(compare=False, repr=False)

    @classmethod
    def of(cls, mesh: DataMesh) -> "HeightSplit":
        """The split over ``mesh``'s model axis."""
        return cls(mesh.n_model, mesh.model_index,
                   GroupRef(mesh.model_group))

    @property
    def group(self):
        return self.ref.group


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's SAME padding of one axis: ``(lo, hi)``, the odd row at the
    end."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Halo(torch.autograd.Function):
    """NCHW ``x`` with ``top`` rows of the rank above and ``bot`` rows of
    the rank below around it (``fill`` at the global edges)."""

    @staticmethod
    def forward(ctx, x, top: int, bot: int, split: HeightSplit, fill: float):
        ctx.top, ctx.bot, ctx.split, ctx.h = top, bot, split, x.shape[2]
        h, i, n = x.shape[2], split.index, split.n
        edges = torch.cat([x[:, :, h - top:], x[:, :, :bot]], 2)
        parts = all_gather(edges, split.group, n)
        pad = lambda rows: x.new_full(  # noqa: E731
            (*x.shape[:2], rows, x.shape[3]), fill)
        up = parts[i - 1][:, :, :top] if i > 0 else pad(top)
        down = parts[i + 1][:, :, top:] if i < n - 1 else pad(bot)
        return torch.cat([up, x, down], 2)

    @staticmethod
    def backward(ctx, g):
        top, bot, h, sp = ctx.top, ctx.bot, ctx.h, ctx.split
        i, n = sp.index, sp.n
        parts = all_gather(torch.cat([g[:, :, :top], g[:, :, top + h:]], 2),
                           sp.group, n)
        gx = g[:, :, top:top + h].clone()
        if i < n - 1 and top:       # the rank below took my last rows
            gx[:, :, h - top:] += parts[i + 1][:, :, :top]
        if i > 0 and bot:           # the rank above took my first rows
            gx[:, :, :bot] += parts[i - 1][:, :, top:]
        return gx, None, None, None, None


def halo(x: torch.Tensor, k: int, s: int, pad: Tuple[int, int],
         split: Optional[HeightSplit], fill: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW, this rank's rows) with the rows a window of ``k``
    rows, stride ``s`` and global height padding ``pad`` reaches beyond
    them: the neighbours' rows, or ``fill`` at the global edges; without a
    split, the padding itself."""
    pt, pb = pad
    if split is None or split.n == 1:
        return F.pad(x, (0, 0, pt, pb), value=fill)
    h = x.shape[2]
    top, bot = pt, max(k - s - pt, 0)
    if h % s:
        raise ValueError(f"spatial partitioning: a local height of {h} rows "
                         f"does not divide the stride {s}")
    if max(top, bot) > h:
        raise ValueError(f"spatial partitioning: a local height of {h} rows "
                         f"is smaller than the halo ({top} above, {bot} "
                         f"below) of a {k}-row window")
    if bot > pb or (top + h + bot - k) // s + 1 != h // s:
        raise ValueError(f"spatial partitioning: a {k}-row window at stride "
                         f"{s} with padding {pad} does not give {s}x fewer "
                         f"rows on every rank")
    if top == bot == 0:
        return x
    return _Halo.apply(x, top, bot, split, fill)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride, pad_h: Tuple[int, int],
           pad_w: Tuple[int, int], split: Optional[HeightSplit],
           dilation=1, groups: int = 1) -> torch.Tensor:
    """A conv of this rank's rows (NCHW) with explicit padding (``pad_h``,
    ``pad_w``: (before, after)) as the unsplit conv computes them."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation
    k = dh * (weight.shape[2] - 1) + 1
    x = halo(x, k, sh, pad_h, split)
    x = F.pad(x, (*pad_w, 0, 0))
    return F.conv2d(x, weight, bias, (sh, sw), 0, (dh, dw), groups)


def max_pool2d(x: torch.Tensor, k: int, s: int, p: int,
               split: Optional[HeightSplit]) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)`` of this rank's rows."""
    x = halo(x, k, s, (p, p), split, float("-inf"))
    return F.max_pool2d(x, k, s, (0, p))


def avg_pool2d(x: torch.Tensor, k: int, s: int,
               split: Optional[HeightSplit]) -> torch.Tensor:
    """flax's ``avg_pool`` (VALID) of this rank's rows."""
    return F.avg_pool2d(halo(x, k, s, (0, 0), split), k, s)


def _conv_forward(self, x, weight, bias):
    ph, pw = self.padding
    return conv2d(x, weight, bias, self.stride, (ph, ph), (pw, pw),
                  self.spatial_split, self.dilation, self.groups)


def _sppf_pool(self, x):
    return max_pool2d(x, self.k, 1, self.k // 2, self.spatial_split)


def enable_spatial(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """Make ``model``'s train-mode forward take this rank's rows of the
    height (over ``mesh``'s model axis) of its rows of the batch (over the
    data axis): halo exchanges before every ``nn.Conv2d`` and SPPF's pools,
    BatchNorm over the world. Raises on a layer it does not cover."""
    split = HeightSplit.of(mesh)
    for name, m in model.named_modules():
        if isinstance(m, (nn.ConvTranspose2d, nn.MaxPool2d, nn.AvgPool2d,
                          nn.AdaptiveAvgPool2d)):
            raise NotImplementedError(
                f"{name}: {type(m).__name__} is not spatially partitioned")
        if isinstance(m, nn.Conv2d):
            if m.padding_mode != "zeros" or isinstance(m.padding, str):
                raise NotImplementedError(
                    f"{name}: spatial convs take integer zero padding")
            if getattr(m.weight, "model_shard", None) is not None:
                raise NotImplementedError(
                    f"{name}: a kernel sharded over the model axis cannot "
                    f"also split the height over it")
            m.spatial_split = split
            m._conv_forward = types.MethodType(_conv_forward, m)
        elif isinstance(m, SPPF):
            m.spatial_split = split
            m.pool = types.MethodType(_sppf_pool, m)
    set_data_parallel(model, mesh.world, mesh.rank, None)
    return model


def split_height(x: torch.Tensor, split: Optional[HeightSplit],
                 dim: int = 1) -> torch.Tensor:
    """This rank's rows of the height (``dim``: 1 for NHWC, 2 for NCHW) of
    ``x``."""
    if split is None or split.n == 1:
        return x
    if x.shape[dim] % split.n:
        raise ValueError(f"spatial partitioning: a height of {x.shape[dim]} "
                         f"does not split over {split.n} ranks")
    h = x.shape[dim] // split.n
    return x.narrow(dim, split.index * h, h)


class _GatherHeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, split: HeightSplit, dim: int):
        ctx.split, ctx.dim, ctx.h = split, dim, x.shape[dim]
        return torch.cat(all_gather(x, split.group, split.n), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.split.index * ctx.h, ctx.h), None, None


def gather_height(tree: Any, split: Optional[HeightSplit],
                  dim: int = 1) -> Any:
    """Every tensor of ``tree`` with the ranks' rows of the height
    concatenated along ``dim`` (1: NHWC outputs), differentiable: the
    backward keeps this rank's rows (every rank computes the same loss)."""
    if split is None or split.n == 1:
        return tree
    return _tree_map(lambda t: _GatherHeight.apply(t, split, dim), tree)
