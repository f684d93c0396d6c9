"""CenterNet on DLA-34 (counterpart of ``tpucv/models/centernet.py``).

The network of the reference (``DLASeg``):
  * DLA-34: a 7x7 stem, two conv levels and four recursive aggregation
    ``Tree``s (levels 1, 2, 2, 1), each conv followed by BatchNorm;
  * ``DLAUp``: three ``IDAUp`` stages that bring levels 2-5 (strides 4 to
    32) up to stride 4 through 1x1 projections, depthwise transposed convs
    (``DepthwiseUp``, bilinear init) and 3x3 merge nodes;
  * three heads, conv3x3 (with bias) -> ReLU -> conv1x1 (with bias), no
    BatchNorm, concatenated as ``[heatmap, wh, reg]``.

Submodule names are the reference's, as tpucv's ``import_centernet``
reads them: ``backbone.base.{base_layer,level_0,level_1}.{0,1}``,
``backbone.base.level_N.{tree1,tree2,root,project}``, BasicBlock
``conv1/bn1/conv2/bn2``, ``backbone.dla_up.ida_i.{proj_k,up_k,node_k}``
and ``backbone.{heatmap,wh,reg}.{0,2}``, so a reference ``.pth`` loads as
it is. Every conv + BatchNorm is a ``HookedConv2d`` paired with its
BatchNorm (``pair_with``), which carries the int8 PTQ hooks of tpucv's
``quant.conv_bn``; the heads' 3x3 convs are unpaired ``HookedConv2d``s
(tpucv's ``conv_biased``). The heads' 1x1 convs and the ``up_k``
transposed convs stay float.

The reference computes a ``levels=2`` Tree's own ``project`` (level 3 and
4) and then drops it: each inner Tree recomputes its residual. The port
computes it too, in every mode: in training its BatchNorm statistics move
as the reference's do, and in inference it is calibrated and quantized as
tpucv's is (a 1x1 conv at stride 8 and 16, a few MFLOPs an image). Its
parameters get no gradient (``None``; tpucv's are zeros, and with weight
decay 0 Adam leaves them unchanged either way).

``forward`` takes tpucv's NHWC input (B, S, S, 3) and returns tpucv's raw
output (B, S/4, S/4, nc + 4), NHWC: a view of the NCHW concat, contiguous
on the card, where the network runs ``channels_last``. The loss and the
decode read offsets at ``[nc:nc+2]`` and sizes at ``[nc+2:nc+4]``, so the
head *named* ``wh`` learns offsets, as in the reference. At nc 20 the
model has 17,946,056 parameters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import BatchNorm2d, HookedConv2d, init_weights

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL = 2                     # the pyramid starts at stride 4
BN_EPS, BN_MOMENTUM = 1e-5, 0.1     # flax's BatchNorm defaults
HM_BIAS = -2.19                     # sigmoid(-2.19) ~ 0.1 at init


def conv_bn(cin: int, cout: int, k: int,
            s: int = 1) -> Tuple[HookedConv2d, BatchNorm2d]:
    """A bias-free k x k conv (padding k // 2) paired with its BatchNorm."""
    conv = HookedConv2d(cin, cout, k, s, k // 2, bias=False)
    bn = BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
    conv.pair_with(bn)
    return conv, bn


class ConvBN(nn.Sequential):
    """The reference's ``Sequential(conv, bn[, ReLU])`` (keys ``.0`` and
    ``.1``); the conv runs its BatchNorm as one pair."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1,
                 relu: bool = True):
        super().__init__(*conv_bn(cin, cout, k, s),
                         *([nn.ReLU()] if relu else []))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        return F.relu(x) if len(self) > 2 else x


class BasicBlock(nn.Module):
    """conv3x3 (stride s) + BN + ReLU, conv3x3 + BN, + residual, ReLU."""

    def __init__(self, cin: int, cout: int, s: int = 1):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, cout, 3, s)
        self.conv2, self.bn2 = conv_bn(cout, cout, 3)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x if residual is None else residual
        return F.relu(self.conv2(F.relu(self.conv1(x))) + residual)


class Root(nn.Module):
    """Aggregation node: the children concatenated, 1x1 conv + BN, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv, self.bn = conv_bn(cin, cout, 1)

    def forward(self, children: Sequence[torch.Tensor]) -> torch.Tensor:
        return F.relu(self.conv(torch.cat(list(children), 1)))


class Tree(nn.Module):
    """Recursive deep-aggregation tree. ``root_dim`` is the root's input
    width: 2 * ``cout`` by default, plus ``cin`` when ``level_root`` (the
    tree's strided input joins the root's children)."""

    def __init__(self, levels: int, cin: int, cout: int, s: int = 1,
                 level_root: bool = False, root_dim: int = 0):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, s)
            self.tree2 = BasicBlock(cout, cout)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, s)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout)
        self.project = (ConvBN(cin, cout, 1, relu=False) if cin != cout
                        else None)
        self.levels, self.s, self.level_root = levels, s, level_root

    def forward(self, x: torch.Tensor,
                children: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        children = list(children or [])
        bottom = F.max_pool2d(x, self.s, self.s) if self.s > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = bottom if self.project is None else self.project(bottom)
            x1 = self.tree1(x, residual)
            return self.root([self.tree2(x1), x1, *children])
        if self.project is not None:
            self.project(bottom)       # dead, as in the reference (above)
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


class DLA34(nn.Module):
    """``forward`` returns the features of levels 0-5 (strides 1-32)."""

    def __init__(self):
        super().__init__()
        ch = DLA34_CHANNELS
        self.base_layer = ConvBN(3, ch[0], 7)
        self.level_0 = ConvBN(ch[0], ch[0], 3)
        self.level_1 = ConvBN(ch[0], ch[1], 3, 2)
        for i in range(2, 6):
            setattr(self, f"level_{i}", Tree(DLA34_LEVELS[i], ch[i - 1],
                                             ch[i], 2, level_root=i > 2))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = self.base_layer(x)
        outs = []
        for i in range(6):
            y = getattr(self, f"level_{i}")(y)
            outs.append(y)
        return outs


def bilinear_kernel(k: int) -> torch.Tensor:
    """The classic DLA bilinear-upsample kernel, (k, k)."""
    f = (k + 1) // 2
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w1d = 1.0 - (torch.arange(k, dtype=torch.float32) / f - c).abs()
    return w1d[:, None] * w1d[None, :]


class DepthwiseUp(nn.ConvTranspose2d):
    """The reference IDAUp's ``up`` op: a grouped (depthwise) transposed
    conv, kernel 2f, stride f, padding f // 2, no bias, bilinear init.
    tpucv computes it as an lhs-dilated depthwise conv with the kernel
    flipped at call time; on the stored (C, 1, 2f, 2f) kernel that is this
    op."""

    def __init__(self, ch: int, f: int):
        super().__init__(ch, ch, 2 * f, stride=f, padding=f // 2, groups=ch,
                         bias=False)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.copy_(bilinear_kernel(self.kernel_size[0]).expand_as(
                self.weight))


class IDAUp(nn.Module):
    """Iterative deep aggregation: each input through its 1x1 projection
    (``proj_i``, identity when the width already matches) and its upsample
    (``up_i``, identity at factor 1), then sequential concat -> 3x3 merges
    (``node_1..``). Returns (the last merge, every merge)."""

    def __init__(self, out_ch: int, channels: Sequence[int],
                 up_factors: Sequence[int]):
        super().__init__()
        for i, (c, f) in enumerate(zip(channels, up_factors)):
            setattr(self, f"proj_{i}", ConvBN(c, out_ch, 1) if c != out_ch
                    else nn.Identity())
            setattr(self, f"up_{i}", DepthwiseUp(out_ch, int(f)) if f > 1
                    else nn.Identity())
        for i in range(1, len(channels)):
            setattr(self, f"node_{i}", ConvBN(2 * out_ch, out_ch, 3))
        self.n = len(channels)

    def forward(self, layers: Sequence[torch.Tensor]):
        layers = [getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(x))
                  for i, x in enumerate(layers)]
        x, ys = layers[0], []
        for i in range(1, self.n):
            x = getattr(self, f"node_{i}")(torch.cat([x, layers[i]], 1))
            ys.append(x)
        return x, ys


class DLAUp(nn.Module):
    """Full pyramid aggregation with the reference's in_channels / scales
    bookkeeping, rewritten in place after each stage, so that module
    shapes and names line up one to one."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        channels, in_channels = list(channels), list(channels)
        n = len(channels)
        scales = [2 ** i for i in range(n)]
        for i in range(n - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]]))
            scales[j + 1:] = [scales[j]] * (-j - 1)
            in_channels[j + 1:] = [channels[j]] * (-j - 1)
        self.n = n

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        layers = list(layers)
        for i in range(self.n - 1):
            x, ys = getattr(self, f"ida_{i}")(layers[-i - 2:])
            layers[-i - 1:] = ys
        return x


def head(cin: int, mid: int, cout: int) -> nn.Sequential:
    """conv3x3 (bias; int8 hooks) -> ReLU -> conv1x1 (bias; float)."""
    return nn.Sequential(HookedConv2d(cin, mid, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(mid, cout, 1))


class DLASeg(nn.Module):
    """DLA-34 -> DLAUp from level 2 (stride 4) -> the three heads,
    concatenated NCHW as ``[heatmap, wh, reg]``."""

    def __init__(self, num_classes: int, head_channels: int):
        super().__init__()
        self.base = DLA34()
        self.dla_up = DLAUp(DLA34_CHANNELS[FIRST_LEVEL:])
        c = DLA34_CHANNELS[FIRST_LEVEL]
        self.heatmap = head(c, head_channels, num_classes)
        self.wh = head(c, head_channels, 2)
        self.reg = head(c, head_channels, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dla_up(self.base(x)[FIRST_LEVEL:])
        return torch.cat([self.heatmap(y), self.wh(y), self.reg(y)], 1)


class CenterNet(nn.Module):
    """``forward`` maps (B, S, S, 3) images to the raw (B, S/4, S/4,
    num_classes + 4) output: heatmap logits, offsets, sizes."""

    def __init__(self, num_classes: int = 20, head_channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = DLASeg(num_classes, head_channels)

    def reset_parameters(self, generator: torch.Generator) -> "CenterNet":
        """Random weights drawn from ``generator`` (``init_weights``:
        LeCun-normal convs, zero biases, identity BatchNorm), the
        upsamples bilinear and the heatmap bias at -2.19."""
        init_weights(self, generator)
        for m in self.modules():
            if isinstance(m, DepthwiseUp):
                m.reset_parameters()
        with torch.no_grad():
            self.backbone.heatmap[2].bias.fill_(HM_BIAS)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.backbone(x.permute(0, 3, 1, 2))     # NHWC -> NCHW view
        return out.permute(0, 2, 3, 1)
