"""The zoo's secondary networks (counterpart of ``tpucv/models/extras.py``):
the VGG-BN feature extractor, MobileNetV2 and UNet. No registered family
builds them.

Each is an ``nn.Module`` over NCHW inputs, returning NCHW maps (VGG, UNet)
or the logits (B, nc) (MobileNetV2). Submodule names are tpucv's flax
names, so ``ckpt/convert.py:from_flax_variables`` carries tpucv's trees
over as they are: VGG's ``conv{i}`` / ``bn{i}``; MobileNetV2's ``stem``,
``stem_bn``, ``ir{i}.{expand,dw,proj}[_bn]``, ``head_conv``, ``head_bn``
and ``classifier``; UNet's ``{e1..e5,d4..d1}_{c,b}{i}`` and ``out``.

BatchNorm is flax's here (momentum 0.9, eps 1e-5: torch momentum 0.1),
with flax's biased running variance (``nn/blocks.py:BatchNorm2d``). The
pools are flax's ``nn.max_pool`` (2, 2), stride 2, no padding, and UNet's
up-resize is ``jax.image.resize(..., "bilinear")``, half-pixel centres
(``models/deeplabv3plus.py:upsample``): on an input that 16 does not
divide the encoder floors (e.g. 46 -> 23 -> 11 -> 5 -> 2) and the decoder
resizes to each skip's size (2 -> 5 -> 11 -> 23 -> 46), not by 2.

At their defaults VGG16-BN has 14,718,912 parameters, MobileNetV2
(width 1.0, nc 1000) 3,504,872 and UNet (nc 21) 24,898,581, as tpucv's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.models.deeplabv3plus import upsample
from tpucv_torch.nn.blocks import BatchNorm2d, init_weights

VGG_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}
BN_EPS = 1e-5
BN_MOMENTUM = 0.1           # flax's 0.9


def bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv3x3(cin: int, cout: int, s: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, s, 1, groups=groups, bias=False)


class Seeded(nn.Module):
    def reset_parameters(self, generator: torch.Generator) -> "Seeded":
        """Random weights drawn from ``generator`` (``init_weights``:
        LeCun-normal convs and linears, biases 0, identity BatchNorm)."""
        init_weights(self, generator)
        return self


class VGG(Seeded):
    """VGG-BN feature extractor: the first ``end_layer`` entries of
    ``VGG_CFGS[depth]`` (-1: all), each a 3x3 conv + BN + ReLU or a 2x2
    max pool."""

    def __init__(self, depth: int = 16, end_layer: int = -1, in_ch: int = 3):
        super().__init__()
        cfg = VGG_CFGS[depth]
        self.cfg = cfg[:len(cfg) if end_layer < 0 else end_layer]
        ci = 0
        for spec in self.cfg:
            if spec != "M":
                self.add_module(f"conv{ci}", conv3x3(in_ch, spec))
                self.add_module(f"bn{ci}", bn(spec))
                in_ch, ci = spec, ci + 1
        self.out_ch = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ci = 0
        for spec in self.cfg:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv, norm = getattr(self, f"conv{ci}"), getattr(self, f"bn{ci}")
                x = F.relu(norm(conv(x)))
                ci += 1
        return x


class InvertedResidual(nn.Module):
    """MobileNetV2's block: 1x1 expand (when ``expand`` > 1), 3x3
    depthwise at stride ``s`` (groups = the hidden width), each + BN +
    ReLU6, then the 1x1 projection + BN; the residual only when s = 1 and
    the channels stay."""

    def __init__(self, in_ch: int, out_ch: int, s: int = 1, expand: int = 6):
        super().__init__()
        hid = in_ch * expand
        self.expand = self.expand_bn = None
        if expand != 1:
            self.expand = nn.Conv2d(in_ch, hid, 1, bias=False)
            self.expand_bn = bn(hid)
        self.dw = conv3x3(hid, hid, s, groups=hid)
        self.dw_bn = bn(hid)
        self.proj = nn.Conv2d(hid, out_ch, 1, bias=False)
        self.proj_bn = bn(out_ch)
        self.add = s == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = F.relu6(self.expand_bn(self.expand(y)))
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.proj_bn(self.proj(y))
        return x + y if self.add else y


# (expand, out, n, stride)
MOBILENET_V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                    (6, 320, 1, 1)]


class MobileNetV2(Seeded):
    """MobileNetV2 classifier; every width is tpucv's
    ``max(8, int(ch * width + 4) // 8 * 8)``."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 in_ch: int = 3):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width + 4) // 8 * 8)

        self.stem = conv3x3(in_ch, c(32), 2)
        self.stem_bn = bn(c(32))
        ch, bi = c(32), 0
        for e, o, n, s in MOBILENET_V2_CFG:
            for i in range(n):
                self.add_module(f"ir{bi}", InvertedResidual(
                    ch, c(o), s if i == 0 else 1, e))
                ch, bi = c(o), bi + 1
        self.n_blocks = bi
        self.head_conv = nn.Conv2d(ch, c(1280), 1, bias=False)
        self.head_bn = bn(c(1280))
        self.classifier = nn.Linear(c(1280), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.stem_bn(self.stem(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"ir{i}")(x)
        x = F.relu6(self.head_bn(self.head_conv(x)))
        return self.classifier(x.mean((2, 3)))


class UNet(Seeded):
    """A VGG16-BN encoder (e1-e5: 2, 2, 3, 3, 3 convs of 64-512, a pool
    between each) and four decoder blocks (d4-d1: the deeper map resized
    bilinearly to its skip's size, concatenated [up, skip], two 3x3 convs
    + BN + ReLU), then the biased 1x1 ``out``; logits (B, nc, H, W)."""

    ENCODER = (("e1", 64, 2), ("e2", 128, 2), ("e3", 256, 3),
               ("e4", 512, 3), ("e5", 512, 3))
    DECODER = (("d4", 512), ("d3", 256), ("d2", 128), ("d1", 64))

    def __init__(self, num_classes: int = 21, in_ch: int = 3):
        super().__init__()
        widths = []
        for name, ch, n in self.ENCODER:
            self._block(name, in_ch, ch, n)
            in_ch = ch
            widths.append(ch)
        for (name, ch), skip in zip(self.DECODER, widths[-2::-1]):
            self._block(name, in_ch + skip, ch, 2)
            in_ch = ch
        self.out = nn.Conv2d(in_ch, num_classes, 1)

    def _block(self, name: str, cin: int, cout: int, n: int) -> None:
        for i in range(n):
            self.add_module(f"{name}_c{i}", conv3x3(cin if i == 0 else cout,
                                                    cout))
            self.add_module(f"{name}_b{i}", bn(cout))

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        i = 0
        while hasattr(self, f"{name}_c{i}"):
            x = F.relu(getattr(self, f"{name}_b{i}")(
                getattr(self, f"{name}_c{i}")(x)))
            i += 1
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips: List[torch.Tensor] = []
        for k, (name, _, _) in enumerate(self.ENCODER):
            x = self._run(name, x if k == 0 else F.max_pool2d(x, 2, 2))
            skips.append(x)
        for (name, _), skip in zip(self.DECODER, skips[-2::-1]):
            up = upsample(x, skip.shape[2:]).to(skip.dtype)
            x = self._run(name, torch.cat([up, skip], 1))
        return self.out(x)
