"""ResNet-50 / -101 with dilation (counterpart of ``tpucv/models/resnet.py``;
the reference's ``core/models/resnet.py``, torchvision's Bottleneck).

The network: a 7x7 stride-2 stem conv + BN + ReLU, a 3x3 stride-2 max
pool padded with -inf, then four layers of Bottlenecks (1x1, 3x3 with the
layer's stride and dilation, 1x1 to 4x the width, + the identity or a
strided 1x1 projection on the first block, ReLU). ``output_stride`` 16
trades layer 4's stride for dilation, 8 layer 3's and 4's, as
torchvision's ``replace_stride_with_dilation`` does: the first block of
a dilated layer keeps the previous dilation and later blocks take the
increased one. Every conv pads ``dilation * (k - 1) // 2``.

Submodule names are torchvision's, as tpucv's ``import_resnet`` reads
them: ``conv1`` / ``bn1``, ``layerN.b.conv{1,2,3}`` / ``bn{1,2,3}`` and
``layerN.0.downsample.{0,1}``. Each conv is a bias-free ``HookedConv2d``
paired with its BatchNorm, which carries the int8 PTQ hooks of tpucv's
``quant.conv_bn``. BatchNorm takes ``conv_bn``'s defaults, eps 1e-5 and
flax momentum 0.9 (torch's 0.1), and keeps flax's running variance
(``nn/blocks.py:BatchNorm2d``).

``forward`` takes NCHW and returns ``{"low_level": layer1, "out":
layer4}`` (strides 4 and ``output_stride``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import BatchNorm2d, HookedConv2d

BN_EPS, BN_MOMENTUM = 1e-5, 0.1     # flax's BatchNorm defaults
PLANES = (64, 128, 256, 512)
EXPANSION = 4
LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
# which layers trade their stride for dilation at each output stride
DILATE = {32: (False, False, False, False), 16: (False, False, False, True),
          8: (False, False, True, True)}


def conv_bn(cin: int, cout: int, k: int, s: int = 1,
            d: int = 1) -> Tuple[HookedConv2d, BatchNorm2d]:
    """A bias-free k x k conv (stride s, dilation d, padding d (k - 1) / 2)
    paired with its BatchNorm."""
    conv = HookedConv2d(cin, cout, k, s, d * (k - 1) // 2, dilation=d,
                        bias=False)
    bn = BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
    conv.pair_with(bn)
    return conv, bn


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, s: int = 1, d: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, planes, 1)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3, s, d)
        self.conv3, self.bn3 = conv_bn(planes, planes * EXPANSION, 1)
        self.downsample = (nn.Sequential(*conv_bn(cin, planes * EXPANSION,
                                                  1, s))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample[0](x)
        y = F.relu(self.conv2(F.relu(self.conv1(x))))
        return F.relu(self.conv3(y) + identity)


class ResNet(nn.Module):
    """``layers``: Bottlenecks a layer, (3, 4, 23, 3) for ResNet-101."""

    def __init__(self, layers=LAYERS["resnet101"], output_stride: int = 16):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(3, 64, 7, 2)
        cin, dilation = 64, 1
        for li, (n, p, dilate) in enumerate(zip(layers, PLANES,
                                                DILATE[output_stride])):
            s = 1 if li == 0 else 2
            prev = dilation
            if dilate:
                dilation *= s
                s = 1
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, p, s if b == 0 else 1,
                                         prev if b == 0 else dilation,
                                         downsample=b == 0))
                cin = p * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        low = self.layer1(x)
        return {"low_level": low,
                "out": self.layer4(self.layer3(self.layer2(low)))}
