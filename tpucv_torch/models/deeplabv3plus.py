"""DeepLabV3+ on ResNet (counterpart of ``tpucv/models/deeplabv3plus.py``;
the reference's ``core/models/deeplabv3plus.py``).

The network:
  * the dilated ResNet (``models/resnet.py``), output stride 16 or 8;
  * ASPP on its last feature: a 1x1 conv, three dilated 3x3 convs (rates
    6, 12, 18 at OS 16; 12, 24, 36 at OS 8) and the image-pool branch
    (the spatial mean, a 1x1 conv + BN + ReLU on the 1x1 map, broadcast
    back), each 256 wide, concatenated and projected by a 1x1 conv to
    256, then ``Dropout(0.1)`` (training only);
  * the decoder: layer 1's feature projected to 48 by a 1x1 conv, the
    ASPP output resized bilinearly to its size, the two concatenated as
    [low (48), ASPP (256)], one 3x3 conv + BN + ReLU and the biased 1x1
    classifier;
  * the logits resized bilinearly to the input size, in f32.

Every conv but the classifier is a bias-free ``HookedConv2d`` paired with
its BatchNorm (tpucv's ``BNConv``), followed by ReLU; the classifier is a
plain biased conv and stays float, as tpucv's ``nn.Conv`` does.

Both resizes are ``F.interpolate(mode="bilinear", align_corners=False)``,
``jax.image.resize(..., "bilinear")`` as it upsamples: half-pixel
centres, the triangle kernel's weights renormalised at the edge (the edge
clamped), no antialiasing. Each rounds the sample coordinate ``(i + 0.5)
* f32(in / out) - 0.5`` once, as a multiply-add, as XLA:CPU does when it
computes jax's weight matrix at run time (33 -> 129, 129 -> 513: within
1.8e-7 of unit values); where XLA folds a small matrix into a constant
(17 -> 65) it rounds the product and the difference apart, and the two
part by up to 1.7e-6 (each within 2.6e-6 of the float64 resize).

Submodule names are the reference's, as tpucv's ``import_deeplab`` reads
them: ``backbone.*`` (torchvision's ResNet names),
``classifier.aspp.convs.{0..3}.{0,1}``, the pool branch
``classifier.aspp.convs.4.{1,2}``, ``classifier.aspp.project.{0,1}``,
``classifier.project.{0,1}`` and ``classifier.classifier.{0,1,3}``.

``forward`` takes tpucv's NHWC input (B, H, W, 3) and returns the logits
NCHW, (B, nc, H, W) f32. At nc 21 DeepLabV3+-ResNet101 has 58,753,973
parameters. Its three stages are spans (``utils/profile.py:span``), each
closed once a forward: ``tpucv.seg.backbone`` (the ResNet),
``tpucv.seg.aspp`` (ASPP) and ``tpucv.seg.decoder`` (the low-level
projection, the resize to its size, the concat, the 3x3, the classifier
and the resize to the input).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.models.resnet import LAYERS, ResNet, conv_bn
from tpucv_torch.nn.blocks import StepDropout, init_weights
from tpucv_torch.utils.profile import span

def upsample(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, size, "bilinear")`` for an upsample, NCHW."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


ASPP_CH = 256
LOW_CH = 48
DROPOUT = 0.1
RATES = {16: (6, 12, 18), 8: (12, 24, 36)}


class ConvBNReLU(nn.Sequential):
    """The reference's ``Sequential(conv, bn, ReLU[, Dropout])`` (keys
    ``.0`` and ``.1``); the conv runs its BatchNorm as one pair."""

    def __init__(self, cin: int, cout: int, k: int, d: int = 1,
                 dropout: float = 0.0):
        super().__init__(*conv_bn(cin, cout, k, 1, d), nn.ReLU(),
                         *([StepDropout(dropout)] if dropout else []))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self[0](x))
        return self[3](x) if len(self) > 3 else x


class ASPPPooling(nn.Sequential):
    """The image-pool branch: ``Sequential(pool, conv, bn, ReLU)`` (keys
    ``.1`` and ``.2``); the spatial mean, the conv + BN + ReLU on the 1x1
    map, broadcast to the input's size."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), *conv_bn(cin, cout, 1),
                         nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self[1](x.mean((2, 3), keepdim=True)))
        return y.expand(-1, -1, *x.shape[2:])


class ASPP(nn.Module):
    def __init__(self, cin: int, rates: Tuple[int, ...]):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(cin, ASPP_CH, 1)]
            + [ConvBNReLU(cin, ASPP_CH, 3, r) for r in rates]
            + [ASPPPooling(cin, ASPP_CH)])
        self.project = ConvBNReLU(ASPP_CH * len(self.convs), ASPP_CH, 1,
                                  dropout=DROPOUT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([c(x) for c in self.convs], 1))


class DeepLabHeadV3Plus(nn.Module):
    def __init__(self, num_classes: int, rates: Tuple[int, ...],
                 low_ch: int = 256, in_ch: int = 2048):
        super().__init__()
        self.project = ConvBNReLU(low_ch, LOW_CH, 1)
        self.aspp = ASPP(in_ch, rates)
        self.classifier = nn.Sequential(
            *conv_bn(LOW_CH + ASPP_CH, ASPP_CH, 3), nn.ReLU(),
            nn.Conv2d(ASPP_CH, num_classes, 1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.decode(feats["low_level"], self.aspp(feats["out"]))

    def decode(self, low_level: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        """The decoder on layer 1's feature and the ASPP output."""
        low = self.project(low_level)
        y = upsample(y, low.shape[2:])
        y = F.relu(self.classifier[0](torch.cat([low, y], 1)))
        return self.classifier[3](y)


class DeeplabV3Plus(nn.Module):
    def __init__(self, num_classes: int = 21, backbone: str = "resnet101",
                 output_stride: int = 16):
        super().__init__()
        self.backbone = ResNet(LAYERS[backbone], output_stride)
        self.classifier = DeepLabHeadV3Plus(num_classes,
                                            RATES[output_stride])

    def reset_parameters(self, generator: torch.Generator) -> "DeeplabV3Plus":
        """Random weights drawn from ``generator`` (``init_weights``:
        LeCun-normal convs, the classifier's bias 0, identity
        BatchNorm)."""
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        with span("tpucv.seg.backbone"):
            feats = self.backbone(x.permute(0, 3, 1, 2))
        with span("tpucv.seg.aspp"):
            y = self.classifier.aspp(feats["out"])
        with span("tpucv.seg.decoder"):
            y = self.classifier.decode(feats["low_level"], y)
            return upsample(y.float(), (H, W))
