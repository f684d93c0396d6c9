"""SSD300 / SSD512 on VGG16-BN (counterpart of ``tpucv/models/ssd.py``).

The network of the reference (ssd.pytorch's layout):
  * VGG16-BN: conv (with bias) + BN + ReLU per conv, 2x2 pools after
    blocks 1, 2 and 4 and a ceil-mode pool after block 3 (75 -> 38 at
    300); conv4_3's feature is tapped after its ReLU (layer 32);
  * pool5 3x3 stride 1 pad 1, the dilated conv6 (d 6, p 6) and the 1x1
    conv7, each with bias and ReLU and no BN (layers 44 and 46);
  * conv4_3 L2-normalised with a learned scale, initialised to 20;
  * extra layers: plain biased convs with no activation, tapped after
    every second conv;
  * a 3x3 loc and conf head on each tapped feature.

Submodule names are the reference's, as tpucv's ``import_ssd`` reads them:
``backbone.layers.N`` (one ``nn.ModuleList`` in the ``nn.Sequential``
order above), ``l2_norm.weight``, ``extras.conv{j}``, ``locs.{i}`` and
``confs.{i}``. The VGG convs, conv6 and conv7 are ``HookedConv2d``s, which
carry the int8 PTQ hooks; each VGG conv runs its BatchNorm as a pair.

``forward`` takes tpucv's NHWC input (B, S, S, 3) and returns tpucv's raw
outputs: loc (B, A, 4) and conf (B, A, nc), each head's map flattened per
pixel, NHWC (``(h, w, box)`` order, A = 8,732 at 300). Inside it runs NCHW
modules, on a ``channels_last`` tensor on the card. At nc = 21 SSD300 has
26,293,934 parameters.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from tpucv_torch.nn.blocks import BatchNorm2d, HookedConv2d, init_weights

VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# (out channels, kernel, stride, padding) of each extra conv
EXTRA_SPECS = {
    300: [(256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 3, 1, 0), (128, 1, 1, 0), (256, 3, 1, 0)],
    512: [(256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 4, 1, 1)],
}
N_BOXES = {300: (4, 6, 6, 6, 4, 4), 512: (4, 6, 6, 6, 6, 4, 4)}
CONV4_3 = 32            # layer index of conv4_3's ReLU, the first feature
BN_EPS, BN_MOMENTUM = 1e-5, 0.1       # flax's BatchNorm defaults


def vgg16_bn_layers() -> List[nn.Module]:
    """The backbone's 48 layers in the reference's order, pools in their
    slots: 13 conv + BN + ReLU triples, then pool5, conv6, ReLU, conv7,
    ReLU."""
    layers: List[nn.Module] = []
    cin = 3
    for bi, (ch, n) in enumerate(VGG16_BLOCKS):
        for _ in range(n):
            layers += [HookedConv2d(cin, ch, 3, padding=1),
                       BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM),
                       nn.ReLU()]
            cin = ch
        if bi == 2:
            layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        elif bi < 4:
            layers.append(nn.MaxPool2d(2, 2))
    layers += [nn.MaxPool2d(3, 1, 1),
               HookedConv2d(512, 1024, 3, padding=6, dilation=6), nn.ReLU(),
               HookedConv2d(1024, 1024, 1), nn.ReLU()]
    return layers


class VGG16BN(nn.Module):
    """``layers`` in the reference's order; ``forward`` returns (conv4_3
    after its ReLU, conv7 after its ReLU). Every BatchNorm, at ``i``, is
    paired here with the conv at ``i - 1`` (``HookedConv2d.pair_with``):
    it runs inside that conv's forward, as one int8 pair, and the walk
    skips the indices in ``paired``."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(vgg16_bn_layers())
        paired = []
        for i, m in enumerate(self.layers):
            if isinstance(m, nn.BatchNorm2d):
                conv = self.layers[i - 1]
                if not isinstance(conv, HookedConv2d):
                    raise TypeError(f"layers.{i}: a BatchNorm after "
                                    f"{type(conv).__name__}, not a conv")
                conv.pair_with(m)
                paired.append(i)
        self.paired = frozenset(paired)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f1 = None
        for i, m in enumerate(self.layers):
            if i not in self.paired:
                x = m(x)
            if i == CONV4_3:
                f1 = x
        return f1, x


class L2Norm(nn.Module):
    """Channelwise L2 normalisation with a learned scale (init 20): the norm
    in f32 plus 1e-10 after the square root, cast to the input's dtype
    before the division."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.init_scale = scale
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.float().square().sum(1, keepdim=True).sqrt() + 1e-10
        w = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return x / n.to(x.dtype) * w


class Extras(nn.Module):
    """``conv1..convN``: plain biased convs, no activation; the outputs of
    every second one are features."""

    def __init__(self, input_size: int, in_ch: int = 1024):
        super().__init__()
        self.n = len(EXTRA_SPECS[input_size])
        for j, (ch, k, s, p) in enumerate(EXTRA_SPECS[input_size]):
            setattr(self, f"conv{j + 1}", nn.Conv2d(in_ch, ch, k, s, p))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for j in range(self.n):
            x = getattr(self, f"conv{j + 1}")(x)
            if j % 2 == 1:
                feats.append(x)
        return feats


class SSD(nn.Module):
    """``forward`` maps (B, S, S, 3) images, S = ``input_size``, to (loc
    (B, A, 4), conf (B, A, num_classes)) raw outputs; ``num_classes``
    counts the background, class 0."""

    def __init__(self, num_classes: int = 21, input_size: int = 300):
        super().__init__()
        if input_size not in EXTRA_SPECS:
            raise ValueError(f"SSD input size must be 300 or 512, got "
                             f"{input_size}")
        self.num_classes, self.input_size = num_classes, input_size
        self.backbone = VGG16BN()
        self.l2_norm = L2Norm(512)
        self.extras = Extras(input_size)
        chans = [512, 1024] + [ch for j, (ch, *_) in
                               enumerate(EXTRA_SPECS[input_size]) if j % 2]
        nb = N_BOXES[input_size]
        self.locs = nn.ModuleList(
            nn.Conv2d(c, n * 4, 3, 1, 1) for c, n in zip(chans, nb))
        self.confs = nn.ModuleList(
            nn.Conv2d(c, n * num_classes, 3, 1, 1) for c, n in zip(chans, nb))

    def reset_parameters(self, generator: torch.Generator) -> "SSD":
        """Random weights drawn from ``generator`` (``init_weights``:
        LeCun-normal convs, zero biases, identity BatchNorm), the L2 scale
        at 20."""
        init_weights(self, generator)
        with torch.no_grad():
            self.l2_norm.weight.fill_(self.l2_norm.init_scale)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)                # NHWC -> NCHW view
        f1, f2 = self.backbone(x)
        feats = [self.l2_norm(f1), f2] + self.extras(f2)
        B = x.shape[0]
        locs, confs = [], []
        for f, loc, conf in zip(feats, self.locs, self.confs):
            locs.append(loc(f).permute(0, 2, 3, 1).reshape(B, -1, 4))
            confs.append(conf(f).permute(0, 2, 3, 1).reshape(
                B, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)
