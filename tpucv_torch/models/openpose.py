"""CPM / OpenPose pose network (counterpart of ``tpucv/models/openpose.py``):
VGG19-BN through its 10th conv, two 3x3 convs to 128 channels, then
``n_stages`` refinement stages, each a PAF branch and a heatmap branch.
tpucv has no loss or trainer for it, nor does the port.

Every stage conv is a biased conv + ReLU (``ConvBlock``) with no BN: the
first stage has three 3x3 convs of 128, a 1x1 of 512 and the 1x1 ``out``;
stages 1-5 take the concatenation [features (128), PAFs (2·n_limbs),
heatmaps (n_keypoints + 1)] (185 channels at 18 / 19) through five 7x7
convs of 128, a 1x1 of 128 and ``out``. NCHW in, ``(pafs, heatmaps)``
out, each at stride 8. Names are tpucv's: ``vgg.conv{i}`` /
``vgg.bn{i}``, ``cpm0`` / ``cpm1``, ``paf{s}`` / ``hm{s}`` with
``c{i}.conv``, ``pre.conv`` and ``out``. At 18 keypoints, 19 limbs and 6
stages CPM has 52,313,878 parameters, as tpucv's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.models.extras import VGG, Seeded

HIDDEN = 128


class ConvBlock(nn.Module):
    """A biased k x k conv, "same" padding, then ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class Stage(nn.Module):
    """One refinement branch: 3 (first) or 5 ConvBlocks, ``pre`` and the
    biased 1x1 ``out``."""

    def __init__(self, cin: int, out_ch: int, first: bool = False):
        super().__init__()
        k, n = (3, 3) if first else (7, 5)
        for i in range(n):
            self.add_module(f"c{i}", ConvBlock(cin if i == 0 else HIDDEN,
                                               HIDDEN, k))
        self.n = n
        pre = 512 if first else HIDDEN
        self.pre = ConvBlock(HIDDEN, pre, 1)
        self.out = nn.Conv2d(pre, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"c{i}")(x)
        return self.out(self.pre(x))


class CPM(Seeded):
    def __init__(self, n_keypoints: int = 18, n_limbs: int = 19,
                 n_stages: int = 6, in_ch: int = 3):
        super().__init__()
        self.vgg = VGG(19, end_layer=13, in_ch=in_ch)
        self.cpm0 = ConvBlock(self.vgg.out_ch, 256, 3)
        self.cpm1 = ConvBlock(256, HIDDEN, 3)
        paf_ch, hm_ch = 2 * n_limbs, n_keypoints + 1
        cat = HIDDEN + paf_ch + hm_ch
        self.n_stages = n_stages
        for s in range(n_stages):
            cin = HIDDEN if s == 0 else cat
            self.add_module(f"paf{s}", Stage(cin, paf_ch, first=s == 0))
            self.add_module(f"hm{s}", Stage(cin, hm_ch, first=s == 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.cpm1(self.cpm0(self.vgg(x)))
        paf, hm = self.paf0(f), self.hm0(f)
        for s in range(1, self.n_stages):
            cat = torch.cat([f, paf, hm], 1)
            paf, hm = getattr(self, f"paf{s}")(cat), getattr(self, f"hm{s}")(cat)
        return paf, hm
