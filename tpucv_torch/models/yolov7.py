"""YOLOv7, l and x (counterpart of ``tpucv/models/yolov7.py``): the E-ELAN
backbone, ``Transition`` dual-path downsampling, ``SPPCSPC``, the PAN head
and three anchor heads, with ``RepConv`` before each head at l.

Submodule names are the reference network's, so a ``state_dict`` carries
its keys (``backbone.stem.0``, ``backbone.dark2.1.cv3.0``,
``conv3_for_upsample1``, ``sppcspc.cv7``, ``rep_conv_1.rbr_dense.0``,
``yolo_head_P3``) and a reference ``.pth`` loads with no importer. The
forward takes tpucv's NHWC input and returns tpucv's NHWC raw maps
``(B, H/s, W/s, na*(5+nc))`` for s = 8, 16, 32, channels anchor-major;
inside it runs NCHW modules, on a ``channels_last`` tensor on the card.
``RepConv`` keeps its training branches; ``deploy.fuse_repconv_params``
folds them into one 3x3 conv. At nc=20, l has 37,297,025 parameters and
x 70,940,649.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import (BN_EPS, BN_MOMENTUM, BatchNorm2d,
                                   ConvBnAct, init_weights, max_pool_same,
                                   upsample2x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MultiConcat(nn.Module):
    """E-ELAN block: 1x1 ``cv1`` and ``cv2`` to ``mid``, ``n`` chained 3x3
    ``cv3.{i}`` of ``mid2`` off ``cv2``, the outputs picked by ``ids``
    (negative indices into [cv1, cv2, o1..on]) concatenated into 1x1
    ``cv4``."""

    def __init__(self, in_ch: int, mid: int, mid2: int, out_ch: int,
                 n: int = 4, ids: Sequence[int] = (-1, -3, -5, -6)):
        super().__init__()
        self.cv1 = ConvBnAct(in_ch, mid, 1)
        self.cv2 = ConvBnAct(in_ch, mid, 1)
        self.cv3 = nn.ModuleList(
            ConvBnAct(mid if i == 0 else mid2, mid2, 3) for i in range(n))
        widths = [mid, mid] + [mid2] * n
        self.ids = tuple(ids)
        self.cv4 = ConvBnAct(sum(widths[i] for i in self.ids), out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(x)
        outs = [self.cv1(x), y]
        for m in self.cv3:
            y = m(y)
            outs.append(y)
        return self.cv4(torch.cat([outs[i] for i in self.ids], 1))


class Transition(nn.Module):
    """Dual-path downsample to ``2*ch``: 3x3 stride-2 ``cv3`` after 1x1
    ``cv2``, beside a 2x2 stride-2 VALID max pool and 1x1 ``cv1``;
    concatenated [conv path, pool path]."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.cv1 = ConvBnAct(in_ch, ch, 1)
        self.cv2 = ConvBnAct(in_ch, ch, 1)
        self.cv3 = ConvBnAct(ch, ch, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(F.max_pool2d(x, 2, 2))
        return torch.cat([self.cv3(self.cv2(x)), a], 1)


class SPPCSPC(nn.Module):
    """CSP spatial pyramid pooling: cv1 -> cv3 (3x3) -> cv4, max pools of
    5, 9, 13 (stride 1, -inf padding) beside it, cv5 -> cv6 (3x3), then
    cv7 over [that, the cv2 shortcut]."""

    def __init__(self, in_ch: int, out_ch: int,
                 ks: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = out_ch
        self.cv1 = ConvBnAct(in_ch, c_, 1)
        self.cv2 = ConvBnAct(in_ch, c_, 1)
        self.cv3 = ConvBnAct(c_, c_, 3)
        self.cv4 = ConvBnAct(c_, c_, 1)
        self.cv5 = ConvBnAct(c_ * (1 + len(ks)), c_, 1)
        self.cv6 = ConvBnAct(c_, c_, 3)
        self.cv7 = ConvBnAct(2 * c_, out_ch, 1)
        self.ks = ks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv4(self.cv3(self.cv1(x)))
        z = torch.cat([y] + [max_pool_same(y, k) for k in self.ks], 1)
        z = self.cv6(self.cv5(z))
        return self.cv7(torch.cat([z, self.cv2(x)], 1))


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class RepConv(nn.Module):
    """Re-parameterisable conv: 3x3 conv + BN (``rbr_dense``) plus 1x1
    conv + BN (``rbr_1x1``), plus a BN of the input (``rbr_identity``)
    where in == out and the stride is 1, summed, then SiLU. The int8 hook
    does not reach it: it stays float when the model is quantized."""

    def __init__(self, in_ch: int, out_ch: int, s: int = 1):
        super().__init__()
        self.rbr_dense = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, s, 1, bias=False), _bn(out_ch))
        self.rbr_1x1 = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, s, 0, bias=False), _bn(out_ch))
        self.rbr_identity = (_bn(in_ch) if in_ch == out_ch and s == 1
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return F.silu(y)


# per-phi structure: transition channels tc, block channels bc, panet
# channels pc, head expansion e, convs per block n, the concat picks of
# the backbone's and the head's blocks, RepConv (l) or ConvBnAct (x)
# before each head conv
PHI: Dict[str, dict] = {
    "l": dict(tc=32, bc=32, pc=32, e=2, n=4,
              ids=(-1, -3, -5, -6), head_ids=(-1, -2, -3, -4, -5, -6),
              rep_head=True),
    "x": dict(tc=40, bc=32, pc=64, e=1, n=6,
              ids=(-1, -3, -5, -7, -8), head_ids=(-1, -3, -5, -7, -8),
              rep_head=False),
}


class Backbone(nn.Module):
    """Stem (three 3x3 convs) and four stages ``dark2..dark5``, each a
    downsample then an E-ELAN block; returns the /8, /16, /32 features."""

    def __init__(self, tc: int, bc: int, n: int, ids: Sequence[int]):
        super().__init__()
        self.stem = nn.Sequential(
            ConvBnAct(3, tc, 3, 1), ConvBnAct(tc, 2 * tc, 3, 2),
            ConvBnAct(2 * tc, 2 * tc, 3, 1))
        self.dark2 = nn.Sequential(
            ConvBnAct(2 * tc, 4 * tc, 3, 2),
            MultiConcat(4 * tc, 2 * bc, 2 * bc, 8 * tc, n, ids))
        self.dark3 = nn.Sequential(
            Transition(8 * tc, 4 * tc),
            MultiConcat(8 * tc, 4 * bc, 4 * bc, 16 * tc, n, ids))
        self.dark4 = nn.Sequential(
            Transition(16 * tc, 8 * tc),
            MultiConcat(16 * tc, 8 * bc, 8 * bc, 32 * tc, n, ids))
        self.dark5 = nn.Sequential(
            Transition(32 * tc, 16 * tc),
            MultiConcat(32 * tc, 8 * bc, 8 * bc, 32 * tc, n, ids))

    def forward(self, x: torch.Tensor):
        p3 = self.dark3(self.dark2(self.stem(x)))
        p4 = self.dark4(p3)
        return p3, p4, self.dark5(p4)


class Yolo7(nn.Module):
    """``forward`` maps (B, H, W, 3) images to the raw maps
    ``((B, H/8, W/8, no), (B, H/16, W/16, no), (B, H/32, W/32, no))``,
    ``no = na*(5+nc)``, channel ``a*(5+nc) + c`` for anchor a."""

    def __init__(self, nc: int = 20, na: int = 3, phi: str = "l"):
        super().__init__()
        if phi not in PHI:
            raise ValueError(f"phi {phi!r}: YOLOv7 has {tuple(PHI)}")
        p = PHI[phi]
        tc, bc, pc, e, n = p["tc"], p["bc"], p["pc"], p["e"], p["n"]
        hids = p["head_ids"]
        self.nc, self.na, self.phi = nc, na, phi
        self.backbone = Backbone(tc, bc, n, p["ids"])
        self.sppcspc = SPPCSPC(32 * tc, 16 * tc)
        self.conv_for_P5 = ConvBnAct(16 * tc, 8 * tc, 1)
        self.conv_for_feat2 = ConvBnAct(32 * tc, 8 * tc, 1)
        self.conv3_for_upsample1 = MultiConcat(
            16 * tc, 4 * pc * e, 4 * pc, 8 * tc, n, hids)
        self.conv_for_P4 = ConvBnAct(8 * tc, 4 * tc, 1)
        self.conv_for_feat1 = ConvBnAct(16 * tc, 4 * tc, 1)
        self.conv3_for_upsample2 = MultiConcat(
            8 * tc, 2 * pc * e, 2 * pc, 4 * tc, n, hids)
        self.down_sample1 = Transition(4 * tc, 4 * tc)
        self.conv3_for_downsample1 = MultiConcat(
            16 * tc, 4 * pc * e, 4 * pc, 8 * tc, n, hids)
        self.down_sample2 = Transition(8 * tc, 8 * tc)
        self.conv3_for_downsample2 = MultiConcat(
            32 * tc, 8 * pc * e, 8 * pc, 16 * tc, n, hids)
        no = na * (5 + nc)
        for i, (cin, ch) in enumerate(((4 * tc, 8 * tc), (8 * tc, 16 * tc),
                                       (16 * tc, 32 * tc))):
            rep = (RepConv(cin, ch) if p["rep_head"]
                   else ConvBnAct(cin, ch, 3, 1))
            setattr(self, f"rep_conv_{i + 1}", rep)
            setattr(self, f"yolo_head_P{i + 3}", nn.Conv2d(ch, no, 1))

    def reset_parameters(self, generator: torch.Generator) -> "Yolo7":
        """Random weights drawn from ``generator`` (``init_weights``:
        LeCun-normal convs, zero biases, identity BatchNorm)."""
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2)                # NHWC -> NCHW view
        p3, p4, p5 = self.backbone(x)
        sppc = self.sppcspc(p5)
        up1 = upsample2x(self.conv_for_P5(sppc))
        h4 = self.conv3_for_upsample1(
            torch.cat([self.conv_for_feat2(p4), up1], 1))
        up2 = upsample2x(self.conv_for_P4(h4))
        h3 = self.conv3_for_upsample2(
            torch.cat([self.conv_for_feat1(p3), up2], 1))
        h4b = self.conv3_for_downsample1(
            torch.cat([self.down_sample1(h3), h4], 1))
        h5 = self.conv3_for_downsample2(
            torch.cat([self.down_sample2(h4b), sppc], 1))
        return tuple(
            _nhwc(head(rep(f))) for f, rep, head in (
                (h3, self.rep_conv_1, self.yolo_head_P3),
                (h4b, self.rep_conv_2, self.yolo_head_P4),
                (h5, self.rep_conv_3, self.yolo_head_P5)))
