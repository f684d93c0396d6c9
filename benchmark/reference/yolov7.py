"""YOLOv7 network, plain PyTorch (WongKinYiu/yolov7 ``cfg/training/
yolov7.yaml`` at l, ``yolov7x.yaml`` at x): E-ELAN blocks, the dual-path
``Transition`` downsample, ``SPPCSPC``, the PAN head and three anchor
heads, RepConv before each at l (training form: 3x3 + BN, 1x1 + BN,
identity BN where the shapes allow). ``state_dict`` keys are those of the
port's network (``backbone.stem.0``, ``backbone.dark2.1.cv3.0``,
``sppcspc.cv7``, ``rep_conv_1.rbr_dense.0``, ``yolo_head_P3``).

Takes NHWC images in [0, 1] and returns the raw maps NHWC
``(B, H/s, W/s, na*(5+nc))``, channels anchor-major. Departures from the
published network: those of ``reference.nn`` (BatchNorm's running
variance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import (Conv2d, ConvBnAct, bn, pool_same,
                                    upsample2x)


class MultiConcat(nn.Module):
    def __init__(self, c1, mid, mid2, c2, n, ids):
        super().__init__()
        self.cv1 = ConvBnAct(c1, mid)
        self.cv2 = ConvBnAct(c1, mid)
        self.cv3 = nn.ModuleList(ConvBnAct(mid if i == 0 else mid2, mid2, 3)
                                 for i in range(n))
        widths = [mid, mid] + [mid2] * n
        self.ids = tuple(ids)
        self.cv4 = ConvBnAct(sum(widths[i] for i in self.ids), c2)

    def forward(self, x):
        y = self.cv2(x)
        outs = [self.cv1(x), y]
        for m in self.cv3:
            y = m(y)
            outs.append(y)
        return self.cv4(torch.cat([outs[i] for i in self.ids], 1))


class Transition(nn.Module):
    def __init__(self, c1, ch):
        super().__init__()
        self.cv1 = ConvBnAct(c1, ch)
        self.cv2 = ConvBnAct(c1, ch)
        self.cv3 = ConvBnAct(ch, ch, 3, 2)

    def forward(self, x):
        return torch.cat([self.cv3(self.cv2(x)),
                          self.cv1(F.max_pool2d(x, 2, 2))], 1)


class SPPCSPC(nn.Module):
    def __init__(self, c1, c2, ks=(5, 9, 13)):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2)
        self.cv2 = ConvBnAct(c1, c2)
        self.cv3 = ConvBnAct(c2, c2, 3)
        self.cv4 = ConvBnAct(c2, c2)
        self.cv5 = ConvBnAct(c2 * (1 + len(ks)), c2)
        self.cv6 = ConvBnAct(c2, c2, 3)
        self.cv7 = ConvBnAct(2 * c2, c2)
        self.ks = ks

    def forward(self, x):
        y = self.cv4(self.cv3(self.cv1(x)))
        z = torch.cat([y] + [pool_same(y, k) for k in self.ks], 1)
        return self.cv7(torch.cat([self.cv6(self.cv5(z)), self.cv2(x)], 1))


class RepConv(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.rbr_dense = nn.Sequential(Conv2d(c1, c2, 3, 1, 1, bias=False),
                                       bn(c2))
        self.rbr_1x1 = nn.Sequential(Conv2d(c1, c2, 1, 1, 0, bias=False),
                                     bn(c2))
        self.rbr_identity = bn(c1) if c1 == c2 else None

    def forward(self, x):
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return F.silu(y)


PHI = {
    "l": dict(tc=32, bc=32, pc=32, e=2, n=4, ids=(-1, -3, -5, -6),
              head_ids=(-1, -2, -3, -4, -5, -6), rep_head=True),
    "x": dict(tc=40, bc=32, pc=64, e=1, n=6, ids=(-1, -3, -5, -7, -8),
              head_ids=(-1, -3, -5, -7, -8), rep_head=False),
}


class Backbone(nn.Module):
    def __init__(self, tc, bc, n, ids):
        super().__init__()
        self.stem = nn.Sequential(ConvBnAct(3, tc, 3),
                                  ConvBnAct(tc, 2 * tc, 3, 2),
                                  ConvBnAct(2 * tc, 2 * tc, 3))
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


class YOLOv7(nn.Module):
    def __init__(self, phi: str = "l", nc: int = 80, na: int = 3):
        super().__init__()
        p = PHI[phi]
        tc, pc, e, n, hids = p["tc"], p["pc"], p["e"], p["n"], p["head_ids"]
        self.nc, self.na = nc, na
        self.backbone = Backbone(tc, p["bc"], n, p["ids"])
        self.sppcspc = SPPCSPC(32 * tc, 16 * tc)
        self.conv_for_P5 = ConvBnAct(16 * tc, 8 * tc)
        self.conv_for_feat2 = ConvBnAct(32 * tc, 8 * tc)
        self.conv3_for_upsample1 = MultiConcat(16 * tc, 4 * pc * e, 4 * pc,
                                               8 * tc, n, hids)
        self.conv_for_P4 = ConvBnAct(8 * tc, 4 * tc)
        self.conv_for_feat1 = ConvBnAct(16 * tc, 4 * tc)
        self.conv3_for_upsample2 = MultiConcat(8 * tc, 2 * pc * e, 2 * pc,
                                               4 * tc, n, hids)
        self.down_sample1 = Transition(4 * tc, 4 * tc)
        self.conv3_for_downsample1 = MultiConcat(16 * tc, 4 * pc * e, 4 * pc,
                                                 8 * tc, n, hids)
        self.down_sample2 = Transition(8 * tc, 8 * tc)
        self.conv3_for_downsample2 = MultiConcat(32 * tc, 8 * pc * e, 8 * pc,
                                                 16 * tc, n, hids)
        no = na * (5 + nc)
        for i, (cin, ch) in enumerate(((4 * tc, 8 * tc), (8 * tc, 16 * tc),
                                       (16 * tc, 32 * tc))):
            setattr(self, f"rep_conv_{i + 1}",
                    RepConv(cin, ch) if p["rep_head"]
                    else ConvBnAct(cin, ch, 3))
            setattr(self, f"yolo_head_P{i + 3}", Conv2d(ch, no, 1))

    def forward(self, images: torch.Tensor):
        bb = self.backbone
        x = images.permute(0, 3, 1, 2)
        p3 = bb.dark3(bb.dark2(bb.stem(x)))
        p4 = bb.dark4(p3)
        p5 = bb.dark5(p4)
        sppc = self.sppcspc(p5)
        h4 = self.conv3_for_upsample1(torch.cat(
            [self.conv_for_feat2(p4), upsample2x(self.conv_for_P5(sppc))], 1))
        h3 = self.conv3_for_upsample2(torch.cat(
            [self.conv_for_feat1(p3), upsample2x(self.conv_for_P4(h4))], 1))
        h4b = self.conv3_for_downsample1(
            torch.cat([self.down_sample1(h3), h4], 1))
        h5 = self.conv3_for_downsample2(
            torch.cat([self.down_sample2(h4b), sppc], 1))
        return tuple(
            head(rep(f)).permute(0, 2, 3, 1)
            for f, rep, head in ((h3, self.rep_conv_1, self.yolo_head_P3),
                                 (h4b, self.rep_conv_2, self.yolo_head_P4),
                                 (h5, self.rep_conv_3, self.yolo_head_P5)))
