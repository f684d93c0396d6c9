"""DeepLabV3+ on a dilated ResNet-101, its focal loss and its Adam run,
plain float32 PyTorch (Chen et al., "Encoder-Decoder with Atrous Separable
Convolution for Semantic Image Segmentation", arXiv:1802.02611, with the
head of calmiLovesAI/ComputerVision.pytorch ``core/models/
deeplabv3plus.py``, ``DeeplabHeadV3Plus``). It imports nothing of the
measured program.

The network:

- torchvision's ResNet-101 (a 7x7 stride-2 stem, BatchNorm, ReLU, a 3x3
  stride-2 max pool; layers of 3, 4, 23 and 3 Bottlenecks, 1x1, 3x3 with
  the stride and dilation, 1x1 to 4x the width, the identity or a strided
  1x1 projection on each layer's first block), at output stride 16 or 8
  as ``replace_stride_with_dilation`` makes it: a dilated layer's first
  block keeps the previous dilation, its later blocks take the doubled
  one;
- ASPP on layer 4: a 1x1 conv, three dilated 3x3 convs (``rates``), the
  image-pool branch (the spatial mean, a 1x1 conv, BatchNorm and ReLU,
  broadcast back), each ``ASPP_CH`` wide with BatchNorm and ReLU, their
  concat projected to ``ASPP_CH`` by a 1x1 conv, BatchNorm, ReLU and
  dropout (train mode);
- the decoder: layer 1 projected to ``LOW_CH`` by a 1x1 conv, BatchNorm
  and ReLU, the ASPP output resized bilinearly to its size, the concat
  [low, ASPP] through one 3x3 conv, BatchNorm and ReLU, and a biased 1x1
  classifier; the logits resized bilinearly to the input. Both resizes
  are ``F.interpolate(mode="bilinear", align_corners=False)``.

Every conv but the classifier is bias-free. ``state_dict`` keys are the
measured program's (torchvision's ``backbone.*``,
``classifier.aspp.convs.{0..3}.{0,1}``, ``classifier.aspp.convs.4.{1,2}``,
``classifier.aspp.project.{0,1}``, ``classifier.project.{0,1}``,
``classifier.classifier.{0,1,3}``), so one set of weights loads into both.

Departures from the published model:

- the decoder has one 3x3 conv, as the head named above and
  VainF/DeepLabV3Plus-Pytorch have it (the paper: two);
- BatchNorm (``reference.nn.BatchNorm``, eps 1e-5, momentum 0.1) folds
  the biased batch variance into its running variance, the program's rule
  (``nn.BatchNorm2d`` folds the unbiased one), once a step;
- the dropout's keep mask is drawn as the program draws it, so that a
  training step can be compared at all: ``torch.rand(shape,
  generator=torch.Generator(device).manual_seed(seed)) >= p`` with the
  seed ``step * G + i`` (one micro-batch a step here: the step's index),
  the kept values scaled by 1 / (1 - p).

The focal loss: ``alpha (1 - p_t)^gamma CE`` summed over the valid pixels
(label not ``ignore_index`` and in [0, nc)) over ``max(n_valid, 1)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.nn import (BatchNorm, Conv2d, arm_batchnorm, fp32,
                                    set_precision, to_fp8)
from benchmark.reference.train import lr_at

BN_EPS, BN_MOMENTUM = 1e-5, 0.1
ASPP_CH, LOW_CH = 256, 48
PLANES = (64, 128, 256, 512)
BLOCKS = {"resnet101": (3, 4, 23, 3)}


class Conv(Conv2d):
    """``reference.nn.Conv2d`` with its dilation kept on the float8 path
    too (``set_precision``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return to_fp8(F.conv2d(to_fp8(x), to_fp8(self.weight), self.bias,
                                   self.stride, self.padding, self.dilation))
        return super().forward(x)


def conv(cin: int, cout: int, k: int, s: int = 1, d: int = 1) -> Conv:
    return Conv(cin, cout, k, s, d * (k - 1) // 2, dilation=d, bias=False)


def norm(ch: int) -> BatchNorm:
    return BatchNorm(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu(cin: int, cout: int, k: int, d: int = 1) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, k, 1, d), norm(cout), nn.ReLU())


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, s: int, d: int,
                 downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, planes, 1), norm(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, s, d), norm(planes)
        self.conv3, self.bn3 = conv(planes, 4 * planes, 1), norm(4 * planes)
        self.downsample = (nn.Sequential(conv(cin, 4 * planes, 1, s),
                                         norm(4 * planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResNet(nn.Module):
    def __init__(self, blocks: Sequence[int], output_stride: int):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2), norm(64)
        cin, stride_now, dilation = 64, 4, 1
        for li, (n, planes) in enumerate(zip(blocks, PLANES)):
            s = 1 if li == 0 else 2
            prev = dilation
            if stride_now * s > output_stride:
                dilation, s = dilation * s, 1
            stride_now *= s
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, planes, s if b == 0 else 1,
                                        prev if b == 0 else dilation,
                                        downsample=b == 0))
                cin = 4 * planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)

    def blocks(self) -> List[nn.Module]:
        return [m for i in range(1, 5) for m in getattr(self, f"layer{i}")]


class ImagePool(nn.Sequential):
    """Keys ``.1`` (conv) and ``.2`` (BatchNorm), as torchvision's
    ``ASPPPooling``."""

    def __init__(self, cin: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), conv(cin, ASPP_CH, 1),
                         norm(ASPP_CH), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self[2](self[1](x.mean((2, 3), keepdim=True))))
        return y.expand(-1, -1, *x.shape[2:])


class ASPP(nn.Module):
    def __init__(self, cin: int, rates: Sequence[int], dropout: float):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(cin, ASPP_CH, 1)]
            + [conv_bn_relu(cin, ASPP_CH, 3, r) for r in rates]
            + [ImagePool(cin)])
        self.project = conv_bn_relu(ASPP_CH * len(self.convs), ASPP_CH, 1)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        y = self.project(torch.cat([c(x) for c in self.convs], 1))
        if not self.training or self.dropout == 0:
            return y
        g = torch.Generator(device=y.device).manual_seed(seed)
        keep = torch.rand(y.shape, generator=g, device=y.device) \
            >= self.dropout
        return torch.where(keep, y / (1.0 - self.dropout),
                           torch.zeros((), device=y.device))


class Head(nn.Module):
    def __init__(self, nc: int, rates: Sequence[int], dropout: float):
        super().__init__()
        self.project = conv_bn_relu(4 * PLANES[0], LOW_CH, 1)
        self.aspp = ASPP(4 * PLANES[-1], rates, dropout)
        self.classifier = nn.Sequential(
            conv(LOW_CH + ASPP_CH, ASPP_CH, 3), norm(ASPP_CH), nn.ReLU(),
            Conv(ASPP_CH, nc, 1))

    def decode(self, low_level: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        low = self.project(low_level)
        y = resize(y, low.shape[2:])
        return self.classifier(torch.cat([low, y], 1))


def resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class DeepLabV3Plus(nn.Module):
    def __init__(self, nc: int = 21, backbone: str = "resnet101",
                 output_stride: int = 16, rates: Sequence[int] = (6, 12, 18),
                 dropout: float = 0.1):
        super().__init__()
        self.backbone = ResNet(BLOCKS[backbone], output_stride)
        self.classifier = Head(nc, rates, dropout)

    def forward(self, images: torch.Tensor, dropout_seed: int = 0,
                recompute: bool = False) -> torch.Tensor:
        """NHWC images -> NCHW logits at the input's size. ``recompute``:
        keep only each block's output for the backward and run the block
        again there (``torch.utils.checkpoint``), which changes no value
        (the dropout mask is drawn again from its seed)."""

        def run(fn, *xs):
            if recompute and torch.is_grad_enabled():
                return checkpoint(fn, *xs, use_reentrant=False)
            return fn(*xs)

        H, W = images.shape[1:3]
        bb, head = self.backbone, self.classifier
        x = run(bb.stem, images.permute(0, 3, 1, 2))
        low = None
        for i, block in enumerate(bb.blocks()):
            x = run(block, x)
            if i == len(bb.layer1) - 1:
                low = x
        y = run(head.aspp, x, dropout_seed)
        return run(lambda a, b: resize(head.decode(a, b), (H, W)), low, y)


def build(network: dict) -> DeepLabV3Plus:
    """The reference of a configuration file's ``network``, on the current
    default device."""
    return DeepLabV3Plus(network["nc"], network["backbone"],
                         network["output_stride"],
                         tuple(network["aspp_rates"]),
                         network["aspp_dropout"])


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float,
               gamma: float, ignore_index: int) -> torch.Tensor:
    nc = logits.shape[1]
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < nc)
    logp = F.log_softmax(logits.float(), dim=1)
    ce = -logp.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    terms = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    return torch.where(valid, terms, 0.0).sum() / valid.sum().clamp(min=1)


def run(model: DeepLabV3Plus, state: Dict[str, torch.Tensor],
        batches: List[Dict[str, torch.Tensor]], loss_kw: dict, lr: float,
        warmup: int, prec: str = "f32", keep: Sequence[int] = ()) -> dict:
    """``model`` loaded with ``state`` and trained on ``batches`` (images
    NHWC, labels (B, H, W)): the train-mode forward with step t's dropout
    seed, the focal loss, the backward and Adam (b1 0.9, b2 0.999, eps
    1e-8, no weight decay) at ``lr_at(t)``, in float32 with TF32 off (or
    float8 convolutions, ``prec``), each block recomputed in the backward.
    Returns {"losses", "grads" (step 1), "states" ({t: the state after t
    steps} for each t of ``keep`` and the last)}, tensors on the device.
    The images are widened to the weights' dtype (float32; float64 in the
    CPU tests)."""
    model.load_state_dict(state)
    model.train()
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grads, states = [], None, {}
    keep = set(keep) | {len(batches)}
    dtype = model.classifier.classifier[0].weight.dtype
    set_precision(model, prec)
    with fp32():
        for t, batch in enumerate(batches):
            arm_batchnorm(model)
            for p in params.values():
                p.grad = None
            logits = model(batch["images"].to(dtype), dropout_seed=t,
                           recompute=True)
            loss = focal_loss(logits, batch["labels"], **loss_kw)
            loss.backward()
            losses.append(float(loss.detach()))
            if grads is None:
                grads = {n: p.grad.detach().clone()
                         for n, p in params.items()}
            lr_t = lr_at(t, lr, warmup)
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            with torch.no_grad():
                for n, p in params.items():
                    g = p.grad
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(c2)).add_(eps)
                    p.addcdiv_(m[n], denom, value=-lr_t / c1)
            if t + 1 in keep:
                states[t + 1] = {k: x.detach().clone()
                                 for k, x in model.state_dict().items()}
    set_precision(model, "f32")
    return {"losses": losses, "grads": grads, "states": states}
