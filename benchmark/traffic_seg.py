"""The segmentation cells' traffic: a ring of ``ring`` global batches made
on the device from the seed, as the program's VOC loader hands them to
the step (``trainer/segmentation_trainer.py``).

- ``images``: RGB uint8 pixels uniform over 0-255, through the loader's
  arithmetic in the compute dtype: /255, then ImageNet's mean and standard
  deviation;
- ``labels`` (B, S, S) int32: background 0; ``objects`` an image from a
  geometric law of the given mean (at least one); each a filled
  axis-aligned ellipse of a class uniform in 1..nc-1, its area
  log-uniform in ``area`` (shares of the crop), its aspect (width over
  height) log-uniform in ``aspect``, its centre uniform over the crop, so
  that a large one runs off the edge; later objects paint over earlier
  ones. Then a void band (``void``, 255) along every boundary between two
  labels: a pixel whose (w + 1) x (w + 1) window holds two labels, which
  makes a band w px wide across a straight edge, w an image drawn
  uniform over the integers in ``band_px``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def label_maps(spec: dict, n_images: int, S: int, nc: int,
               rng: np.random.Generator, device) -> torch.Tensor:
    """(n_images, S, S) int32 label maps on ``device`` by the law."""
    dev = torch.device(device)
    yy, xx = torch.meshgrid(torch.arange(S, device=dev, dtype=torch.float32),
                            torch.arange(S, device=dev, dtype=torch.float32),
                            indexing="ij")
    a0, a1 = spec["area"]
    r0, r1 = spec["aspect"]
    b0, b1 = spec["band_px"]
    out = torch.zeros((n_images, S, S), dtype=torch.int32, device=dev)
    for i in range(n_images):
        lab = out[i]
        for _ in range(int(rng.geometric(1.0 / spec["objects"]))):
            area = np.exp(rng.uniform(np.log(a0), np.log(a1))) * S * S
            aspect = np.exp(rng.uniform(np.log(r0), np.log(r1)))
            ax = np.sqrt(area / np.pi * aspect)        # semi-axes
            ay = np.sqrt(area / np.pi / aspect)
            cx, cy = rng.uniform(0, S, 2)
            inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
            lab[inside] = int(rng.integers(1, nc))
        k = int(rng.integers(b0, b1 + 1)) + 1
        f = F.pad(lab.float()[None, None], (k // 2, (k - 1) // 2) * 2,
                  mode="replicate")
        hi = F.max_pool2d(f, k, 1)[0, 0]
        lo = -F.max_pool2d(-f, k, 1)[0, 0]
        lab[hi != lo] = spec["void"]
    return out


def train_ring(spec: dict, seed: int, device, B: int, S: int, nc: int,
               dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
    """``spec["ring"]`` global batches of B images on the device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng([seed, 3])
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=dev)
    ring = []
    for _ in range(spec["ring"]):
        u8 = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev,
                           dtype=torch.uint8)
        x = u8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=dev)
        ring.append({"images": (x - mean) / std,
                     "labels": label_maps(spec["labels"], B, S, nc, rng,
                                          dev)})
    return ring
