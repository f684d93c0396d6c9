"""The one traffic generator: it reads a workload file's parameters and
makes the cell's inputs from the seed.

Detection: a pool of raw RGB uint8 images, ``per_shape`` of each
(h, w) in ``shapes``, their pixels uniform on the device, copied to
the host as the program's callers hold them; batches draw from the pool in
seeded permutations, so every seed sends the same set of sizes in
another order.

Training: a ring of ``ring`` global batches on the device: images uniform
in [0, 1) in the program's compute dtype, and GT rows drawn by ``gt``:
a count an image from a geometric law of the given mean, capped at (and
padded to) the configuration's ``max_num_boxes``; a box's side
(sqrt of its area) log-uniform within the size class drawn by
``size_split`` ([share, low px, high px] for small, medium, large), its
aspect ratio log-uniform in ``aspect``, its centre uniform where it fits;
labels uniform over the classes.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch


def detect_pool(shapes: list, per_shape: int, seed: int, device,
                divisor: int = 1) -> List[np.ndarray]:
    """The pool of host images, ``per_shape`` of each (h, w) in ``shapes``;
    ``divisor`` shrinks every side (CPU tests)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = []
    for h, w in shapes:
        h, w = max(h // divisor, 8), max(w // divisor, 8)
        block = torch.randint(0, 256, (per_shape, h, w, 3),
                              generator=g, device=dev, dtype=torch.uint8)
        pool.extend(block.cpu().numpy())
    return pool


def batch_order(n_pool: int, batch: int, seed: int) -> Iterator[List[int]]:
    """Endless batches of pool indices: seeded permutations, back to
    back."""
    rng = np.random.default_rng([seed, 1])
    stream: List[int] = []
    while True:
        while len(stream) < batch:
            stream.extend(rng.permutation(n_pool).tolist())
        yield stream[:batch]
        stream = stream[batch:]


def gt_rows(spec: dict, n_images: int, S: int, M: int, nc: int,
            rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """(labels (N, M), boxes (N, M, 4) xyxy px, mask (N, M)) by the law."""
    count = np.minimum(rng.geometric(1.0 / spec["mean"], n_images), M)
    shares = np.array([s[0] for s in spec["size_split"]], np.float64)
    lo = np.array([s[1] for s in spec["size_split"]], np.float64)
    hi = np.array([s[2] for s in spec["size_split"]], np.float64)
    k = rng.choice(len(shares), (n_images, M), p=shares / shares.sum())
    side = np.exp(rng.uniform(np.log(lo[k]), np.log(hi[k])))
    a0, a1 = spec["aspect"]
    aspect = np.exp(rng.uniform(np.log(a0), np.log(a1), (n_images, M)))
    w = np.minimum(side * np.sqrt(aspect), S)
    h = np.minimum(side / np.sqrt(aspect), S)
    cx = rng.uniform(w / 2, S - w / 2)
    cy = rng.uniform(h / 2, S - h / 2)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    mask = np.arange(M)[None, :] < count[:, None]
    labels = rng.integers(0, nc, (n_images, M))
    boxes = np.where(mask[..., None], boxes, 0.0)
    labels = np.where(mask, labels, 0)
    return {"gt_labels": labels.astype(np.int64),
            "gt_bboxes": boxes.astype(np.float32), "gt_mask": mask}


def train_ring(spec: dict, seed: int, device, B: int, S: int, M: int,
               nc: int, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
    """``spec["ring"]`` global batches of B images on the device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng([seed, 2])
    ring = []
    for _ in range(spec["ring"]):
        rows = gt_rows(spec["gt"], B, S, M, nc, rng)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        batch["images"] = torch.rand((B, S, S, 3), generator=g,
                                     device=dev).to(dtype)
        ring.append(batch)
    return ring
