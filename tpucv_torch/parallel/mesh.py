"""The data-parallel mesh (counterpart of the data axis of
``tpucv/parallel/mesh.py``).

tpucv shards the batch over the ``data`` axis of a ``(data, model)`` mesh
and lets XLA insert the collectives; its step on W devices is one step on
the global batch. The port keeps that contract with W processes
(``torch.distributed``, one rank a device):

- each rank runs the network on its rows of the global batch
  (``DataMesh.rows``), and BatchNorm takes its statistics over the whole
  global batch (``nn.blocks.BatchNorm2d``);
- ``gather_rows`` assembles the global head outputs on every rank, and the
  family's own loss and in-graph targets run on the global batch there, so
  every normaliser that spans the batch (YOLOv8's ``target_scores_sum``,
  SSD's positive count and hard-negative sort, CenterNet's and DeepLab's
  counts) is the one-process one;
- ``all_reduce_grads`` sums the gradients over the ranks.

Every rank computes the same global loss, so the gradient that reaches
``gather_rows`` is the same on every rank: its backward keeps this rank's
rows with no collective, each rank's gradients are its rows' share of the
global gradient, and their sum over the ranks is the global gradient.
BatchNorm's cross-rank terms come back through ``all_reduce_sum``, whose
backward sums each rank's share.

ZeRO-1 (``opt_state_sharding_rule``'s counterpart): the Adam moments are
partitioned over the ranks by ``ZeroRedundancyOptimizer``, and each rank
broadcasts the parameters it updated (``zero_adam``).

``n_model > 1`` (channel sharding), spatial partitioning and batch-sharded
inference are not ported (ROADMAP queue 1, item 14b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from tpucv_torch.parallel import multihost
from tpucv_torch.utils.device import get_device


@dataclass(frozen=True)
class DataMesh:
    """W ranks on the data axis, this process the ``rank``-th."""
    world: int = 1
    rank: int = 0

    @classmethod
    def current(cls) -> "DataMesh":
        """The mesh of this process's world (one rank without a process
        group)."""
        return cls(multihost.world_count(), multihost.process_index())

    @property
    def parallel(self) -> bool:
        return self.world > 1

    def check_batch(self, batch_size: int, grad_accum: int = 1) -> None:
        """Raise unless every micro-batch splits evenly over the ranks."""
        if batch_size % (grad_accum * self.world):
            raise ValueError(
                f"batch_size={batch_size} does not split over "
                f"grad_accum={grad_accum} micro-batches of world size "
                f"{self.world}: it must be a multiple of "
                f"{grad_accum * self.world}")

    def rows(self, batch_size: int, grad_accum: int = 1) -> np.ndarray:
        """The rows of a global batch that this rank feeds: its contiguous
        share of each of the ``grad_accum`` micro-batches (tpucv splits the
        batch into micro-batches first, ``x.reshape(G, B // G, ...)``, and
        shards each over the data axis). With one micro-batch, tpucv's
        ``local_batch_slice``."""
        self.check_batch(batch_size, grad_accum)
        micro = batch_size // grad_accum
        per = micro // self.world
        return np.concatenate([np.arange(i * micro + self.rank * per,
                                         i * micro + (self.rank + 1) * per)
                               for i in range(grad_accum)])


def rank_device(device="cuda") -> torch.device:
    """This rank's device: for a bare ``"cuda"``, ``utils.device.
    get_device``'s card (``cuda:LOCAL_RANK`` under torchrun, one rank a
    card; else the one with the most free memory), else ``device`` as
    given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return get_device("cuda")
    return dev


class _GatherRows(torch.autograd.Function):
    """All ranks' rows of a tensor, concatenated in rank order. The
    backward returns this rank's rows of the gradient: every rank computes
    the same loss, so no collective is needed."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, world: int, rank: int):
        ctx.rank, ctx.rows = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        r, n = ctx.rank, ctx.rows
        return g[r * n:(r + 1) * n], None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the
    gradients (each rank's share of the loss reaches every rank's
    input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably."""
    return _AllReduceSum.apply(x)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def gather_rows(tree: Any, mesh: DataMesh) -> Any:
    """Every tensor of ``tree`` (the head's outputs) with the ranks' rows
    concatenated along the batch axis, differentiable (``_GatherRows``)."""
    return _tree_map(lambda t: _GatherRows.apply(t, mesh.world, mesh.rank),
                     tree)


def gather_batch(batch: Dict[str, torch.Tensor],
                 mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """The global batch's targets: every entry of ``batch`` but the images,
    all ranks' rows concatenated (bool through uint8, which every backend
    gathers)."""

    def gather(t: torch.Tensor) -> torch.Tensor:
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, 0)
        return out.bool() if t.dtype == torch.bool else out

    return {k: (v if k == "images" else gather(v)) for k, v in batch.items()}


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the parameters' gradients over the ranks: one all-reduce over a
    flat copy of them, then each gradient replaced by its sum."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def zero_adam(params: List[torch.nn.Parameter], lr: float,
              weight_decay: float = 0.0):
    """ZeRO-1 Adam: ``ZeroRedundancyOptimizer`` over ``torch.optim.Adam``
    with optax's defaults, each rank holding the moments of its share of
    the parameters and broadcasting those it updated."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(
        params, optimizer_class=torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay)


def is_zero(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def moment_bytes(optimizer) -> int:
    """Bytes of the Adam moments this rank holds (``exp_avg`` and
    ``exp_avg_sq``), for either optimizer."""
    inner = optimizer.optim if is_zero(optimizer) else optimizer
    return sum(v.numel() * v.element_size()
               for s in inner.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq"))
