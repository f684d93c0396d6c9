"""The ``(data, model)`` mesh (counterpart of ``tpucv/parallel/mesh.py``).

tpucv lays its devices out as a ``(data, model)`` mesh, row-major, and
lets XLA insert the collectives; its step on the mesh is one step on the
global batch. The port keeps that contract with W processes
(``torch.distributed``, one rank a device) on a mesh of ``n_data x
n_model`` ranks: rank ``r`` has data index ``r // n_model`` and model
index ``r % n_model``. Each data slice (the ranks of one data index) is a
model group; each model slice (the ranks of one model index) is a data
group.

The data axis:

- each rank runs the network on the rows of the global batch of its data
  index (``DataMesh.rows``); BatchNorm takes its statistics over the whole
  global batch, summed over the data group (``nn.blocks.BatchNorm2d``);
- ``gather_rows`` assembles the global head outputs over the data group,
  and the family's own loss and in-graph targets run on the global batch
  there, so every normaliser that spans the batch (YOLOv8's
  ``target_scores_sum``, SSD's positive count and hard-negative sort,
  CenterNet's and DeepLab's counts) is the one-process one;
- ``all_reduce_grads`` sums the gradients over the data group.

Every rank computes the same global loss, so the gradient that reaches
``gather_rows`` is the same on every rank: its backward keeps this rank's
rows with no collective, each rank's gradients are its rows' share of the
global gradient, and their sum over the data group is the global gradient.
BatchNorm's cross-rank terms come back through ``all_reduce_sum``, whose
backward sums each rank's share.

The model axis (``n_model > 1``, tpucv's ``param_sharding_rule``): a conv
whose weight has at least 65,536 elements and whose output channels divide
``n_model`` holds, on each model rank, only its slice of output channels
(``shard_model``: dim 0 of a ``Conv2d``'s OIHW weight, dim 1 of a
``ConvTranspose2d``'s; a grouped conv also takes its groups' input
channels). Its forward computes the local slice and all-gathers it along
channels over the model group (``_GatherChannels``); its bias stays whole
and is added after the gather.

- The gather's backward keeps this rank's channel slice with no
  collective: every rank of a model group holds the same rows and the same
  replicated weights, so everything downstream of the gather is the same on
  each of them, and so is the gradient that reaches it.
  ``torch.distributed.nn``'s all-gather sums in its backward instead, which
  would scale every gradient by ``n_model``.
- Each rank's slice reaches only part of the input's gradient, so the
  conv's input passes through ``_CopyToModel``: the identity forward, its
  backward the sum over the model group. Upstream of it every rank again
  holds the same gradient.
- ``all_reduce_grads`` sums a sharded kernel's gradient over the data group
  of its own model index. A replicated parameter's gradient is the same on
  every rank of a model group; it is summed over the whole world and
  divided by ``n_model``, so that every rank holds it bit for bit and the
  replicas never drift apart.
- BatchNorm's and dropout's cross-rank terms span the data group only.

ZeRO-1 (``opt_state_sharding_rule``'s counterpart): the Adam moments of
this rank's parameters are partitioned over its data group by
``ZeroRedundancyOptimizer``, and each rank broadcasts the parameters it
updated (``zero_adam``).

Batch-sharded inference (``sharded_infer``): a detector family's infer
function on this rank's rows, its fixed-shape outputs all-gathered in rank
order over the data group; no other collective. Spatial partitioning is
``parallel/spatial.py``.
"""

from __future__ import annotations

import copy
import types
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import GroupRef
from tpucv_torch.parallel import multihost
from tpucv_torch.utils.device import get_device

#: tpucv's ``param_sharding_rule``: kernels of at least this many elements
#: are sharded over the model axis
SHARD_MIN_SIZE = 1 << 16

def _mesh_groups(world: int, n_model: int) -> Tuple[list, list]:
    """The data groups (one a model index) and the model groups (one a
    data index) of a ``world / n_model x n_model`` mesh; None for a group
    of one rank, ``WORLD`` for a group of every rank. Collective: every
    rank creates every group, in the same order."""
    n_data = world // n_model

    def group(ranks):
        if len(ranks) == 1:
            return None
        if len(ranks) == world:
            return dist.group.WORLD
        return dist.new_group(ranks)

    data = [group(list(range(m, world, n_model))) for m in range(n_model)]
    model = [group(list(range(d * n_model, (d + 1) * n_model)))
             for d in range(n_data)]
    return data, model


@dataclass(frozen=True)
class DataMesh:
    """``world`` ranks as an ``n_data x n_model`` mesh, this process the
    ``rank``-th: data index ``rank // n_model``, model index ``rank %
    n_model``. ``data_group`` and ``model_group`` are this rank's process
    groups (None for a group of one rank)."""
    world: int = 1
    rank: int = 0
    n_model: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.n_model < 1 or self.world % self.n_model:
            raise ValueError(
                f"train.n_model={self.n_model} does not divide the "
                f"{self.world} ranks")

    @classmethod
    def current(cls, n_model: int = 1) -> "DataMesh":
        """The mesh of this process's world (one rank without a process
        group), ``n_model`` ranks on the model axis. Collective when it
        creates process groups (``1 < n_model < world``): every rank calls
        it at the same point."""
        world, rank = multihost.world_count(), multihost.process_index()
        mesh = cls(world, rank, n_model)
        if world == 1:
            return mesh
        data, model = _mesh_groups(world, n_model)
        return cls(world, rank, n_model, data[mesh.model_index],
                   model[mesh.data_index])

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def parallel(self) -> bool:
        return self.world > 1

    def check_batch(self, batch_size: int, grad_accum: int = 1) -> None:
        """Raise unless every micro-batch splits evenly over the data
        axis."""
        if batch_size % (grad_accum * self.n_data):
            raise ValueError(
                f"batch_size={batch_size} does not split over "
                f"grad_accum={grad_accum} micro-batches of world size "
                f"{self.n_data}: it must be a multiple of "
                f"{grad_accum * self.n_data}")

    def rows(self, batch_size: int, grad_accum: int = 1) -> np.ndarray:
        """The rows of a global batch that this rank feeds: its data
        index's contiguous share of each of the ``grad_accum``
        micro-batches (tpucv splits the batch into micro-batches first,
        ``x.reshape(G, B // G, ...)``, and shards each over the data
        axis). With one micro-batch, tpucv's ``local_batch_slice``."""
        self.check_batch(batch_size, grad_accum)
        micro = batch_size // grad_accum
        per = micro // self.n_data
        d = self.data_index
        return np.concatenate([np.arange(i * micro + d * per,
                                         i * micro + (d + 1) * per)
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


def all_gather(x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """``x`` of each of the ``n`` ranks of ``group``, in group order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _GatherRows(torch.autograd.Function):
    """All ranks' rows of a tensor, concatenated in data-index order. The
    backward returns this rank's rows of the gradient: every rank computes
    the same loss, so no collective is needed."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh):
        ctx.rank, ctx.rows = mesh.data_index, x.shape[0]
        return torch.cat(all_gather(x, mesh.data_group, mesh.n_data), 0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        r, n = ctx.rank, ctx.rows
        return g[r * n:(r + 1) * n], None


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group; its backward is the same sum of the gradients
    (each rank's share of the loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the world by default),
    differentiably."""
    return _AllReduceSum.apply(x, group)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def gather_rows(tree: Any, mesh: DataMesh) -> Any:
    """Every tensor of ``tree`` (the head's outputs) with the data ranks'
    rows concatenated along the batch axis, differentiable
    (``_GatherRows``); ``tree`` itself on a mesh of one data index."""
    if mesh.n_data == 1:
        return tree
    return _tree_map(lambda t: _GatherRows.apply(t, mesh), tree)


def _gather_any(t: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along ``dim``, bool
    through uint8, which every backend gathers; not differentiable."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    out = torch.cat(all_gather(src, group, n), dim)
    return out.bool() if t.dtype == torch.bool else out


def gather_batch(batch: Dict[str, torch.Tensor],
                 mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """The global batch's targets: every entry of ``batch`` but the images,
    all data ranks' rows concatenated."""
    if mesh.n_data == 1:
        return batch
    return {k: (v if k == "images" else
                _gather_any(v, mesh.data_group, mesh.n_data))
            for k, v in batch.items()}


def _flat_all_reduce(grads: List[torch.Tensor], group,
                     scale: float = 1.0) -> None:
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def all_reduce_grads(params: Iterable[torch.Tensor],
                     mesh: Optional[DataMesh] = None) -> None:
    """Sum the parameters' gradients over the data axis, one all-reduce
    over a flat copy of them each: a kernel sharded over the model axis
    over the data group of its model index; a replicated parameter over
    the world, divided by ``n_model`` (every rank of a model group holds
    the same gradient), so that all ranks hold the same sum. Without
    ``mesh``, every gradient over the world."""
    params = [p for p in params if p.grad is not None]
    if mesh is None or mesh.n_model == 1:
        if mesh is None or mesh.n_data > 1:
            _flat_all_reduce([p.grad for p in params],
                             None if mesh is None else mesh.data_group)
        return
    sharded = [p.grad for p in params if getattr(p, "model_shard", None)]
    replicated = [p.grad for p in params
                  if not getattr(p, "model_shard", None)]
    if mesh.n_data > 1:
        _flat_all_reduce(sharded, mesh.data_group)
    _flat_all_reduce(replicated, None, 1.0 / mesh.n_model)


def zero_adam(params: List[torch.nn.Parameter], lr: float,
              weight_decay: float = 0.0, group=None):
    """ZeRO-1 Adam: ``ZeroRedundancyOptimizer`` over ``torch.optim.Adam``
    with optax's defaults, each rank of ``group`` (a data group; the world
    by default) holding the moments of its share of the parameters and
    broadcasting those it updated."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(
        params, optimizer_class=torch.optim.Adam, process_group=group,
        lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


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


# ------------------------------------------------------------ model axis
@dataclass(frozen=True)
class ModelShard:
    """This rank's slice of a parameter sharded over the model axis:
    ``n`` equal parts along ``dim``, the ``index``-th held here, gathered
    over the group ``ref`` holds."""
    dim: int
    n: int
    index: int
    ref: GroupRef = field(compare=False, repr=False)

    @property
    def group(self):
        return self.ref.group

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full``."""
        size = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * size, size)

    def whole(self, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's slice (collective over the
        model group)."""
        return torch.cat(all_gather(part, self.group, self.n), self.dim)


def is_sharded_kernel(conv: nn.Module, n_model: int) -> bool:
    """tpucv's ``param_sharding_rule`` on a conv's kernel: at least
    ``SHARD_MIN_SIZE`` elements and output channels that divide
    ``n_model`` (the last dim of flax's HWIO kernel)."""
    return (n_model > 1 and isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d))
            and conv.weight.dim() == 4
            and conv.weight.numel() >= SHARD_MIN_SIZE
            and conv.out_channels % n_model == 0)


def sharded_kernels(model: nn.Module, n_model: int) -> List[str]:
    """The names of the weights ``shard_model`` would shard."""
    return [f"{name}.weight" if name else "weight"
            for name, m in model.named_modules()
            if is_sharded_kernel(m, n_model)]


class _CopyToModel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model
    group: each rank's output slice reaches only its part of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The model ranks' channel slices concatenated along dim 1; the
    backward keeps this rank's slice of the gradient with no collective
    (everything downstream is the same on every rank of the group)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, shard: ModelShard):
        ctx.shard, ctx.width = shard, y.shape[1]
        return torch.cat(all_gather(y, shard.group, shard.n), 1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        i, c = ctx.shard.index, ctx.width
        return g[:, i * c:(i + 1) * c], None


def _local_input(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input channels a grouped conv's slice of groups reads (all of
    them for an ungrouped conv)."""
    sh = conv.weight.model_shard
    if conv.groups == 1:
        return x
    c = x.shape[1] // sh.n
    return x[:, sh.index * c:(sh.index + 1) * c]


def _sharded_conv_forward(self, x, weight, bias):
    sh = weight.model_shard
    x = _local_input(self, _CopyToModel.apply(x, sh.group))
    y = F.conv2d(x, weight, None, self.stride, self.padding, self.dilation,
                 self.groups // sh.n if self.groups > 1 else 1)
    y = _GatherChannels.apply(y, sh)
    return y if bias is None else y + bias[None, :, None, None]


def _sharded_conv_transpose_forward(self, x, output_size=None):
    sh = self.weight.model_shard
    out_pad = self._output_padding(x, output_size, self.stride, self.padding,
                                   self.kernel_size, 2, self.dilation)
    x = _local_input(self, _CopyToModel.apply(x, sh.group))
    y = F.conv_transpose2d(x, self.weight, None, self.stride, self.padding,
                           out_pad, self.groups // sh.n
                           if self.groups > 1 else 1, self.dilation)
    y = _GatherChannels.apply(y, sh)
    return y if self.bias is None else y + self.bias[None, :, None, None]


def shard_model(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """Shard ``model``'s large conv kernels over the model axis in place
    (``is_sharded_kernel``): each keeps only this rank's slice of output
    channels, marked with its ``ModelShard`` (``weight.model_shard``), and
    its forward computes that slice and gathers the channels over the
    model group. Call it before the optimizer is built, on the same
    weights on every rank. ``model`` itself when ``n_model`` is 1."""
    n = mesh.n_model
    if n == 1:
        return model
    for name, m in model.named_modules():
        if not is_sharded_kernel(m, n):
            continue
        if m.padding_mode != "zeros":
            raise NotImplementedError(
                f"{name}: a sharded conv pads with zeros only, not "
                f"{m.padding_mode!r}")
        transpose = isinstance(m, nn.ConvTranspose2d)
        if m.groups > 1 and m.groups % n:
            raise NotImplementedError(
                f"{name}: {m.groups} groups do not split over n_model={n}")
        # a grouped conv's groups are its output slices: dim 0 of either
        # layout; an ungrouped ConvTranspose2d's outputs are dim 1
        dim = 1 if transpose and m.groups == 1 else 0
        shard = ModelShard(dim, n, mesh.model_index,
                           GroupRef(mesh.model_group))
        w = nn.Parameter(shard.take(m.weight.detach()).clone(),
                         requires_grad=m.weight.requires_grad)
        w.model_shard = shard
        m.weight = w
        if transpose:
            m.forward = types.MethodType(_sharded_conv_transpose_forward, m)
        else:
            m._conv_forward = types.MethodType(_sharded_conv_forward, m)
    return model


def model_shards(model: nn.Module) -> Dict[str, ModelShard]:
    """``{parameter name: ModelShard}`` of ``model``'s sharded kernels."""
    return {n: p.model_shard for n, p in model.named_parameters()
            if getattr(p, "model_shard", None) is not None}


def whole_tensors(tree: Dict[str, torch.Tensor],
                  shards: Dict[str, ModelShard]) -> Dict[str, torch.Tensor]:
    """``tree`` with each sharded entry gathered whole (collective over the
    model groups: every rank calls it)."""
    return {k: (shards[k].whole(v) if k in shards else v)
            for k, v in tree.items()}


def local_tensors(tree: Dict[str, torch.Tensor],
                  shards: Dict[str, ModelShard]) -> Dict[str, torch.Tensor]:
    """``tree`` (whole tensors) with each sharded entry cut to this rank's
    slice."""
    return {k: (shards[k].take(v).clone() if k in shards else v)
            for k, v in tree.items()}


def unsharded(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with whole kernels and the plain forward, for
    one rank to evaluate alone (collective: every rank calls it);
    ``model`` itself when nothing is sharded."""
    shards = model_shards(model)
    if not shards:
        return model
    whole = whole_tensors(dict(model.named_parameters()), shards)
    out = copy.deepcopy(model)
    for name, m in out.named_modules():
        for attr in ("forward", "_conv_forward"):
            m.__dict__.pop(attr, None)
        if hasattr(m, "weight") and f"{name}.weight" in shards:
            w = whole[f"{name}.weight"].detach().clone()
            m.weight = nn.Parameter(w, requires_grad=m.weight.requires_grad)
    return out


def param_bytes(model: nn.Module) -> int:
    """Bytes of the parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ---------------------------------------------------- sharded inference
def sharded_infer(infer, model: nn.Module, images_u8: torch.Tensor,
                  mesh: DataMesh) -> Tuple[torch.Tensor, ...]:
    """Batch-sharded inference (tpucv runs its plain infer function on a
    batch sharded over the data axis, with no collectives): ``infer(model,
    rows)`` on this rank's rows of the global uint8 batch, then its
    fixed-shape outputs (boxes, scores, classes, valid) all-gathered over
    the data group in rank order, so every rank returns the global batch's
    detections."""
    rows = torch.as_tensor(mesh.rows(images_u8.shape[0]),
                           device=images_u8.device)
    out = infer(model, images_u8[rows])
    if mesh.n_data == 1:
        return tuple(out)
    return tuple(_gather_any(t, mesh.data_group, mesh.n_data) for t in out)
