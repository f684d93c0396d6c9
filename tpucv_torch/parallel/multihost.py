"""Multi-process initialisation (counterpart of
``tpucv/parallel/multihost.py``).

tpucv calls ``jax.distributed.initialize`` once per process; the port calls
``torch.distributed.init_process_group`` from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), over NCCL on
CUDA and gloo on the CPU:

    torchrun --nproc_per_node=N -m tpucv_torch.train --model yolo8_det

The failure policy is tpucv's: an init error is swallowed only for a plain
single process (no launcher around it), and re-raised when a world of more
than one process was asked for or a launcher's markers are set, since a
rank that carried on alone would train with the wrong world size in
silence.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

#: Environment variables that a launcher sets for each process it starts:
#: torchrun's (``TORCHELASTIC_RUN_ID``, ``LOCAL_RANK``, ``GROUP_RANK``) and
#: MPI's. With any of them set, a failed init means the launch is broken.
_LAUNCHER_ENV_MARKERS = (
    "TORCHELASTIC_RUN_ID",
    "LOCAL_RANK",
    "GROUP_RANK",
    "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE",
)


def _in_launcher_environment() -> bool:
    return any(os.environ.get(k) for k in _LAUNCHER_ENV_MARKERS)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with torchrun's environment.

    Without arguments the world size and rank come from ``WORLD_SIZE`` and
    ``RANK`` and the address from ``MASTER_ADDR`` / ``MASTER_PORT``
    (``env://``); pass ``init_method`` (``tcp://host:port``), ``world_size``
    and ``rank`` to set them yourself. ``backend``: NCCL when CUDA is
    available, else gloo.

    Failure policy: an init error is swallowed only for a plain single
    process; it re-raises when the caller or ``WORLD_SIZE`` asked for more
    than one process, or when a launcher's markers are set. A world that
    comes up with another size than the one asked for raises."""
    if dist.is_initialized():
        return                                   # already initialised
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    try:
        dist.init_process_group(**kwargs)
    except Exception:
        if world_size not in (None, 1) or _in_launcher_environment():
            raise
        # a plain single process needs no process group
    if world_size and world_count() != world_size:
        raise RuntimeError(
            f"torch.distributed came up with world size {world_count()} but "
            f"the caller expected {world_size}; the launch is misconfigured")


def world_count() -> int:
    """The number of processes in the world; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and evaluation
    results (rank 0)."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this process feeds: the ``rank``-th of
    ``world`` equal contiguous parts. Raises when the world size does not
    divide the batch."""
    world = world_count()
    if global_batch % world:
        raise ValueError(f"the world size {world} does not divide the "
                         f"global batch of {global_batch}")
    per = global_batch // world
    start = per * process_index()
    return slice(start, start + per)
