"""Checkpoint save / load (counterpart of ``tpucv/ckpt/checkpoint.py``).

The bundle is the whole train state, as tpucv's is: the model's
``state_dict`` (parameters and BatchNorm buffers), Adam's ``state_dict``,
the EMA of the parameters (or None) and the step. It is written with
``torch.save`` to a temporary file that ``os.replace`` moves into place, so
a reader never sees half a file.

Under data parallelism every rank calls ``save`` (it is collective when the
Adam moments are ZeRO-partitioned: they are consolidated on the first rank
of each data group first, and when kernels are sharded over the model
axis: their weights, EMA and moments are gathered whole over the model
group) and rank 0 alone writes. The bundle is always the replicated one,
whole kernels and a plain ``torch.optim.Adam`` state, so a checkpoint
saved under any ``(n_data, n_model)`` mesh, with or without ZeRO, resumes
in one process or under any other mesh, and the other way round:
``load`` cuts each sharded kernel's weight, EMA and moments to this
rank's slice, and into a ZeRO optimizer keeps this rank's share of the
moments. ``load_pure`` returns the model weights
alone, from a bundle or from a bare ``state_dict``, as tpucv's does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def _atomic_save(obj: Any, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> Any:
    # weights_only: tensors and plain containers, never arbitrary objects
    return torch.load(path, map_location="cpu", weights_only=True)


def _weights(raw: Any) -> StateDict:
    """The model weights of a loaded file: a port bundle (``model``), a
    reference-style bundle (``model_state_dict``) or a bare state_dict."""
    for key in ("model", "model_state_dict"):
        if isinstance(raw, dict) and isinstance(raw.get(key), dict):
            return raw[key]
    return raw


def replicated_optimizer_state(optimizer) -> Optional[Dict[str, Any]]:
    """The optimizer's ``state_dict`` as a replicated ``torch.optim.Adam``
    gives it. A ZeRO optimizer's moments are consolidated on the first rank
    of its process group (a collective: every rank calls this), whose state
    it returns with the inner Adam's group keys; the other ranks get
    None."""
    from tpucv_torch.parallel import mesh as pmesh

    if not pmesh.is_zero(optimizer):
        return optimizer.state_dict()
    optimizer.consolidate_state_dict(to=0)
    if optimizer.rank != 0:
        return None
    sd = optimizer.state_dict()
    keys = {k: v for k, v in optimizer.optim.param_groups[0].items()
            if k != "params"}
    groups = [{**keys, "lr": g["lr"], "params": g["params"]}
              for g in sd["param_groups"]]
    return {"state": sd["state"], "param_groups": groups}


def _moments(optimizer_state: Dict[str, Any], state, shards, fn):
    """``optimizer_state`` with ``fn(shard, tensor, param)`` applied to
    the moments of every sharded parameter (the state is keyed by the
    parameter's index in ``state.params``)."""
    names = list(state.params)
    out = dict(optimizer_state)
    out["state"] = {
        i: ({k: (fn(shards[names[i]], v, state.params[names[i]])
                 if k in ("exp_avg", "exp_avg_sq") else v)
             for k, v in s.items()} if names[i] in shards else s)
        for i, s in optimizer_state["state"].items()}
    return out


class CheckPoint:
    @staticmethod
    def save(state, path: str) -> str:
        """Write ``state`` (a ``train.state.TrainState``) as one bundle, on
        rank 0 alone, with whole kernels; every rank of a data-parallel run
        calls it."""
        from tpucv_torch.parallel import mesh as pmesh
        from tpucv_torch.parallel.multihost import is_primary

        shards = pmesh.model_shards(state.model)
        model = pmesh.whole_tensors(state.model.state_dict(), shards)
        ema = (None if state.ema is None else
               pmesh.whole_tensors(state.ema, shards))
        optimizer = replicated_optimizer_state(state.optimizer)
        if shards and optimizer is not None:
            # every rank that holds the whole state of its slice (all, or
            # under ZeRO the first data index's) gathers its model group's
            optimizer = _moments(optimizer, state, shards,
                                 lambda sh, v, p: sh.whole(v.to(p.device)))
        if not is_primary():
            return path
        return _atomic_save({
            "model": model,
            "optimizer": optimizer,
            "ema": ema,
            "step": state.step,
        }, path)

    @staticmethod
    def load(path: str, state):
        """Load a bundle written by :meth:`save` into ``state`` in place
        (tensors go to the devices of ``state``'s own; a kernel sharded
        over the model axis takes its slice) and return it."""
        from tpucv_torch.parallel import mesh as pmesh

        raw = _read(path)
        shards = pmesh.model_shards(state.model)
        state.model.load_state_dict(pmesh.local_tensors(raw["model"], shards))
        optimizer = raw["optimizer"]
        if shards:
            optimizer = _moments(optimizer, state, shards,
                                 lambda sh, v, p: sh.take(v).clone())
        state.optimizer.load_state_dict(optimizer)
        if (state.ema is None) != (raw["ema"] is None):
            raise ValueError(f"{path}: the EMA is "
                             f"{'absent' if raw['ema'] is None else 'present'}"
                             f" in the file but not in the train state")
        if state.ema is not None:
            ema = pmesh.local_tensors(raw["ema"], shards)
            with torch.no_grad():
                for k, v in state.ema.items():
                    v.copy_(ema[k])
        state.step = int(raw["step"])
        return state

    @staticmethod
    def save_pure(model: nn.Module, path: str) -> str:
        """Write the inference weights alone (the model's state_dict)."""
        return _atomic_save(model.state_dict(), path)

    @staticmethod
    def load_pure(path: str) -> StateDict:
        """The model weights (parameters and BatchNorm buffers, not the
        EMA) of a bundle or of a bare state_dict, on the CPU."""
        return _weights(_read(path))


def _overlay_matching(init: StateDict, loaded: StateDict,
                      stats: dict) -> StateDict:
    """Shape-matched partial overlay (reference ``load_pretrained``,
    core/utils/ckpt.py:19-36): tensors present in ``loaded`` with an equal
    shape replace the init value; everything else keeps its init."""
    out = {}
    for k, v in init.items():
        new = loaded.get(k)
        if new is None:
            out[k] = v
        elif tuple(new.shape) != tuple(v.shape):
            stats["skipped"].append(k)
            out[k] = v
        else:
            stats["loaded"] += 1
            out[k] = new.to(v.dtype)
    return out


def load_pretrained(model: nn.Module, path: str,
                    model_name: Optional[str] = None,
                    logger: Any = None) -> nn.Module:
    """Initialise ``model`` in place from a pretrained-weights file and
    return it.

    Accepts a port checkpoint (bundle or state_dict) or a reference
    ``.pth`` state_dict: the port keeps ultralytics' key names, so no
    importer is needed, and ``model_name`` is only named in the log.
    Loading is partial and shape-matched like the reference's
    ``CheckPoint.load_pretrained``: mismatched or missing tensors keep
    their init values, so a backbone-only file fine-tunes a fresh head."""
    stats = {"loaded": 0, "skipped": []}
    merged = _overlay_matching(model.state_dict(), _weights(_read(path)),
                               stats)
    model.load_state_dict(merged)
    msg = (f"pretrained{f' {model_name}' if model_name else ''}: loaded "
           f"{stats['loaded']} tensors from {path}"
           + (f", skipped {len(stats['skipped'])} shape-mismatched"
              if stats["skipped"] else ""))
    (logger.info if logger else print)(msg)
    return model
