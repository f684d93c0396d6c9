"""Checkpoint save / load (counterpart of ``tpucv/ckpt/checkpoint.py``).

The bundle is the whole train state, as tpucv's is: the model's
``state_dict`` (parameters and BatchNorm buffers), Adam's ``state_dict``,
the EMA of the parameters (or None) and the step. It is written with
``torch.save`` to a temporary file that ``os.replace`` moves into place, so
a reader never sees half a file. ``load_pure`` returns the model weights
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


class CheckPoint:
    @staticmethod
    def save(state, path: str) -> str:
        """Write ``state`` (a ``train.state.TrainState``) as one bundle."""
        return _atomic_save({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "step": state.step,
        }, path)

    @staticmethod
    def load(path: str, state):
        """Load a bundle written by :meth:`save` into ``state`` in place
        (tensors go to the devices of ``state``'s own) and return it."""
        raw = _read(path)
        state.model.load_state_dict(raw["model"])
        state.optimizer.load_state_dict(raw["optimizer"])
        if (state.ema is None) != (raw["ema"] is None):
            raise ValueError(f"{path}: the EMA is "
                             f"{'absent' if raw['ema'] is None else 'present'}"
                             f" in the file but not in the train state")
        if state.ema is not None:
            with torch.no_grad():
                for k, v in state.ema.items():
                    v.copy_(raw["ema"][k])
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
