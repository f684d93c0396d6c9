"""Resolve a model name to its (config instance, algorithm class, trainer
class) triple, as ``tpucv/builder.py`` does. The trainer slot is ``None``
until the port has a trainer."""

from __future__ import annotations

from tpucv_torch.check import check_model_name
from tpucv_torch.registry import config_registry, model_registry

# imports for registration side effects
import tpucv_torch.configs.model_cfgs  # noqa: F401
import tpucv_torch.algorithms  # noqa: F401


def export_from_registry(name: str):
    check_model_name(name)
    cfg = config_registry["cfg_" + name]()       # instantiated
    algo = model_registry["model_" + name]       # class
    return cfg, algo, None
