"""Name-keyed registries (counterpart of ``tpucv/registry.py``): prefixed
string keys, decorator registration with or without an explicit key.
Registration happens as an import side effect of ``tpucv_torch.configs``,
``tpucv_torch.algorithms`` and ``tpucv_torch.trainer`` (see ``builder``)."""

from __future__ import annotations

from typing import Any, Dict


class Register:
    def __init__(self, name: str, prefix: str = ""):
        self.name = name
        self.prefix = prefix
        self._dict: Dict[str, Any] = {}

    def __setitem__(self, key: str, value: Any):
        if not callable(value):
            raise ValueError(f"register object must be callable, got {value!r}")
        key = self.prefix + (key if key is not None else value.__name__)
        if key in self._dict:
            raise KeyError(f"{key!r} already registered in {self.name}")
        self._dict[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._dict[key]

    def __contains__(self, key: str) -> bool:
        return key in self._dict

    def register(self, target: Any = None):
        """Decorator usable as ``@reg`` or ``@reg("name")``."""
        if callable(target):  # @reg with no key
            self[target.__name__] = target
            return target

        def deco(obj):
            self[target] = obj
            return obj

        return deco

    __call__ = register


config_registry = Register("config", prefix="cfg_")
model_registry = Register("model", prefix="model_")
trainer_registry = Register("trainer", prefix="trainer_")
