"""Config schema and per-model configs (counterpart of ``tpucv.configs``)."""
