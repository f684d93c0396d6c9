"""In-graph target assignment (counterpart of ``tpucv.targets``)."""
