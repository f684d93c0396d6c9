"""Detection metrics (counterpart of ``tpucv.metrics``)."""
