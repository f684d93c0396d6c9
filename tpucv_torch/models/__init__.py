"""Model networks (counterpart of ``tpucv.models``)."""
