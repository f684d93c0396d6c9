"""Host-side utilities (counterpart of ``tpucv.utils``)."""
