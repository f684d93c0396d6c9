"""Weight conversion (counterpart of ``tpucv.ckpt``)."""
