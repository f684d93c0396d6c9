"""Raw-map decoders (counterpart of ``tpucv.decode``)."""
