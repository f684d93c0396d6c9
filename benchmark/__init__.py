"""The benchmark of ``tpucv_torch`` on the H100 (see ``README.md``)."""
