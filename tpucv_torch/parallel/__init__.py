"""Data parallelism (counterpart of ``tpucv/parallel``): process-group
set-up from torchrun's environment (``multihost``) and the data-parallel
mesh, its batch slices, its device and the ZeRO-1 optimizer (``mesh``)."""
