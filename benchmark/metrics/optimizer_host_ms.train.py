"""The training step's optimizer stage (``train/state.py:make_train_step``:
the gradients' all-reduce when data-parallel, the update and the EMA):
milliseconds a step on the host clock in the program's span
``tpucv.train.optimizer`` over the traced window (``_span.ms_per``). None
where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/step"


def read(ctx):
    return _span.ms_per(ctx, "train", "tpucv.train.optimizer")
