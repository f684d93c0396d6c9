"""The training step's forward stage (``train/state.py:make_train_step``:
the batch's move, ``zero_grad`` and the forward): milliseconds a step on the
host clock in the program's span ``tpucv.train.forward`` over the traced
window (``_span.ms_per``). None where the program records no such span."""

from benchmark.metrics import _span

UNIT = "ms/step"


def read(ctx):
    return _span.ms_per(ctx, "train", "tpucv.train.forward")
