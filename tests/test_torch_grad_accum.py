"""tpucv_torch's ``grad_accum=2`` against tpucv's, in both loss
conventions, on the CPU in f32 (YOLOv8n, nc=8, 64², B=4: two micro-batches
of two images, BatchNorm statistics threaded through them).

With ``loss_batch_scaled`` the micro-gradients are summed and the logged
loss is the sum; without it both are averaged, so the two conventions'
gradients differ by exactly G = 2. The step's loss within 1e-5 relative
(measured 8.4e-7), the metrics (micro-batch means) within 2e-5 relative
(measured 5.3e-6) with ``num_fg`` equal, the gradients within 2e-3 of each
tensor's largest element (measured 7.4e-4; the tolerance and reason of
``tests/test_torch_train_step.py``), the BatchNorm
running statistics after the two micro-batches within 1e-5, and the
parameters within 2.1 * lr (Adam's first step, ibid.). Micro-batches of
one image are avoided: BatchNorm over one image's 2x2 P5 map leaves the
gradients only within 1.7e-2 of each other (measured)."""

import numpy as np
import pytest
import torch

from test_torch_train_step import (FROZEN, LR, _params, det_batches,
                                   flax_run, flax_variables, port_model,
                                   t_loss_fn, to_torch)
from tpucv_torch.train.state import TrainState, make_train_step

torch.set_num_threads(1)
G = 2


def _port_step(batch, scaled):
    state = TrainState.create(port_model(), LR, use_ema=True)
    step = make_train_step(t_loss_fn, device="cpu", ema_decay=0.99,
                           grad_accum=G, loss_batch_scaled=scaled)
    state, m = step(state, to_torch(batch))
    return state, {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def batch():
    return det_batches(1, B=4)[0]


@pytest.mark.parametrize("scaled", [True, False])
def test_grad_accum_matches_tpucv(batch, scaled):
    _, ref = flax_run([batch], flax_variables(port_model()), grad_accum=G,
                      loss_batch_scaled=scaled)
    ref = ref[0]
    state, m = _port_step(batch, scaled)
    np.testing.assert_allclose(m["loss"], ref["metrics"]["loss"], rtol=1e-5)
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(m[k], ref["metrics"][k], rtol=2e-5,
                                   err_msg=k)
    assert m["num_fg"] == ref["metrics"]["num_fg"] > 0
    for k, p in state.params.items():
        r = ref["grads"][k]
        err = float((p.grad - r).abs().max())
        assert err <= 2e-3 * float(r.abs().max()) + 1e-12, (k, err)
    sd = state.model.state_dict()
    for k, r in ref["sd"].items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
    assert int(sd["model.0.bn.num_batches_tracked"]) == G
    rsd = _params(ref["sd"])
    err = max(float((sd[k] - rsd[k]).abs().max()) for k in rsd)
    assert err <= 2.1 * LR
    assert torch.equal(sd[FROZEN].flatten(), torch.arange(16.0))


def test_conventions_differ_by_g(batch):
    """Summed micro-gradients and loss are G times the averaged ones; the
    micro-batch metrics are the same."""
    s_state, s_m = _port_step(batch, True)
    a_state, a_m = _port_step(batch, False)
    np.testing.assert_allclose(s_m["loss"], G * a_m["loss"], rtol=1e-6)
    for k in ("box_loss", "cls_loss", "dfl_loss", "num_fg"):
        assert s_m[k] == a_m[k]
    for k, p in s_state.params.items():
        torch.testing.assert_close(p.grad, G * a_state.params[k].grad,
                                   rtol=1e-6, atol=0)
