"""tpucv_torch's train and eval steps against tpucv's ``make_train_step``
and ``make_eval_step``, on the CPU in f32.

Both start from the same weights (the port's, drawn from a
``torch.Generator`` and carried into flax by tpucv's own importer) and
take the same batches (``SyntheticDetectionIndex``, YOLOv8n with nc=8 at
64², B=2, M=4, as ``tests/test_training_dynamics.py`` makes them): Adam
1e-3 with optax's defaults, EMA 0.99.

Tolerances, each measured in this setting:

- Step 0, the gradients: each tensor within 2e-3 of its largest element
  (measured ≤ 6.8e-4). The port's own f32 gradients differ from its f64
  ones by up to 7.8e-4 of the largest element: train-mode BatchNorm over
  a few pixels makes the backward ill-conditioned, so this is rounding.
- Step 1, loss within 1e-5 relative, components within 1e-5 relative,
  ``num_fg`` equal; BatchNorm running statistics within 1e-5 (measured
  2.4e-6).
- The update itself: the port's Adam + EMA applied to tpucv's step-0
  gradients gives tpucv's step-1 parameters and EMA within 2e-7 (ulps).
- Step 1 from each side's own gradients: Adam's first step is
  ``lr * g / (|g| + eps)``, so an element whose gradient is rounding noise
  (|g| ~ 1e-9) moves by up to ``lr`` either way; parameters within
  2.1 * lr (measured 2.0e-3) and all but 0.1% of elements within 1e-5
  (measured 0.04%; the median is 6.5e-9).
- After 3 steps the trajectories have parted as rounding parts them
  (the port in f32 and in f64 differ as much: measured loss 3.6% and
  parameters 4.5e-3 apart at step 3, against tpucv 4.0% and 4.0e-3), so
  losses within 1e-3 relative after one update and 15% after two, and
  parameters within 6.3e-3 = 2 sides x 3 steps x 1.05 * lr, the most
  Adam's first three steps can move a parameter; the EMA within
  (1 - 0.99) times the sum of those per-step bounds. Those maxima are
  set by noise-gradient elements, so after steps 2 and 3 the median
  |port - tpucv| of the parameters, the EMA and the BatchNorm running
  means and variances is also held within 2x the same median between
  the port in f32 and in f64 (measured ratios 1.05-1.49 after step 2,
  0.46-0.61 after step 3).
- Steps 2 and 3 held from identical inputs: the port's Adam + EMA on
  tpucv's gradients of steps 0-2 lands on tpucv's parameters and EMA
  after each of the three updates within 1.5e-6 (measured 4.8e-7 and
  9.5e-7; a beta2 of 0.99 instead of 0.999 moves them 5.1e-6 by the third
  update), and the port's step 3 taken from tpucv's state after step 2
  gives tpucv's loss within 1e-5 relative, its gradients within 2e-3 of
  each tensor's largest element (measured 8.2e-4) and its BatchNorm
  running statistics within 1e-5 (measured 7.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpucv.ckpt.importer import import_yolov8
from tpucv.data.detection_dataset import SyntheticDetectionIndex
from tpucv.losses.yolov8 import yolov8_loss as j_loss
from tpucv.models import get_yolo8_n
from tpucv.train.state import TrainState as JState
from tpucv.train.state import make_eval_step as j_eval_step
from tpucv.train.state import make_train_step as j_train_step
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.losses.yolov8 import yolov8_loss as t_loss
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.train.state import (TrainState, make_eval_step,
                                     make_train_step)

torch.set_num_threads(1)
NC, S, B, M = 8, 64, 2, 4
LR, EMA = 1e-3, 0.99
FROZEN = "model.22.dfl.conv.weight"


def det_batches(n_batches, B=B, seed=11, max_objects=M - 1):
    """Padded synthetic detection batches (numpy), shared by both sides."""
    index = SyntheticDetectionIndex(n_batches * B, S, NC,
                                    max_objects=max_objects, seed=seed)
    out = []
    for k in range(n_batches):
        b = {"images": np.zeros((B, S, S, 3), np.float32),
             "gt_bboxes": np.zeros((B, M, 4), np.float32),
             "gt_labels": np.zeros((B, M), np.int32),
             "gt_mask": np.zeros((B, M), bool)}
        for j in range(B):
            img, boxes, labels = index[k * B + j]
            b["images"][j] = img.astype(np.float32) / 255.0
            b["gt_bboxes"][j, :len(boxes)] = boxes
            b["gt_labels"][j, :len(labels)] = labels
            b["gt_mask"][j, :len(labels)] = True
        out.append(b)
    return out


def port_model(seed=0, dtype=torch.float32):
    return Yolo8("n", nc=NC).reset_parameters(
        torch.Generator().manual_seed(seed)).to(dtype)


def flax_variables(model):
    """The port's weights as tpucv variables (copies)."""
    return import_yolov8({k: v.detach().float().numpy().copy()
                          for k, v in model.state_dict().items()})


def grad_capture():
    """An optax stage that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def j_loss_fn(raw, b):
    return j_loss(raw, b["gt_labels"], b["gt_bboxes"], b["gt_mask"], nc=NC)


def t_loss_fn(raw, b):
    return t_loss(raw, b["gt_labels"], b["gt_bboxes"], b["gt_mask"], nc=NC)


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b, dtype=torch.float32):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["images"] = out["images"].to(dtype)
    out["gt_bboxes"] = out["gt_bboxes"].to(dtype)
    return out


def port_run(batches, dtype=torch.float32):
    """The port's step over ``batches``: per step the metrics, the
    state_dict, the EMA and (step 0 only) the gradients."""
    state = TrainState.create(port_model(dtype=dtype), LR, use_ema=True)
    step = make_train_step(t_loss_fn, device="cpu", ema_decay=EMA)
    out = []
    for b in batches:
        state, m = step(state, to_torch(b, dtype))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "sd": {k: v.detach().double().clone()
                           for k, v in state.model.state_dict().items()},
                    "ema": {k: v.double().clone()
                            for k, v in state.ema.items()},
                    "grads": {k: p.grad.double().clone()
                              for k, p in state.params.items()
                              if p.grad is not None}})
    return state, out


def flax_run(batches, variables, **kw):
    tx = optax.chain(grad_capture(), optax.adam(LR))
    state = JState.create(variables["params"], variables["batch_stats"], tx,
                          use_ema=True)
    step = j_train_step(get_yolo8_n(nc=NC).apply, j_loss_fn, tx,
                        ema_decay=EMA, donate=False, **kw)
    out = []
    for b in batches:
        state, m = step(state, to_jax(b))
        out.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "sd": from_flax_variables({"params": state.params,
                                       "batch_stats": state.batch_stats}),
            "ema": from_flax_variables({"params": state.ema_params}),
            "grads": from_flax_variables({"params": state.opt_state[0]})})
    return state, out


@pytest.fixture(scope="module")
def runs():
    batches = det_batches(3)
    variables = flax_variables(port_model())
    _, ref = flax_run(batches, variables)
    state, got = port_run(batches)
    _, got64 = port_run(batches, torch.float64)
    return batches, variables, ref, got, got64, state


def _params(sd):
    return {k: v for k, v in sd.items()
            if "running" not in k and "num_batches" not in k and k != FROZEN}


def test_step0_gradients(runs):
    _, _, ref, got, _, _ = runs
    g, r = got[0]["grads"], ref[0]["grads"]
    assert set(g) == set(r) - {FROZEN}
    for k in g:
        scale = float(r[k].abs().max())
        err = float((g[k] - r[k].double()).abs().max())
        assert err <= 2e-3 * scale + 1e-12, (k, err, scale)


def test_step1_loss_and_metrics(runs):
    _, _, ref, got, _, _ = runs
    gm, rm = got[0]["metrics"], ref[0]["metrics"]
    assert set(gm) == set(rm) == {"loss", "box_loss", "cls_loss", "dfl_loss",
                                  "num_fg"}
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(gm[k], rm[k], rtol=1e-5, err_msg=k)
    assert gm["num_fg"] == rm["num_fg"] > 0


def test_step1_batchnorm_running_stats(runs):
    _, _, ref, got, _, _ = runs
    sd, rsd = got[0]["sd"], ref[0]["sd"]
    keys = [k for k in rsd if "running" in k]
    assert len(keys) == 2 * 57
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), rsd[k].double().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert int(sd["model.0.bn.num_batches_tracked"]) == 1


def test_update_from_identical_gradients(runs):
    """The port's Adam + EMA on tpucv's step-0 gradients lands on tpucv's
    step-1 parameters and EMA."""
    _, _, ref, _, _, _ = runs
    model = port_model()
    state = TrainState.create(model, LR, use_ema=True)
    for k, p in state.params.items():
        p.grad = ref[0]["grads"][k].float().clone()
    state.apply_gradients(EMA)
    rsd, rema = _params(ref[0]["sd"]), ref[0]["ema"]
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), rsd[k].numpy(),
                                   atol=2e-7, rtol=0, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(), rema[k].numpy(),
                                   atol=2e-7, rtol=0, err_msg=k)


def test_step1_params(runs):
    _, _, ref, got, _, _ = runs
    sd, rsd = _params(got[0]["sd"]), _params(ref[0]["sd"])
    diffs = torch.cat([(sd[k] - rsd[k].double()).abs().flatten()
                       for k in rsd])
    assert float(diffs.max()) <= 2.1 * LR
    assert float((diffs > 1e-5).double().mean()) <= 1e-3
    ema_diff = max(float((got[0]["ema"][k] - ref[0]["ema"][k].double())
                         .abs().max()) for k in rsd)
    assert ema_diff <= (1 - EMA) * 2.1 * LR


def _median_diff(a, b, keys):
    return float(torch.cat([(a[k].double() - b[k].double()).abs().flatten()
                            for k in keys]).median())


def test_three_steps(runs):
    _, _, ref, got, got64, _ = runs
    losses = [[r["metrics"]["loss"] for r in run] for run in (ref, got,
                                                             got64)]
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1][1], losses[0][1], rtol=1e-3)
    np.testing.assert_allclose(losses[1][2], losses[0][2], rtol=0.15)
    # the port in f64 parts from the port in f32 as tpucv does
    np.testing.assert_allclose(losses[2][1], losses[1][1], rtol=1e-3)
    bound = 0.0
    ema_bound = 0.0
    for t in range(3):
        bound += 2 * 1.05 * LR
        ema_bound = EMA * ema_bound + (1 - EMA) * bound
        sd, rsd = _params(got[t]["sd"]), _params(ref[t]["sd"])
        err = max(float((sd[k] - rsd[k].double()).abs().max()) for k in rsd)
        assert err <= bound, (t, err, bound)
        ema_err = max(float((got[t]["ema"][k] - ref[t]["ema"][k].double())
                            .abs().max()) for k in rsd)
        assert ema_err <= ema_bound, (t, ema_err, ema_bound)
    # the bulk of the elements, against the f32-vs-f64 spread
    for t in (1, 2):
        params = list(_params(ref[t]["sd"]))
        groups = {
            "params": ("sd", params), "ema": ("ema", params),
            "running_mean": ("sd", [k for k in ref[t]["sd"]
                                    if k.endswith("running_mean")]),
            "running_var": ("sd", [k for k in ref[t]["sd"]
                                   if k.endswith("running_var")])}
        for name, (part, keys) in groups.items():
            diff = _median_diff(got[t][part], ref[t][part], keys)
            spread = _median_diff(got[t][part], got64[t][part], keys)
            assert 0 < spread and diff <= 2 * spread, (t, name, diff, spread)


def test_three_updates_from_identical_gradients(runs):
    """The port's Adam + EMA on tpucv's gradients of steps 0-2 lands on
    tpucv's parameters and EMA after each update (bias correction and
    the second moment at work beyond the first step)."""
    _, _, ref, _, _, _ = runs
    state = TrainState.create(port_model(), LR, use_ema=True)
    for t in range(3):
        for k, p in state.params.items():
            p.grad = ref[t]["grads"][k].float().clone()
        state.apply_gradients(EMA)
        rsd, rema = _params(ref[t]["sd"]), ref[t]["ema"]
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), rsd[k].numpy(),
                                       atol=1.5e-6, rtol=0, err_msg=(t, k))
            np.testing.assert_allclose(state.ema[k].numpy(),
                                       rema[k].numpy(), atol=1.5e-6, rtol=0,
                                       err_msg=(t, k))


def test_step3_from_tpucv_state(runs):
    """The port's step 3 from tpucv's parameters and BatchNorm statistics
    after step 2: loss, gradients and the running statistics it leaves."""
    batches, _, ref, _, _, _ = runs
    model = port_model()
    model.load_state_dict({k: v.float() for k, v in ref[1]["sd"].items()})
    state = TrainState.create(model, LR)
    state, m = make_train_step(t_loss_fn, device="cpu")(
        state, to_torch(batches[2]))
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(m[k]), ref[2]["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    assert float(m["num_fg"]) == ref[2]["metrics"]["num_fg"] > 0
    for k, p in state.params.items():
        r = ref[2]["grads"][k].double()
        err = float((p.grad.double() - r).abs().max())
        assert err <= 2e-3 * float(r.abs().max()) + 1e-12, (k, err)
    sd = state.model.state_dict()
    keys = [k for k in sd if "running" in k]
    assert len(keys) == 2 * 57
    for k in keys:
        np.testing.assert_allclose(sd[k].double().numpy(),
                                   ref[2]["sd"][k].double().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_frozen_dfl_projection_is_not_trained(runs):
    _, _, _, got, _, state = runs
    assert FROZEN not in state.params and FROZEN not in state.ema
    n_train = sum(p.numel() for p in state.params.values())
    assert n_train == sum(p.numel() for p in state.model.parameters()) - 16
    for t in range(3):
        assert torch.equal(got[t]["sd"][FROZEN].flatten(),
                           torch.arange(16, dtype=torch.float64))
    assert state.step == 3


def test_eval_step(runs):
    """make_eval_step on the running statistics of a model whose BatchNorm
    statistics are drawn from a seed."""
    batches = runs[0]
    model = port_model(seed=5)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    v = flax_variables(model)
    tx = optax.adam(LR)
    jstate = JState.create(v["params"], v["batch_stats"], tx)
    ref = j_eval_step(get_yolo8_n(nc=NC).apply, j_loss_fn)(
        jstate, to_jax(batches[1]))
    state = TrainState.create(model, LR)
    got = make_eval_step(t_loss_fn, device="cpu")(state, to_torch(batches[1]))
    assert set(got) == set(ref)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(got["num_fg"]) == float(ref["num_fg"])
    assert not model.training
    assert all(int(b) == 0 for n, b in model.named_buffers()
               if n.endswith("num_batches_tracked"))


def test_steps_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(t_loss_fn, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(t_loss_fn, device="cuda")
