"""The training step's parts against tpucv's, on the CPU in f32: the
flax-style train-mode BatchNorm, the learning-rate schedules, and Adam +
EMA from identical gradients.

- BatchNorm in train mode against flax's ``nn.BatchNorm`` (momentum 0.97,
  eps 1e-3, tpucv's settings): outputs and input gradients within 1e-5
  absolute, running mean and the BIASED running variance within 1e-6
  relative after each of three calls. Eval mode and the ``state_dict``
  are ``nn.BatchNorm2d``'s.
- Schedules within 1e-6 relative (tpucv evaluates in f32, the port in
  Python floats).
- ``torch.optim.Adam`` with optax's defaults against ``optax.adam`` on the
  same gradient sequence, magnitudes 1e-10 to 1 (about eps and far above
  it): within 2e-7 absolute after each of three updates (measured ≤ 6e-8,
  an ulp of the parameters); the EMA ``e*d + p*(1-d)`` likewise.
- ``TrainState.from_config`` against tpucv's trainer (``set_optimizer``):
  the lr of each step as ``warmup_multistep`` gives it, and with weight
  decay against ``optax.chain(add_decayed_weights, adam)`` within 2e-7
  absolute after each of three updates."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tpucv.configs.base import OptimizerCfg as JOptimizerCfg
from tpucv.train import schedules as js
from tpucv_torch.configs.base import OptimizerCfg
from tpucv_torch.configs.model_cfgs import Yolo8DetConfig
from tpucv_torch.nn.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d
from tpucv_torch.train import schedules as ts
from tpucv_torch.train.state import TrainState

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 2, 2, 4), (4, 8, 8, 16)])
def test_batchnorm_train_mode_matches_flax(shape):
    rng = np.random.default_rng(shape[-1])
    C = shape[-1]
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.97,
                        epsilon=1e-3)
    v = fbn.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    tbn = BatchNorm2d(C, eps=BN_EPS, momentum=BN_MOMENTUM).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    for step in range(3):
        x = (rng.normal(0.3 * step, 1 + step, shape)).astype(np.float32)
        w = rng.normal(size=shape).astype(np.float32)

        def f(xx, vv):
            y, upd = fbn.apply(vv, xx, mutable=["batch_stats"])
            return (y * w).sum(), (y, upd)

        (_, (y, upd)), gx = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(x), v)
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        ty = tbn(tx)
        (ty * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(gx), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tbn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tbn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6)
    assert int(tbn.num_batches_tracked) == 3
    # nn.BatchNorm2d's own update folds the unbiased variance: it differs
    ref = torch.nn.BatchNorm2d(C, eps=BN_EPS, momentum=BN_MOMENTUM).train()
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    mine = BatchNorm2d(C, eps=BN_EPS, momentum=BN_MOMENTUM).train()
    mine(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (ref.running_var > mine.running_var).all()


def test_batchnorm_eval_mode_and_keys_unchanged():
    rng = np.random.default_rng(3)
    ref = torch.nn.BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        for t in (ref.weight, ref.bias, ref.running_mean):
            t.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
        ref.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2, 8).astype(np.float32)))
    mine = BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM)
    mine.load_state_dict(ref.state_dict(), strict=True)
    assert list(mine.state_dict()) == list(ref.state_dict())
    x = torch.from_numpy(rng.normal(size=(2, 8, 5, 5)).astype(np.float32))
    assert torch.equal(mine.eval()(x), ref.eval()(x))
    assert torch.equal(mine.running_var, ref.running_var)


@pytest.mark.parametrize("kind", ["linear", "exponential"])
def test_warmup_multistep(kind):
    ref = js.warmup_multistep(1e-3, 50, [80, 30, 120], 0.1, kind)
    got = ts.warmup_multistep(1e-3, 50, [80, 30, 120], 0.1, kind)
    for step in (0, 1, 10, 29, 30, 31, 49, 50, 79, 80, 119, 120, 500):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_untuned_warmup_constants():
    for beta2 in (0.999, 0.99, 0.9):
        assert ts.untuned_linear_warmup_period(beta2) == \
            js.untuned_linear_warmup_period(beta2)
        assert ts.untuned_exponential_warmup_tau(beta2) == \
            js.untuned_exponential_warmup_tau(beta2)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 40), (30, 20)])
def test_cosine_with_warmup(warmup, total):
    ref = js.cosine_with_warmup(2e-3, warmup, total, final_scale=0.05)
    got = ts.cosine_with_warmup(2e-3, warmup, total, final_scale=0.05)
    for step in range(0, 130, 3):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def test_adam_and_ema_from_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 3), "b": (200,)}
    p0 = {k: rng.normal(0, 0.1, s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-10, 0, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    ema_j = dict(jp)
    d = 0.9

    model = torch.nn.Module()
    for k, v in p0.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    state = TrainState.create(model, 1e-3, use_ema=True)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        ema_j = {k: ema_j[k] * d + jp[k] * (1.0 - d) for k in jp}
        for k, p in state.params.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients(ema_decay=d)
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=2e-7, rtol=0)
            np.testing.assert_allclose(state.ema[k].numpy(),
                                       np.asarray(ema_j[k]), atol=2e-7,
                                       rtol=0)
    assert state.step == 3


def test_schedule_drives_the_optimizer_lr():
    model = torch.nn.Linear(3, 2)
    sched = ts.warmup_multistep(1e-2, 4, [2], 0.5)
    state = TrainState.create(model, sched)
    lrs = []
    for _ in range(5):
        for p in state.params.values():
            p.grad = torch.ones_like(p)
        state.apply_gradients()
        lrs.append(state.optimizer.param_groups[0]["lr"])
    assert lrs == [sched(s) for s in range(5)]
    assert lrs[0] == pytest.approx(2.5e-3) and lrs[2] == pytest.approx(
        3.75e-3)


def test_from_config_follows_tpucvs_trainer():
    """yolo8_det's optimizer section at 10 steps an epoch: Adam at
    warmup_multistep(lr, warmup_iters, milestones * 10, gamma), no EMA
    (ema_decay 0), no weight decay."""
    o = Yolo8DetConfig().optimizer
    ref = js.warmup_multistep(o.lr, o.warmup_iters,
                              [m * 10 for m in o.milestones], o.gamma)
    state = TrainState.from_config(torch.nn.Linear(3, 2), o,
                                   iters_per_epoch=10)
    assert state.ema is None
    assert state.optimizer.param_groups[0]["weight_decay"] == 0.0
    for step in (0, 1, 599, 600, 799, 800, 998, 999, 1000, 5000):
        np.testing.assert_allclose(state.schedule(step), float(ref(step)),
                                   rtol=1e-6, err_msg=str(step))


def test_from_config_weight_decay_matches_optax():
    rng = np.random.default_rng(3)
    o = OptimizerCfg(lr=1e-2, weight_decay=0.05, warmup_iters=2,
                     milestones=(1,), gamma=0.5, ema_decay=0.9)
    jo = JOptimizerCfg(lr=o.lr, weight_decay=o.weight_decay,
                       warmup_iters=o.warmup_iters, milestones=o.milestones,
                       gamma=o.gamma)
    tx = optax.chain(optax.add_decayed_weights(jo.weight_decay),
                     optax.adam(js.warmup_multistep(
                         jo.lr, jo.warmup_iters,
                         [m * 2 for m in jo.milestones], jo.gamma)))
    model = torch.nn.Linear(4, 3)
    jp = {k: jnp.asarray(v.detach().numpy().copy())
          for k, v in model.named_parameters()}
    opt = tx.init(jp)
    state = TrainState.from_config(model, o, iters_per_epoch=2)
    assert state.ema is not None
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in jp.items()}
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in state.params.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients(o.ema_decay)
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=2e-7, rtol=0, err_msg=k)


def test_from_config_refuses_other_optimizers():
    with pytest.raises(ValueError, match="only adam"):
        TrainState.from_config(torch.nn.Linear(3, 2),
                               OptimizerCfg(name="sgd"))
