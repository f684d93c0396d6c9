"""tpucv_torch blocks and detect head against tpucv's flax modules.

Narrow widths (8-32 channels, 16x16 maps). Flax init weights, BatchNorm
params and statistics drawn from a numpy seed, carried across with
``from_flax_variables``; inputs from a numpy seed. The port's blocks are
NCHW, tpucv's NHWC, so inputs and outputs are transposed. Tolerance atol
1e-5, rtol 1e-4: XLA:CPU and PyTorch's CPU convolutions sum in different
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.nn import blocks as fb
from tpucv.nn.heads import DetectHead as FlaxDetectHead
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.nn import blocks as tb
from tpucv_torch.nn.heads import DetectHead, dfl_project

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)


def _random_bn(tree, rng, parent=None):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_bn(v, rng, k)
            continue
        a = np.array(v, np.float32)
        if parent == "bn":
            a = (rng.uniform(0.5, 1.5, a.shape) if k in ("scale", "var")
                 else rng.normal(0.0, 0.2, a.shape)).astype(np.float32)
        out[k] = a
    return out


def _flax_and_port(flax_module, port_module, x_nhwc, layer="b0"):
    """Init the flax module on ``x_nhwc``, randomise its BatchNorms, load
    the same weights into ``port_module`` (as ultralytics layer ``layer``
    of a Yolo8) and return (flax output, port output) as numpy."""
    if isinstance(x_nhwc, (list, tuple)):
        xj = tuple(jnp.asarray(x) for x in x_nhwc)
        xt = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in x_nhwc]
    else:
        xj = jnp.asarray(x_nhwc)
        xt = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    v = jax.jit(flax_module.init)(jax.random.PRNGKey(0), xj)
    rng = np.random.default_rng(7)
    v = {c: _random_bn(v[c], rng) for c in v}
    sd = from_flax_variables({c: {layer: v[c]} for c in v})
    prefix = {"b0": "model.0.", "detect": "model.22."}[layer]
    port_module.load_state_dict(
        {k[len(prefix):]: t for k, t in sd.items()}, strict=True)
    port_module.eval()
    ref = jax.jit(flax_module.apply)(v, xj)
    with torch.no_grad():
        out = port_module(xt)
    return ref, out


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,k,s", [(8, 16, 3, 1), (16, 32, 3, 2),
                                          (32, 16, 1, 1)])
def test_conv_bn_act(cin, cout, k, s):
    ref, out = _flax_and_port(fb.ConvBnAct(cout, k, s),
                              tb.ConvBnAct(cin, cout, k, s),
                              _x((2, 16, 16, cin)))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, False)])
def test_c2f(n, shortcut):
    ref, out = _flax_and_port(fb.C2f(32, n, shortcut),
                              tb.C2f(16, 32, n, shortcut),
                              _x((2, 16, 16, 16), 1))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_sppf():
    ref, out = _flax_and_port(fb.SPPF(16, 5), tb.SPPF(32, 16, 5),
                              _x((2, 16, 16, 32), 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_upsample_and_max_pool():
    x = _x((2, 5, 7, 8), 3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        tb.upsample2x(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(fb.upsample2x(jnp.asarray(x))))
    for k, s in [(5, 1), (3, 2)]:
        np.testing.assert_array_equal(
            tb.max_pool_same(xt, k, s).permute(0, 2, 3, 1).numpy(),
            np.asarray(fb.max_pool_same(jnp.asarray(x), k, s)))


def test_detect_head():
    feats = [_x((2, 16, 16, 16), 4), _x((2, 8, 8, 32), 5),
             _x((2, 4, 4, 32), 6)]
    ref, out = _flax_and_port(FlaxDetectHead(nc=5, reg_max=16),
                              DetectHead(5, 16, (8, 16, 32), (16, 32, 32)),
                              feats, layer="detect")
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape           # NHWC raw maps
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_dfl_project():
    from tpucv.nn.heads import dfl_project as flax_dfl

    x = _x((3, 7, 64), 8) * 3
    np.testing.assert_allclose(
        dfl_project(torch.from_numpy(x), 16).numpy(),
        np.asarray(flax_dfl(jnp.asarray(x), 16)), atol=1e-5, rtol=1e-5)


def test_autopad():
    for k, p, d in [(1, None, 1), (3, None, 1), (5, None, 1), (3, 2, 1),
                    (3, None, 2)]:
        assert tb.autopad(k, p, d) == fb.autopad(k, p, d)
