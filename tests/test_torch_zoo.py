"""tpucv_torch's rest of the zoo against tpucv's, in f32 on the CPU: the
twenty blocks of ``nn/blocks.py`` that no registered network uses, VGG,
MobileNetV2 and UNet (``models/extras.py``) and CPM
(``models/openpose.py``).

tpucv's flax init (``jax.jit(module.init)``), with every BatchNorm's scale,
bias, mean and variance and every bias drawn from a numpy seed, goes into
the port through ``from_flax_variables(variables, model)`` with
``strict=True``; inputs come from a numpy seed, NHWC for tpucv and NCHW
for the port. Held, each output within REL (5e-4) of its largest
magnitude:

- every block at narrow widths (8-16 channels, 8-16² maps, B=2) in eval
  mode, and those with BatchNorm in train mode too: the output and every
  running mean and variance afterwards (flax folds the biased batch
  variance, as the port's ``BatchNorm2d`` does);
- the transposed convs where the layouts part: ConvTransposeBnAct at
  k = 2, 3 (flax does not flip its kernel, torch does) and k = 1 < s = 2
  (``output_padding``), DWConvTranspose2d at c1 = 8, out = 12, g = 4 and
  at c1 = 8, out = 6, g = 2 (the grouped kernel regrouped), and at
  c1 = out = g = 8;
- VGG11 / VGG16-BN at 32² and 48², MobileNetV2 at width 0.25, UNet at
  32², 48² and 46² (16 does not divide 46: the decoder resizes 2 -> 5 ->
  11 -> 23 -> 46) and CPM with 2 stages at 64², in eval and train mode
  with the running statistics;
- the full-width parameter counts and key sets: VGG16-BN, MobileNetV2
  (width 1, nc 1000), UNet (nc 21) and CPM (18 keypoints, 19 limbs, 6
  stages), from shapes alone.

Measured, as a share of the output's largest magnitude: the blocks within
9.5e-6 (SPP), the networks within 7.7e-5 (MobileNetV2; UNet 2.1e-5, VGG
1.9e-5, CPM 1.7e-6), so no case needs the float64 runs that DeepLab's
train-mode tests take.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.models import extras as fx
from tpucv.models import openpose as fo
from tpucv.nn import blocks as fb
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.models import extras as tx
from tpucv_torch.models import openpose as to
from tpucv_torch.nn import blocks as tb

torch.set_num_threads(1)
REL = 5e-4


def _randomized(tree, rng):
    """``tree`` as numpy, each BatchNorm scale / variance drawn from
    U(0.5, 1.5), each bias and mean from N(0, 0.2); kernels stay flax's."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomized(v, rng)
            continue
        a = np.array(v, np.float32)
        if k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            a = rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        out[k] = a
    return out


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2) if x.ndim == 4 \
        else torch.from_numpy(x)


def _nhwc(t):
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).detach().numpy()


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


def _running_stats(port, new_stats):
    """Every running mean / variance of ``port`` against flax's updated
    ``batch_stats``."""
    ref = from_flax_variables({"batch_stats": new_stats}, port)
    sd = port.state_dict()
    assert ref, "no BatchNorm statistics"
    for k, v in ref.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k].numpy(), v.numpy())


def _pair(flax_module, port_module, x, seed=7):
    v = jax.jit(flax_module.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {c: _randomized(v[c], np.random.default_rng(seed)) for c in v}
    port_module.load_state_dict(from_flax_variables(v, port_module),
                                strict=True)
    return v


def _check(flax_module, port_module, x, train_arg=True):
    """Eval, then (where ``train_arg``) train mode, port against tpucv."""
    v = _pair(flax_module, port_module, x)
    xj, xt = jnp.asarray(x), _nchw(x)
    kw = {"train": False} if train_arg else {}
    port_module.eval()
    with torch.no_grad():
        _close(_nhwc(port_module(xt)), flax_module.apply(v, xj, **kw))
    if not train_arg or "batch_stats" not in v:
        return
    ref, new = flax_module.apply(v, xj, train=True, mutable=["batch_stats"])
    port_module.train()
    with torch.no_grad():
        _close(_nhwc(port_module(xt)), ref)
    _running_stats(port_module, new["batch_stats"])


# (name, flax block, port block, NHWC input shape, takes ``train``)
BLOCKS = [
    ("DWConv", fb.DWConv(16, 3, 2), tb.DWConv(8, 16, 3, 2), (2, 16, 16, 8),
     True),
    ("C1", fb.C1(16, 2), tb.C1(8, 16, 2), (2, 16, 16, 8), True),
    ("C2", fb.C2(16, 2), tb.C2(8, 16, 2), (2, 16, 16, 8), True),
    ("C3", fb.C3(16, 2), tb.C3(8, 16, 2), (2, 16, 16, 8), True),
    ("C3x", fb.C3x(16, 2), tb.C3x(8, 16, 2), (2, 16, 16, 8), True),
    ("SPP", fb.SPP(16), tb.SPP(16, 16), (2, 16, 16, 16), True),
    ("Focus", fb.Focus(16, 3), tb.Focus(4, 16, 3), (2, 16, 16, 4), True),
    ("GhostConv", fb.GhostConv(16, 3, 2), tb.GhostConv(8, 16, 3, 2),
     (2, 16, 16, 8), True),
    ("GhostBottleneck identity", fb.GhostBottleneck(16),
     tb.GhostBottleneck(16, 16), (2, 16, 16, 16), True),
    ("GhostBottleneck scv", fb.GhostBottleneck(16),
     tb.GhostBottleneck(8, 16), (2, 16, 16, 8), True),
    ("GhostBottleneck s2", fb.GhostBottleneck(16, 3, 2),
     tb.GhostBottleneck(8, 16, 3, 2), (2, 16, 16, 8), True),
    ("ChannelAttention", fb.ChannelAttention(), tb.ChannelAttention(8),
     (2, 16, 16, 8), False),
    ("SpatialAttention", fb.SpatialAttention(7), tb.SpatialAttention(7),
     (2, 16, 16, 8), False),
    ("CBAM", fb.CBAM(7), tb.CBAM(8, 7), (2, 16, 16, 8), False),
    ("ConvTransposeBnAct k2", fb.ConvTransposeBnAct(16),
     tb.ConvTransposeBnAct(8, 16), (2, 8, 8, 8), True),
    ("ConvTransposeBnAct k3", fb.ConvTransposeBnAct(12, 3, 2),
     tb.ConvTransposeBnAct(8, 12, 3, 2), (2, 8, 8, 8), True),
    ("ConvTransposeBnAct k1 s2", fb.ConvTransposeBnAct(12, 1, 2),
     tb.ConvTransposeBnAct(8, 12, 1, 2), (2, 8, 8, 8), True),
    ("TransformerLayer", fb.TransformerLayer(16, 4),
     tb.TransformerLayer(16, 4), (2, 10, 16), False),
    ("TransformerBlock", fb.TransformerBlock(16, 4, 2),
     tb.TransformerBlock(8, 16, 4, 2), (2, 8, 8, 8), True),
    ("BottleneckCSP", fb.BottleneckCSP(16, 2), tb.BottleneckCSP(8, 16, 2),
     (2, 16, 16, 8), True),
    ("C3TR", fb.C3TR(16, 1), tb.C3TR(8, 16, 1), (2, 8, 8, 8), True),
    ("C3Ghost", fb.C3Ghost(16, 2), tb.C3Ghost(8, 16, 2), (2, 16, 16, 8),
     True),
    ("DWConvTranspose2d c1 8 out 12 g 4", fb.DWConvTranspose2d(12, 3, 2, 1, 1),
     tb.DWConvTranspose2d(8, 12, 3, 2, 1, 1), (2, 6, 5, 8), False),
    ("DWConvTranspose2d c1 8 out 6 g 2", fb.DWConvTranspose2d(6, 4, 2, 1, 0),
     tb.DWConvTranspose2d(8, 6, 4, 2, 1, 0), (2, 6, 5, 8), False),
    ("DWConvTranspose2d depthwise", fb.DWConvTranspose2d(8, 3, 1, 1),
     tb.DWConvTranspose2d(8, 8, 3, 1, 1), (2, 6, 5, 8), False),
]


@pytest.mark.parametrize("name,fm,tm,shape,train_arg", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_equals_tpucv(name, fm, tm, shape, train_arg):
    _check(fm, tm, _x(shape, seed=len(name)), train_arg)


def test_transposed_kernels_are_not_the_generic_transpose():
    """Without the target model the kernels go through the plain HWIO ->
    OIHW transpose, which is wrong for both transposed convs where
    c1 != out != g: the shapes or the values part."""
    x = _x((2, 6, 5, 8), 3)
    for fm, tm in [(fb.DWConvTranspose2d(12, 3, 2, 1, 1),
                    tb.DWConvTranspose2d(8, 12, 3, 2, 1, 1)),
                   (fb.ConvTransposeBnAct(8, 3, 2),
                    tb.ConvTransposeBnAct(8, 8, 3, 2))]:
        v = _pair(fm, tm, x)
        generic = from_flax_variables(v)
        right = tm.state_dict()
        key = "weight" if "weight" in right else "conv.weight"
        assert (generic[key].shape != right[key].shape
                or not torch.equal(generic[key], right[key]))


def test_ensemble_concatenates_like_tpucv():
    """Two members' (B, A_i, no) outputs concatenated on the candidate
    axis, in member order, as tpucv's Ensemble does."""
    x = _x((2, 8, 8, 4), 5)
    members = []
    flax_members = []
    for k, ch in enumerate((6, 6)):
        fm, tm = fb.Focus(ch), tb.Focus(4, ch).eval()
        v = _pair(fm, tm, x, seed=11 + k)
        flax_members.append(
            (lambda v_, x_, fm=fm: fm.apply(v_, x_).reshape(2, -1, 6), v))
        members.append(lambda t, tm=tm: tm(t).permute(0, 2, 3, 1)
                       .reshape(2, -1, 6))
    ref = fb.Ensemble(flax_members)(jnp.asarray(x))
    ens = tb.Ensemble(members[:1])
    ens.append(members[1])
    with torch.no_grad():
        got = ens(_nchw(x))
    assert tuple(got.shape) == (2, 32, 6)
    _close(got.numpy(), ref)
    with pytest.raises(ValueError, match="no members"):
        tb.Ensemble()(_nchw(x))


# ------------------------------------------------------------ the networks
@functools.lru_cache(maxsize=None)
def _network(name):
    """tpucv's network with its seed-0 init randomised as above, and the
    port's with those weights."""
    fm, tm, size = {
        "vgg11": (fx.VGG(11), tx.VGG(11), 32),
        "vgg16": (fx.VGG(16), tx.VGG(16), 32),
        "mobilenet_v2": (fx.MobileNetV2(10, 0.25),
                         tx.MobileNetV2(10, 0.25), 32),
        "unet": (fx.UNet(5), tx.UNet(5), 32),
        "cpm": (fo.CPM(n_stages=2), to.CPM(n_stages=2), 64),
    }[name]
    v = _pair(fm, tm, _x((1, size, size, 3)))
    return fm, tm, v


def _network_check(name, size, seed=1):
    fm, tm, v = _network(name)
    x = _x((2, size, size, 3), seed)
    xj, xt = jnp.asarray(x), _nchw(x)
    tm.load_state_dict(from_flax_variables(v, tm), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(xt)
    ref = jax.jit(lambda a: fm.apply(v, a))(xj)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(_nhwc(g), r)
    ref, new = jax.jit(lambda a: fm.apply(v, a, train=True,
                                          mutable=["batch_stats"]))(xj)
    tm.train()
    with torch.no_grad():
        got = tm(xt)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(_nhwc(g), r)
    _running_stats(tm, new["batch_stats"])


@pytest.mark.parametrize("name,size", [
    ("vgg11", 32), ("vgg11", 48), ("vgg16", 32), ("vgg16", 48),
    ("mobilenet_v2", 32), ("unet", 32), ("unet", 48), ("unet", 46),
    ("cpm", 64)])
def test_network_equals_tpucv(name, size):
    _network_check(name, size)


def test_unet_resizes_to_each_skip_size():
    """At 46² the encoder floors to 23, 11, 5, 2 and the decoder resizes
    to each skip's size: 2 -> 5, 5 -> 11, 11 -> 23, 23 -> 46."""
    _, tm, _ = _network("unet")
    seen = []
    hooks = [getattr(tm, f"{d}_c0").register_forward_pre_hook(
        lambda m, a: seen.append(tuple(a[0].shape[2:])))
        for d in ("d4", "d3", "d2", "d1")]
    try:
        with torch.no_grad():
            tm.eval()(_nchw(_x((1, 46, 46, 3))))
    finally:
        for h in hooks:
            h.remove()
    assert seen == [(5, 5), (11, 11), (23, 23), (46, 46)]


def _flax_param_count(fm, size):
    v = jax.eval_shape(fm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, size, size, 3)))
    return v, sum(int(np.prod(a.shape))
                  for a in jax.tree_util.tree_leaves(v["params"]))


@pytest.mark.parametrize("name", ["vgg16", "mobilenet_v2", "unet", "cpm"])
def test_full_width_parameter_counts(name):
    fm, tm, size = {
        "vgg16": (fx.VGG(16), tx.VGG(16), 32),
        "mobilenet_v2": (fx.MobileNetV2(), tx.MobileNetV2(), 32),
        "unet": (fx.UNet(21), tx.UNet(21), 32),
        "cpm": (fo.CPM(), to.CPM(), 64),
    }[name]
    shapes, n = _flax_param_count(fm, size)
    assert n == sum(p.numel() for p in tm.parameters())
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = from_flax_variables(zeros, tm)
    assert sd.keys() == tm.state_dict().keys()
    for k, t in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
