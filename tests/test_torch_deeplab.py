"""DeepLabV3+-ResNet: tpucv_torch against tpucv, module by module, in f32 on
the CPU, at full width (ASPP 256, nc 21) and small inputs (ResNet-50 at
65-97² for most cases, ResNet-101 once at 65², so that all 23 layer-3
blocks are crossed). Both packages get the same weights: the port's
seeded init with every BatchNorm and the classifier's bias drawn from a
numpy seed, carried into flax by tpucv's ``import_deeplab`` (which also
skips tpucv's ``jax.jit(model.init)``). Held:

- the config equal to tpucv's; the feature shapes of ``tests/
  test_deeplab.py`` at output stride 8, 16 and 32 (shapes through
  ``jax.eval_shape``) and each block's stride and dilation, torchvision's
  bookkeeping; the parameter counts at ResNet-50 (39,761,845) and
  ResNet-101 (58,753,973) equal to tpucv's;
- the two bilinear resizes alone (``F.interpolate``, half-pixel, no
  antialias) against ``jax.image.resize`` within 1e-6 at 33 -> 129,
  129 -> 513 and 16 -> 64; at 17 -> 65 XLA:CPU folds jax's weight matrix
  into a constant and rounds its sample coordinate differently than it
  does at run time: there each engine's weights are held equal to its own
  rounding and each output within 3e-6 of the float64 resize (the two
  1.7e-6 apart);
- the eval-mode forward within 1e-4 of the largest logit: the port's
  weights through ``import_deeplab`` (ResNet-50 at OS 16 and OS 8,
  ResNet-101), and tpucv's own init through ``from_flax_variables``;
- the train-mode forward at B=1 and B=2 (the image-pool branch's
  BatchNorm sees B values a channel: at B=1 its output is its bias, in
  both) with the ASPP dropout mask shared (the port's mask, recorded by a
  forward hook on its ``StepDropout``, is handed to flax's ``Dropout``,
  replaced in this process by ``SharedDropout``): both engines also run
  in float64, and those runs agree within 1e-5 (of the largest logit,
  and on every running statistic); the f32 logits and statistics within
  2x the larger of the two engines' own f32 gaps from float64 (tpucv's
  is the larger: flax's E[x^2] - E[x]^2 batch variance in f32);
- the weights across: the port's ``state_dict`` through
  ``import_deeplab`` and back through ``from_flax_variables``, exact and
  strict; a reference ``.pth`` loads through ``load_pretrained``;
- CE and focal (jitted in tpucv) within 1e-5 relative with ignored and
  out-of-range labels, 0 on an all-ignored batch, and their gradients
  within 1e-4 of the largest element;
- the confusion matrix equal and every metric within 1e-12, absent
  classes (NaN) included;
- ``SegmentationDataset`` byte-equal to tpucv's in training (over seeds
  and loader epochs) and evaluation, from arrays and from JPEG + colour
  PNG files (VOC's 255 boundary colour included), the sample builders,
  the LUTs and ``SyntheticSegIndex``.

``test_torch_deeplab_slice.py`` holds the algorithm, the trainer, int8
and the CLIs.
"""

import copy
import functools
import os

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_yolov7 import randomize_bn
from tpucv.builder import export_from_registry as tpucv_export
from tpucv.ckpt.importer import import_deeplab
from tpucv.data import loader as jloader
from tpucv.data import segmentation_dataset as jds
from tpucv.losses.segmentation import cross_entropy_loss as j_ce
from tpucv.losses.segmentation import focal_loss as j_focal
from tpucv.metrics.seg_metrics import SegmentationMetrics as JMetrics
from tpucv.metrics.seg_metrics import confusion_matrix as j_confusion
from tpucv.models.deeplabv3plus import DeeplabV3Plus as JDeeplab
from tpucv.models.resnet import ResNet as JResNet
from tpucv_torch.builder import export_from_registry
from tpucv_torch.check import MODELS
from tpucv_torch.ckpt.checkpoint import load_pretrained
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.data import loader as tloader
from tpucv_torch.data import segmentation_dataset as tds
from tpucv_torch.losses.segmentation import cross_entropy_loss, focal_loss
from tpucv_torch.metrics.seg_metrics import (SegmentationMetrics,
                                             confusion_matrix)
from tpucv_torch.models.deeplabv3plus import DeeplabV3Plus, upsample
from tpucv_torch.models.resnet import LAYERS, ResNet
from tpucv_torch.nn.blocks import StepDropout

torch.set_num_threads(1)
NC = 21
FWD_REL = 1e-4
TRAIN_FWD_X, TRAIN_FWD_CEIL = 2.0, 2e-3
BN_STAT_TOL = 1e-5
RESIZE_TOL = 1e-6
LOSS_REL, GRAD_TOL = 1e-5, 1e-4
METRIC_TOL = 1e-12
PARAMS = {"resnet50": 39_761_845, "resnet101": 58_753_973}


# ------------------------------------------------------------ dropout mask
class MaskQueue:
    """The port's dropout masks in the order its training forwards drew
    them, handed to flax in the order flax's dropout keys first appear."""

    def __init__(self):
        self.masks, self.seen = [], {}

    def record(self, module, inputs, _):
        if module.training:
            self.masks.append(module.keep_mask(inputs[0]).permute(
                0, 2, 3, 1).numpy())

    def hook(self, model):
        return [m.register_forward_hook(self.record) for m in model.modules()
                if isinstance(m, StepDropout)]

    def lookup(self, key):
        k = np.asarray(key).tobytes()
        if k not in self.seen:
            self.seen[k] = len(self.seen)
        return self.masks[self.seen[k]]


class SharedDropout(fnn.Dropout):
    """flax's ``Dropout`` with its keep mask taken from ``queue`` (the
    port's masks), by a host callback keyed by the dropout key."""

    queue = None

    @fnn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        det = fnn.merge_param("deterministic", self.deterministic,
                              deterministic)
        if det or self.rate == 0:
            return inputs
        key = self.make_rng(self.rng_collection)
        mask = jax.pure_callback(
            SharedDropout.queue.lookup,
            jax.ShapeDtypeStruct(inputs.shape, jnp.bool_), key)
        return jax.lax.select(mask, inputs / (1.0 - self.rate),
                              jnp.zeros_like(inputs))


@pytest.fixture
def shared_dropout(monkeypatch):
    """A fresh ``MaskQueue``, flax's ``Dropout`` replaced by
    ``SharedDropout`` for the test."""
    q = MaskQueue()
    monkeypatch.setattr(SharedDropout, "queue", q)
    monkeypatch.setattr(fnn, "Dropout", SharedDropout)
    return q


# ----------------------------------------------------------------- weights
def port_model(backbone="resnet50", os_=16, nc=NC, seed=0):
    """The port's seeded init with BatchNorm and the classifier's bias drawn
    from a numpy seed."""
    model = DeeplabV3Plus(nc, backbone, os_).reset_parameters(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    randomize_bn(model, rng)
    with torch.no_grad():
        b = model.classifier.classifier[3].bias
        b.copy_(torch.from_numpy(rng.normal(0, 0.05, b.shape)
                                 .astype(np.float32)))
    return model.eval()


def numpy_sd(model):
    """Copies: a view would follow the model's weights as it trains."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@functools.lru_cache(maxsize=None)
def pair(backbone="resnet50", os_=16):
    """(tpucv module, tpucv variables, port model) with the same weights."""
    model = port_model(backbone, os_)
    return (JDeeplab(num_classes=NC, backbone=backbone, output_stride=os_),
            import_deeplab(numpy_sd(model)), model)


def _images(b=1, s=65, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, s, s, 3)).astype(
        np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------ config
def test_config_equals_tpucv():
    jcfg, _, _ = tpucv_export("deeplabv3plus")
    tcfg, _, _ = export_from_registry("deeplabv3plus")
    for sec in ("arch", "loss", "optimizer", "dataset", "train"):
        assert vars(getattr(tcfg, sec)) == vars(getattr(jcfg, sec)), sec
    assert tcfg.num_classes == jcfg.num_classes == NC
    assert (tcfg.arch.backbone, tcfg.arch.output_stride,
            tcfg.arch.crop_size) == ("resnet101", 16, 513)
    assert (tcfg.loss.name, tcfg.loss.alpha, tcfg.loss.gamma,
            tcfg.loss.ignore_index) == ("focal", 0.25, 2.0, 255)
    assert (tcfg.optimizer.lr, tcfg.optimizer.warmup_iters,
            tcfg.optimizer.milestones) == (7e-4, 1000, (60, 80))
    assert tcfg.train.batch_size == 16 and tcfg.train.mixed_precision
    assert "deeplabv3plus" in MODELS


# ----------------------------------------------------------------- network
# (layer, block) -> (stride, dilation) of conv2, torchvision's bookkeeping
BLOCKS = {
    32: {(4, 0): (2, 1), (4, 1): (1, 1), (3, 0): (2, 1), (3, 1): (1, 1)},
    16: {(4, 0): (1, 1), (4, 1): (1, 2), (4, 2): (1, 2), (3, 0): (2, 1),
         (3, 5): (1, 1)},
    8: {(3, 0): (1, 1), (3, 1): (1, 2), (3, 5): (1, 2), (4, 0): (1, 2),
        (4, 1): (1, 4), (4, 2): (1, 4), (2, 0): (2, 1)},
}


@pytest.mark.parametrize("os_", [8, 16, 32])
def test_resnet_feature_shapes_and_dilations(os_):
    x = np.zeros((1, 64, 64, 3), np.float32)
    jm = JResNet(LAYERS["resnet50"], os_)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    ref = jax.eval_shape(jm.apply, v, x)
    model = ResNet(LAYERS["resnet50"], os_).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ref["low_level"].shape == (1, 16, 16, 256)
    assert ref["out"].shape == (1, 64 // os_, 64 // os_, 2048)
    for k in ("low_level", "out"):
        assert _nhwc(got[k]).shape == ref[k].shape, k
    for (li, b), (s, d) in BLOCKS[os_].items():
        c = getattr(model, f"layer{li}")[b].conv2
        assert (c.stride[0], c.dilation[0], c.padding[0]) == (s, d, d), (li, b)
        down = getattr(model, f"layer{li}")[0].downsample[0]
        assert down.stride[0] == getattr(model, f"layer{li}")[0].conv2.stride[0]


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_param_counts(backbone):
    x = jnp.zeros((1, 65, 65, 3))
    v = jax.eval_shape(JDeeplab(NC, backbone).init, jax.random.PRNGKey(0), x)
    ref = sum(int(np.prod(a.shape))
              for a in jax.tree_util.tree_leaves(v["params"]))
    model = DeeplabV3Plus(NC, backbone)
    assert sum(p.numel() for p in model.parameters()) == ref \
        == PARAMS[backbone]


def _j_resize(x, dst):
    return np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (a.shape[0], dst, dst, a.shape[3]), "bilinear"))(x))


def _t_resize(x, dst):
    return _nhwc(upsample(torch.from_numpy(x).permute(0, 3, 1, 2),
                          (dst, dst)))


def _coordinate_weights(src, dst, fused):
    """(src, dst) bilinear weights with the sample coordinate ``(i + 0.5)
    * f32(src / dst) - 0.5`` rounded once (a multiply-add) or twice."""
    inv = np.float32(1.0 / (dst / src))
    i = np.arange(dst, dtype=np.float32) + np.float32(0.5)
    s = ((i.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
         if fused else i * inv - np.float32(0.5))
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(
        s[None, :] - np.arange(src, dtype=np.float32)[:, None]))
    return w / w.sum(0, keepdims=True)


@pytest.mark.parametrize("src,dst", [(33, 129), (129, 513), (16, 64)])
def test_resize_equals_jax(src, dst):
    x = np.random.default_rng(src).uniform(-1, 1, (2, src, src, 5)).astype(
        np.float32)
    np.testing.assert_allclose(_t_resize(x, dst), _j_resize(x, dst), rtol=0,
                               atol=RESIZE_TOL)


def test_resize_where_xla_folds_the_weights():
    """17 -> 65: XLA:CPU folds jax's (17, 65) weight matrix into a constant
    and there rounds the coordinate's product and difference apart, where
    at run time (33 -> 129, 129 -> 513) it fuses them as ``F.interpolate``
    does. Each engine's weights (read off one-hot inputs) within 1e-7 of
    its own rounding's, each output within 4e-6 of the float64 resize,
    the two 1.7e-6 apart."""
    src, dst = 17, 65
    eye = np.eye(src, dtype=np.float32).reshape(src, src, 1, 1)
    j_w = _j_resize(eye, dst)          # (src, dst, dst, 1): row i's weights
    t_w = _t_resize(eye, dst)
    once, twice = (_coordinate_weights(src, dst, f) for f in (True, False))
    assert np.abs(once - twice).max() > 9e-7          # an ulp of 16
    np.testing.assert_allclose(j_w[:, :, 0, 0], twice, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_w[:, :, 0, 0], once, rtol=0, atol=1e-7)
    x = np.random.default_rng(src).uniform(-1, 1, (2, src, src, 5)).astype(
        np.float32)
    s = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    w = np.maximum(0, 1 - np.abs(s[None, :] - np.arange(src)[:, None]))
    w /= w.sum(0, keepdims=True)
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), w, w)
    for got in (_t_resize(x, dst), _j_resize(x, dst)):
        # an ulp of a coordinate near 16 (1.9e-6) times values 2 apart
        assert np.abs(got - exact).max() <= 4e-6
    assert np.abs(_t_resize(x, dst) - _j_resize(x, dst)).max() <= 2e-6


def _assert_logits_close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= FWD_REL * np.abs(ref).max()


@pytest.mark.parametrize("backbone,os_,size", [("resnet50", 16, 65),
                                               ("resnet50", 8, 97),
                                               ("resnet101", 16, 65)])
def test_forward_eval_equal(backbone, os_, size):
    jm, variables, model = pair(backbone, os_)
    x = _images(s=size, seed=size)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, NC, size, size)
    _assert_logits_close(_nhwc(got), ref)


def test_forward_from_tpucv_init():
    """tpucv's own init (``jax.jit(model.init)``) through
    ``from_flax_variables``, strict, and the same forward."""
    jm = JDeeplab(NC, "resnet50")
    x = _images(s=65, seed=7)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    model = DeeplabV3Plus(NC, "resnet50")
    model.load_state_dict(from_flax_variables(v), strict=True)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    _assert_logits_close(_nhwc(got), ref)


def _tpucv_train_f64(variables, x, key):
    """tpucv's train-mode forward in float64 (x64 on for the call): the
    logits and the batch statistics' tree."""
    with jax.enable_x64():
        jm = JDeeplab(num_classes=NC, backbone="resnet50", dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        out, upd = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64), rngs={"dropout": key})
        return np.asarray(out), jax.tree_util.tree_map(np.asarray, upd)


@pytest.mark.parametrize("b", [1, 2])
def test_forward_train_and_bn_stats_equal(b, shared_dropout):
    """Each engine in f32 and in float64 (the port's model ``.double()``,
    tpucv's under x64 with float64 variables; one dropout mask for all
    four): the two float64 runs within 1e-5 of the largest logit (tpucv
    casts its logits to f32 before the last resize) and every running
    statistic within 1e-5; the f32 runs within 2x the larger of the two
    engines' own f32 gaps. tpucv's is the larger (1.1e-3 and 1.5e-3 of
    logits up to 2.5 at B=1 and 2, the port's 5e-4 and 7e-4): flax takes
    the batch variance as E[x^2] - E[x]^2 in f32, and on layer 4's 5x5
    maps BatchNorm amplifies that."""
    jm, variables, model = pair()
    x = _images(b=b, seed=3 + b)
    m = copy.deepcopy(model).train()
    m64 = copy.deepcopy(model).double().train()
    hooks = shared_dropout.hook(m)
    with torch.no_grad():
        got = _nhwc(m(torch.from_numpy(x)))
        exact = _nhwc(m64(torch.from_numpy(x).double()))
    for h in hooks:
        h.remove()
    assert len(shared_dropout.masks) == 1
    key = jax.random.PRNGKey(1)
    ref, upd = jax.jit(functools.partial(jm.apply, train=True,
                                         mutable=["batch_stats"]))(
        variables, jnp.asarray(x), rngs={"dropout": key})
    ref = np.asarray(ref)
    ref64, upd64 = _tpucv_train_f64(variables, x, key)
    scale = np.abs(ref).max()
    assert np.abs(exact - ref64).max() <= FWD_REL * 0.1 * scale
    own = max(np.abs(got - exact).max(), np.abs(ref - ref64).max())
    assert np.abs(got - ref).max() <= TRAIN_FWD_X * own
    assert np.abs(got - exact).max() <= TRAIN_FWD_CEIL * scale

    sds = [from_flax_variables({"params": variables["params"],
                                "batch_stats": u["batch_stats"]})
           for u in (upd, upd64)]
    sd, sd64, before = m.state_dict(), m64.state_dict(), model.state_dict()
    n = 0
    for k in sds[0]:
        if "running_" not in k:
            continue
        p, p64, j, j64 = (t[k].double().numpy() for t in (sd, sd64, *sds))
        assert np.abs(p64 - j64).max() <= BN_STAT_TOL, k
        own = max(np.abs(p - p64).max(), np.abs(j - j64).max())
        assert np.abs(p - j).max() <= max(TRAIN_FWD_X * own, BN_STAT_TOL), k
        assert not torch.equal(sd[k], before[k]), k
        n += 1
    assert n == 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                        for mod in m.modules())
    # the pool branch at B=1: one value a channel, its batch variance 0
    if b == 1:
        torch.testing.assert_close(
            sd["classifier.aspp.convs.4.2.running_var"],
            before["classifier.aspp.convs.4.2.running_var"] * 0.9,
            rtol=0, atol=1e-6)


def test_weights_round_trip_through_import_deeplab():
    _, variables, model = pair()
    sd = from_flax_variables(variables)
    assert sorted(sd) == sorted(model.state_dict())
    fresh = DeeplabV3Plus(NC, "resnet50")
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    back = import_deeplab(numpy_sd(fresh))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])


def test_reference_pth_loads_without_importer(tmp_path):
    _, _, model = pair()
    path = str(tmp_path / "ref.pth")
    torch.save(model.state_dict(), path)
    fresh = DeeplabV3Plus(NC, "resnet50")
    load_pretrained(fresh, path, "deeplabv3plus")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# -------------------------------------------------------------------- loss
def _loss_inputs(seed, b=2, s=33, ignore=0.2, out_of_range=0.05):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, s, s, NC)).astype(np.float32)
    labels = rng.integers(0, NC, (b, s, s)).astype(np.int32)
    labels[rng.random((b, s, s)) < ignore] = 255
    bad = rng.random((b, s, s)) < out_of_range
    labels[bad] = rng.choice([-1, NC, 100], bad.sum())
    return logits, labels


LOSSES = {"ce": (j_ce, cross_entropy_loss, {}),
          "focal": (j_focal, focal_loss, {"alpha": 0.25, "gamma": 2.0})}


def _both_losses(name, logits, labels):
    jf, tf, kw = LOSSES[name]
    rl, rp = jax.jit(functools.partial(jf, **kw))(jnp.asarray(logits),
                                                  jnp.asarray(labels))
    gl, gp = tf(torch.from_numpy(logits).permute(0, 3, 1, 2),
                torch.from_numpy(labels), **kw)
    assert sorted(gp) == sorted(rp) == [f"{name}_loss"]
    return float(rl), float(gl)


@pytest.mark.parametrize("name", ["ce", "focal"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_equal(name, seed):
    ref, got = _both_losses(name, *_loss_inputs(seed))
    assert got > 0 and got == pytest.approx(ref, rel=LOSS_REL)


@pytest.mark.parametrize("name", ["ce", "focal"])
def test_loss_all_ignored_is_zero(name):
    logits, labels = _loss_inputs(2)
    labels[:] = 255
    labels[0, 0, :3] = [-1, NC, 300]
    assert _both_losses(name, logits, labels) == (0.0, 0.0)


@pytest.mark.parametrize("name", ["ce", "focal"])
def test_loss_gradient_equal(name):
    logits, labels = _loss_inputs(3)
    jf, tf, kw = LOSSES[name]
    ref = np.asarray(jax.jit(jax.grad(lambda a: jf(a, jnp.asarray(labels),
                                                   **kw)[0]))(logits))
    t = torch.from_numpy(logits).permute(0, 3, 1, 2).requires_grad_()
    tf(t, torch.from_numpy(labels), **kw)[0].backward()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(_nhwc(t.grad) - ref).max() <= GRAD_TOL * scale


# ----------------------------------------------------------------- metrics
def _maps(seed, b=3, s=40, nc=NC):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, nc, (b, s, s)).astype(np.int32)
    label[rng.random((b, s, s)) < 0.1] = 255
    label[rng.random((b, s, s)) < 0.02] = -1
    pred = np.where(rng.random((b, s, s)) < 0.6, label,
                    rng.integers(-2, nc + 2, (b, s, s))).astype(np.int32)
    return pred, label


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_equal(seed):
    pred, label = _maps(seed)
    ref = np.asarray(jax.jit(functools.partial(
        j_confusion, num_classes=NC))(jnp.asarray(pred), jnp.asarray(label)))
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label),
                           NC)
    assert got.dtype == torch.int64 and got.shape == (NC, NC)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum() == ((label >= 0) & (label < NC)).sum()


@pytest.mark.parametrize("absent", [(), (3, 7), (0, 20)])
def test_metrics_equal(absent):
    ref, got = JMetrics(NC), SegmentationMetrics(NC)
    for seed in range(3):
        pred, label = _maps(10 + seed)
        pred = np.clip(pred, 0, NC - 1)
        for c in absent:      # no GT and no prediction of these classes
            label[label == c] = 255
            pred[pred == c] = 10
        ref.update(pred, label)
        got.update(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_array_equal(got.hist, ref.hist)
    r, g = ref.compute(), got.compute()
    assert sorted(g) == sorted(r)
    for k in ("overall_acc", "mean_acc", "freq_weighted_acc", "mIoU"):
        assert abs(g[k] - r[k]) <= METRIC_TOL, k
    np.testing.assert_allclose(g["per_class_iou"], r["per_class_iou"],
                               rtol=0, atol=METRIC_TOL)
    assert np.isnan(g["per_class_iou"]).sum() == len(absent)


# ------------------------------------------------------------------ dataset
def test_colour_tables_equal():
    assert tds.VOC_COLORMAP == jds.VOC_COLORMAP
    assert tds.CITYSCAPES_COLORMAP == jds.CITYSCAPES_COLORMAP
    np.testing.assert_array_equal(tds.colormap2label(), jds.colormap2label())
    np.testing.assert_array_equal(tds.cityscapes_id_lut(),
                                  jds.cityscapes_id_lut())
    rgb = np.random.default_rng(0).integers(0, 256, (40, 50, 3),
                                            dtype=np.uint8)
    rgb[:10, :10] = tds.VOC_COLORMAP[5]
    rgb[10:12] = (224, 224, 192)                   # VOC's boundary colour
    np.testing.assert_array_equal(tds.label_indices(rgb),
                                  jds.label_indices(rgb))
    assert (tds.label_indices(rgb)[:10, :10] == 5).all()
    assert (tds.label_indices(rgb)[10:12] == 255).all()


def test_synthetic_index_equal():
    a, b = tds.SyntheticSegIndex(5, 65, NC, 3), jds.SyntheticSegIndex(
        5, 65, NC, 3)
    for i in range(5):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)


def _samples(seed, n=4):
    """Arrays of varied shapes, smaller and larger than the crop."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(40, 140)), int(rng.integers(40, 140))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = rng.integers(0, NC, (h, w)).astype(np.uint8)
        mask[rng.random((h, w)) < 0.1] = 255
        out.append((img, mask))
    return out


def _assert_items_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_byte_equal(train, seed):
    samples = _samples(seed)
    a = tds.SegmentationDataset(samples, 65, train=train)
    b = jds.SegmentationDataset(samples, 65, train=train)
    for epoch in range(2):
        for i in range(len(samples)):
            # the loaders' per-batch reseed
            tloader._reseed(a, seed, epoch, i)
            jloader._reseed(b, seed, epoch, i)
            _assert_items_equal(a[i], b[i])


def _write_seg_root(root, n=3, size=(70, 90)):
    """VOC ``JPEGImages`` + colour ``SegmentationClass`` PNGs whose objects
    are bordered by VOC's 255 boundary colour, ``ImageSets/Segmentation/
    val.txt``; an SBD ``img`` / ``cls_png`` layout and a Cityscapes one."""
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation",
              "img", "cls_png", "leftImg8bit/val/aachen",
              "gtFine/val/aachen"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    h, w = size
    ids = []
    for i in range(n):
        ids.append(f"{i:06d}")
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w, 3), np.uint8)
        mask[10:40, 20:60] = (224, 224, 192)
        mask[12:38, 22:58] = tds.VOC_COLORMAP[1 + i]
        for path, arr in (
                (f"JPEGImages/{ids[-1]}.jpg", img),
                (f"img/{ids[-1]}.jpg", img),
                (f"SegmentationClass/{ids[-1]}.png", mask),
                (f"cls_png/{ids[-1]}.png", mask[..., 0] % NC),
                (f"leftImg8bit/val/aachen/a_{i}_leftImg8bit.png", img),
                (f"gtFine/val/aachen/a_{i}_gtFine_labelIds.png",
                 mask[..., 1])):
            assert cv2.imwrite(os.path.join(root, path),
                               arr[..., ::-1] if arr.ndim == 3 else arr)
    for f in ("ImageSets/Segmentation/val.txt", "val.txt"):
        with open(os.path.join(root, f), "w") as fh:
            fh.write("\n".join(ids) + "\n")


@pytest.mark.parametrize("train", [True, False])
def test_dataset_from_files_byte_equal(tmp_path, train):
    root = str(tmp_path)
    _write_seg_root(root)
    for t_build, j_build in (
            (tds.build_voc_seg_samples, jds.build_voc_seg_samples),
            (tds.build_sbd_samples, jds.build_sbd_samples),
            (tds.build_cityscapes_samples, jds.build_cityscapes_samples)):
        samples = t_build(root, "val")
        assert samples == j_build(root, "val") and len(samples) == 3
        a = tds.SegmentationDataset(samples, 65, train=train)
        b = jds.SegmentationDataset(samples, 65, train=train)
        for i in range(len(samples)):
            tloader._reseed(a, 4, 0, i)
            jloader._reseed(b, 4, 0, i)
            _assert_items_equal(a[i], b[i])
    labels = tds.SegmentationDataset(
        tds.build_voc_seg_samples(root, "val"), 65, train=False)[0][1]
    assert (labels == 255).any() and (labels == 1).any()


def test_loader_batches_equal():
    samples = tds.synthetic_seg_samples(6, 65, NC, 0)
    a = tloader.Loader(tds.SegmentationDataset(samples, 65, train=True), 4,
                       shuffle=True, collate=tloader.segmentation_collate)
    b = jloader.Loader(jds.SegmentationDataset(samples, 65, train=True), 4,
                       shuffle=True, collate=jloader.segmentation_collate)
    for epoch in range(2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        n = 0
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y) == ["images", "labels"]
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
            n += 1
        assert n == len(a) == len(b)
