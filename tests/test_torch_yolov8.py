"""tpucv_torch YOLOv8 network against tpucv's flax ``Yolo8``.

The same weights (tpucv's init, BatchNorm statistics drawn from a numpy
seed) go through ``from_flax_variables`` into the port; the same images go
through both. Compared in f32 on the CPU: atol 1e-4 on the raw maps, since
XLA:CPU and PyTorch's CPU convolutions sum in different orders over ~60
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ckpt.importer import import_yolov8
from tpucv.models.yolov8 import Yolo8 as FlaxYolo8
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.models.yolov8 import Yolo8

torch.set_num_threads(1)

REF_PARAMS = {"n": 3_157_200, "s": 11_166_560}


def randomize_bn(tree, rng, parent=None):
    """Numpy copy of a flax variables tree with every BatchNorm's affine
    params and statistics drawn from ``rng`` (init leaves them at the
    identity, which would hide an eps or a statistics mix-up)."""
    if isinstance(tree, dict):
        return {k: randomize_bn(v, rng, k) if isinstance(v, dict)
                else _bn_leaf(k, v, rng, parent) for k, v in tree.items()}
    return tree


def _bn_leaf(name, value, rng, parent):
    a = np.array(value, np.float32)
    if parent != "bn":
        return a
    lo_hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name)
    if lo_hi:
        return rng.uniform(*lo_hi, a.shape).astype(np.float32)
    return rng.normal(0.0, 0.1, a.shape).astype(np.float32)    # bias, mean


@pytest.fixture(scope="module")
def flax_n():
    model = FlaxYolo8(scale="n", nc=80)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(0)
    return model, {"params": randomize_bn(v["params"], rng),
                   "batch_stats": randomize_bn(v["batch_stats"], rng)}


@pytest.mark.parametrize("scale", ["n", "s"])
def test_param_count_matches_reference(scale):
    model = Yolo8(scale, nc=80)
    assert sum(p.numel() for p in model.parameters()) == REF_PARAMS[scale]


def test_raw_maps_match_flax(flax_n):
    fmodel, variables = flax_n
    model = Yolo8("n", nc=80)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    model.eval()
    x = np.random.default_rng(1).random((2, 128, 128, 3), dtype=np.float32)
    ref = jax.jit(fmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


def test_flax_to_port_to_flax_round_trip(flax_n):
    _, variables = flax_n
    sd = from_flax_variables(variables)
    assert "model.22.dfl.conv.weight" in sd
    assert tuple(sd["model.22.dfl.conv.weight"].shape) == (1, 16, 1, 1)
    back = import_yolov8({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa
    for coll in ("params", "batch_stats"):
        a, b = flat(variables[coll]), flat(back[coll])
        assert a.keys() == b.keys(), coll
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_port_init_is_seeded_and_loads_into_flax():
    """Weights drawn from a torch.Generator are reproducible, keep the
    head's bias init, and tpucv's importer reads the port's state_dict."""
    a = Yolo8("n").reset_parameters(torch.Generator().manual_seed(3))
    b = Yolo8("n").reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sd = a.state_dict()
    assert torch.all(sd["model.22.cv2.0.2.bias"] == 1.0)
    np.testing.assert_allclose(sd["model.22.cv3.2.2.bias"].numpy(),
                               np.log(5 / 80 / (640 / 32) ** 2), rtol=1e-6)
    assert torch.equal(sd["model.22.dfl.conv.weight"].flatten(),
                       torch.arange(16, dtype=torch.float32))
    v = import_yolov8({k: t.numpy() for k, t in sd.items()})
    assert v["params"]["b2"]["m0"]["cv1"]["conv"]["kernel"].shape == \
        (3, 3, 16, 16)
