"""tpucv_torch preprocessing against tpucv's: letterbox canvases must be
byte-equal, on random sizes including odd ones; geometry and scaling
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.ops import preprocess as jp
from tpucv_torch.ops import preprocess as tp

torch.set_num_threads(1)


def _canvases(sizes, C, seed=0):
    rng = np.random.default_rng(seed)
    canvases = np.zeros((len(sizes), C, C, 3), np.uint8)
    for j, (h, w) in enumerate(sizes):
        canvases[j, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
    return canvases, np.asarray(sizes, np.int32)


def test_host_letterbox_geom_identical():
    rng = np.random.default_rng(1)
    hw = rng.integers(1, 1500, (200, 2))
    for S in (160, 320, 640):
        g, s = tp.host_letterbox_geom(hw, S)
        gr, sr = jp.host_letterbox_geom(hw, S)
        np.testing.assert_array_equal(g, gr)
        np.testing.assert_array_equal(s, sr)


@pytest.mark.parametrize("S,host_geom", [(320, True), (160, True),
                                         (320, False)])
def test_letterbox_images_byte_equal(S, host_geom):
    rng = np.random.default_rng(S)
    sizes = [(480, 640), (427, 640), (300, 500), (375, 499), (333, 211),
             (1, 7), (640, 640), (97, 613)]
    sizes += [tuple(int(v) for v in rng.integers(1, 641, 2)) for _ in range(8)]
    canvases, hw = _canvases(sizes, 640, seed=S)
    kw_j, kw_t = {}, {}
    if host_geom:
        geom, scale = jp.host_letterbox_geom(hw, S)
        kw_j = dict(geom=jnp.asarray(geom), scale=jnp.asarray(scale))
        kw_t = dict(geom=torch.from_numpy(geom), scale=torch.from_numpy(scale))
    ref = jp.letterbox_images(jnp.asarray(canvases), jnp.asarray(hw), S,
                              **kw_j)
    out = tp.letterbox_images(torch.from_numpy(canvases),
                              torch.from_numpy(hw), S, **kw_t)
    assert out[0].dtype == torch.uint8 and tuple(out[0].shape) == \
        (len(sizes), S, S, 3)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_letterbox_static_equal():
    raw = np.random.default_rng(2).integers(0, 256, (2, 480, 640, 3),
                                            np.uint8)
    ref = jp.letterbox_static(jnp.asarray(raw), 640)
    out = tp.letterbox_static(torch.from_numpy(raw), 640)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert out[1] == ref[1] and tuple(out[2]) == tuple(ref[2])
    with pytest.raises(ValueError):
        tp.letterbox_static(torch.from_numpy(raw[:, :, :400]), 640)


def test_normalize_images():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, -1)
    for jdt, tdt in [(jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)]:
        ref = np.asarray(jp.normalize_images(jnp.asarray(u8), jdt)
                         .astype(jnp.float32))
        out = tp.normalize_images(torch.from_numpy(u8), tdt).float().numpy()
        np.testing.assert_array_equal(out, ref)
    x = np.random.default_rng(3).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tp.imagenet_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jp.imagenet_normalize(jnp.asarray(x))), rtol=1e-6)
