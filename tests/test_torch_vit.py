"""tpucv_torch's ViT against tpucv's (``tpucv/models/vit.py``), in f32 on
the CPU. Weights come from tpucv's own init (``jax.jit(model.init)``) and
are carried into the port by ``ckpt/convert.py:from_flax_variables``,
which loads with ``strict=True``; inputs are drawn with numpy. Held:

- tanh GELU: within 2e-6 of flax's ``nn.gelu`` (measured 9.5e-7 over
  values up to 13; the erf form parts by 4.7e-4);
- LayerNorm at eps 1e-6: on rows of unit scale within 1e-5 of flax's; on
  rows with a large mean and a small spread, where flax's f32
  E[x²]-E[x]² variance loses digits (9.1e-4 from float64, the port's
  two-pass variance 3.6e-6), within 2x the larger of the two engines'
  float64 gaps; eps 1e-5 would part by 5.8e-2;
- one attention ``Block`` (dim 32, heads 2) and the ``DenseGeneral``
  reshapes (q / k / v (dim, H, hd) -> (H·hd, dim), out (H, hd, dim) ->
  (dim, H·hd), biases (H, hd) -> (H·hd)): the flat ``nn.Linear`` equal to
  flax's contraction within 1e-5 + 1e-6 relative, on unit-normal kernels;
- a narrow ViT (patch 8, dim 32, depth 2, heads 2, 32², nc 10) and one
  ViT-S/16-width block at 224² (dim 384, heads 6, depth 1: 197 tokens):
  the f32 logits within FWD_REL (1e-4) of the largest |logit| (measured
  2.9e-7 and 9.1e-7; both engines' float64 runs agree within 3e-15, so
  the gap is f32 rounding alone), the parameter counts and key sets equal;
- the bf16 forward (tpucv's ``dtype=bfloat16``, the port's bf16
  autocast): the port's bf16-against-f32 error within 2x tpucv's own
  (measured 0.71-0.89x) and top-1 agreeing with the f32 logits on at
  least 95% of the images (measured 100%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from tpucv.models.vit import Block as FlaxBlock
from tpucv.models.vit import ViT as FlaxViT
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.models.vit import LN_EPS, Block, ViT

torch.set_num_threads(1)
FWD_REL = 1e-4
BF16_RATIO = 2.0
TOP1_AGREE_MIN = 0.95
NARROW = dict(patch=8, dim=32, depth=2, heads=2, size=32)
S16_BLOCK = dict(patch=16, dim=384, depth=1, heads=6, size=224)


@functools.lru_cache(maxsize=None)
def _pair(patch, dim, depth, heads, size, nc=10):
    """tpucv's ViT with its seed-0 init, and the port's with those
    weights."""
    fm = FlaxViT(num_classes=nc, patch=patch, dim=dim, depth=depth,
                 heads=heads)
    variables = jax.jit(fm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, size, size, 3)))
    model = ViT(nc, patch, dim, depth, heads, size).eval()
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return fm, variables, model


def _images(b, s, seed=2):
    return np.random.default_rng(seed).random((b, s, s, 3), np.float32)


def test_gelu_is_flaxs_tanh_form():
    x = np.random.default_rng(0).normal(0, 3, 100_000).astype(np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    assert np.abs(got - ref).max() <= 2e-6
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - ref).max() > 1e-4


def _layer_norms(x, scale, bias):
    """flax's LayerNorm, the port's (eps LN_EPS) and torch's default eps
    on ``x``, and the float64 two-pass reference."""
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    ref = np.asarray(fnn.LayerNorm().apply(params, jnp.asarray(x)))
    outs = []
    for eps in (LN_EPS, 1e-5):
        ln = torch.nn.LayerNorm(x.shape[-1], eps=eps)
        ln.load_state_dict({"weight": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            outs.append(ln(torch.from_numpy(x)).numpy())
    x64 = x.astype(np.float64)
    m = x64.mean(-1, keepdims=True)
    var = ((x64 - m) ** 2).mean(-1, keepdims=True)
    f64 = (x64 - m) / np.sqrt(var + 1e-6) * scale + bias
    return ref, outs[0], outs[1], f64


@pytest.mark.parametrize("rows", ["unit", "offset"])
def test_layer_norm_eps_and_variance(rows):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (64, 384))
    if rows == "offset":          # mean 0-15, spread 1e-3-3: eps matters
        x = x * rng.uniform(1e-3, 3, (64, 1)) + rng.normal(0, 5, (64, 1))
    x = x.astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 384).astype(np.float32)
    bias = rng.normal(0, 0.1, 384).astype(np.float32)
    ref, got, eps5, f64 = _layer_norms(x, scale, bias)
    gap = max(np.abs(ref - f64).max(), np.abs(got - f64).max())
    if rows == "unit":
        assert np.abs(got - ref).max() <= 1e-5
    else:
        assert np.abs(got - f64).max() <= 1e-5
        assert np.abs(got - ref).max() <= 2 * gap
        assert np.abs(eps5 - ref).max() > 10 * gap


def test_attention_block_equals_flax():
    fb = FlaxBlock(dim=32, heads=2)
    x = np.random.default_rng(4).normal(0, 1, (2, 17, 32)).astype(np.float32)
    variables = jax.jit(fb.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    sd = from_flax_variables({"params": {"block0": variables["params"],
                                         "pos_embed": np.zeros((1, 17, 32))}})
    block = Block(32, 2).eval()
    block.load_state_dict({k[len("block0."):]: v for k, v in sd.items()
                           if k.startswith("block0.")}, strict=True)
    ref = np.asarray(fb.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= FWD_REL * np.abs(ref).max()


def test_dense_general_reshapes():
    """The flat ``nn.Linear`` of each attention projection equals flax's
    ``DenseGeneral`` contraction, on random kernels."""
    _, variables, _ = _pair(**NARROW)
    rng = np.random.default_rng(5)
    attn = {k: {"kernel": rng.normal(0, 1, np.shape(v["kernel"])).astype(
                    np.float32),
                "bias": rng.normal(0, 1, np.shape(v["bias"])).astype(
                    np.float32)}
            for k, v in variables["params"]["block0"]["attn"].items()}
    sd = from_flax_variables({"params": {"block0": {"attn": attn},
                                         "pos_embed": np.zeros((1, 5, 32))}})
    x = rng.normal(0, 1, (3, 32)).astype(np.float32)
    h = rng.normal(0, 1, (3, 2, 16)).astype(np.float32)
    for name in ("query", "key", "value"):
        k, b = attn[name]["kernel"], attn[name]["bias"]
        assert k.shape == (32, 2, 16) and b.shape == (2, 16)
        ref = np.einsum("bi,ihd->bhd", x, k) + b
        w = sd[f"block0.attn.{name}.weight"].numpy()
        assert w.shape == (32, 32)
        got = x @ w.T + sd[f"block0.attn.{name}.bias"].numpy()
        np.testing.assert_allclose(got, ref.reshape(3, 32), atol=1e-5,
                                   rtol=1e-6)
    k, b = attn["out"]["kernel"], attn["out"]["bias"]
    assert k.shape == (2, 16, 32)
    ref = np.einsum("bhd,hdo->bo", h, k) + b
    got = h.reshape(3, 32) @ sd["block0.attn.out.weight"].numpy().T \
        + sd["block0.attn.out.bias"].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("shape", [NARROW, S16_BLOCK],
                         ids=["narrow", "s16_block_224"])
def test_forward_equals_tpucv(shape):
    fm, variables, model = _pair(**shape)
    n = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables))
    assert n == sum(p.numel() for p in model.parameters())
    keys = set(model.state_dict())
    assert {"cls", "pos_embed", "patchify.weight", "ln.weight",
            "head.weight", "block0.attn.out.weight",
            "block0.mlp.fc2.bias"} <= keys
    s = shape["size"]
    assert model.pos_embed.shape == (1, 1 + (s // shape["patch"]) ** 2,
                                     shape["dim"])
    x = _images(2, s)
    ref = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    assert np.abs(got - ref).max() <= FWD_REL * np.abs(ref).max()


def test_vit_s16_parameter_count():
    """ViT-S/16 at 224², nc 10, as ``vit_cls`` ships it."""
    model = ViT(10)
    assert sum(p.numel() for p in model.parameters()) == 21_669_514
    assert model.pos_embed.shape == (1, 197, 384)


def test_bf16_forward_within_tpucvs_own_bf16_error():
    fm, variables, model = _pair(**NARROW)
    fb = FlaxViT(num_classes=10, patch=8, dim=32, depth=2, heads=2,
                 dtype=jnp.bfloat16)
    x = _images(64, 32, seed=6)
    ref = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x)))
    ref_bf16 = np.asarray(jax.jit(fb.apply)(
        variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got_bf16 = model(torch.from_numpy(x).bfloat16()).float().numpy()
    own = np.abs(ref_bf16 - ref).max()
    assert 0 < np.abs(got_bf16 - got).max() <= BF16_RATIO * own
    assert (got_bf16.argmax(-1) == ref.argmax(-1)).mean() >= TOP1_AGREE_MIN
