"""tpucv_torch's probe kernels' plain versions against tpucv's probes.

``add_one_reference`` is held bit for bit against a JAX bf16 add;
``conv3x3_reference`` against the Pallas ``build_packed_conv`` of
scripts/probe_pallas_conv.py (in interpret mode, on the CPU) and against
``lax.conv_general_dilated``, and every timing-only variant's plain
definition against a direct loop in numpy. Conv tolerance: one bf16 ulp at
the largest value, max |port - ref| <= 2^-7 * max |ref|: both sides sum in
f32 (or wider) in other orders and round once to bf16. The probes' mains
run at their tiny CPU size. The CUDA kernels themselves are held against
these plain versions in tests/test_torch_cuda.py, on the card.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpucv_torch import _build
from tpucv_torch.ops.conv3x3 import (SMEM_MAX, VARIANTS, conv3x3,
                                     conv3x3_reference, plan, smem_bytes,
                                     strips_for)
from tpucv_torch.ops.stream import add_one, add_one_reference
from tpucv_torch.probes import (common, conv_ablations, probe_bw, probe_conv,
                                probe_conv_parts, probe_conv_v2)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ULP = 2.0 ** -7


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _assert_ulp_close(got: np.ndarray, ref: np.ndarray):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= ULP * scale, f"max err {err} above 2^-7 * {scale}"


def _conv_inputs(seed, B, S, C):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((B, S, S, C)))
    w = _bf16(rng.standard_normal((3, 3, C, C)) * 0.1)
    return x, w


# -- add_one ---------------------------------------------------------------

def _add_one_input(seed, n):
    """bf16 values whose + 1 must round: integers times powers of two at
    |x| >= 256 (where 1 is half an ulp or less: ties to even) and small
    normals."""
    rng = np.random.default_rng(seed)
    big = rng.integers(-1024, 1024, n) * 2.0 ** rng.integers(0, 6, n)
    big[:8] = [256, 257, 258, 510, -256, -258, 511, 512]
    small = rng.standard_normal(n) * 3
    return _bf16(np.where(np.arange(n) % 2 == 0, big, small))


@pytest.mark.parametrize("rows,cols", [(64, 128), (4, 2048), (1, 8192),
                                       (37, 3)])
def test_add_one_reference_is_jax_bf16_add(rows, cols):
    x = _add_one_input(rows, rows * cols).reshape(rows, cols)
    ref = np.asarray(jnp.asarray(_np(x), jnp.bfloat16) + 1)
    got = add_one_reference(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(), ref.view(np.int16))


def test_add_one_on_cpu_is_the_plain_version_and_launches_nothing():
    x = _add_one_input(0, 1000)
    before = add_one.launches
    assert torch.equal(add_one(x).view(torch.int16),
                       add_one_reference(x).view(torch.int16))
    assert add_one.launches == before


def test_add_one_refuses_what_it_cannot_take():
    with pytest.raises(TypeError):
        add_one(torch.ones(8))
    with pytest.raises(ValueError):
        add_one(torch.ones(4, 4, dtype=torch.bfloat16).t())


# -- conv3x3: the full convolution ------------------------------------------

def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,S,C,BHP", [(2, 16, 64, 32), (1, 16, 32, 16),
                                       (1, 16, 16, 16)])
def test_conv3x3_reference_matches_pallas_packed_conv(monkeypatch, B, S, C,
                                                      BHP):
    import jax.experimental.pallas as pallas

    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    script = _load_script("probe_pallas_conv")
    run, pack_weights = script.build_packed_conv(B, S, C, BHP)
    x, w = _conv_inputs(S + C, B, S, C)
    xj = jnp.asarray(_np(x), jnp.bfloat16)
    wj = jnp.asarray(_np(w), jnp.bfloat16)
    ref = np.asarray(run(xj, pack_weights(wj)), np.float32)
    _assert_ulp_close(_np(conv3x3_reference(x, w)), ref)


@pytest.mark.parametrize("C,S", [(16, 12), (32, 10), (64, 9), (64, 16)])
def test_conv3x3_reference_matches_lax_conv(C, S):
    x, w = _conv_inputs(C * S, 2, S, C)
    ref = lax.conv_general_dilated(
        jnp.asarray(_np(x), jnp.bfloat16), jnp.asarray(_np(w), jnp.bfloat16),
        (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    _assert_ulp_close(_np(conv3x3_reference(x, w)), np.asarray(ref))


# -- conv3x3: every variant's plain definition -------------------------------

def _numpy_variant(x, w, variant, tile):
    """The variants written out pixel by pixel, in float64."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    B, S, _, C = x.shape
    flat = x.reshape(-1, C)
    y = np.zeros_like(x)
    for b in range(B):
        for h in range(S):
            for v in range(S):
                r = (b * S + h) * S + v
                for du in range(3):
                    for dv in range(3):
                        if variant == "gemm1" and (du, dv) != (1, 1):
                            continue
                        if variant in ("noshift", "gemm1"):
                            src = x[b, h, v]
                        elif variant == "nomask":
                            q = r + (du - 1) * S + (dv - 1)
                            if not 0 <= q < flat.shape[0]:
                                continue
                            src = flat[q]
                        else:
                            hh, vv = h + du - 1, v + dv - 1
                            ok = 0 <= hh < S and 0 <= vv < S
                            if variant == "nohalo":
                                ok = ok and hh // tile == h // tile
                            if not ok:
                                continue
                            src = x[b, hh, vv]
                        y[b, h, v] += np.dot(src, w[du, dv])
    return y


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_plain_definition_matches_numpy_loop(variant):
    x, w = _conv_inputs(7, 2, 5, 16)
    got = conv3x3_reference(x, w, variant, tile_rows=2)
    _assert_ulp_close(_np(got), _numpy_variant(_np(x), _np(w), variant, 2))


@pytest.mark.parametrize("mode", ["halo", "rolling"])
def test_conv3x3_on_cpu_is_the_plain_version_and_launches_nothing(mode):
    x, w = _conv_inputs(3, 2, 11, 32)
    before = conv3x3.launches
    got = conv3x3(x, w, mode=mode, variant="nohalo", tile_rows=4)
    assert torch.equal(got, conv3x3_reference(x, w, "nohalo", 4))
    assert conv3x3.launches == before


def test_conv3x3_refuses_what_it_cannot_take():
    x, w = _conv_inputs(0, 1, 6, 16)
    with pytest.raises(TypeError):
        conv3x3(x.float(), w.float())
    with pytest.raises(ValueError):
        conv3x3(x[..., :8].contiguous(), w[:, :, :8, :8].contiguous())
    with pytest.raises(ValueError):
        conv3x3(x, w[:, :, :, :8].contiguous())
    with pytest.raises(ValueError):
        conv3x3(x, w, variant="nohalo")
    with pytest.raises(ValueError):
        conv3x3(x, w, mode="sideways")
    with pytest.raises(ValueError):
        conv3x3(x, w, variant="slab2")


# -- what the probes and the smoke compute from shapes ------------------------

# the bounds the probes and chip_smoke.py report, max(bytes / 3.35 TB/s,
# FLOPs / 989 TFLOP/s), all set by bytes
BOUNDS_MS = [0.0626, 0.1252, 0.2504, 0.4402, 0.0451, 0.2504]


@pytest.mark.parametrize("shape,bound", list(zip(probe_conv.SHAPES,
                                                 BOUNDS_MS)))
def test_conv_bounds_and_shared_memory_at_the_probe_shapes(shape, bound):
    _, B, S, C, _ = shape
    ms, by = common.conv_bound(B, S, C)
    assert by == "bytes" and ms == pytest.approx(bound, abs=1e-4)
    assert smem_bytes(S, C) <= SMEM_MAX


def _kernel_constant(name):
    """A constexpr int of csrc/conv3x3.cu, read from the source."""
    src = (REPO / "tpucv_torch" / "csrc" / "conv3x3.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# every (S, C) a probe runs the kernel at: probe_conv's six shapes, the
# parts/v2 shape, and the probes' small CPU shapes
PLAN_SHAPES = sorted({(s[2], s[3]) for s in probe_conv.SHAPES} |
                     {(s[2], s[3]) for s in probe_conv.SMALL_SHAPES} |
                     {(probe_conv_parts.S, probe_conv_parts.C),
                      probe_conv_parts.SMALL[1:]})


@pytest.mark.parametrize("S,C", PLAN_SHAPES)
def test_conv3x3_plan_fits_and_is_the_kernels(S, C):
    p = plan(S, C)
    assert p.col_tile == _kernel_constant("kColTile")
    assert p.ring_rows == _kernel_constant(f"kRingC{C}") >= 4
    assert p.col_tile % 64 == 0
    assert (p.col_tiles - 1) * p.col_tile < S <= p.col_tiles * p.col_tile
    # the weight (tap, ci/8, co, ci%8), the ring of padded rows and each
    # warp's output staging: its m16 tiles of a row, at most 2 KB (8 warps
    # of 2 tiles at C=64, 4 warps of 4 tiles below)
    warps, tiles = (8, 2) if C == 64 else (4, 4)
    assert (p.warps, p.wgmma) == (warps, C == 64)
    assert p.smem_bytes == 9 * C * C * 2 + \
        p.ring_rows * (p.col_tile + 2) * C * 2 + \
        warps * min(tiles * 16 * C * 2, 2048)
    assert p.smem_bytes == smem_bytes(S, C) <= SMEM_MAX


@pytest.mark.parametrize("shape,strips", list(zip(probe_conv.SHAPES,
                                                  [1, 1, 1, 2, 2, 4])))
def test_rolling_strips_at_the_probe_shapes(shape, strips):
    """One CTA an SM on 132 SMs: the strips whose waves of jobs take the
    fewest row steps, halo rows counted."""
    _, B, S, C, _ = shape
    tiles = plan(S, C).col_tiles
    assert strips_for(B, S, tiles, 132) == strips

    def steps(n):
        return -(-B * tiles * n // 132) * (-(-S // n) + 2)

    assert all(steps(strips) <= steps(n) for n in range(1, S + 1))


def test_probe_block_heights_become_row_tiles():
    tiles = [common.tile_rows_of(bhp, 64, 320)
             for _, bhp, _ in probe_conv_parts.CASES]
    assert tiles == [8, 16, 32, 4, 8, 8, 8, 32]
    assert [common.tile_rows_of(s[4], s[3], s[2])
            for s in probe_conv.SHAPES] == [40, 40, 40, 6, 32, 20]


def test_stream_views_are_the_same_bytes():
    views = probe_bw.views(probe_bw.TOT)
    assert len(views) == 6
    assert {r * c for r, c, _ in views} == {probe_bw.TOT * 128}
    assert common.stream_bound_ms(2 * probe_bw.TOT * 128 * 2) == \
        pytest.approx(0.2504, abs=1e-4)


@pytest.mark.parametrize("probe,n_rows", [(probe_bw, 8), (probe_conv, 6),
                                          (probe_conv_parts, 8),
                                          (probe_conv_v2, 9)])
def test_probe_main_runs_small_on_cpu(probe, n_rows, capsys):
    rows = probe.main(["--device", "cpu", "--small"])
    assert len(rows) == n_rows
    assert all(r["mismatches"] == 0 for r in rows)
    assert all(np.isfinite(r["ms"]) for r in rows)
    assert "(cpu)" in capsys.readouterr().out


@pytest.mark.parametrize("name", list(conv_ablations.ABLATIONS))
def test_conv_ablation_edits_apply_to_the_kernel_source(name):
    """Each ablation finds the text it edits in csrc/conv3x3.cu, once or
    more, and changes the source."""
    src = (REPO / "tpucv_torch" / "csrc" / "conv3x3.cu").read_text()
    assert conv_ablations._ablated_source(name) != src


def test_conv_ablations_run_on_the_card_only():
    with pytest.raises(SystemExit):
        conv_ablations.main(["--device", "cpu"])


def test_probe_refuses_the_card_when_there_is_none():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit):
        probe_conv.main([])


# -- the build's flags -------------------------------------------------------

def test_build_flags_are_per_source():
    assert "--fmad=false" in _build.nvcc_flags("nms")
    for name in ("stream", "conv3x3"):
        assert "--fmad=false" not in _build.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in _build.nvcc_flags(name)


def test_library_name_covers_the_sources_own_flags(monkeypatch):
    before = _build.lib_path("stream")
    monkeypatch.setitem(_build.SOURCE_FLAGS, "stream", ["--fmad=false"])
    assert _build.lib_path("stream") != before
    assert _build.lib_path("nms").name.startswith("libnms-")
