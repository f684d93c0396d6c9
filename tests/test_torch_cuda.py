"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor tpucv, so it runs on a machine with an
NVIDIA card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q

Without CUDA every test skips. NMS keep masks must be identical: the
kernel computes the IoU in f32 with the reference's association and no FMA
contraction, so no pair near the threshold may flip. ``add_one`` must be
bit-equal to ``x + 1``. The 3x3 conv may differ from its plain version by
one bf16 ulp at the largest value (2^-7 * max |plain|): both sum in f32,
in other orders, and round once to bf16.
"""

import numpy as np
import pytest
import torch

from tpucv_torch.ops.cuda_nms import (MAX_BOXES, cuda_nms, nms_keep,
                                      nms_keep_reference)
from tpucv_torch.ops.conv3x3 import (COL_TILE, VARIANTS, _ctas_on_card,
                                     conv3x3, conv3x3_reference, kernel_plan,
                                     plan, rolling_tile_rows, strips_for)
from tpucv_torch.ops.nms_cases import (chain_keep, class_offset_case,
                                       kernel_cases)
from tpucv_torch.ops.stream import add_one, add_one_reference
from tpucv_torch.probes import probe_conv
from tpucv_torch.probes.common import compare, conv_inputs, library_conv

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel needs an NVIDIA card")


def _tensors(seed, B, K, n_cls, n_invalid):
    boxes, scores = class_offset_case(seed, B, K, n_cls, n_invalid)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


CASES = kernel_cases()


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_version(name):
    (boxes, scores), thr = CASES[name]
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = nms_keep.launches
    keep = nms_keep(boxes.cuda(), scores.cuda(), thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    ref = nms_keep_reference(boxes, scores, thr)
    torch.testing.assert_close(keep.cpu(), ref, rtol=0, atol=0)
    if name.startswith("chain"):
        assert torch.nonzero(keep[0]).flatten().tolist() == chain_keep(name)


def test_cuda_nms_matches_cpu_path():
    boxes, scores = _tensors(3, 8, 1024, 8, 100)
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(0))
    boxes, scores = boxes[:, perm].contiguous(), scores[:, perm].contiguous()
    idx_c, val_c = cuda_nms(boxes.cuda(), scores.cuda(), 0.7, 300)
    idx_p, val_p = cuda_nms(boxes, scores, 0.7, 300)
    assert torch.equal(idx_c.cpu(), idx_p) and torch.equal(val_c.cpu(), val_p)


def test_kernel_refuses_what_it_cannot_take():
    boxes, scores = _tensors(1, 2, MAX_BOXES + 1, 1, 0)
    with pytest.raises(ValueError):
        nms_keep(boxes.cuda(), scores.cuda(), 0.5)
    with pytest.raises(ValueError):
        nms_keep(boxes.cuda(), scores, 0.5)
    with pytest.raises(TypeError):
        nms_keep(boxes.cuda().half(), scores.cuda().half(), 0.5)


# -- add_one --------------------------------------------------------------

def _bf16_ties(n, seed):
    """bf16 values where + 1 rounds: |x| >= 256 (ties to even among them)
    and ordinary normals."""
    rng = np.random.default_rng(seed)
    big = rng.integers(-1024, 1024, n).astype(np.float32) * 2.0 ** \
        rng.integers(0, 4, n)
    vals = np.where(rng.random(n) < 0.5, big, rng.standard_normal(n) * 3)
    return torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (1000, 3), (1024, 128),
                                   (33, 2048), (4099, 130)])
def test_add_one_bitwise(shape):
    x = _bf16_ties(int(np.prod(shape)), len(shape)).reshape(shape).cuda()
    before = add_one.launches
    y = add_one(x)
    torch.cuda.synchronize()
    assert add_one.launches == before + 1
    assert torch.equal(y.view(torch.int16),
                       add_one_reference(x).view(torch.int16))


def test_add_one_refuses_what_it_cannot_take():
    with pytest.raises(TypeError):
        add_one(torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        add_one(torch.ones(8, 8, device="cuda", dtype=torch.bfloat16).t())


# -- conv3x3 ---------------------------------------------------------------

def _close(got, ref):
    bad, err, scale = compare(got, ref)
    assert bad == 0, f"{bad} elements off by more than 2^-7 * {scale} " \
                     f"(max {err})"


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("mode", ["halo", "rolling"])
@pytest.mark.parametrize("B,S", [(2, 20), (1, 33), (3, 5), (2, 12),
                                 (1, 63), (1, 64), (1, 65), (1, 129),
                                 (1, 300)])
def test_conv3x3_matches_plain(C, mode, B, S):
    """Rows narrower than a column tile, at its edges (63-65, 129) and over
    three tiles (300), S < 16 included."""
    x, w = conv_inputs(B, S, C, torch.device("cuda"), seed=S)
    before = conv3x3.launches
    got = conv3x3(x, w, mode=mode, tile_rows=3 if mode == "halo" else None)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    _close(got, conv3x3_reference(x, w))
    _, err, scale = compare(got, library_conv(x, w))
    assert err / scale <= 2e-2


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ["halo", "rolling"])
@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("S", [21, 130])
def test_conv3x3_variants_match_their_plain_definitions(variant, mode, C, S):
    """A row tile of 4 that does not divide S, in one or two column
    tiles."""
    x, w = conv_inputs(2, S, C, torch.device("cuda"), seed=1)
    got = conv3x3(x, w, mode=mode, variant=variant, tile_rows=4)
    torch.cuda.synchronize()
    _close(got, conv3x3_reference(x, w, variant, 4))


@pytest.mark.parametrize("mode", ["halo", "rolling"])
@pytest.mark.parametrize("C", [16, 64])
def test_conv3x3_more_jobs_than_ctas(mode, C):
    """Each CTA walks several jobs: the ring carries on from one job's rows
    to the next's."""
    B, S, tile = 48, 70, 1 if mode == "halo" else 3
    ctas, _ = _ctas_on_card(C, 0)
    assert B * -(-S // tile) * -(-S // COL_TILE) > ctas
    x, w = conv_inputs(B, S, C, torch.device("cuda"), seed=4)
    got = conv3x3(x, w, mode=mode, tile_rows=tile)
    torch.cuda.synchronize()
    _close(got, conv3x3_reference(x, w))


@pytest.mark.parametrize("shape", probe_conv.SHAPES, ids=lambda s: s[0])
def test_conv3x3_plan_at_the_probe_shapes(shape):
    """The Python plan is the kernel's, its ring holds at least 4 rows and
    at least one CTA fits an SM."""
    _, B, S, C, _ = shape
    p = plan(S, C)
    assert kernel_plan(C) == (p.col_tile, p.ring_rows, p.smem_bytes,
                              p.warps, p.wgmma)
    assert p.ring_rows >= 4
    ctas, per_sm = _ctas_on_card(C, 0)
    assert per_sm >= 1 and ctas == per_sm * \
        torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("B,S,C", [(1, 320, 64), (1, 300, 64), (2, 400, 16),
                                   (1, 160, 32), (1, 400, 64)])
def test_conv3x3_full_width_rows(B, S, C):
    """The widest rows the probes use and wider (several column tiles, a
    ragged last one)."""
    x, w = conv_inputs(B, S, C, torch.device("cuda"), seed=2)
    for mode in ("halo", "rolling"):
        got = conv3x3(x, w, mode=mode)
        torch.cuda.synchronize()
        _close(got, conv3x3_reference(x, w))


def test_conv3x3_rolling_strips_fit_on_the_card_at_once():
    """The rolling mode's strips give every CTA on the card a job."""
    ctas, _ = _ctas_on_card(64, 0)
    assert ctas >= torch.cuda.get_device_properties(0).multi_processor_count
    strips = -(-320 // rolling_tile_rows(32, 320, 64, torch.device("cuda")))
    assert strips == strips_for(32, 320, plan(320, 64).col_tiles, ctas)
    assert 2 <= strips and 32 * plan(320, 64).col_tiles * strips >= ctas


def test_conv3x3_refuses_what_it_cannot_take():
    x, w = conv_inputs(1, 8, 64, torch.device("cuda"))
    with pytest.raises(TypeError):
        conv3x3(x.float(), w.float())
    with pytest.raises(ValueError):
        conv3x3(x[..., :48].contiguous(), w[:, :, :48, :48].contiguous())
    with pytest.raises(ValueError):
        conv3x3(x, w, variant="nohalo")
    with pytest.raises(ValueError):
        conv3x3(x, w, mode="sideways")
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    with pytest.raises(ValueError):        # not 16-byte aligned
        conv3x3(off.view(x.shape), w)
