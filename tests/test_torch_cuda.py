"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor tpucv, so it runs on a machine with an
NVIDIA card and PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q

Without CUDA every test skips. NMS keep masks must be identical, and the
build kernel's mask words bit-equal to their plain twin: the kernel
computes the IoU in f32 with the reference's association and no FMA
contraction, so no pair near the threshold may flip. ``add_one`` must be
bit-equal to ``x + 1``. The 3x3 conv may differ from its plain version by
one bf16 ulp at the largest value (2^-7 * max |plain|): both sum in f32,
in other orders, and round once to bf16.

The training step has no kernel of its own; its tests at the end hold the
card against the CPU: the TAL top-k's lowest-index tie order and the
assignment bit-equal, one f32 step within the CPU tests' bounds against
tpucv, and the bf16 step finite.
"""

import copy

import numpy as np
import pytest
import torch

from tpucv_torch.ops.cuda_nms import (MAX_BOXES, cuda_nms, nms_keep,
                                      nms_keep_reference, overlap_words,
                                      overlap_words_reference,
                                      timing_launchers, walk_words,
                                      walk_words_reference)
from tpucv_torch.ops.conv3x3 import (COL_TILE, VARIANTS, _ctas_on_card,
                                     conv3x3, conv3x3_reference, kernel_plan,
                                     plan, rolling_tile_rows, strips_for)
from tpucv_torch.ops.nms_cases import (block_cases, chain_keep,
                                       class_offset_case, kernel_cases)
from tpucv_torch.ops.stream import (THREADS, add_one, add_one_reference,
                                    launch, library_plan, stream_plan)
from tpucv_torch.probes import probe_conv
from tpucv_torch.probes.common import compare, conv_inputs, library_conv

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel needs an NVIDIA card")


def _tensors(seed, B, K, n_cls, n_invalid):
    boxes, scores = class_offset_case(seed, B, K, n_cls, n_invalid)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


CASES = kernel_cases()
BLOCK_CASES = block_cases()


def _sorted_cuda(name):
    (boxes, scores), thr = CASES[name]
    order = np.argsort(-scores, axis=-1, kind="stable")
    sb = torch.from_numpy(np.take_along_axis(boxes, order[..., None], 1))
    ss = torch.from_numpy(np.take_along_axis(scores, order, 1))
    return sb.cuda(), ss.cuda(), thr


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


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_words_bit_equal_to_their_twin(name):
    """The build kernel alone, every word (zero left of the diagonal), and
    the walk kernel alone over the twin's words."""
    sb, ss, thr = _sorted_cuda(name)
    before = (overlap_words.launches, walk_words.launches)
    words = overlap_words(sb, thr)
    torch.cuda.synchronize()
    ref = overlap_words_reference(sb, thr)
    assert torch.equal(words, ref)
    keep = walk_words(ref, ss)
    torch.cuda.synchronize()
    assert (overlap_words.launches, walk_words.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(keep, nms_keep_reference(sb, ss, thr))


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_kernels_in_the_given_order(name):
    """Unsorted: invalid boxes inside the blocks and across a chain."""
    (boxes, scores), thr = BLOCK_CASES[name]
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    keep = nms_keep(boxes.cuda(), scores.cuda(), thr)
    ref = walk_words_reference(overlap_words_reference(boxes, thr), scores)
    assert torch.equal(keep.cpu(), ref)
    assert torch.equal(ref, nms_keep_reference(boxes, scores, thr))


@pytest.mark.parametrize("B,K", [(8, 1024), (128, 512), (128, 1024), (3, 77),
                                 (1, 1), (70_000, 2)])
def test_nms_plan_is_the_kernels(B, K):
    from tpucv_torch.ops.cuda_nms import library_plan, nms_plan
    assert library_plan(B, K) == nms_plan(B, K)


def test_kernel_takes_more_images_than_a_grid_row():
    """The images are the grids' x: 70,000 images launch, and pair 0 of
    each suppresses box 1."""
    B = 70_000
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [1.0, 1.0, 10.0, 10.0]]) \
        .expand(B, 2, 4).contiguous().cuda()
    scores = torch.tensor([0.9, 0.8]).expand(B, 2).contiguous().cuda()
    keep = nms_keep(boxes, scores, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(keep, nms_keep_reference(boxes, scores, 0.5))
    assert keep[:, 0].all() and not keep[:, 1].any()


def test_timing_launchers_are_the_two_launches():
    sb, ss, thr = _sorted_cuda("offsets_B128_K1024_iou0.7")
    build, walk = timing_launchers(sb, ss, thr)
    build()
    assert torch.equal(walk(), nms_keep(sb, ss, thr))


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
    with pytest.raises(ValueError):
        overlap_words(boxes.cuda(), 0.5)
    words = torch.zeros(2, 64, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):        # 64 boxes want 2 words, not 3
        walk_words(torch.zeros(2, 64, 3, dtype=torch.int32, device="cuda"),
                   scores[:, :64].contiguous().cuda())
    with pytest.raises(ValueError):        # on two devices
        walk_words(words, scores[:, :64].contiguous())


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


def test_add_one_every_tail_length():
    """n = one chunk + t for every t in 1 .. chunk - 1: each split of the
    last CTA's tail into whole vectors and fewer than 8 elements."""
    chunk = 8 * THREADS
    x = _bf16_ties(2 * chunk, 9).cuda()
    ref = add_one_reference(x).view(torch.int16)
    before = add_one.launches
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for t in range(1, chunk):
        y = add_one(x[:chunk + t])
        bad += (y.view(torch.int16) != ref[:chunk + t]).sum()
    torch.cuda.synchronize()
    assert add_one.launches == before + chunk - 1
    assert int(bad) == 0


@pytest.mark.parametrize("n", [1, 7, 8, 8 * THREADS + 3,
                               1_638_400 * 128, 8 * (2 ** 32 - THREADS)])
def test_stream_plan_is_the_kernels(n):
    assert library_plan(n) == stream_plan(n)


def test_add_one_refuses_what_it_cannot_take():
    with pytest.raises(TypeError):
        add_one(torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        add_one(torch.ones(8, 8, device="cuda", dtype=torch.bfloat16).t())
    with pytest.raises(ValueError):        # the kernel alone: cuda only
        launch(torch.ones(8, dtype=torch.bfloat16))


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


# ---------------------------------------------------------------------------
# The training step on the card (no kernel of its own: torch ops and
# torch.optim.Adam), held against the same code on the CPU.

def _train_parts():
    from tpucv_torch import bench
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.losses import tal
    from tpucv_torch.losses.yolov8 import yolov8_loss
    from tpucv_torch.train import state
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    return bench, tal, yolov8_loss, state, algo_cls(cfg, "cpu").build_loss()


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("A", [7, 336, 8400])
def test_tal_topk_breaks_ties_by_lowest_index_on_the_card(A):
    """Rows of zeros with a few positives: the card marks the same anchors
    as the CPU, the positives and then the lowest indices."""
    _, tal, _, _, _ = _train_parts()
    g = torch.Generator().manual_seed(A)
    rows = torch.zeros((4, 32, A))
    hot = torch.randint(0, A, (4, 32, 3), generator=g)
    rows.scatter_(-1, hot, torch.rand((4, 32, 3), generator=g))
    k = min(10, A)
    cpu = tal.topk_mask(rows, k)
    card = tal.topk_mask(rows.cuda(), k).cpu()
    assert torch.equal(cpu, card)
    want = torch.zeros_like(cpu)
    for i in range(4):
        for j in range(32):
            r = rows[i, j].tolist()
            order = sorted(range(A), key=lambda a: (-r[a], a))[:k]
            want[i, j, order] = True
    assert torch.equal(cpu, want)


@pytest.mark.parametrize("case", ["random", "zero_scores", "top_strip"])
def test_tal_assignment_on_the_card_equals_the_cpu(case):
    """The assigner on the card: fg mask, GT rows and labels bit-equal to
    the CPU's, boxes and scores within 1e-6, at the full-width shape
    (A = 8400, M = 32)."""
    _, tal, _, _, _ = _train_parts()
    from tpucv_torch.ops.anchors import make_anchors
    g = torch.Generator().manual_seed(3)
    B, M, nc = 2, 32, 80
    pts, st = make_anchors([(80, 80), (40, 40), (20, 20)], (8, 16, 32),
                           device="cpu")
    anc = pts * st
    A = anc.shape[0]
    scores = torch.rand((B, A, nc), generator=g) * 0.3
    half = torch.rand((B, A, 2), generator=g) * 60 + 4
    pd = torch.cat([anc - half, anc + half], -1)
    xy = torch.rand((B, M, 2), generator=g) * 400
    gt = torch.cat([xy, xy + torch.rand((B, M, 2), generator=g) * 200 + 8],
                   -1)
    labels = torch.randint(0, nc, (B, M), generator=g, dtype=torch.int32)
    mask = torch.ones((B, M), dtype=torch.bool)
    mask[1, 20:] = False
    if case == "zero_scores":               # every metric 0: pure ties
        scores.zero_()
        gt[:, 1] = torch.tensor([0.0, 0.0, 100.0, 30.0])
    elif case == "top_strip":
        pd = torch.cat([anc - 60, anc + 60], -1).expand(B, A, 4).clone()
        gt[:, 0] = torch.tensor([0.0, 0.0, 640.0, 5.0])
    args = (scores, pd, anc, labels, gt, mask)
    cpu = tal.task_aligned_assigner(*args)
    card = tal.task_aligned_assigner(*(a.cuda() for a in args))
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), \
            name
    for name in ("target_bboxes", "target_scores"):
        torch.testing.assert_close(getattr(card, name).cpu(),
                                   getattr(cpu, name), atol=1e-6, rtol=0)
    if case != "random":                    # zero-metric ties: anchors 0-9
        assert bool(cpu.fg_mask[:, :10].all())
    assert bool(cpu.fg_mask.any())


def test_train_step_on_the_card_equals_the_cpu(no_tf32):
    """One f32 step (TF32 off) of YOLOv8n on the card against the CPU,
    same weights and batch: loss and metrics within 1e-4 relative,
    BatchNorm statistics within 1e-5, parameters within 2.1 * lr with all
    but 0.1% of elements within 1e-5 (the CPU tests' bounds against
    tpucv), the EMA within (1 - 0.99) times the parameters' bound."""
    bench, _, _, state_mod, loss_fn = _train_parts()
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    model = bench.yolo8n(cpu)
    batch = bench.synthetic_batch(2, 96, 4, cpu, 80.0, torch.float32, seed=2)
    out = []
    for d in (cpu, dev):
        m = copy.deepcopy(model).to(d, memory_format=torch.channels_last)
        st = state_mod.TrainState.create(m, 1e-3, use_ema=True)
        step = state_mod.make_train_step(loss_fn, device=d, ema_decay=0.99,
                                         mixed_precision=False)
        st, metrics = step(st, {k: v.to(d) for k, v in batch.items()})
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: v.detach().cpu() for k, v in
                     st.model.state_dict().items()},
                    {k: v.cpu() for k, v in st.ema.items()}))
    (cm, csd, cema), (gm, gsd, gema) = out
    for k in cm:
        assert gm[k] == pytest.approx(cm[k], rel=1e-4), k
    diffs = []
    for k in csd:
        d = (gsd[k].double() - csd[k].double()).abs()
        if "running" in k:
            assert float(d.max()) <= 1e-5, k
        elif "num_batches" not in k:
            diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= 2.1e-3
    assert float((diffs > 1e-5).double().mean()) <= 1e-3
    for k in cema:
        assert float((gema[k] - cema[k]).abs().max()) <= (1 - 0.99) * 2.1e-3, k


def test_train_step_bf16_on_the_card():
    """The bench's step (bf16 autocast, channels_last) at a small size:
    finite metrics left on the card; a parameter whose Adam moment is
    zero everywhere (no gradient reached it, e.g. a level's box branch
    without a foreground anchor) unchanged, most others moved; the frozen
    DFL projection untouched."""
    bench, _, _, _, _ = _train_parts()
    import dataclasses
    shapes = dataclasses.replace(bench.SMALL, size=128, train_batch=4,
                                 max_boxes=8, box_scale=100.0)
    st, step, batch = bench.train_setup(torch.device("cuda"), shapes)
    assert batch["images"].dtype == torch.bfloat16
    before = {k: p.detach().clone() for k, p in st.params.items()}
    for _ in range(2):
        st, m = step(st, batch)
    assert all(v.is_cuda for v in m.values())
    assert all(torch.isfinite(v) for v in m.values())
    moved = 0
    for k, p in st.params.items():
        changed = bool((p.detach() != before[k]).any())
        if not st.optimizer.state[p]["exp_avg"].any():
            assert not changed, k
        moved += changed
    assert moved >= 0.9 * len(before)
    assert torch.equal(st.model.state_dict()["model.22.dfl.conv.weight"]
                       .flatten().cpu(), torch.arange(16.0))
    assert st.step == 2
