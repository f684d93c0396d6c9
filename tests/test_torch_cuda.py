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

The SSD cases of ``ops/nms_cases.py`` (K = 1,024 at B = 1, 8, 32, class
offsets up to 19 x 7680 px) run with the other kernel cases, and SSD's
decode is held through ``nms_keep`` against its plain version.
CenterNet has no kernel: its forward, targets, loss and decode (DIoU NMS
by the scan, ``nms_keep`` not launched) are held against the CPU.

The training step has no kernel of its own; its tests at the end hold the
card against the CPU: the TAL top-k's lowest-index tie order and the
assignment bit-equal, one f32 step within the CPU tests' bounds against
tpucv, and the bf16 step finite.

The NMS as the ``tpucv::nms_keep`` operator: called directly and inside
``torch.compile`` it launches the kernel (counted) with the plain keep
mask; YOLOv8n's program exported and reloaded on the card gives the eager
detections bit for bit with one launch a call, and the int8 model's
served forward under bf16 autocast its raw maps; and two ranks over gloo on
the one card (``torch_dp_workers.py``) take the one-process step on the
global batch within the CPU tests' bounds (``test_torch_parallel.py``).
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


def test_augment_card_matches_cpu():
    """augment_batch on the card against the CPU (f32): the gather's
    source indices equal, pixels within 1e-5 (chip_smoke's tolerance),
    boxes within 1e-5; the bf16 output is the f32 one rounded."""
    from tpucv_torch.ops.augment import (AffineParams, augment_batch,
                                         source_indices)

    rng = np.random.default_rng(3)
    B, S = 4, 128
    img = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), np.uint8))
    boxes = torch.from_numpy((rng.random((B, 6, 4)) * S).astype(np.float32))
    scale = rng.uniform(0.5, 1.5, B).astype(np.float32)
    params = AffineParams(
        torch.from_numpy(scale),
        torch.from_numpy((rng.random((B, 2)) * np.maximum(
            S * (1 - scale), 0)[:, None]).astype(np.float32)),
        torch.from_numpy(rng.random(B) < 0.5),
        torch.from_numpy((1 + (rng.random((B, 3)) * 2 - 1)
                          * [0.1, 0.7, 0.4]).astype(np.float32)))
    card = AffineParams(*(t.cuda() for t in params))
    for a, b in zip(source_indices(params, S), source_indices(card, S)):
        assert torch.equal(a, b.cpu())
    out_c, ob_c = augment_batch(img, boxes, params, dtype=torch.float32)
    out_g, ob_g = augment_batch(img.cuda(), boxes.cuda(), card,
                                dtype=torch.float32)
    assert float((out_g.cpu() - out_c).abs().max()) <= 1e-5
    assert float((ob_g.cpu() - ob_c).abs().max()) <= 1e-5
    bf16, _ = augment_batch(img.cuda(), boxes.cuda(), card)
    assert torch.equal(bf16, out_g.to(torch.bfloat16))


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A bundle saved from a train state on the card loads into another
    one on the card bit for bit (weights, Adam's state on the card, step),
    and the next step from each is the same."""
    from tpucv_torch.ckpt.checkpoint import CheckPoint

    bench, _, _, state_mod, _ = _train_parts()
    import dataclasses
    shapes = dataclasses.replace(bench.SMALL, size=128, train_batch=4,
                                 max_boxes=8, box_scale=100.0)
    st, step, batch = bench.train_setup(torch.device("cuda"), shapes)
    st, _ = step(st, batch)
    path = CheckPoint.save(st, str(tmp_path / "s.ckpt"))
    other, _, _ = bench.train_setup(torch.device("cuda"), shapes)
    CheckPoint.load(path, other)
    assert other.step == st.step == 1
    for k, v in st.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    for p, q in zip(st.params.values(), other.params.values()):
        for k, v in st.optimizer.state[p].items():
            w = other.optimizer.state[q][k]
            assert w.device == v.device and torch.equal(w, v), k
    _, m1 = step(st, batch)
    _, m2 = step(other, batch)
    assert float(m1["loss"]) == float(m2["loss"])


# ------------------------------------------------ predict and evaluate
def _coco_fuzz(seed, n_img=6, n_cat=4, n_gt=30, n_dt=60):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for k in range(n_gt + n_dt):
        w, h = rng.uniform(2, 120, 2)
        x, y = rng.uniform(0, 200, 2)
        rec = {"image_id": int(rng.integers(1, n_img + 1)),
               "category_id": int(rng.integers(1, n_cat + 1)),
               "bbox": [x, y, w, h]}
        if k < n_gt:
            gts.append({**rec, "area": float(w * h),
                        "iscrowd": int(rng.random() < 0.15)})
        else:
            dts.append({**rec, "score": round(float(rng.random()), 2)})
    return gts, dts, list(range(1, n_cat + 1))


@pytest.mark.parametrize("seed", range(3))
def test_native_cocoeval_on_the_card_host(seed):
    """The COCOeval C++ core builds on the card's host and equals the
    numpy engine within 1e-12."""
    from tpucv_torch.metrics.coco_map import COCOMeanAP
    from tpucv_torch.native import load

    assert load("cocoeval") is not None
    gts, dts, cats = _coco_fuzz(seed)
    a = COCOMeanAP(gts, dts, cats).accumulate(use_native=False)
    b = COCOMeanAP(gts, dts, cats).accumulate(use_native=True)
    np.testing.assert_allclose(a.precision, b.precision, atol=1e-12, rtol=0)
    np.testing.assert_allclose(a.recall, b.recall, atol=1e-12, rtol=0)


def test_imagepipe_on_the_card_host(tmp_path):
    """``read_image`` and the eval canvas fill equal cv2 on the card's
    host: through the native decode where libjpeg is there, through cv2
    where it is not."""
    import cv2

    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.native import imagepipe as ip
    from tpucv_torch.utils.image_process import read_image

    rng = np.random.default_rng(0)
    paths, ref = [], []
    for k, (h, w) in enumerate([(480, 640), (720, 960), (33, 47)]):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                               (5, 5), 2)
        paths.append(str(tmp_path / f"{k}.jpg"))
        assert cv2.imwrite(paths[-1], img)
        ref.append(cv2.cvtColor(cv2.imread(paths[-1]), cv2.COLOR_BGR2RGB))
    for p, r in zip(paths, ref):
        np.testing.assert_array_equal(read_image(p), r)
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    algo = algo_cls(cfg, device="cuda")
    canv, hw, oshapes, _ = algo._fill_canvases([(p,) for p in paths],
                                               range(3), 4, 640)
    for j, r in enumerate(ref):
        assert oshapes[j] == r.shape[:2]
        if max(r.shape[:2]) <= 640:
            np.testing.assert_array_equal(canv[j, :r.shape[0], :r.shape[1]],
                                          r)
    if ip.available():
        out, nhw, _, ok = ip.decode_to_canvas(paths, 640)
        assert ok.all() and np.array_equal(out, canv[:3])
        assert np.array_equal(nhw, hw[:3])


def _eval_raw_maps(B=4, conf=0.01):
    """yolo8_det as shipped (640, bf16) with random weights and a sharpened
    class branch, on B letterboxed images: raw maps and the decode args."""
    from tpucv_torch.algorithms.yolov8 import yolo_decode_args
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.ops.preprocess import (host_letterbox_geom,
                                            letterbox_images)

    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    algo = algo_cls(cfg, device="cuda")
    model = algo.init_variables(seed=0)
    with torch.no_grad():
        for head in model.model[22].cv3:
            head[-1].bias.zero_()
            head[-1].weight.mul_(3000.0)
    rng = np.random.default_rng(1)
    imgs = [(rng.integers(0, 256, (480, 640, 3), np.uint8),)
            for _ in range(B)]
    canv, hw, _, _ = algo._fill_canvases(imgs, range(B), B, 640)
    geom, hs = host_letterbox_geom(hw, 640)
    dev = torch.device("cuda")
    from tpucv_torch.ops.preprocess import normalize_images
    with torch.inference_mode():
        lb, _, _ = letterbox_images(
            torch.from_numpy(canv).to(dev), torch.from_numpy(hw).to(dev),
            640, geom=torch.from_numpy(geom).to(dev),
            scale=torch.from_numpy(hs).to(dev))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            raw = model(normalize_images(lb, algo.dtype))
    return raw, yolo_decode_args(cfg, algo.nc, conf)


def test_eval_detections_through_nms_keep_equal_the_plain_route(monkeypatch):
    """In-training mAP's decode (conf 0.01, so K = 1024) on the card: the
    detections through ``nms_keep`` equal those through its plain version
    on the same raw maps, and the kernel was launched."""
    from tpucv_torch.decode.yolov8 import decode_boxes
    from tpucv_torch.ops import cuda_nms as cn

    raw, kw = _eval_raw_maps()
    assert kw["pre_nms_topk"] == 1024
    before = cn.nms_keep.launches
    with torch.inference_mode():
        got = decode_boxes(raw, **kw)
    assert cn.nms_keep.launches == before + 1
    monkeypatch.setattr(cn, "nms_keep", cn.nms_keep_reference)
    with torch.inference_mode():
        ref = decode_boxes(raw, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[3].sum()) > 0


def test_scan_on_the_card_equals_the_cpu():
    """The evaluate CLI's decode (conf 0.001, K = 4096: the sequential
    scan, no kernel) on the card and on the CPU, from the same candidates:
    the same kept indices."""
    from tpucv_torch.decode.yolov8 import topk_candidates
    from tpucv_torch.ops.nms import dispatch_batched_nms

    raw, kw = _eval_raw_maps(B=2, conf=0.001)
    assert kw["pre_nms_topk"] == 4096
    with torch.inference_mode():
        boxes, scores, cls = topk_candidates(
            raw, kw["reg_max"], kw["strides"], kw["conf_threshold"], 4096)
        off = boxes + cls[..., None].float() * 7680.0
        card = dispatch_batched_nms(off, scores, kw["iou_threshold"], 300)
        cpu = dispatch_batched_nms(off.cpu(), scores.cpu(),
                                   kw["iou_threshold"], 300)
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1].cpu(), cpu[1])
    assert int(cpu[1].sum()) > 0


# ---------------------------------------------------------------------------
# YOLOv8-seg and YOLOv8-pose on the card: their forward and mask assembly
# against the CPU, and their decodes through nms_keep against its plain
# version.

@pytest.mark.parametrize("head,nc", [("segment", 80), ("pose", 1)])
def test_seg_pose_forward_on_the_card_equals_the_cpu(head, nc, no_tf32):
    """f32 (TF32 off), B=2 at 160: every output within 1e-3 of its
    largest value, the bound of chip_smoke's forward_f32 phase."""
    from tpucv_torch.models.yolov8 import Yolo8

    model = Yolo8("n", nc=nc, head=head).reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 160, 160, 3), dtype=np.float32))
    with torch.inference_mode():
        cpu = model(x)
        card = copy.deepcopy(model).cuda().to(
            memory_format=torch.channels_last)(x.cuda())
    flat = lambda out: [t for o in out for t in (  # noqa: E731
        o if isinstance(o, tuple) else (o,))]
    for g, c in zip(flat(card), flat(cpu)):
        assert g.shape == c.shape and bool(torch.isfinite(g).all())
        assert float((g.cpu() - c).abs().max() / c.abs().max()) < 1e-3


@pytest.mark.parametrize("how", ["crop", "upsample", "native_down"])
def test_process_mask_on_the_card_equals_the_cpu(how, no_tf32):
    from tpucv_torch.ops import masks

    rng = np.random.default_rng(4)
    protos = torch.from_numpy(rng.normal(0, 1, (160, 160, 32))
                              .astype(np.float32))
    coefs = torch.from_numpy(rng.normal(0, 0.3, (40, 32)).astype(np.float32))
    xy = rng.uniform(0, 400, (40, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(8, 240, (40, 2))], -1).astype(np.float32))

    def run(dev):
        args = [t.to(dev) for t in (protos, coefs, boxes)]
        if how == "native_down":
            return masks.process_mask_native(*args, (120, 100))
        return masks.process_mask(*args, (640, 640),
                                  upsample=how == "upsample")

    card, cpu = run("cuda").cpu(), run("cpu")
    assert card.shape == cpu.shape
    assert float((card - cpu).abs().max()) <= 1e-5


def _head_raw(head, S=640, B=2, seed=5):
    rng = np.random.default_rng(seed)
    nc, extra = (80, 32) if head == "segment" else (1, 51)
    det, other = [], []
    for s in (8, 16, 32):
        m = rng.normal(0, 2.0, (B, S // s, S // s, 64 + nc))
        m[..., 64:] -= 3.0
        det.append(torch.from_numpy(m.astype(np.float32)).cuda())
        other.append(torch.from_numpy(rng.normal(
            0, 1, (B, S // s, S // s, extra)).astype(np.float32)).cuda())
    if head == "segment":
        protos = torch.from_numpy(rng.normal(0, 1, (B, S // 4, S // 4, 32))
                                  .astype(np.float32)).cuda()
        return (det, other, protos), nc
    return (det, other), nc


@pytest.mark.parametrize("head", ["segment", "pose"])
def test_seg_pose_decode_through_nms_keep_equal_the_plain_route(head,
                                                                monkeypatch):
    """decode_seg / decode_pose at predict's K <= 1024 on the card: through
    ``nms_keep`` (one launch) and through its plain version, equal outputs
    and equal anchor indices."""
    from tpucv_torch.decode import yolov8 as dec
    from tpucv_torch.decode.yolov8_pose import decode_pose
    from tpucv_torch.decode.yolov8_seg import decode_seg
    from tpucv_torch.ops import cuda_nms as cn

    raw, nc = _head_raw(head)
    fn = decode_seg if head == "segment" else decode_pose
    kw = dict(nc=nc, pre_nms_topk=1024)

    def run():
        with torch.inference_mode():
            return fn(raw, **kw), dec.decode_boxes(
                raw[0], nc=nc, pre_nms_topk=1024, return_idx=True)[4]

    before = cn.nms_keep.launches
    got, got_idx = run()
    assert cn.nms_keep.launches == before + 2      # decode, then its indices
    monkeypatch.setattr(cn, "nms_keep", cn.nms_keep_reference)
    ref, ref_idx = run()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(got_idx, ref_idx)
    assert int(got[3].sum()) > 0


# SSD: its multilabel decode reaches nms_keep at K = 1,024 on every path
@pytest.mark.parametrize("B,conf", [(1, 0.7), (8, 0.7), (32, 0.01)])
def test_ssd_decode_through_nms_keep_equals_the_plain_route(B, conf,
                                                            monkeypatch):
    """decode_ssd at SSD300's shape (8,732 priors, nc 21, K = 1,024) on the
    card at predict's, serve's and evaluate's batches: through ``nms_keep``
    (one launch) and through its plain version, equal outputs; the
    candidates' class offsets reach 19 x 7680 px."""
    from tpucv_torch.configs.model_cfgs import ssd_tables
    from tpucv_torch.decode.ssd import decode_ssd
    from tpucv_torch.ops import cuda_nms as cn
    from tpucv_torch.ops.anchors import generate_ssd_anchors

    t = ssd_tables(300)
    priors = torch.from_numpy(generate_ssd_anchors(
        300, t["feature_shapes"], t["anchor_sizes"],
        t["aspect_ratios"])).cuda()
    rng = np.random.default_rng(B)
    A = priors.shape[0]
    loc = torch.from_numpy(rng.normal(0, 1, (B, A, 4)).astype(
        np.float32)).cuda()
    logits = rng.normal(0, 4, (B, A, 21)).astype(np.float32)
    logits[..., 0] -= 4.0                  # fewer background winners
    conf_maps = torch.from_numpy(logits).cuda()

    def run():
        with torch.inference_mode():
            return decode_ssd(loc, conf_maps, priors, 300, conf, 0.5, 100,
                              1024)

    before = cn.nms_keep.launches
    got = run()
    assert cn.nms_keep.launches == before + 1
    monkeypatch.setattr(cn, "nms_keep", cn.nms_keep_reference)
    ref = run()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[3].sum()) > 0 and int(got[2].max()) > 10


# int8 PTQ: the GEMM route (im2col + torch._int_mm) against the plain
# route (float64 F.conv2d) on the card, at YOLOv8's conv kinds and at the
# shapes that need padding: pose's 51-wide convs (N, and K = 459) and
# M <= 16 (the P5 map of one small image)
INT8_SHAPES = [(2, 16, 40, 40, 32, 1, 1), (2, 32, 40, 40, 48, 3, 1),
               (2, 16, 40, 40, 32, 3, 2), (2, 64, 20, 20, 51, 3, 1),
               (2, 51, 20, 20, 51, 3, 1), (1, 64, 2, 2, 64, 3, 1),
               (1, 51, 2, 2, 51, 1, 1)]


@pytest.mark.parametrize("B,cin,H,W,cout,k,s", INT8_SHAPES)
def test_int8_gemm_route_equals_the_plain_route(B, cin, H, W, cout, k, s):
    from tpucv_torch.ops import int8_conv

    g = torch.Generator(device="cuda").manual_seed(cin * k + cout)
    xq = torch.randint(-127, 128, (B, cin, H, W), generator=g,
                       device="cuda", dtype=torch.int8) \
        .contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                       device="cuda", dtype=torch.int8)
    geom = ((k, k), (s, s), (k // 2, k // 2), (1, 1), 1)
    got = int8_conv.int8_conv(xq, wq, *geom)
    want = int8_conv.conv_plain(xq, wq, *geom)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # the extreme: every tap at 127 x -127; an interior output sums all
    # k*k*cin of them
    top = int8_conv.int8_conv(torch.full_like(xq, 127),
                              torch.full_like(wq, -127), *geom)
    taps = k * k * cin if H >= 3 else cin * min(k, 2) ** 2
    assert int(top.min()) == -taps * 127 * 127


def test_int_mm_shape_rule_is_what_gemm_dims_pads_for():
    """torch._int_mm on CUDA refuses M <= 16 and K or N off a multiple of
    8; gemm_dims pads exactly those."""
    from tpucv_torch.ops import int8_conv

    def mm(M, K, N):
        a = torch.ones((M, K), dtype=torch.int8, device="cuda")
        w = torch.ones((N, K), dtype=torch.int8, device="cuda")
        return int8_conv.int8_mm(a, w)

    assert int(mm(17, 8, 8)[0, 0]) == 8
    for M, K, N in ((16, 8, 8), (32, 12, 8), (32, 8, 12)):
        with pytest.raises(RuntimeError):
            mm(M, K, N)
        assert int8_conv.gemm_dims(M, K, N) != (M, K, N)


# ---------------------------------------------------------------------------
# CenterNet on the card: no kernel of its own (its DIoU NMS is the scan,
# nms_keep's criterion is plain IoU); the forward, the targets, the loss and
# the decode against the CPU.

def _centernet_setup():
    from tpucv_torch.builder import export_from_registry

    cfg, algo_cls, _ = export_from_registry("centernet")
    model = algo_cls(cfg, device="cpu").init_variables(seed=0)
    return cfg, model


def _centernet_gt(B=2, M=30, S=384, seed=4):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(10, S - 10, (B, M, 2))
    wh = rng.uniform(4, S * 0.7, (B, M, 2))
    return {"gt_bboxes": torch.from_numpy(np.clip(np.concatenate(
                [cxy - wh / 2, cxy + wh / 2], -1), 0, S).astype(np.float32)),
            "gt_labels": torch.from_numpy(rng.integers(0, 20, (B, M))),
            "gt_mask": torch.from_numpy(rng.random((B, M)) < 0.7)}


def test_centernet_forward_on_the_card_equals_the_cpu(no_tf32):
    """f32 (TF32 off), B=2 at 384: the heatmap, offset and size channels
    each within 1e-4 of their largest |value|."""
    _, model = _centernet_setup()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 384, 384, 3), dtype=np.float32))
    with torch.inference_mode():
        cpu = model(x)
        card = copy.deepcopy(model).cuda().to(
            memory_format=torch.channels_last)(x.cuda()).cpu()
    assert card.shape == cpu.shape == (2, 96, 96, 24)
    for sl in (slice(0, 20), slice(20, 22), slice(22, 24)):
        c, g = cpu[..., sl], card[..., sl]
        assert float((g - c).abs().max() / c.abs().max()) < 1e-4


def test_centernet_targets_and_loss_on_the_card_equal_the_cpu():
    """From the same raw maps and 30 GT rows an image: ind, mask, wh and reg
    equal, the heatmap within 1e-6, the loss terms within 1e-5 relative."""
    from tpucv_torch.targets.centernet import build_centernet_targets

    from tpucv_torch.algorithms.centernet import CenterNetA

    cfg, _ = _centernet_setup()
    gt = _centernet_gt()
    raw = torch.from_numpy(np.random.default_rng(5).normal(
        0, 2, (2, 96, 96, 24)).astype(np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        g = {k: v.to(dev) for k, v in gt.items()}
        t = build_centernet_targets(g["gt_bboxes"], g["gt_labels"],
                                    g["gt_mask"], 20, (96, 96), 4)
        loss, parts = CenterNetA(cfg, device=dev).build_loss()(raw.to(dev), g)
        outs.append(([v.cpu() for v in t], float(loss),
                     {k: float(v) for k, v in parts.items()}))
    (tc, lc, pc), (tg, lg, pg) = outs
    for a, b in zip(tc[1:], tg[1:]):
        assert torch.equal(a, b)
    assert float((tc[0] - tg[0]).abs().max()) <= 1e-6
    assert lg == pytest.approx(lc, rel=1e-5)
    for k in pc:
        assert pg[k] == pytest.approx(pc[k], rel=1e-5), k


@pytest.mark.parametrize("diou", [True, False])
def test_centernet_decode_on_the_card_equals_the_cpu(diou):
    """decode_centernet (K 100, conf 0.1) on random maps at 96² (B=8): valid,
    classes and scores equal, boxes within 1e-3 px; nms_keep not
    launched (the DIoU NMS is the scan)."""
    from tpucv_torch.decode.centernet import decode_centernet
    from tpucv_torch.ops import cuda_nms as cn

    rng = np.random.default_rng(6)
    raw = rng.normal(0, 2, (8, 96, 96, 24)).astype(np.float32)
    raw[..., 22:] = np.abs(raw[..., 22:]) * 4
    raw = torch.from_numpy(raw)
    kw = dict(num_classes=20, K=100, conf_threshold=0.1, use_diou_nms=diou)
    before = cn.nms_keep.launches
    got = [t.cpu() for t in decode_centernet(raw.cuda(), **kw)]
    assert cn.nms_keep.launches == before
    ref = decode_centernet(raw, **kw)
    assert torch.equal(got[3], ref[3]) and int(got[3].sum()) > 0
    assert torch.equal(got[2][got[3]], ref[2][ref[3]])
    assert torch.equal(got[1], ref[1])
    assert float((got[0] - ref[0]).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# DeepLabV3+ on the card: no kernel of its own (cuDNN convs, F.interpolate,
# torch.bincount); the forward, the confusion matrix and the int8 routes
# against the CPU and the plain route.

def _deeplab_model(backbone="resnet50"):
    from tpucv_torch.models.deeplabv3plus import DeeplabV3Plus

    return DeeplabV3Plus(21, backbone).reset_parameters(
        torch.Generator().manual_seed(0)).eval()


def test_deeplab_forward_on_the_card_equals_the_cpu(no_tf32):
    """ResNet-101, f32 (TF32 off), B=2 at 129²: the logits within 1e-4 of
    their largest |value|."""
    model = _deeplab_model("resnet101")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 129, 129, 3)).astype(np.float32))
    with torch.inference_mode():
        cpu = model(x)
        card = copy.deepcopy(model).cuda().to(
            memory_format=torch.channels_last)(x.cuda()).cpu()
    assert card.shape == cpu.shape == (2, 21, 129, 129)
    assert float((card - cpu).abs().max() / cpu.abs().max()) < 1e-4


def test_deeplab_confusion_matrix_on_the_card_equals_the_cpu():
    """B=32 at 513² (8.4 M pixels, ignore and out-of-range labels): the
    integer histogram equal."""
    from tpucv_torch.metrics.seg_metrics import confusion_matrix

    g = torch.Generator().manual_seed(7)
    label = torch.randint(0, 21, (32, 513, 513), generator=g,
                          dtype=torch.int32)
    label[torch.rand(label.shape, generator=g) < 0.1] = 255
    label[torch.rand(label.shape, generator=g) < 0.01] = -1
    pred = torch.randint(-1, 23, label.shape, generator=g, dtype=torch.int32)
    cpu = confusion_matrix(pred, label, 21)
    card = confusion_matrix(pred.cuda(), label.cuda(), 21).cpu()
    assert card.dtype == torch.int64 and torch.equal(card, cpu)
    assert int(cpu.sum()) == int(((label >= 0) & (label < 21)).sum())


def test_deeplab_int8_routes_bit_equal():
    """ResNet-50 quantized on the card (bf16 autocast, 2 images of 129²):
    every quantized conv's int32 accumulators, the card's GEMM route
    against the plain route on the same int8 input, bit-equal, the dilated
    3x3s and the pool branch's 1x1 on a 1x1 map among them."""
    from tpucv_torch import quant
    from tpucv_torch.ops import int8_conv

    model = copy.deepcopy(_deeplab_model()).cuda().to(
        memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 129, 129, 3)).astype(np.float32)).cuda()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        q = quant.quantize_for_inference(model, [x])
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, name=name: seen.append((name, mod, inp[0])))
        for name, m in quant.hooked(q) if m.qweight is not None]
    try:
        with torch.inference_mode(), torch.autocast("cuda",
                                                    dtype=torch.bfloat16):
            q(x)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == quant.count_quantized(q) == 60
    dilated = 0
    for name, m, xi in seen:
        c = m.conv
        xq = quant.quantize_activation(xi, m.xscale)
        geom = (c.kernel_size, c.stride, c.padding, c.dilation, c.groups)
        got = int8_conv.int8_conv(xq, m.qweight, *geom)
        want = int8_conv.conv_plain(xq, m.qweight, *geom)
        assert torch.equal(got, want), name
        dilated += c.dilation[0] > 1
    assert dilated == 5


# ViT-S/16 and YOLOv8n-cls (no kernel: tpucv's ViT and YOLOv8-cls reach
# no pallas_call); the forward and one train step against the CPU.

def _cls_algo(name, dev, size=224):
    from tpucv_torch.builder import export_from_registry

    cfg, algo_cls, _ = export_from_registry(name)
    cfg.dataset.input_size = size
    cfg.train.mixed_precision = False
    return algo_cls(cfg, device=dev)


@pytest.mark.parametrize("name", ["vit_cls", "yolo8_cls"])
def test_cls_forward_on_the_card_equals_the_cpu(name, no_tf32):
    """The shipped width at 224², f32 (TF32 off), B=2: the logits within
    1e-4 of their largest |value|."""
    model = _cls_algo(name, "cpu").init_variables(seed=0)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 224, 224, 3), np.float32))
    with torch.inference_mode():
        cpu = model(x)
        card = copy.deepcopy(model).cuda().to(
            memory_format=torch.channels_last)(x.cuda()).cpu()
    assert card.shape == cpu.shape == (2, 10)
    assert float((card - cpu).abs().max() / cpu.abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["vit_cls", "yolo8_cls"])
def test_cls_train_step_on_the_card_equals_the_cpu(name, no_tf32):
    """One f32 step of the family's train step (label-smoothed CE, Adam
    1e-3) at 64², B=4, card against CPU: the loss within 1e-4 relative,
    the parameters after the step within 2.1e-3 (an Adam step moves each
    by at most about lr)."""
    from tpucv_torch.train.state import TrainState, make_train_step

    algo = _cls_algo(name, "cpu", size=64)
    model = algo.init_variables(seed=0)
    rng = np.random.default_rng(5)
    batch = {"images": torch.from_numpy(rng.random((4, 64, 64, 3),
                                                   np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 4).astype(
                 np.int32))}
    out = []
    for d in (torch.device("cpu"), torch.device("cuda")):
        m = copy.deepcopy(model).to(d, memory_format=torch.channels_last)
        st = TrainState.create(m, 1e-3)
        step = make_train_step(algo.build_loss(), device=d,
                               mixed_precision=False)
        st, metrics = step(st, {k: v.to(d) for k, v in batch.items()})
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: v.detach().cpu() for k, v in
                     st.model.state_dict().items()}))
    (cm, csd), (gm, gsd) = out
    assert gm["loss"] == pytest.approx(cm["loss"], rel=1e-4)
    for k in csd:
        if csd[k].is_floating_point():
            assert float((gsd[k] - csd[k]).abs().max()) <= 2.1e-3, k


# ------------------------------------------- the operator, export and DP
def test_nms_keep_operator_and_compile_launch_the_kernel():
    sb, ss, thr = _sorted_cuda(next(iter(CASES)))
    before = nms_keep.launches
    keep = torch.ops.tpucv.nms_keep(sb, ss, thr)
    compiled = torch.compile(lambda b, s: nms_keep(b, s, thr),
                             fullgraph=True)
    again = compiled(sb, ss)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 2
    ref = nms_keep_reference(sb.cpu(), ss.cpu(), thr)
    assert torch.equal(keep.cpu(), ref) and torch.equal(again.cpu(), ref)


def test_exported_program_on_the_card_is_eager():
    from tpucv_torch import deploy
    from tpucv_torch.bench import inference_program, yolo8n

    model = yolo8n(torch.device("cuda"))
    with torch.no_grad():
        for lv in range(3):
            model.model[22].cv3[lv][2].weight.mul_(3000.0)
            model.model[22].cv3[lv][2].bias.zero_()
    _, program = inference_program(model, 64, amp=True)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 48, 64, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        ref = program(x)
    loaded = deploy.load_serialized(deploy.export_serialized(program, x))
    before = nms_keep.launches
    with torch.inference_mode():
        got = loaded(x)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert int(ref[3].sum()) > 0
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_exported_int8_forward_under_autocast_on_the_card():
    """The int8 YOLOv8n's served forward under CUDA's bf16 autocast: its
    artifact runs once loaded, raw maps bit-equal to eager."""
    from tpucv_torch import deploy, quant
    from tpucv_torch.bench import inference_program, prep, yolo8n

    model = yolo8n(torch.device("cuda"))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, (2, 48, 64, 3), dtype=np.uint8)).cuda()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        q = quant.quantize_for_inference(model, [prep(x, 64, True)])
    fwd, _ = inference_program(q, 64, amp=True)
    with torch.no_grad():
        eager = fwd(x)
        got = deploy.load_serialized(deploy.export_serialized(fwd, x))(x)
    for a, b in zip(got, eager):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_two_rank_gloo_step_on_the_card(tmp_path):
    import torch_dp_workers as W

    runs = [("bn", "mse", 1, False, 1), ("wide", "mse", 1, True, 3)]
    ranks = W.Ranks(W.case_tiny, 2, tmp_path, runs=runs,
                    device="cuda:0").results()
    torch.backends.cudnn.allow_tf32 = False
    for net, loss, G, zero, steps in runs:
        make, cin = W.NETS[net]
        _, ref = W.run_steps(make(), {k: v.cuda() for k, v in W.local(
            W.tiny_batch(cin=cin), slice(None)).items()}, W.LOSSES[loss],
            steps, device="cuda")
        for rank in ranks:
            got = rank[(net, loss, G, zero)][-1]
            assert got["metrics"]["loss"] == pytest.approx(
                ref[-1]["metrics"]["loss"], rel=1e-6)
            for k, v in ref[-1]["sd"].items():
                torch.testing.assert_close(got["sd"][k], v, rtol=0,
                                           atol=1e-6)


# ------------------------------------------------------ the rest of the zoo
def _zoo(name):
    """A network with seed-0 weights (at a small size) or a block with
    torch's default init, and an input for it, NCHW."""
    from tpucv_torch.models import extras, openpose
    from tpucv_torch.nn import blocks as tb
    nets = {"vgg16": (extras.VGG(16), 48),
            "mobilenet_v2": (extras.MobileNetV2(10, 0.25), 64),
            "unet": (extras.UNet(5), 46),
            "cpm": (openpose.CPM(n_stages=2), 64)}
    blocks = {"c3tr": (tb.C3TR(8, 16, 1), 8),
              "dwconv_transpose": (tb.DWConvTranspose2d(8, 12, 3, 2, 1, 1),
                                   9),
              "conv_transpose_bn_act": (tb.ConvTransposeBnAct(8, 12, 3, 2),
                                        9)}
    if name in nets:
        model, size = nets[name]
        model.reset_parameters(torch.Generator().manual_seed(0))
        cin = 3
    else:
        model, size = blocks[name]
        cin = 8
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, cin, size, size)).astype(np.float32))
    return model, x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["vgg16", "mobilenet_v2", "unet", "cpm",
                                  "c3tr", "dwconv_transpose",
                                  "conv_transpose_bn_act"])
def test_zoo_on_the_card_equals_the_cpu(name, train, no_tf32):
    """f32 (TF32 off), B=2: every output within 1e-4 of its largest
    |value|, card against CPU, in eval and train mode, and after the
    train-mode forward each running variance within 1e-4 of its largest
    value, each running mean of its BatchNorm's largest std."""
    model, x = _zoo(name)
    model.train(train)
    card = copy.deepcopy(model).cuda().to(memory_format=torch.channels_last)
    with torch.no_grad():
        cpu_out, card_out = model(x), card(x.cuda())
    cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
    card_out = card_out if isinstance(card_out, tuple) else (card_out,)
    for c, g in zip(cpu_out, card_out):
        assert g.shape == c.shape
        assert float((g.cpu() - c).abs().max() / c.abs().max()) < 1e-4
    sd, csd = model.state_dict(), card.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            # a mean that is 0 but for rounding is scaled by its BN's std
            var = sd[k.replace("running_mean", "running_var")]
            scale = var.max() if k.endswith("var") else var.max().sqrt()
            assert float((csd[k].cpu() - v).abs().max() / scale) < 1e-4, k


@pytest.mark.parametrize("topk,launches", [(1024, 1), (2048, 0)])
def test_batched_non_max_suppression_on_the_card(topk, launches):
    """B=8, A=8,400, nc=80: one ``nms_keep`` launch for the whole batch at
    K=1,024 and the scan (none) at 2,048; every output equal to the CPU
    plain route's, boxes and scores bit for bit."""
    from tpucv_torch.ops.nms import batched_non_max_suppression
    from tpucv_torch.ops.nms_cases import yolo_pred_case
    pred = torch.from_numpy(yolo_pred_case(0, 8, 8400, 80))
    cpu = batched_non_max_suppression(pred, 0.25, 0.45, 300, topk)
    before = nms_keep.launches
    card = batched_non_max_suppression(pred.cuda(), 0.25, 0.45, 300, topk)
    assert nms_keep.launches - before == launches
    valid = cpu[3]
    assert torch.equal(card[3].cpu(), valid) and valid.any()
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1].cpu(), cpu[1])
    assert torch.equal(card[2].cpu()[valid], cpu[2][valid])
