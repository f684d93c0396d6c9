"""tpucv_torch's task-aligned assigner against tpucv's exact path (the one
tpucv takes off the TPU), on the same numpy-seeded inputs in f32 on the
CPU.

``fg_mask``, ``target_gt_idx`` and the labels must be bit-equal; boxes
and scores within 1e-6 absolute. The cases cover ties: zero scores make
every metric 0, so each GT's top-k is decided by the lowest anchor index
alone, which ``lax.top_k`` and the port's stable sort agree on and
``torch.topk`` does not promise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.losses import tal as jt
from tpucv.ops.anchors import make_anchors as j_anchors
from tpucv_torch.losses import tal as tt

torch.set_num_threads(1)
TOL = 1e-6
S, NC = 128, 80


def _anchors():
    shapes = [(S // s, S // s) for s in (8, 16, 32)]
    pts, st = j_anchors(shapes, (8, 16, 32))
    return np.asarray(pts * st)                          # (A, 2) pixels


def _boxes(rng, shape, lo=4.0, hi=S * 0.5):
    xy = rng.uniform(0, S - hi, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    anc = _anchors()
    A, B, M = anc.shape[0], 2, 6
    scores = 1 / (1 + np.exp(-rng.normal(-1, 2, (B, A, NC))))
    # predictions near each anchor, so many IoUs are positive
    half = rng.uniform(4, 40, (B, A, 2))
    pd = np.concatenate([anc - half, anc + half], -1)
    gt = _boxes(rng, (B, M))
    labels = rng.integers(0, NC, (B, M))
    mask = np.ones((B, M), bool)
    if name == "padded":
        mask[0, 4:] = False
        mask[1, 2:] = False
        gt[~mask] = rng.uniform(-50, 200, (int((~mask).sum()), 4))
        labels[~mask] = -1
    elif name == "empty_image":
        mask[1] = False
    elif name == "ties_zero_scores":
        scores[:] = 0.0                   # every metric is 0: pure ties
        gt[:, 0] = [0, 0, 30, 30]         # covers the lowest-index anchors
        gt[:, 1] = [2, 2, 70, 20]
    elif name == "ties_top_left":
        # small GTs at the top-left whose CIoU with the large predictions
        # clips to 0: their top-k are zero-metric ties at anchors 0, 1, ...
        pd = np.repeat(np.concatenate([anc - 60, anc + 60], -1)[None], B, 0)
        gt[:, 0] = [0, 0, 12, 12]
        gt[:, 1] = [0, 0, 20, 9]
    elif name == "multi_claim":
        gt[:, 1] = gt[:, 0] + np.array([2, 2, -2, -2], np.float32)
        gt[:, 2] = gt[:, 0] + np.array([-3, 1, 3, 5], np.float32)
    return (scores.astype(np.float32), pd.astype(np.float32),
            anc.astype(np.float32), labels.astype(np.int32), gt,
            mask)


CASES = ["random", "padded", "empty_image", "ties_zero_scores",
         "ties_top_left", "multi_claim"]


@pytest.mark.parametrize("name", CASES)
def test_task_aligned_assigner(name):
    args = _case(name)
    ref = jt.task_aligned_assigner(*map(jnp.asarray, args), num_classes=NC)
    got = tt.task_aligned_assigner(*map(torch.from_numpy, args),
                                   num_classes=NC)
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(),
                                  np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(ref.target_labels))
    np.testing.assert_allclose(got.target_bboxes.numpy(),
                               np.asarray(ref.target_bboxes), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got.target_scores.numpy(),
                               np.asarray(ref.target_scores), atol=TOL,
                               rtol=0)
    fg = got.fg_mask.numpy()
    if name == "empty_image":
        assert not fg[1].any() and fg[0].any()
    elif name.startswith("ties"):
        # the tie-selected anchors are the lowest-index valid ones: (4, 4)
        # and (12, 4) lie strictly inside both images' GT rows 0 or 1
        assert fg[:, :2].all(), fg[:, :8]
    else:
        assert fg.any()


@pytest.mark.parametrize("A,k", [(8400, 10), (336, 10), (7, 10)])
def test_topk_mask_breaks_ties_by_lowest_index(A, k):
    """A row of zeros with two positives: lax.top_k's indices, the port's
    marks (k capped at A, as the assigner caps it)."""
    row = np.zeros((1, 1, A), np.float32)
    row[0, 0, [A * 5 // 8, A * 5 // 6]] = [0.5, 0.25]
    kk = min(k, A)
    _, ref_idx = jax.lax.top_k(jnp.asarray(row), kk)
    ref = np.zeros(A, bool)
    ref[np.asarray(ref_idx)[0, 0]] = True
    got = tt.topk_mask(torch.from_numpy(row), kk)[0, 0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_select_candidates_in_gts():
    rng = np.random.default_rng(11)
    anc = _anchors()
    gt = _boxes(rng, (3, 5))
    gt[0, 0] = [4, 4, 12, 12]             # anchor centres on the edges
    ref = jt.select_candidates_in_gts(jnp.asarray(anc), jnp.asarray(gt))
    got = tt.select_candidates_in_gts(torch.from_numpy(anc.copy()),
                                      torch.from_numpy(gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().any()


@pytest.mark.parametrize("case", ["non_claimant", "random"])
def test_select_highest_overlaps(case):
    """A doubly claimed anchor goes to the row of highest RAW overlap,
    claimant or not (tpucv's faithful rule)."""
    rng = np.random.default_rng(12)
    B, M, A = 2, 4, 40
    overlaps = rng.uniform(0, 1, (B, M, A)).astype(np.float32)
    mask = (rng.uniform(size=(B, M, A)) < 0.4).astype(np.float32)
    if case == "non_claimant":
        mask[0, :, 5] = [1, 1, 0, 0]      # claimed by rows 0 and 1 ...
        overlaps[0, :, 5] = [0.3, 0.4, 0.9, 0.1]   # ... row 2 overlaps most
        mask[1, :, 7] = [0, 1, 0, 1]
        overlaps[1, :, 7] = [0.5, 0.5, 0.2, 0.1]   # a tie: the first row
    ref = jt.select_highest_overlaps(jnp.asarray(mask), jnp.asarray(overlaps),
                                     M)
    got = tt.select_highest_overlaps(torch.from_numpy(mask),
                                     torch.from_numpy(overlaps), M)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if case == "non_claimant":
        assert got[0][0, 5] == 2 and got[0][1, 7] == 0
