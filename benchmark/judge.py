"""The comparisons that decide ``correct``: the program's outputs against
the reference's, as numbers each held to a limit from the workload file.

Detection (per sampled image, the program's detections against the
reference's detections and its dense per-anchor predictions, all in
original pixels). Every answer gets a gap in [0, 1]:

- each detection the program returned: the least over the reference's
  anchors of max(box distance to the anchor's box, |score - the anchor's
  score for the detection's class|). The box distance is the largest
  difference of a coordinate over the larger of the anchor box's longer
  side and ``BOX_FLOOR`` px (the finest stride). A detection that no
  anchor of the reference predicts, by place, class and score, reads
  high;
- each detection the reference keeps that scores at least
  ``cover_margin`` above the lowest score that can still be kept (the
  last kept one's where the reference keeps ``max_det``, else the
  confidence threshold): 0 where a program detection covers it, else 1.
  A program detection covers it when it overlaps it with IoU above the
  NMS threshold less ``cover_slack``, or lies within box distance
  ``cover_slack`` of it, and has its class or a class the reference
  scores within ``cover_margin`` of it at its anchor (where two classes
  nearly tie, rounding picks either). Greedy NMS keeps a candidate or
  one of its class that overlaps it above the threshold, so where
  near-equal scores swap which of two neighbours survives, the other
  still covers it; the margin keeps out the detections that bfloat16's
  score noise moves across the ``max_det`` cut.

``answer_gap_p90`` is the 90th percentile of all the answers' gaps: the
tail of the arithmetic's error, which a lower precision moves at every
answer, where the widest gap swings with one unlucky answer. Answers left
out or altered read 1 or near it. The widest support gap and the share
of reference answers not covered are reported beside it, for the
readings in ``PERF.md``, with ``noise_ratio_p90``, this percentile over
the same percentile of the reference run at the configuration's
precision (``drivers.detect.judge_outputs``), and ``image_ratio_max``
(``image_ratios``): the same ratio taken image by image, the worst
image's. A fault in a few images (one slot's answers empty, shifted or
another image's) fills under a tenth of the answers and leaves the
pooled percentile where it was; it moves its own images' percentiles,
and where it drops or moves detections, the share not covered. Each
cell compares the numbers its workload's ``limits`` name: those that
separate its sound runs from its control.

Training (the program's steps against the reference's, from the same
weights on the same batches: set-up's first ``n_check`` steps, the
warm-up's, and the window's first steps, ``total`` in all):

- ``loss_gap``: the widest |loss - reference| / |reference| over
  set-up's first ``n_check`` steps; ``window_loss_gap`` the same over
  the steps after them (the warm-up's and the window's first).
- ``grad_gap``: the first step's gradient as the optimizer gets it (its
  parameters' ``.grad`` when its ``step`` is called), leaf by leaf:
  |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median leaf's
  ‖g_ref‖; the worst leaf. Leaves whose reference gradient is under a
  thousandth of the median leaf's (rounding alone moves them under Adam)
  are left out.
- ``change_gap``: the same measure of each leaf's change from the start
  to the end of step ``n_check``: the trained parameters (with the same
  leaves left out) and the BatchNorm running means and variances;
  ``window_change_gap`` the same to the end of step ``total``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference.detect import Detections, iou_matrix

GRAD_FLOOR = 1e-3
BOX_FLOOR = 8.0


def box_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M): max |a - b| over the four coordinates of (N, 4) and (M, 4)
    xyxy boxes, over max(b's longer side, ``BOX_FLOOR``)."""
    side = (b[:, 2:] - b[:, :2]).amax(-1).clamp(min=BOX_FLOOR)
    return (a[:, None, :] - b[None, :, :]).abs().amax(-1) / side[None, :]


def detection_numbers(program: Sequence[tuple], reference: Sequence[Detections],
                      conf: float, iou_thr: float, max_det: int,
                      cover_margin: float, cover_slack: float
                      ) -> Dict[str, float]:
    """``program``: per image (boxes (P, 4), scores (P,), classes (P,)).
    Besides the numbers, ``image_p90``: each image's 90th percentile of
    its own answers' gaps (NaN for an image with no answer)."""
    support, cover, per_image = [], [], []
    for (pb, ps, pc), ref in zip(program, reference):
        n_s, n_c = len(support), len(cover)
        dev = ref.dense_boxes.device
        pb = torch.as_tensor(np.asarray(pb, np.float32), device=dev)
        ps = torch.as_tensor(np.asarray(ps, np.float32), device=dev)
        pc = torch.as_tensor(np.asarray(pc, np.int64), device=dev)
        if len(pb):
            dist = box_distance(pb, ref.dense_boxes)              # (P, A)
            sc = ref.dense_scores[:, pc].T                        # (P, A)
            gap = torch.maximum(dist, (sc - ps[:, None]).abs())
            support.append(gap.min(1).values)
        cut = ref.scores[max_det - 1] if len(ref.scores) >= max_det else conf
        n = int((ref.scores >= cut + cover_margin).sum())
        if n == 0:
            pass
        elif len(pb) == 0:
            cover.append(torch.ones(n, device=dev))
        else:
            cover.append(_uncovered(ref, n, pb, pc, iou_thr, cover_margin,
                                    cover_slack))
        own = support[n_s:] + cover[n_c:]
        per_image.append(float(torch.quantile(torch.cat(own).float().cpu(),
                                              0.9)) if own else float("nan"))
    s = torch.cat(support) if support else torch.zeros(1)
    c = torch.cat(cover) if cover else torch.zeros(0)
    every = torch.cat([s.to(c.device) if len(c) else s, c]).float().cpu()
    return {"answer_gap_p90": float(torch.quantile(every, 0.9)),
            "support_gap": float(s.max()),
            "miss_share": float(c.mean()) if len(c) else 0.0,
            "image_p90": per_image}


def _uncovered(ref: Detections, n: int, pb, pc, iou_thr: float,
               cover_margin: float, cover_slack: float) -> torch.Tensor:
    """1 for each of the reference's first ``n`` detections that no
    program detection covers, else 0."""
    dev = ref.dense_boxes.device
    rb = torch.as_tensor(ref.boxes[:n], device=dev)
    rs = torch.as_tensor(ref.scores[:n], device=dev)
    ra = torch.as_tensor(ref.anchors[:n], device=dev)
    near = (iou_matrix(rb, pb) > iou_thr - cover_slack) \
        | (box_distance(pb, rb).T <= cover_slack)
    tie = (ref.dense_scores[ra][:, pc] - rs[:, None]).abs() <= cover_margin
    return (~(near & tie).any(1)).float()


def image_ratios(program_p90: Sequence[float], noise_p90: Sequence[float],
                 pooled_noise: float) -> List[float]:
    """Each image's 90th percentile of the program's answer gaps over the
    same of the reference at the configuration's precision; an image's
    noise is floored at a tenth of the sample's pooled noise, so that no
    image whose reference rounding happens to read near 0 makes sound
    arithmetic read large. An image the program answers nothing for
    where nothing is due reads 0."""
    floor = max(0.1 * pooled_noise, 1e-12)
    out = []
    for p, n in zip(program_p90, noise_p90):
        p = 0.0 if np.isnan(p) else p
        out.append(p / max(0.0 if np.isnan(n) else n, floor))
    return out


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              names: List[str]) -> torch.Tensor:
    """Each leaf's |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)."""
    if not names:
        return torch.zeros(1)
    rn = torch.stack([reference[n].float().norm() for n in names])
    pn = torch.stack([program[n].float().norm() for n in names])
    med = rn.median()
    return (pn - rn).abs() / torch.maximum(rn, med)


def moved_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least ``GRAD_FLOOR`` of the
    median leaf's."""
    names = sorted(ref_grads)
    norms = torch.stack([ref_grads[n].norm() for n in names])
    med = norms.median()
    return [n for n, g in zip(names, norms) if g >= GRAD_FLOOR * med]


def training_numbers(prog: dict, ref: dict, start: Dict[str, torch.Tensor],
                     n_check: int, detail: bool = False) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses" (every followed step), "grads"
    (step 1), "states" ({steps done: weights and statistics})}, the
    states after ``n_check`` and after the last followed step; ``start``:
    the weights both began from. ``detail`` adds each step's loss gap,
    the median leaf's gaps and the worst leaves."""
    total = len(ref["losses"])
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    if len(prog["losses"]) != total or not all(np.isfinite(prog["losses"])):
        losses += [float("inf")] * (total + 1 - len(losses))
    moved = moved_leaves(ref["grads"])
    grad = leaf_gaps(prog["grads"], ref["grads"], moved)
    stats = [k for k in start
             if k.endswith(("running_mean", "running_var"))]
    names = moved + stats

    def change(steps):
        dp = {n: prog["states"][steps][n].float() - start[n].float()
              for n in names}
        dr = {n: ref["states"][steps][n].float() - start[n].float()
              for n in names}
        return leaf_gaps(dp, dr, names)

    first, last = change(n_check), change(total)
    out = {"loss_gap": max(losses[:n_check]),
           "window_loss_gap": max(losses[n_check:]),
           "grad_gap": float(grad.max()),
           "change_gap": float(first.max()),
           "window_change_gap": float(last.max())}
    if detail:
        out.update(
            step_loss_gaps=losses, grad_median=float(grad.median()),
            change_median=float(first.median()),
            window_change_median=float(last.median()),
            grad_worst=[moved[i] for i in grad.argsort(descending=True)[:3]],
            change_worst=[names[i] for i in
                          first.argsort(descending=True)[:3]])
    return out
