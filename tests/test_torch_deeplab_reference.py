"""DeepLabV3+-ResNet101 of tpucv_torch against the benchmark's plain
reference (``benchmark/reference/deeplabv3plus.py``, float32 PyTorch that
imports nothing of the port), on the CPU at 65², B=2, from one set of
seeded weights (``benchmark/weights.py``: LeCun-normal convs, identity
BatchNorm) loaded into both, on labels with void pixels
(``benchmark/traffic_seg.py``).

Held, each tolerance with its reason:

- eval-mode logits, float32: the two run the same operations in the same
  order on the CPU, so within ``EVAL_TOL`` (1e-5) of the largest logit,
  room for a reordered sum;
- the train-mode forward with the same dropout seed, one step's gradients
  and BatchNorm statistics: in float64 the two agree within ``F64_TOL``
  (1e-5 of the largest value, a leaf's norm for gradients): the port
  rounds its logits to float32 before the last resize
  (``models/deeplabv3plus.py``), 6e-8 relative, which the backward
  carries (measured: 3e-6 of the logits, 1.4e-6 of a gradient leaf). In
  float32 train-mode BatchNorm over a few values a channel (50 a channel
  in layer 3 at 65², 2 in the image-pool branch at B=2) amplifies
  rounding: each engine's float32 run parts from its own float64 run by
  up to ~5e-3 of the logits and ~10% of a gradient leaf, so the float32
  results are held within ``F32_ROOM`` (2x) the larger of the two
  engines' own float32 gaps from float64;
- two Adam updates change each leaf by the same amount: the size of each
  leaf's change (its norm), within ``ADAM_F64_TOL`` (5e-3) in float64:
  Adam moves an element by about lr whatever its gradient's size, so an
  element whose gradient lies within the float32 loss's rounding of 0
  (both engines take the loss in float32) may move either way, and one
  whose gradient is near Adam's eps by another amount (measured: 1.1e-3);
  in float32 within ``F32_ROOM`` the engines' own gaps (measured: up to
  ~7% in a BatchNorm leaf, against 6% between the two);
- the focal loss on the same logits within 1e-6 relative, with void
  (255) and out-of-range labels left out of it, and 0 on a batch that is
  all void.

A bfloat16 forward and a nearest resize in place of the bilinear one
fail them (the last tests: each must part further than the tolerance it
would meet).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import traffic_seg, weights
from benchmark.reference import deeplabv3plus as ref
from tpucv_torch.builder import export_from_registry
from tpucv_torch.models import deeplabv3plus as port_mod
from tpucv_torch.nn.blocks import seed_dropout
from tpucv_torch.train.state import TrainState, make_train_step

torch.set_num_threads(1)

NETWORK = {"nc": 21, "backbone": "resnet101", "output_stride": 16,
           "aspp_rates": [6, 12, 18], "aspp_dropout": 0.1}
LABELS = {"objects": 2.4, "area": [0.01, 0.6], "aspect": [0.3333333, 3.0],
          "band_px": [5, 10], "void": 255}
FOCAL = {"alpha": 0.25, "gamma": 2.0, "ignore_index": 255}
B, S, SEED = 2, 65, 2147483711
EVAL_TOL = 1e-5
F64_TOL = 1e-5
ADAM_F64_TOL = 5e-3
F32_ROOM = 2.0
LR, WARMUP = 7e-4, 1000


@pytest.fixture(scope="module")
def setup():
    with torch.device("meta"):
        shapes = weights.shapes_of(ref.build(NETWORK))
    state = weights.make(shapes, SEED, [], "cpu")
    ring = traffic_seg.train_ring({"ring": 2, "labels": LABELS}, SEED, "cpu",
                                  B, S, NETWORK["nc"], torch.float32)
    cfg, algo_cls, _ = export_from_registry("deeplabv3plus")
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device="cpu")
    return state, ring, algo


def _port(setup, dtype=torch.float32):
    state, _, algo = setup
    model = algo.build_model()
    model.load_state_dict(state)
    return model.to(dtype)


def _ref(setup, dtype=torch.float32):
    net = ref.build(NETWORK)
    net.load_state_dict(setup[0])
    return net.to(dtype)


def _gap(a, b):
    """|a - b| at its largest over b's largest magnitude."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _leaf_gaps(a, b):
    """Each leaf's ||a - b|| / ||b|| (leaves where b is 0: ||a||)."""
    out = {}
    for k in b:
        d = float((a[k].double() - b[k].double()).norm())
        n = float(b[k].double().norm())
        out[k] = d / n if n > 0 else d
    return out


def _train_once(setup, dtype, port: bool):
    """One train-mode forward (dropout seed 0), the focal loss and the
    backward: (logits, loss, gradients, state after)."""
    _, ring, algo = setup
    batch = ring[0]
    x = batch["images"].to(dtype)
    if port:
        model = _port(setup, dtype).train()
        seed_dropout(model, 0)
        logits = model(x)
        loss, _ = algo.build_loss()(logits, batch)
    else:
        model = _ref(setup, dtype).train()
        logits = model(x, dropout_seed=0)
        loss = ref.focal_loss(logits, batch["labels"], **FOCAL)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return logits.detach(), float(loss.detach()), grads, stats


@pytest.fixture(scope="module")
def steps(setup):
    return {(dt, port): _train_once(setup, getattr(torch, dt), port)
            for dt in ("float64", "float32") for port in (True, False)}


def test_eval_logits(setup):
    x = setup[1][0]["images"]
    with torch.no_grad():
        got = _port(setup).eval()(x)
        want = _ref(setup).eval()(x)
    assert got.shape == (B, NETWORK["nc"], S, S)
    assert _gap(got, want) <= EVAL_TOL


def _f32_room(steps, pick):
    """``F32_ROOM`` x the larger of the two engines' own float32 gaps from
    their float64 runs, by ``pick(run) -> tensor``."""
    own = max(_gap(pick(steps["float32", p]), pick(steps["float64", p]))
              for p in (True, False))
    return F32_ROOM * own


def test_train_forward_same_dropout(steps):
    logits = lambda run: run[0]                              # noqa: E731
    assert _gap(logits(steps["float64", True]),
                logits(steps["float64", False])) <= F64_TOL
    assert _gap(logits(steps["float32", True]),
                logits(steps["float32", False])) <= _f32_room(steps, logits)


def test_train_step_gradients_and_statistics(steps):
    for part in (2, 3):                       # gradients, then statistics
        p64, r64 = steps["float64", True][part], steps["float64", False][part]
        assert sorted(p64) == sorted(r64)
        gaps = (_leaf_gaps(p64, r64) if part == 2 else
                {k: _gap(p64[k], r64[k]) for k in r64})
        assert max(gaps.values()) <= F64_TOL, max(gaps, key=gaps.get)
        p32, r32 = steps["float32", True][part], steps["float32", False][part]
        own = max(max((_leaf_gaps if part == 2 else _stat_gaps)(
            steps["float32", p][part], steps["float64", p][part]).values())
            for p in (True, False))
        got = (_leaf_gaps if part == 2 else _stat_gaps)(p32, r32)
        assert max(got.values()) <= F32_ROOM * own


def _stat_gaps(a, b):
    return {k: _gap(a[k], b[k]) for k in b}


def test_focal_loss_with_void(setup, steps):
    _, ring, algo = setup
    labels = ring[0]["labels"].clone()
    assert (labels == 255).any() and (labels == 0).any()
    labels[0, 0, :5] = 21                     # out of range: left out too
    logits = steps["float32", False][0]
    got, _ = algo.build_loss()(logits, {"labels": labels})
    want = ref.focal_loss(logits, labels, **FOCAL)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    # void pixels counted as background would move it
    counted = ref.focal_loss(logits, torch.where(labels == 255, 0, labels),
                             **FOCAL)
    assert abs(float(counted) - float(want)) > 1e-3 * float(want)
    void = torch.full_like(labels, 255)
    assert float(algo.build_loss()(logits, {"labels": void})[0]) == 0.0
    assert float(ref.focal_loss(logits, void, **FOCAL)) == 0.0


def _two_updates(setup, dtype, port: bool):
    """The weights' change after two steps of each engine's own training
    loop (the port's ``make_train_step`` and Adam; the reference's
    ``run``) on ring batches 0 and 1."""
    state, ring, algo = setup
    batches = [{k: (v.to(dtype) if k == "images" else v)
                for k, v in b.items()} for b in ring]
    if port:
        model = _port(setup, dtype).train()
        cfg = algo.cfg.optimizer
        ts = TrainState.from_config(model, cfg, iters_per_epoch=91)
        step = make_train_step(algo.build_loss(), device="cpu",
                               mixed_precision=False)
        for b in batches:
            step(ts, b)
        after = model.state_dict()
    else:
        start = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in state.items()}
        out = ref.run(_ref(setup, dtype), start, batches, FOCAL, LR, WARMUP)
        after = out["states"][len(batches)]
    return {k: after[k].double() - state[k].double() for k in after
            if after[k].is_floating_point()}


def _norm_gaps(a, b):
    """Each leaf's | ||a|| - ||b|| | / ||b||: the size of a change, which a
    sign that rounding flips leaves as it is."""
    out = {}
    for k in b:
        na, nb = float(a[k].norm()), float(b[k].norm())
        out[k] = abs(na - nb) / nb if nb > 0 else na
    return out


def test_two_adam_updates(setup):
    runs = {(dt, p): _two_updates(setup, getattr(torch, dt), p)
            for dt in ("float64", "float32") for p in (True, False)}
    gaps64 = _norm_gaps(runs["float64", True], runs["float64", False])
    assert max(gaps64.values()) <= ADAM_F64_TOL, max(gaps64, key=gaps64.get)
    own = max(max(_norm_gaps(runs["float32", p], runs["float64", p]).values())
              for p in (True, False))
    gaps32 = _norm_gaps(runs["float32", True], runs["float32", False])
    assert max(gaps32.values()) <= F32_ROOM * own
    # each element moved by about lr at each update: lr(0) + lr(1) at most
    lr0 = LR * 1.0 / WARMUP
    moved = runs["float64", False]["classifier.classifier.0.weight"]
    assert math.isclose(float(moved.abs().max()), lr0 + 2 * lr0, rel_tol=0.1)


def test_bfloat16_forward_fails(setup, steps):
    """The port's train forward under bfloat16 autocast parts from the
    reference further than the float32 tolerance allows."""
    _, ring, _ = setup
    model = _port(setup).train()
    seed_dropout(model, 0)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        logits = model(ring[0]["images"])
    room = _f32_room(steps, lambda run: run[0])
    assert _gap(logits, steps["float32", False][0]) > room


def test_nearest_resize_fails(setup, monkeypatch):
    monkeypatch.setattr(port_mod, "upsample", lambda x, size: F.interpolate(
        x, size=tuple(size), mode="nearest"))
    x = setup[1][0]["images"]
    with torch.no_grad():
        got = _port(setup).eval()(x)
        want = _ref(setup).eval()(x)
    assert _gap(got, want) > EVAL_TOL
