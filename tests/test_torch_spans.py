"""The port's span recorder (``tpucv_torch/utils/profile.py``) and the
spans the program puts where its work happens, on the CPU.

- The recorder: each name's ring keeps its newest ``RING`` records,
  ``recent(n)`` returns the newest ``n`` (fewer where fewer exist), and
  ``profiled`` the newest run of records taken under a profiler (a traced
  window's, without the untraced calls after it).
- A span is a ``record_function`` only while a profiler runs; in a Chrome
  trace of ``utils.profile.trace`` the call's ``tpucv.detect.queue``
  encloses its forward's ``aten::convolution`` events, on one clock. Inside
  ``torch.export`` and ``torch.compile`` a span is a no-op: the exported
  serving program (YOLOv8n at 64², as ``tests/test_torch_export.py``
  builds it) and the compiled NMS hold no profiler node and the same nodes
  as with the span stubbed out, and give the same outputs bit for bit.
- ``_batched_detections`` (YOLOv8n and YOLOv7 at 64²): each
  ``tpucv.detect.*`` span and ``tpucv.nms`` closes once a call, and the
  five stages cover at least 90% of the calls' host time.
- The train step: each ``tpucv.train.*`` span closes once a step, and the
  forward, loss and backward once a micro-batch at ``grad_accum`` 2; the
  ``lap`` callback still gets the same stages in the same order.
- DeepLabV3+'s train step (65², B=2): each ``tpucv.seg.*`` span closes
  once a step, inside ``tpucv.train.forward`` and in the forward's order;
  ``torch.export`` of the eval model (ResNet-50 at 33²) gains no node from
  them and gives the same logits as with the span stubbed out.
- ``serving.MicroBatcher``'s ``/stats``: ``batch_ms``, the queue wait and
  the stage means.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tpucv_torch.builder import export_from_registry
from tpucv_torch.ops import nms as ops_nms
from tpucv_torch.ops.cuda_nms import MAX_BOXES
from tpucv_torch.train.state import STAGE_SPANS, TrainState, make_train_step
from tpucv_torch.utils import profile

torch.set_num_threads(1)

STAGES = ("fill", "upload", "queue", "download", "unbox")
DETECT = [f"tpucv.detect.{s}" for s in STAGES]
LAPS = ["forward", "loss", "backward", "optimizer_ema"]
SIZE = 64


@pytest.fixture(autouse=True)
def fresh_spans():
    profile.reset()
    yield
    profile.reset()


def counts():
    return {k: len(profile.recent(k, profile.RING)) for k in profile.names()}


# -------- the recorder ------------------------------------------------------
def test_ring_keeps_the_newest_records():
    rec = profile.Spans()
    for i in range(profile.RING + 100):
        rec.add("a", i)
    assert rec.recent("a", 10 ** 6) == list(range(100, profile.RING + 100))


@pytest.mark.parametrize("kept,n", [(5000, 1), (5000, 7), (5000, 4096),
                                    (3, 10), (0, 5), (5000, 0)])
def test_recent_returns_the_newest_n(kept, n):
    rec = profile.Spans()
    for i in range(kept):
        rec.add("a", 10 * i)
    ring = [10 * i for i in range(kept)][-profile.RING:]
    want = ring[max(len(ring) - n, 0):] if n else []
    assert rec.recent("a", n) == want
    assert len(rec.recent("a", n)) == min(n, kept, profile.RING)


def test_totals_count_every_span_and_reset_clears():
    """Each name's count and total, as the ring's length and sum, up to
    ``RING`` records."""
    rec = profile.Spans()
    vals = list(range(1, profile.RING + 51))
    for v in vals:
        rec.add("a", v)
    rec.add("b", 7)
    assert rec.names() == ["a", "b"]
    kept = rec.recent("a", 2 * profile.RING)
    assert len(kept) == profile.RING and sum(kept) == sum(vals[-profile.RING:])
    assert rec.recent("b", profile.RING) == [7]
    rec.reset()
    assert rec.names() == [] and rec.recent("a", 5) == []


# u: a record taken with no profiler, p: one under a profiler
@pytest.mark.parametrize("flags,want", [
    ("", ""), ("uuu", ""), ("ppp", "ppp"), ("uppu", "pp"),
    ("ppuppuu", "pp"), ("p" * profile.RING, ""),
    ("u" + "p" * (profile.RING - 1), "p" * (profile.RING - 1))])
def test_profiled_takes_the_newest_traced_run(flags, want):
    rec = profile.Spans()
    for i, f in enumerate(flags):
        rec.add("a", i, f == "p")
    got = rec.profiled("a")
    assert len(got) == len(want)
    if want:
        newest = flags.rindex("p")
        assert got == list(range(newest - len(want) + 1, newest + 1))


def test_span_times_its_block():
    with profile.span("tpucv.test"):
        time.sleep(0.02)
    (ns,) = profile.recent("tpucv.test", 5)
    assert 20e6 <= ns < 2e9
    assert counts() == {"tpucv.test": 1}


def test_record_function_only_while_profiling(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name, *a):
        made.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with profile.span("tpucv.test"):
        pass
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile.span("tpucv.test"):
            torch.ones(3).sum()
    assert made == ["tpucv.test"]
    assert "tpucv.test" in {e.name for e in prof.events()}
    assert counts() == {"tpucv.test": 2}
    assert profile.profiled("tpucv.test") == profile.recent("tpucv.test", 1)


def test_span_is_a_no_op_while_compiling(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profile.span("tpucv.test"):
        pass
    assert profile.names() == []


# -------- the detect call ---------------------------------------------------
def _algo(name):
    cfg, algo_cls, _ = export_from_registry(name)
    cfg.dataset.input_size = SIZE
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device="cpu")
    return algo, algo.init_variables(seed=0)


@pytest.fixture(scope="module", params=["yolo8_det", "yolo7"])
def detector(request):
    algo, model = _algo(request.param)
    rng = np.random.default_rng(0)
    index = [(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),)
             for h, w in ((48, 64), (64, 40), (30, 30), (64, 64), (20, 50))]
    list(algo._batched_detections(model, index, 2, 0.25))      # warm
    return algo, model, index


def test_detect_spans_close_once_a_call(detector):
    algo, model, index = detector
    profile.reset()
    t0 = time.perf_counter_ns()
    out = list(algo._batched_detections(model, index, 2, 0.25))
    host_ns = time.perf_counter_ns() - t0
    assert [o[0] for o in out] == list(range(len(index)))
    calls = 3
    assert counts() == {**{k: calls for k in DETECT}, "tpucv.nms": calls}
    staged = sum(sum(profile.recent(k, calls)) for k in DETECT)
    assert 0.9 * host_ns <= staged <= host_ns
    assert sum(profile.recent("tpucv.nms", calls)) <= \
        sum(profile.recent("tpucv.detect.queue", calls))


def test_detect_results_made_before_the_first_yield(detector):
    """The caller's time between images is in no span."""
    algo, model, index = detector
    profile.reset()
    gen = algo._batched_detections(model, index[:2], 2, 0.25)
    next(gen)
    assert counts()["tpucv.detect.unbox"] == 1
    time.sleep(0.05)
    list(gen)
    assert sum(profile.recent("tpucv.detect.unbox", 1)) < 50e6


def test_trace_puts_the_forward_inside_queue(tmp_path):
    algo, model = _algo("yolo8_det")
    index = [(np.full((48, 64, 3), 90, np.uint8),)]
    list(algo._batched_detections(model, index, 1, 0.25))
    with profile.trace(str(tmp_path)) as log_dir:
        list(algo._batched_detections(model, index, 1, 0.25))
    with open(f"{log_dir}/trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"].startswith("tpucv.")}
    assert set(spans) == set(DETECT) | {"tpucv.nms"}
    q0, q1 = spans["tpucv.detect.queue"]
    convs = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "aten::convolution"]
    assert len(convs) >= 60                          # YOLOv8n's convs
    assert all(q0 <= a and b <= q1 for a, b in convs)
    n0, n1 = spans["tpucv.nms"]
    assert q0 <= n0 and n1 <= q1
    order = sorted(DETECT, key=lambda k: spans[k][0])
    assert order == DETECT
    assert all(spans[a][1] <= spans[b][0] for a, b in zip(order, order[1:]))


def test_profiled_holds_the_traced_call_alone(detector):
    """A traced call between untraced ones: ``profiled`` gives that call's
    records, one a span, and none of the calls after it."""
    algo, model, index = detector
    profile.reset()
    list(algo._batched_detections(model, index[:2], 2, 0.25))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        list(algo._batched_detections(model, index[:2], 2, 0.25))
    list(algo._batched_detections(model, index[:2], 2, 0.25))
    for name in DETECT + ["tpucv.nms"]:
        assert profile.profiled(name) == profile.recent(name, 2)[:1]


# -------- no node in exported or compiled graphs ----------------------------
class _Stub:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _nodes(gm):
    return [str(n.target) for n in gm.graph.nodes]


def test_exported_serving_program_gains_no_node(monkeypatch):
    from tpucv_torch import deploy
    from tpucv_torch.bench import yolo8n
    from tpucv_torch.decode.yolov8 import decode_boxes
    from tpucv_torch.ops.preprocess import letterbox_static, normalize_images

    model = yolo8n(torch.device("cpu"))

    def program(raw_u8):
        lb, _, _ = letterbox_static(raw_u8, SIZE)
        return decode_boxes(model(normalize_images(lb, torch.float32)),
                            conf_threshold=0.0, max_det=20, pre_nms_topk=64)

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 48, SIZE, 3), dtype=np.uint8))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spanned = deploy._export(program, x)
    monkeypatch.setattr(ops_nms, "span", _Stub)
    stubbed = deploy._export(program, x)
    nodes = _nodes(spanned.graph_module)
    assert nodes == _nodes(stubbed.graph_module)
    assert "tpucv.nms_keep.default" in nodes
    assert not any("profiler" in n for n in nodes)
    with torch.no_grad():
        a, b = spanned.module()(x), stubbed.module()(x)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert profile.names() == []


def test_compiled_nms_gains_no_node(monkeypatch):
    graphs = []

    def capture(gm, example_inputs):
        graphs.append(_nodes(gm))
        return gm.forward

    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 50, (2, 40, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 30, (2, 40, 2)).astype(np.float32)], -1))
    scores = torch.from_numpy(
        -np.sort(-rng.uniform(0, 1, (2, 40)), -1).astype(np.float32))

    def nms(b, s):
        return ops_nms.dispatch_batched_nms(b, s, 0.5, 10)

    outs = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs.append(torch.compile(nms, fullgraph=True,
                                  backend=capture)(boxes, scores))
    assert profile.names() == []
    monkeypatch.setattr(ops_nms, "span", _Stub)
    torch._dynamo.reset()
    outs.append(torch.compile(nms, fullgraph=True,
                              backend=capture)(boxes, scores))
    assert len(graphs) == 2 and graphs[0] == graphs[1]
    assert not any("profiler" in n for n in graphs[0])
    assert all(torch.equal(p, q) for p, q in zip(*outs))
    torch._dynamo.reset()


@pytest.mark.parametrize("K", [64, MAX_BOXES + 64])
def test_nms_span_covers_either_engine(K):
    rng = np.random.default_rng(K)
    xy = rng.uniform(0, 50, (1, K, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 10.0], -1))
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (1, K)), -1)
                              .astype(np.float32))
    idx, valid = ops_nms.dispatch_batched_nms(boxes, scores, 0.5, 5)
    assert idx.shape == valid.shape == (1, 5)
    assert counts() == {"tpucv.nms": 1}


# -------- the train step ----------------------------------------------------
@pytest.fixture(scope="module")
def trainer():
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    cfg.dataset.input_size = SIZE
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    B, M = 4, 3
    xy = torch.rand(B, M, 2, generator=g) * 40
    batch = {"images": torch.rand(B, SIZE, SIZE, 3, generator=g),
             "gt_bboxes": torch.cat([xy, xy + 8 + 16 * torch.rand(
                 B, M, 2, generator=g)], -1),
             "gt_labels": torch.randint(0, 80, (B, M), generator=g,
                                        dtype=torch.int32),
             "gt_mask": torch.ones(B, M, dtype=torch.bool)}
    return algo, batch


@pytest.mark.parametrize("G", [1, 2])
def test_train_spans_close_once_a_stage(trainer, G):
    algo, batch = trainer
    model = algo.init_variables(seed=0).train()
    state = TrainState.create(model, 1e-3)
    step = make_train_step(algo.build_loss(), device="cpu", grad_accum=G,
                           loss_batch_scaled=True)
    laps = []
    steps = 2
    t0 = time.perf_counter_ns()
    for _ in range(steps):
        state, metrics = step(state, batch, laps.append)
    host_ns = time.perf_counter_ns() - t0
    assert torch.isfinite(metrics["loss"])
    assert laps == (LAPS[:3] * G + LAPS[3:]) * steps
    want = {STAGE_SPANS[s]: steps * (G if s != "optimizer_ema" else 1)
            for s in LAPS}
    assert counts() == want
    staged = sum(sum(profile.recent(k, profile.RING))
                 for k in profile.names())
    assert 0.9 * host_ns <= staged <= host_ns


def test_lap_sees_each_span_closed(trainer):
    """``lap(stage)`` runs after its stage's span has closed, so a lap
    that opens its own span nests nothing of the program's in it."""
    algo, batch = trainer
    state = TrainState.create(algo.init_variables(seed=0).train(), 1e-3)
    step = make_train_step(algo.build_loss(), device="cpu")
    seen = []
    step(state, batch, lambda s: seen.append(
        (s, counts().get(STAGE_SPANS[s], 0))))
    assert seen == [(s, 1) for s in LAPS]


# -------- DeepLabV3+'s forward ----------------------------------------------
SEG = ["tpucv.seg.backbone", "tpucv.seg.aspp", "tpucv.seg.decoder"]


def test_deeplab_spans_nest_in_the_train_forward():
    cfg, algo_cls, _ = export_from_registry("deeplabv3plus")
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = {"images": torch.rand(2, 65, 65, 3, generator=g),
             "labels": torch.randint(0, 21, (2, 65, 65), generator=g,
                                     dtype=torch.int32)}
    state = TrainState.create(algo.init_variables(seed=0).train(), 1e-3)
    step = make_train_step(algo.build_loss(), device="cpu")
    step(state, batch)
    assert counts() == {**{k: 1 for k in SEG},
                        **{STAGE_SPANS[s]: 1 for s in LAPS}}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = {}
    for e in prof.events():
        if e.name.startswith("tpucv."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert all(len(spans[k]) == 1 for k in SEG + ["tpucv.train.forward"])
    (f0, f1), = spans["tpucv.train.forward"]
    seg = [spans[k][0] for k in SEG]
    assert all(f0 <= a and b <= f1 for a, b in seg)
    assert all(a[1] <= b[0] for a, b in zip(seg, seg[1:]))
    assert profile.profiled("tpucv.seg.aspp") == \
        profile.recent("tpucv.seg.aspp", 1)


def test_exported_deeplab_gains_no_node(monkeypatch):
    from tpucv_torch import deploy
    from tpucv_torch.models import deeplabv3plus

    model = deeplabv3plus.DeeplabV3Plus(backbone="resnet50").eval()
    x = torch.rand(1, 33, 33, 3, generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spanned = deploy._export(model, x)
    monkeypatch.setattr(deeplabv3plus, "span", _Stub)
    stubbed = deploy._export(model, x)
    nodes = _nodes(spanned.graph_module)
    assert nodes == _nodes(stubbed.graph_module)
    assert not any("profiler" in n for n in nodes)
    with torch.no_grad():
        assert torch.equal(spanned.module()(x), stubbed.module()(x))
    assert profile.names() == []


# -------- the serving batcher's /stats --------------------------------------
class _SlowAlgo:
    """A batched program: 50 ms a batch in ``tpucv.detect.queue``."""

    class_names = ["a"]

    def _batched_detections(self, model, index, batch_size, conf):
        with profile.span("tpucv.detect.queue"):
            time.sleep(0.05)
        for i in range(len(index)):
            yield i, np.zeros((0, 4)), np.zeros(0), np.zeros(0, int)


def test_batcher_stats_queue_wait_and_stages():
    from tpucv_torch.serving import MicroBatcher

    b = MicroBatcher(_SlowAlgo(), None, batch_size=1, max_wait_ms=0.0)
    b.start()
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        threads = [threading.Thread(target=b.submit, args=(img,))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.stop()
    snap = b.snapshot()
    assert snap["batches"] == snap["requests"] == 3 and snap["errors"] == 0
    assert "device_s" not in snap and "device_ms_per_batch" not in snap
    assert snap["batch_s"] >= 0.15 and snap["batch_ms"] >= 50.0
    # three requests, one a batch: the last waits for the first two
    assert snap["queue_wait_ms_p99"] >= 90.0
    assert snap["queue_wait_ms_p50"] <= snap["latency_ms_p50"]
    assert snap["latency_ms_p99"] >= snap["queue_wait_ms_p99"] + 50.0
    assert set(snap["stage_ms"]) == {"queue"}
    assert 50.0 <= snap["stage_ms"]["queue"] < 1000.0
