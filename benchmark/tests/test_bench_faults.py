"""Runs with the timed path broken underneath come out not correct: the
harness's look for a card is skipped (``--device cpu``), the rest of a
run is driven as it is, and a fault is planted in the program at start-up
(a ``sitecustomize`` on the run's ``PYTHONPATH``, so that the ranks a
data-parallel run starts carry it too). One test a fault a cell can
have: an answer left out or altered where it is produced (detection:
half the images' answers dropped, every class shifted, or one image a
call given its neighbour's answers), the state left unchanged, half of
the batch left out (training), and the exchange between ranks left out
(data-parallel training)."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.tests.conftest import REPO, run_cell

SITE = '''
import os

FAULT = os.environ.get("BENCH_TEST_FAULT")
if FAULT in ("half_answers", "altered_answers", "one_image_swapped"):
    from tpucv_torch.algorithms import base

    detections = base.DetectionAlgorithm._batched_detections

    def broken(self, model, index, batch_size, conf):
        out = list(detections(self, model, index, batch_size, conf))
        for j, (i, b, s, c) in enumerate(out):
            if FAULT == "altered_answers":
                c = (c + 1) % self.nc
            elif FAULT == "one_image_swapped":
                if j == 0:
                    b, s, c = out[1][1:]
            elif j >= len(out) // 2:
                b, s, c = b[:0], s[:0], c[:0]
            yield i, b, s, c

    base.DetectionAlgorithm._batched_detections = broken
elif FAULT == "unchanged_state":
    from tpucv_torch.train import state

    def no_update(self, ema_decay=0.0):
        self.step += 1

    state.TrainState.apply_gradients = no_update
elif FAULT == "half_batch":
    from tpucv_torch.train import state

    make = state.make_train_step

    def make_half(*a, **k):
        step = make(*a, **k)

        def half(ts, batch, *rest):
            n = len(batch["images"]) // 2
            return step(ts, {key: v[:n] for key, v in batch.items()}, *rest)

        return half

    state.make_train_step = make_half
elif FAULT == "no_exchange":
    from tpucv_torch.parallel import mesh

    mesh.all_reduce_grads = lambda params, m=None: None
'''

# One image of each call of 16 given its neighbour's answers: a sixteenth
# of the answers, under the tenth that a pooled 90th percentile could see.
ONE_IN_16 = {"batch": 16, "per_shape": 4}

CASES = [
    ("yolov8l-detect-b32", "half_answers", None),
    ("yolov8l-detect-b32", "altered_answers", None),
    ("yolov8l-detect-b32", "one_image_swapped", ONE_IN_16),
    ("yolov7l-detect-b32", "half_answers", None),
    ("yolov7l-detect-b32", "altered_answers", None),
    ("yolov7l-detect-b32", "one_image_swapped", ONE_IN_16),
    ("yolov8l-train-b16", "unchanged_state", None),
    ("yolov8l-train-b16", "half_batch", None),
    ("yolov8l-train-ddp4", "unchanged_state", None),
    ("yolov8l-train-ddp4", "half_batch", None),
    ("yolov8l-train-ddp4", "no_exchange", None),
]


@pytest.mark.parametrize("cell,fault,small", CASES)
def test_fault_is_not_correct(cell, fault, small, tmp_path):
    """``small``: the cell's tiny shapes changed, in a copy of the
    benchmark."""
    root = REPO
    if small:
        root = tmp_path / "copy"
        shutil.copytree(REPO / "benchmark", root / "benchmark",
                        ignore=shutil.ignore_patterns(".cache", "__pycache__"))
        path = root / "benchmark" / "workloads" / f"{cell}.json"
        spec = json.loads(path.read_text())
        spec["small"].update(small)
        path.write_text(json.dumps(spec))
    (tmp_path / "sitecustomize.py").write_text(SITE)
    env = {"PYTHONPATH": f"{tmp_path}:{root}:{REPO}",
           "BENCH_TEST_FAULT": fault}
    rc, line, err = run_cell(cell, "--device", "cpu", "--small", cwd=root,
                             env=env)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
