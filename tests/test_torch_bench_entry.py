"""``python -m tpucv_torch.bench`` at ``--device cpu --small``: the wiring
of the port's benchmark, not its numbers.

Its JSON line carries every key of ``bench.py:main``'s line (read from
``bench.py``'s source), with the keys of what the port has not ported yet
null and named in ``notes``; the train step's metrics are finite. On a
machine without CUDA the default run refuses rather than falling back to
the CPU."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucv_torch import bench

torch.set_num_threads(1)
NOT_PORTED = ["int8_img_per_sec", "host_decode_img_per_sec_per_core",
              "host_decode_threads", "feed_limited_img_per_sec_this_host",
              "cores_to_feed_chip"]


def bench_py_keys():
    """The string keys of the dict ``bench.py:main`` prints."""
    src = Path(__file__).resolve().parents[1] / "bench.py"
    tree = ast.parse(src.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py:main prints no dict")


@pytest.fixture(scope="module")
def line():
    return bench.main(["--device", "cpu", "--small"])


def test_line_has_bench_py_keys(line):
    keys = bench_py_keys()
    assert len(keys) == 14 and "train_step_ms" in keys
    assert set(keys) <= set(line)
    assert line["metric"] == "yolov8n_64_e2e_images_per_sec_per_cpu"
    assert line["device"] == "cpu"


def test_not_ported_keys_are_null_and_named(line):
    for k in NOT_PORTED:
        assert line[k] is None, k
    assert "int8" in line["notes"] and "host_decode" in line["notes"]


def test_measured_values(line):
    for k in ("value", "h2d_img_per_sec", "h2d_gbytes_per_sec",
              "train_img_per_sec", "train_step_ms"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert np.isfinite(line["train_loss"]) and line["train_num_fg"] >= 0
    assert set(line["train_metrics"]) == {"loss", "box_loss", "cls_loss",
                                          "dfl_loss", "num_fg"}
    assert set(line["train_split_ms"]) == {"forward", "loss", "backward",
                                           "optimizer_ema"}
    assert line["train_steps"] == bench.SMALL.train_warmup + \
        bench.SMALL.train_iters
    # 3 x the forward's convolution FLOPs: YOLOv8n is 8.7 GFLOP at 640²,
    # so 8.7e9 / 100 an image at 64²
    per_image = line["train_flops_per_step"] / 3 / line["train_batch"]
    assert 0.085e9 < per_image < 0.089e9
    assert line["train_mfu_share"] is None        # no card, no share


def test_main_prints_one_json_line(capsys):
    out = bench.main(["--device", "cpu", "--small"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    assert json.loads(printed[0]) == json.loads(json.dumps(out))


def test_synthetic_batch_is_seeded():
    a = bench.synthetic_batch(2, 32, 5, torch.device("cpu"), 300.0,
                              torch.float32)
    b = bench.synthetic_batch(2, 32, 5, torch.device("cpu"), 300.0,
                              torch.float32)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["images"].shape == (2, 32, 32, 3)
    assert a["gt_labels"].dtype == torch.int32
    assert 0 <= int(a["gt_labels"].min()) and int(a["gt_labels"].max()) < 80
    assert float(a["gt_bboxes"].max()) < 300.0 and bool(a["gt_mask"].all())


def test_bench_optimizer_is_bench_pys():
    """bench.py's optax.adam(1e-3) at a constant lr, with an EMA."""
    from tpucv_torch.train.state import TrainState
    state = TrainState.from_config(torch.nn.Linear(3, 2), bench.OPTIMIZER)
    assert [state.schedule(s) for s in (0, 1, 10, 1000, 10**6)] == [1e-3] * 5
    assert state.ema is not None and bench.OPTIMIZER.ema_decay == 0.9999


def test_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
