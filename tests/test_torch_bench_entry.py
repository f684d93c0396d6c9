"""``python -m tpucv_torch.bench`` at ``--device cpu --small``: the wiring
of the port's benchmark, not its numbers.

Its JSON line carries every key of ``bench.py:main``'s line (read from
``bench.py``'s source): ``int8_img_per_sec`` finite, the host-decode keys
numbers where the native JPEG decode is available and null, with the
reason in ``notes``, where it is not; the train step's metrics are finite.
On a machine without CUDA the default run refuses rather than falling
back to the CPU.

``--scale s --small`` prints every key of ``bench.py:bench_scale``'s line
at its batches (read from ``bench.py``'s source), and the four scales'
forwards at full width (B=1, 64²) equal tpucv's on the port's seed-0
weights carried into flax by ``import_yolov8``: each level within 1e-4 of
its largest value (f32, as ``test_torch_yolov8.py`` holds YOLOv8n). The
variants' bench lines (``--model yolo7x|ssd512``) carry their names."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucv_torch import bench

torch.set_num_threads(1)
HOST_DECODE = ["host_decode_img_per_sec_per_core", "host_decode_threads",
               "feed_limited_img_per_sec_this_host", "cores_to_feed_chip"]


def bench_py_function(name):
    src = Path(__file__).resolve().parents[1] / "bench.py"
    tree = ast.parse(src.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def bench_py_keys(function="main"):
    """The string keys of the dict ``bench.py:<function>`` prints."""
    main = bench_py_function(function)
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"bench.py:{function} prints no dict")


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
    """Every key is filled where its engine runs: int8 always, the host
    decode where ``imagepipe.available()``; else null and named in
    ``notes``."""
    from tpucv_torch.native import imagepipe

    assert np.isfinite(line["int8_img_per_sec"]) and \
        line["int8_img_per_sec"] > 0
    assert line["int8_convs"] == 56
    if imagepipe.available():
        rates = line["host_decode_threads"]
        assert set(rates) == {"1", "2", "4"}
        assert line["host_decode_img_per_sec_per_core"] == rates["1"] > 0
        assert line["feed_limited_img_per_sec_this_host"] == min(
            rates["1"] * line["host_cores"], line["value"])
        assert line["cores_to_feed_chip"] == int(np.ceil(
            line["value"] / rates["1"]))
        assert "host_decode" not in line["notes"]
    else:
        for k in HOST_DECODE:
            assert line[k] is None and k in line["notes"], k


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


def test_host_decode_keys_null_without_the_library(monkeypatch):
    """Where the native decode is unavailable (the card's host has no
    libjpeg headers) the four keys are null and ``NO_NATIVE_DECODE`` names
    them."""
    from tpucv_torch.native import imagepipe

    monkeypatch.setattr(imagepipe, "available", lambda: False)
    assert bench.bench_host_decode(bench.SMALL) is None
    keys = bench.feed_limits(None, 100.0)
    assert set(keys) == set(HOST_DECODE)
    assert all(v is None and k in bench.NO_NATIVE_DECODE
               for k, v in keys.items())


# ------------------------------------------------------- --scale, variants
def bench_scale_batches():
    """{scale: (inference, training)} from ``bench.py:bench_scale``'s two
    dict literals, ``B_inf`` and ``B_tr``."""
    found = {}
    for node in ast.walk(bench_py_function("bench_scale")):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Subscript) and isinstance(
                node.value.value, ast.Dict):
            d = node.value.value
            found[node.targets[0].id] = {k.value: v.value
                                         for k, v in zip(d.keys, d.values)}
    return {k: (found["B_inf"][k], found["B_tr"][k])
            for k in found["B_inf"] if k != "n"}


def test_scale_batches_are_bench_scales():
    assert bench.SCALE_BATCHES == bench_scale_batches()


def test_scale_line_has_bench_scale_keys(capsys):
    line = bench.main(["--scale", "s", "--small", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(line))
    assert set(bench_py_keys("bench_scale")) <= set(line)
    assert line["metric"] == "yolov8s_64_e2e_images_per_sec_per_cpu"
    assert line["device"] == "cpu"
    assert line["infer_batch"] == line["train_batch"] == 2
    for k in ("value", "train_img_per_sec", "train_step_ms", "train_loss"):
        assert np.isfinite(line[k]) and line[k] > 0, k


def test_scale_and_model_are_exclusive():
    with pytest.raises(SystemExit):
        bench.main(["--scale", "s", "--model", "ssd", "--device", "cpu"])


@pytest.mark.parametrize("name,family,fields", [
    ("yolo7x", "yolo7", {"phi": "x"}), ("ssd512", "ssd", {"input_size": 512})])
def test_variants_configure_their_family(name, family, fields):
    got, cfg, _ = bench.configured(name)
    assert got == family
    for k, v in fields.items():
        assert getattr(cfg.arch, k) == v
    if family == "ssd":
        assert cfg.dataset.input_size == 512


def test_ssd_bench_labels_stop_before_the_background():
    _, cfg, _ = bench.configured("ssd")
    b = bench.family_batch("ssd", cfg, 64, 300, torch.device("cpu"),
                           torch.float32)
    assert int(b["gt_labels"].max()) == cfg.num_classes - 2


@pytest.mark.parametrize("scale", ["s", "m", "l", "x"])
def test_scale_forward_equals_tpucv(scale):
    import jax
    import jax.numpy as jnp

    from tpucv.ckpt.importer import import_yolov8
    from tpucv.models.yolov8 import Yolo8 as FlaxYolo8

    model = bench.scale_algo(scale, torch.device("cpu"), 64).init_variables(
        seed=0)
    variables = import_yolov8({k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()})
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    ref = jax.jit(FlaxYolo8(scale=scale, nc=80).apply)(variables,
                                                       jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        assert float(np.abs(o.numpy() - r).max()) <= 1e-4 * np.abs(r).max()
