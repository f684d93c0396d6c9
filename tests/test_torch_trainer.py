"""The slice as a whole: the port's ``Yolo8Trainer`` against tpucv's, and
the port's trainer alone (resume, divergence, refusals, the CLIs), on the
CPU.

Against tpucv: both trainers are built through ``export_from_registry``
on one tiny config (input 64, B=2, ``max_num_boxes`` 4, f32, device
augmentation and mosaic on, ``print_interval`` 1, TensorBoard off; the
synthetic data both fall back to). tpucv's init weights are carried into
the port with ``from_flax_variables``, and each takes 2 steps. A recorder
in the trainers' TensorBoard slot captures the logged learning rate and
metrics unrounded. Held:

- the host batches byte for byte;
- the augmented device batch (from the same host batch and the same
  augmentation seed): images within 1e-6 (tpucv's jitted
  ``augment_batch``; see ``tests/test_torch_augment.py``), boxes within
  1e-5, ``gt_mask`` and labels exactly;
- the logged learning rates within 1e-6 relative (tpucv's optax schedule
  computes in f32, the port's in f64);
- step 1 from identical inputs (the port's init model on tpucv's
  augmented first batch): the loss and components within 1e-5 relative
  and ``num_fg`` equal, the bounds of ``tests/test_torch_train_step.py``
  (measured 8.1e-6);
- step 1 as each loop takes it, each through its own augmentation:
  within 2e-5 relative (measured 1.0e-5 to 1.15e-5). The inputs now
  differ by up to 7.3e-7 as well, and on this batch each engine's f32
  loss is as far from the port's f64 loss (the port 5.7e-6, tpucv 7.5e-6
  relative, on opposite sides), so the two sum; step 2's loss, after one
  update, within 1e-3 relative, as in ``tests/test_torch_train_step.py``;
- the parameters after 2 steps within 2 * 1.5 * (lr_0 + lr_1): Adam moves
  an element by at most ~1.42 lr in either of its first two steps (1.0 in
  the first), so the two sides part by at most that much each way when a
  gradient is rounding noise (measured 4.5e-6 against 9e-6); the
  BatchNorm running statistics within 1e-5 (measured 2.5e-6);
- the checkpoint files' names.

The port alone, at B=8 (8 steps an epoch): 2 epochs in one run equal 1
epoch, a resume and 1 more epoch exactly; a NaN loss writes
``-diverged.ckpt`` and raises; an ``n_model`` that does not divide the
world size is refused by name, and
``zero_opt`` in one process (no process group) trains with plain Adam; ``eval_map`` logs ``map50``, scored on the EMA weights;
``python -m tpucv_torch.train``'s ``main`` trains a step; ``python -m tpucv_torch.serve`` serves a request
from a bundle the trainer saved.
"""

import copy
import json
import math
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv_torch.builder import export_from_registry
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.ckpt.convert import from_flax_variables
from tpucv_torch.train.state import forward

torch.set_num_threads(1)
REL_STEP1 = 1e-5          # step 1's loss and components, same inputs
REL_LOOP1 = 2e-5          # step 1 through each loop's own augmentation
REL_STEP2 = 1e-3          # after one update
BN_TOL = 1e-5
ADAM_MOVE = 1.5           # most an element moves, in lr, in Adam's step 1-2


class Recorder:
    """Stands in for the TensorBoard writer: keeps what is logged."""

    def __init__(self):
        self.rows = {}

    def add_scalar(self, key, value, step):
        self.rows.setdefault(key, {})[step] = float(value)


def shrink(cfg, root, batch_size=2):
    cfg.dataset.input_size = 64
    cfg.dataset.max_num_boxes = 4
    cfg.train.batch_size = batch_size
    cfg.train.mixed_precision = False
    cfg.train.device_aug = True
    cfg.log.print_interval = 1
    cfg.log.tensorboard_on = False
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    return cfg


def _host_batches(loader, n):
    loader.set_epoch(0)
    out = []
    for b in loader:
        out.append({k: v.copy() for k, v in b.items()})
        if len(out) == n:
            break
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    jcfg, _, j_cls = tpucv_export("yolo8_det")
    j = j_cls(shrink(jcfg, root / "tpucv"))
    tcfg, _, t_cls = export_from_registry("yolo8_det")
    t = t_cls(shrink(tcfg, root / "port"), device="cpu")
    # copies: tpucv's step donates the init arrays
    init_sd = from_flax_variables(
        {"params": j.init_params, "batch_stats": j.init_batch_stats})
    t.model.load_state_dict(init_sd)
    hosts = (_host_batches(j.train_loader, 2), _host_batches(t.train_loader, 2))
    # tpucv's augmented first batch, as its first step will draw it; its
    # counter then restarts at 0 for the run
    j_first = {k: np.asarray(v) for k, v in
               j.device_batch(hosts[0][0], train=True).items()}
    del j._aug_seed
    t_init = copy.deepcopy(t.model)
    j.tb, t.tb = Recorder(), Recorder()
    j_state = j.train(max_steps=2)
    t_state = t.train(max_steps=2)
    return dict(j=j, t=t, root=root, hosts=hosts, j_state=j_state,
                t_state=t_state, j_first=j_first, t_init=t_init,
                init_sd=init_sd)


def test_host_batches_byte_equal(both):
    j_b, t_b = both["hosts"]
    for a, b in zip(j_b, t_b):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(b["host_aug"].any() for b in t_b)   # a mosaic among them


def test_augmented_device_batch_equal(both):
    """Both counters stand at 2 after two train batches, so both draw the
    augmentation of seed 2."""
    j, t = both["j"], both["t"]
    assert j._aug_seed == t._aug_seed == 2
    host = both["hosts"][1][1]
    jb = {k: np.asarray(v) for k, v in j.device_batch(host, train=True).items()}
    tb = {k: v.numpy() for k, v in t.device_batch(host, train=True).items()}
    assert sorted(jb) == sorted(tb)
    assert tb["images"].dtype == np.float32
    assert np.abs(jb["images"] - tb["images"]).max() <= 1e-6
    assert np.abs(jb["gt_bboxes"] - tb["gt_bboxes"]).max() <= 1e-5
    np.testing.assert_array_equal(jb["gt_mask"], tb["gt_mask"])
    np.testing.assert_array_equal(jb["gt_labels"], tb["gt_labels"])
    ev_j, ev_t = j.device_batch(host), t.device_batch(host)
    np.testing.assert_array_equal(np.asarray(ev_j["images"]),
                                  ev_t["images"].numpy())


def test_logged_lr_equal(both):
    j_lr, t_lr = both["j"].tb.rows["lr"], both["t"].tb.rows["lr"]
    assert sorted(j_lr) == sorted(t_lr) == [1, 2]
    for k in j_lr:
        assert t_lr[k] == pytest.approx(j_lr[k], rel=1e-6)
        assert t_lr[k] == pytest.approx(1e-3 * (k + 1) / 1000, rel=1e-12)


def _assert_metrics_close(ref, got, rel):
    assert sorted(ref) == sorted(got)
    assert "loss" in ref and "num_fg" in ref
    for k in ref:
        if k == "num_fg":
            assert ref[k] == got[k]
        else:
            assert got[k] == pytest.approx(ref[k], rel=rel), k


def test_step1_from_identical_inputs(both):
    """The port's loss at its init weights on tpucv's augmented first
    batch, against tpucv's logged step 1."""
    t = both["t"]
    batch = {k: torch.tensor(v) for k, v in both["j_first"].items()}
    with torch.no_grad():
        raw = forward(copy.deepcopy(both["t_init"]).train(), batch["images"],
                      False)
        loss, metrics = t.loss_fn(raw, batch)
    got = {k: float(v) for k, v in metrics.items()}
    got["loss"] = float(loss)
    j_rows = both["j"].tb.rows
    ref = {k[len("train/"):]: v[1] for k, v in j_rows.items()
           if k.startswith("train/")}
    _assert_metrics_close(ref, got, REL_STEP1)


def test_step_metrics_through_the_loops(both):
    j_rows, t_rows = both["j"].tb.rows, both["t"].tb.rows
    for step, rel in ((1, REL_LOOP1), (2, REL_STEP2)):
        ref = {k: v[step] for k, v in j_rows.items() if k.startswith("train/")}
        got = {k: v[step] for k, v in t_rows.items() if k.startswith("train/")}
        _assert_metrics_close({k[6:]: v for k, v in ref.items()},
                              {k[6:]: v for k, v in got.items()}, rel)


def test_parameters_after_two_steps(both):
    j_state, t_state = both["j_state"], both["t_state"]
    assert int(j_state.step) == t_state.step == 2
    ref = from_flax_variables({"params": j_state.params,
                               "batch_stats": j_state.batch_stats})
    got = t_state.model.state_dict()
    assert ref.keys() == got.keys()
    lr = both["t"].lr_schedule
    bound = 2 * ADAM_MOVE * (lr(0) + lr(1))
    moved = 0.0
    init = both["init_sd"]
    for k, v in got.items():
        d = float((v.double() - ref[k].double()).abs().max())
        if "running" in k:
            assert d <= BN_TOL, (k, d)
        elif "num_batches" not in k:
            assert d <= bound, (k, d, bound)
            moved = max(moved, float((v - init[k]).abs().max()))
    assert moved > 0.5 * lr(0)                   # the steps did move them


def test_checkpoint_names_equal(both):
    root = both["root"]
    j_names = sorted(os.listdir(root / "tpucv" / "saves"))
    t_names = sorted(os.listdir(root / "port" / "saves"))
    assert j_names == t_names == ["yolo8_det_coco_epoch-0.ckpt",
                                  "yolo8_det_coco_final.ckpt"]


# ---------------------------------------------------------- the port alone
def port_trainer(root, **train):
    cfg, _, cls = export_from_registry("yolo8_det")
    shrink(cfg, root, batch_size=8)
    cfg.train.epochs = 2
    cfg.train.eval_interval = 1
    cfg.train.save_interval = 1
    cfg.log.print_interval = 3
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cls(cfg, device="cpu")


def everything(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.optimizer.state_dict()["state"], state.step)


def assert_states_equal(a, b):
    (sd_a, opt_a, step_a), (sd_b, opt_b, step_b) = a, b
    assert step_a == step_b
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert opt_a.keys() == opt_b.keys()
    for i in opt_a:
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)


def test_resume_equals_unbroken_run(tmp_path):
    whole = port_trainer(tmp_path / "whole")
    assert len(whole.train_loader) == 8
    ref = everything(whole.train())
    assert ref[2] == 16
    assert whole.last_eval["val_loss"] > 0

    split = tmp_path / "split"
    first = port_trainer(split)
    assert first.train(max_steps=8).step == 8
    assert os.path.isfile(split / "saves" / "yolo8_det_coco_epoch-0.ckpt")
    second = port_trainer(split, resume_training=True, last_epoch=0)
    got = everything(second.train())
    assert_states_equal(ref, got)
    final = CheckPoint.load_pure(str(tmp_path / "whole" / "saves" /
                                     "yolo8_det_coco_final.ckpt"))
    final_split = CheckPoint.load_pure(str(split / "saves" /
                                           "yolo8_det_coco_final.ckpt"))
    assert all(torch.equal(final[k], final_split[k]) for k in final)


def test_nan_loss_saves_diverged_checkpoint_and_raises(tmp_path):
    t = port_trainer(tmp_path)
    real = t.loss_fn

    def nan_loss(raw, batch):
        loss, metrics = real(raw, batch)
        return loss * float("nan"), metrics

    t.loss_fn = nan_loss
    with pytest.raises(FloatingPointError, match="diverged"):
        t.train(max_steps=3)
    assert sorted(os.listdir(tmp_path / "saves")) == [
        "yolo8_det_coco_epoch-0-diverged.ckpt"]
    assert t.state.step == 1
    weights = CheckPoint.load_pure(str(tmp_path / "saves" /
                                       "yolo8_det_coco_epoch-0-diverged.ckpt"))
    assert not all(torch.isfinite(v).all() for v in weights.values())


@pytest.mark.parametrize("setting,value,item", [
    ("n_model", 2, "item 14")])
def test_unported_settings_refused_by_name(tmp_path, setting, value, item):
    """``train.n_model`` (ROADMAP item 14b, ported since) must divide the
    world size, as tpucv's must divide its device count: one process
    refuses a model axis of 2 by name."""
    with pytest.raises(ValueError,
                       match=f"{setting}={value} does not divide the 1 "):
        port_trainer(tmp_path, **{setting: value})


def test_zero_opt_in_one_process_is_plain_adam(tmp_path):
    """Without a process group ZeRO-1 has one rank to partition over: the
    trainer keeps plain Adam, and its run equals one without zero_opt."""
    zero = port_trainer(tmp_path / "zero", zero_opt=True)
    assert type(zero.state.optimizer) is torch.optim.Adam
    plain = port_trainer(tmp_path / "plain")
    assert_states_equal(everything(plain.train(max_steps=2)),
                        everything(zero.train(max_steps=2)))


def test_eval_map_run_logs_map50(tmp_path):
    """``train.eval_map``: a 2-step run evaluates the val index after
    ``evaluate_loop`` and logs the VOC mAP@0.5 (the synthetic index has no
    COCO GT records) beside the val loss."""
    t = port_trainer(tmp_path, eval_map=True)
    t.tb = Recorder()
    t.train(max_steps=2)
    assert {"val_loss", "map50"} <= set(t.last_eval)
    assert 0.0 <= t.last_eval["map50"] <= 1.0
    assert t.tb.rows["val/map50"] == {2: t.last_eval["map50"]}


def test_evaluate_map_scores_the_ema_weights(tmp_path):
    """With an EMA, ``evaluate_map`` runs a model holding the EMA
    parameters and the live BatchNorm statistics, equals
    ``evaluate_on_voc`` on a model loaded that way, and leaves the trained
    model's weights as they were."""
    cfg, _, cls = export_from_registry("yolo8_det")
    shrink(cfg, tmp_path, batch_size=8)
    cfg.optimizer.ema_decay = 0.5
    t = cls(cfg, device="cpu")
    state = t.train(max_steps=2)
    live = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert any(not torch.equal(v, live[k]) for k, v in state.ema.items())
    seen = []
    harness = t.algorithm._batched_detections

    def spy(model, *args, **kw):
        seen.append(model)
        return harness(model, *args, **kw)

    t.algorithm._batched_detections = spy
    got = t.evaluate_map(state)
    assert len(seen) == 1 and seen[0] is not state.model
    scored = seen[0].state_dict()
    for k, v in live.items():
        assert torch.equal(scored[k], state.ema.get(k, v)), k
    assert all(torch.equal(v, live[k])
               for k, v in state.model.state_dict().items())

    ref_model = t.algorithm.init_variables()
    ref_model.load_state_dict({**live, **state.ema})
    res = t.algorithm.evaluate_on_voc(
        ref_model, t.val_index, batch_size=cfg.train.batch_size,
        conf_threshold=cfg.train.eval_map_conf, verbose=False)
    assert got == {"map50": res["mAP"]}


def test_default_device_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg, _, cls = export_from_registry("yolo8_det")
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(shrink(cfg, tmp_path))


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLIs' registry lookup, with the config shrunk; runs in
    ``tmp_path``, where the trainer writes ``saves/`` and ``log/``."""
    import tpucv_torch.train.__main__ as cli

    def small(name):
        cfg, algo, cls = export_from_registry(name)
        shrink(cfg, tmp_path, batch_size=2)
        cfg.train.save_path, cfg.log.root = "saves", "log"
        return cfg, algo, cls

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "export_from_registry", small)
    return cli


def test_train_cli_main_runs(small_cli, tmp_path):
    state = small_cli.main(["--model", "yolo8_det", "--device", "cpu",
                            "--max-steps", "1", "--batch-size", "4"])
    assert state.step == 1
    assert sorted(os.listdir(tmp_path / "saves")) == [
        "yolo8_det_coco_epoch-0.ckpt", "yolo8_det_coco_final.ckpt"]
    assert all(torch.isfinite(v).all()
               for v in state.model.state_dict().values())
    with pytest.raises(ValueError, match="n_model=2 does not divide"):
        small_cli.main(["--model", "yolo8_det", "--device", "cpu",
                        "--n-model", "2"])


def test_serve_cli_reads_a_trainer_bundle(small_cli, tmp_path):
    """``python -m tpucv_torch.serve --ckpt`` loads the bundle the trainer
    saved (the weights, not the optimizer) and answers a request."""
    from tpucv_torch import serve

    state = small_cli.main(["--model", "yolo8_det", "--device", "cpu",
                            "--max-steps", "1"])
    bundle = str(tmp_path / "saves" / "yolo8_det_coco_final.ckpt")
    assert {"model", "optimizer", "ema", "step"} <= set(
        torch.load(bundle, weights_only=True))
    server = serve.build(["--model", "yolo8_det", "--device", "cpu",
                          "--ckpt", bundle, "--host", "127.0.0.1",
                          "--port", "0", "--batch", "1"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        served = server.batcher.model.state_dict()
        trained = state.model.state_dict()
        assert all(torch.equal(served[k], trained[k]) for k in trained)
        img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=img.tobytes(),
            headers={"Content-Type": "application/x-raw-rgb",
                     "X-Height": "48", "X-Width": "64"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
        assert isinstance(body["detections"], list)
        assert all(math.isfinite(d["score"]) for d in body["detections"])
    finally:
        server.shutdown()
        server.batcher.stop()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
