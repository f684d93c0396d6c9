"""The port's checkpoints (``tpucv_torch.ckpt.checkpoint``), on the CPU.

- ``CheckPoint.save`` / ``load`` round trip exactly: parameters, BatchNorm
  buffers, Adam's moments and step counts, the EMA, the train step and the
  schedule's next learning rate; and a step taken after loading equals the
  step the saved run takes next, bit for bit.
- ``load_pure`` returns the model weights (parameters and BatchNorm
  buffers, not the EMA) from a bundle and from a bare ``state_dict``.
- ``load_pretrained`` is partial and shape-matched: a head for another
  class count keeps its init, and the loaded and skipped counts are
  logged.
"""

import logging
import os

import numpy as np
import pytest
import torch

from tpucv_torch.ckpt.checkpoint import CheckPoint, load_pretrained
from tpucv_torch.configs.base import OptimizerCfg
from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
from tpucv_torch.losses.yolov8 import yolov8_loss
from tpucv_torch.models.yolov8 import Yolo8
from tpucv_torch.train.state import TrainState, make_train_step

torch.set_num_threads(1)
NC, S, B, M = 8, 64, 2, 4
EMA = 0.99


def batches(n, seed=11):
    index = SyntheticDetectionIndex(n * B, S, NC, max_objects=M - 1,
                                    seed=seed)
    out = []
    for k in range(n):
        b = {"images": torch.zeros((B, S, S, 3)),
             "gt_bboxes": torch.zeros((B, M, 4)),
             "gt_labels": torch.zeros((B, M), dtype=torch.int32),
             "gt_mask": torch.zeros((B, M), dtype=torch.bool)}
        for j in range(B):
            img, boxes, labels = index[k * B + j]
            b["images"][j] = torch.from_numpy(img).float() / 255.0
            b["gt_bboxes"][j, :len(boxes)] = torch.from_numpy(boxes)
            b["gt_labels"][j, :len(labels)] = torch.from_numpy(labels)
            b["gt_mask"][j, :len(labels)] = True
        out.append(b)
    return out


def loss_fn(raw, b):
    return yolov8_loss(raw, b["gt_labels"], b["gt_bboxes"], b["gt_mask"],
                       nc=NC)


def fresh_state(seed=0, nc=NC):
    model = Yolo8("n", nc=nc).reset_parameters(
        torch.Generator().manual_seed(seed))
    opt = OptimizerCfg(lr=1e-3, warmup_iters=3, milestones=(1,),
                       ema_decay=EMA)
    return TrainState.from_config(model, opt, iters_per_epoch=2)


def snapshot(state):
    """Everything the bundle must carry, as CPU copies."""
    return {
        "model": {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()},
        "adam": {i: {k: v.clone() for k, v in s.items()}
                 for i, s in state.optimizer.state_dict()["state"].items()},
        "ema": {k: v.clone() for k, v in state.ema.items()},
        "step": state.step,
        "next_lr": state.schedule(state.step),
    }


def assert_snapshots_equal(a, b):
    assert a["step"] == b["step"] and a["next_lr"] == b["next_lr"]
    for part in ("model", "ema"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["adam"].keys() == b["adam"].keys()
    for i in a["adam"]:
        for k in a["adam"][i]:
            assert torch.equal(a["adam"][i][k], b["adam"][i][k]), (i, k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A state after 2 steps, saved; and the 3rd step it takes next."""
    bs = batches(3)
    step = make_train_step(loss_fn, device="cpu", ema_decay=EMA)
    state = fresh_state()
    for b in bs[:2]:
        state, _ = step(state, b)
    path = str(tmp_path_factory.mktemp("ckpt") / "run_epoch-0.ckpt")
    CheckPoint.save(state, path)
    saved = snapshot(state)
    state, m = step(state, bs[2])
    return path, saved, snapshot(state), float(m["loss"]), bs


def test_save_load_round_trip_exact(trained):
    path, saved, _, _, _ = trained
    assert os.path.isfile(path) and not any(
        f.endswith(".tmp") for f in os.listdir(os.path.dirname(path)))
    state = fresh_state(seed=1)                 # other weights
    assert state.step == 0
    out = CheckPoint.load(path, state)
    assert out is state and state.step == 2
    assert_snapshots_equal(saved, snapshot(state))
    # the lr of the next update is the schedule's at step 2: past the
    # milestone (epoch 1 = iteration 2), so scaled by gamma
    assert state.schedule(state.step) == pytest.approx(1e-3 * 0.1)


def test_step_after_load_continues_exactly(trained):
    path, _, after, loss, bs = trained
    state = CheckPoint.load(path, fresh_state(seed=1))
    step = make_train_step(loss_fn, device="cpu", ema_decay=EMA)
    state, m = step(state, bs[2])
    assert float(m["loss"]) == loss
    assert_snapshots_equal(after, snapshot(state))


def test_load_refuses_a_missing_ema(trained, tmp_path):
    path = trained[0]
    model = Yolo8("n", nc=NC)
    no_ema = TrainState.create(model, 1e-3, use_ema=False)
    with pytest.raises(ValueError, match="EMA"):
        CheckPoint.load(path, no_ema)


def test_load_pure_bundle_and_bare_state_dict(trained, tmp_path):
    path, saved, _, _, _ = trained
    weights = CheckPoint.load_pure(path)
    assert weights.keys() == saved["model"].keys()
    for k, v in weights.items():
        assert v.device.type == "cpu" and torch.equal(v, saved["model"][k]), k
    # not the EMA: the EMA of an updated parameter differs from it
    k = "model.0.conv.weight"
    assert not torch.equal(weights[k], saved["ema"][k])

    model = Yolo8("n", nc=NC).reset_parameters(
        torch.Generator().manual_seed(5))
    model.load_state_dict(weights)
    bare = CheckPoint.save_pure(model, str(tmp_path / "pure.pt"))
    again = CheckPoint.load_pure(bare)
    assert again.keys() == weights.keys()
    assert all(torch.equal(again[k], weights[k]) for k in weights)
    torch.save({"model_state_dict": weights}, tmp_path / "ref.pth")
    ref = CheckPoint.load_pure(str(tmp_path / "ref.pth"))
    assert all(torch.equal(ref[k], weights[k]) for k in weights)


def test_load_pretrained_partial_shape_matched(trained, tmp_path, caplog):
    path, saved, _, _, _ = trained
    model = Yolo8("n", nc=3).reset_parameters(
        torch.Generator().manual_seed(7))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    logger = logging.getLogger("test_torch_checkpoint")
    with caplog.at_level(logging.INFO, logger=logger.name):
        load_pretrained(model, path, "yolo8_det", logger)
    after = model.state_dict()
    loaded = [k for k in after if init[k].shape == saved["model"][k].shape]
    skipped = [k for k in after if k not in loaded]
    # only the class branches' last convs depend on nc
    assert skipped and all(k.startswith("model.22.cv3.")
                           and ".2." in k for k in skipped)
    for k in loaded:
        assert torch.equal(after[k], saved["model"][k]), k
    for k in skipped:
        assert torch.equal(after[k], init[k]), k
    msg = caplog.records[-1].getMessage()
    assert (f"loaded {len(loaded)} tensors from {path}" in msg
            and f"skipped {len(skipped)} shape-mismatched" in msg)


def test_load_pretrained_full_match_loads_all(trained):
    path, saved, _, _, _ = trained
    model = Yolo8("n", nc=NC)
    load_pretrained(model, path)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], saved["model"][k]) for k in sd)
    np.testing.assert_equal(len(sd), len(saved["model"]))
