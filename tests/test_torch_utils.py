"""The port's configs, registries and small utilities against tpucv's, on
the CPU: the ``yolo8_det`` config field for field, the dataset configs
with the ``TPUCV_<NAME>_ROOT`` override, the trainer registry, device
selection and ``move_to_device``."""

import dataclasses

import pytest
import torch

from tpucv.builder import export_from_registry as tpucv_export
from tpucv.configs import dataset_cfg as j_ds
from tpucv_torch.builder import export_from_registry
from tpucv_torch.configs import dataset_cfg as t_ds
from tpucv_torch.registry import Register, trainer_registry
from tpucv_torch.utils.device import device_summary, get_device
from tpucv_torch.utils.misc import move_to_device


def test_yolo8_det_config_equals_tpucvs():
    j_cfg, _, _ = tpucv_export("yolo8_det")
    t_cfg, _, _ = export_from_registry("yolo8_det")
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.model_name == j_cfg.model_name == "yolo8_det"
    assert t_cfg.num_classes == j_cfg.num_classes == 80
    for section in ("dataset", "train", "optimizer", "log", "decode"):
        j_fields = [f.name for f in dataclasses.fields(getattr(j_cfg, section))]
        t_fields = [f.name for f in dataclasses.fields(getattr(t_cfg, section))]
        assert t_fields == j_fields, section


@pytest.mark.parametrize("name", ["voc", "coco"])
def test_dataset_cfg_and_root_override(name, monkeypatch):
    monkeypatch.delenv(f"TPUCV_{name.upper()}_ROOT", raising=False)
    assert t_ds.get_dataset_cfg(name) == j_ds.get_dataset_cfg(name)
    monkeypatch.setenv(f"TPUCV_{name.upper()}_ROOT", "/data/elsewhere")
    got = t_ds.get_dataset_cfg(name)
    assert got["root"] == "/data/elsewhere" == j_ds.get_dataset_cfg(name)["root"]
    assert got == j_ds.get_dataset_cfg(name)
    assert t_ds.COCO80_TO_COCO91 == j_ds.COCO80_TO_COCO91


def test_trainer_registry():
    _, _, trainer = export_from_registry("yolo8_det")
    assert trainer is trainer_registry["trainer_yolo8_det"]
    assert "trainer_yolo8_det" in trainer_registry
    assert trainer.LOSS_BATCH_SCALED is True
    reg = Register("t", prefix="x_")
    reg("a")(lambda: 1)
    with pytest.raises(KeyError, match="already registered"):
        reg("a")(lambda: 2)
    with pytest.raises(ValueError, match="callable"):
        reg["b"] = 3


def test_get_device():
    assert get_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert get_device().type == "cuda"
        assert "x" in device_summary()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            get_device()
        assert device_summary().startswith("cpu")


def test_move_to_device():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.arange(3), 4)],
            "c": "text"}
    out = move_to_device(tree, "cpu")
    assert out["c"] == "text" and out["b"][1][1] == 4
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    assert torch.equal(out["b"][1][0], torch.arange(3))
    assert out["a"].device.type == "cpu"


def test_profile_accumulates_and_traces(tmp_path):
    """``Profile`` as a context and as a decorator: ``.dt`` is the last
    span, ``.t`` their sum; ``fence`` takes a tensor or a nest of them
    (nothing to wait for on the CPU); ``trace`` writes a Chrome trace
    naming the ops it saw."""
    import json
    import time

    from tpucv_torch.utils.profile import Profile, trace

    p = Profile(t=1.0)
    with p:
        time.sleep(0.01)
    first = p.dt
    assert first >= 0.01 and p.t == pytest.approx(1.0 + first)

    @p
    def work():
        time.sleep(0.02)
        x = torch.ones(4)
        p.fence({"a": [x, (x * 2,)]})
        return x

    work()
    assert p.dt >= 0.02 and p.t == pytest.approx(1.0 + first + p.dt)
    p.fence(torch.zeros(2))
    p.fence(())

    with trace(str(tmp_path / "tr")) as d:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr")
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
