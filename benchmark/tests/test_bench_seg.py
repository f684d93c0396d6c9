"""The segmentation cell, ``deeplabv3plus-train-b16``, on the CPU at its
tiny shapes: a run prints a correct line with the cell's end-to-end
metrics; a traced run prints the per-layer metrics that ``BENCHMARK.json``
lists for it and that a CPU trace holds (the program's spans, the window's
share of the peak; the device's kernels only with a card); planted faults
in the program read not correct (void pixels counted in the loss as
background, and one ASPP branch dropped), as in ``test_bench_faults.py``;
the readers give None where there is nothing to read; the label maps
follow the cell's law; and the stored FLOPs are the count's."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import common, flops_seg, metrics, traffic_seg
from benchmark.tests.conftest import REPO, run_cell

CELL = "deeplabv3plus-train-b16"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SEG_SPANS = {"backbone_host_ms.seg": "tpucv.seg.backbone",
             "aspp_host_ms.seg": "tpucv.seg.aspp",
             "decoder_host_ms.seg": "tpucv.seg.decoder"}
APPENDED = ["launches.train", "kernel_ms.train", "idle_share.train",
            "mfu.train", "forward_host_ms.train", "loss_host_ms.train",
            "backward_host_ms.train", "optimizer_host_ms.train"]
# what a CPU trace has no record of: kernels and their launches
DEVICE_ONLY = {"launches.train", "kernel_ms.train", "idle_share.train",
               "bilinear_ms.train"}

SITE = '''
import os

FAULT = os.environ.get("BENCH_TEST_FAULT")
if FAULT == "void_counted":
    import torch
    from tpucv_torch.losses import segmentation

    valid_ce = segmentation._valid_ce

    def counted(logits, labels, ignore_index):
        labels = torch.where(labels == ignore_index, 0, labels)
        return valid_ce(logits, labels, ignore_index)

    segmentation._valid_ce = counted
elif FAULT == "aspp_branch_dropped":
    import torch
    from tpucv_torch.models import deeplabv3plus

    def dropped(self, x):
        parts = [c(x) for c in self.convs]
        parts[3] = torch.zeros_like(parts[3])
        return self.project(torch.cat(parts, 1))

    deeplabv3plus.ASPP.forward = dropped
'''


def test_cell_is_listed_with_its_metrics():
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "deeplabv3plus-r101-voc513"
    cfg = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert cfg["reduced"] == []
    listed = {m["name"] for m in SPEC["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert listed == set(APPENDED) | set(SEG_SPANS) | {"bilinear_ms.train"}


def test_cell_line():
    rc, line, err = run_cell(CELL, "--device", "cpu", "--small")
    assert rc == 0, err[-3000:]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
        assert f"check {name} " in err


def test_traced_line():
    rc, line, err = run_cell(CELL, "--device", "cpu", "--small", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    want = (set(APPENDED) | set(SEG_SPANS)) - DEVICE_ONLY
    assert want <= set(got) <= want | DEVICE_ONLY
    assert all(got[n]["value"] > 0 for n in want)
    # the three stages lie inside the forward stage of the step
    staged = sum(got[n]["value"] for n in SEG_SPANS)
    assert staged <= got["forward_host_ms.train"]["value"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["void_counted", "aspp_branch_dropped"])
def test_fault_is_not_correct(fault, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(SITE)
    env = {"PYTHONPATH": f"{tmp_path}:{REPO}", "BENCH_TEST_FAULT": fault}
    rc, line, err = run_cell(CELL, "--device", "cpu", "--small", env=env)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", sorted(SEG_SPANS))
def test_span_reader(name, monkeypatch):
    """The span's traced records over the window's steps; None in a detect
    cell, for a program without the recorder, or with no record."""
    import sys

    bare = types.ModuleType("tpucv_torch.utils.profile")
    monkeypatch.setitem(sys.modules, "tpucv_torch.utils.profile", bare)
    import tpucv_torch.utils
    monkeypatch.setattr(tpucv_torch.utils, "profile", bare, raising=False)
    mod = metrics.reader(name)
    ctx = {"kind": "train", "steps": 2}
    assert mod.read(ctx) is None
    bare.profiled = lambda span: []
    assert mod.read(ctx) is None
    bare.profiled = lambda span: ([1_000_000, 3_000_000]
                                  if span == SEG_SPANS[name] else [])
    assert mod.read(ctx) == pytest.approx(2.0)
    assert mod.read({"kind": "detect", "batches": 2}) is None


def test_bilinear_reader():
    from benchmark.trace import Trace

    fwd = "void at::native::upsample_bilinear2d_nhwc_out_frame<float>"
    bwd = "void at::native::upsample_bilinear2d_backward_nhwc_out_frame"
    tr = Trace(device_ops=[
        (fwd, 0, 30), (bwd, 40, 50),
        ("sm90_xmma_fprop_implicit_gemm_bf16", 50, 500),
        ("Memcpy HtoD (Pageable -> Device)", 500, 600)], window=(0.0, 1000.0))
    mod = metrics.reader("bilinear_ms.train")
    assert mod.read({"kind": "train", "steps": 2, "trace": tr}) == \
        pytest.approx(0.02)
    tr.device_ops = tr.device_ops[2:]
    assert mod.read({"kind": "train", "steps": 2, "trace": tr}) is None
    assert mod.read({"kind": "detect", "steps": 2, "trace": tr}) is None


def test_label_maps_follow_the_law():
    spec = common.load_json("workloads", CELL)["traffic"]["labels"]
    import numpy as np

    S, n = 129, 64
    labs = traffic_seg.label_maps(spec, n, S, 21, np.random.default_rng(1),
                                  "cpu")
    assert labs.shape == (n, S, S) and labs.dtype == torch.int32
    vals = set(labs.unique().tolist())
    assert vals <= set(range(21)) | {255} and 255 in vals and 0 in vals
    void = (labs == 255).float().mean()
    assert 0.01 < float(void) < 0.5
    # one object of the crop's full width: its band, 5-10 px across the
    # middle row at each of its two edges
    one = dict(spec, objects=1.0, area=[0.3, 0.3], aspect=[1.0, 1.0])
    lab = traffic_seg.label_maps(one, 1, S, 21, np.random.default_rng(2),
                                 "cpu")[0]
    row = lab[int(torch.nonzero(lab.eq(255).any(1))[:, 0].float().mean())]
    runs = torch.diff(torch.nonzero(torch.diff(
        torch.cat([torch.zeros(1), (row == 255).float(), torch.zeros(1)])))
        [:, 0])[::2]
    assert len(runs) >= 1 and all(5 <= int(r) <= 10 for r in runs)


def test_stored_flops():
    cfg = common.load_json("configs", "deeplabv3plus-r101-voc513")
    assert flops_seg.count(cfg, cfg["input_size"]) == cfg["flops"]
