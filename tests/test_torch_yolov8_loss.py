"""tpucv_torch's YOLOv8 loss against tpucv's, on the same numpy-seeded
raw maps and padded targets, in f32 on the CPU.

The total within 1e-5 relative (measured ≤ 1.0e-6), each component
within 1e-5 relative plus 1e-7 absolute (measured ≤ 1.0e-6 relative),
``num_fg`` equal, and the gradient with respect to every raw map within
1e-5 absolute (measured ≤ 3.3e-7 at a largest gradient of 0.74)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucv.configs.model_cfgs import Yolo8DetConfig as JCfg
from tpucv.losses import yolov8 as jl
from tpucv_torch.builder import export_from_registry
from tpucv_torch.losses import yolov8 as tl

torch.set_num_threads(1)
RTOL = 1e-5


def _inputs(case, B=2, S=128, M=6, nc=80):
    rng = np.random.default_rng(["random", "padded", "empty_image",
                                 "init_like", "labels_clip"].index(case))
    maps = []
    for s in (8, 16, 32):
        m = rng.normal(0, 1, (B, S // s, S // s, 64 + nc))
        if case == "init_like":        # the head's init: box bias 1, cls low
            m[..., :64] = 1.0 + 0.1 * m[..., :64]
            m[..., 64:] = -8.0 + 0.1 * m[..., 64:]
        maps.append(m.astype(np.float32))
    xy = rng.uniform(0, S * 0.6, (B, M, 2))
    wh = rng.uniform(8, S * 0.4, (B, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    if case == "padded":
        mask[0, 3:] = False
        mask[1, 1:] = False
        boxes[~mask] = 0.0
    elif case == "empty_image":
        mask[1] = False
    elif case == "labels_clip":
        labels[0, 0] = nc + 3          # out of range: no class target
    return maps, labels, boxes, mask


@pytest.mark.parametrize("case", ["random", "padded", "empty_image",
                                  "init_like", "labels_clip"])
def test_loss_value_components_and_gradient(case):
    maps, labels, boxes, mask = _inputs(case)

    def f(ms):
        return jl.yolov8_loss(ms, jnp.asarray(labels), jnp.asarray(boxes),
                              jnp.asarray(mask))

    (ref, ref_m), ref_g = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(m) for m in maps])
    tm = [torch.from_numpy(m).requires_grad_() for m in maps]
    got, got_m = tl.yolov8_loss(tm, torch.from_numpy(labels),
                                torch.from_numpy(boxes),
                                torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    for k in ("box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(got_m[k].item(), float(ref_m[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    assert got_m["num_fg"].item() == float(ref_m["num_fg"])
    for t, r in zip(tm, ref_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_loss_takes_bf16_maps_in_f32():
    """bf16 raw maps (the forward under autocast) are cast to f32: the loss
    equals the f32 loss of the bf16-rounded maps."""
    maps, labels, boxes, mask = _inputs("random")
    args = (torch.from_numpy(labels), torch.from_numpy(boxes),
            torch.from_numpy(mask))
    bf = [torch.from_numpy(m).bfloat16() for m in maps]
    got, _ = tl.yolov8_loss(bf, *args)
    ref, _ = tl.yolov8_loss([m.float() for m in bf], *args)
    assert got.dtype == torch.float32
    assert got.item() == ref.item()


def test_return_aux():
    maps, labels, boxes, mask = _inputs("padded")
    _, _, ref = jl.yolov8_loss([jnp.asarray(m) for m in maps],
                               jnp.asarray(labels), jnp.asarray(boxes),
                               jnp.asarray(mask), return_aux=True)
    _, _, got = tl.yolov8_loss([torch.from_numpy(m) for m in maps],
                               torch.from_numpy(labels),
                               torch.from_numpy(boxes),
                               torch.from_numpy(mask), return_aux=True)
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["fg"].numpy(), np.asarray(ref["fg"]))
    np.testing.assert_array_equal(got["gt_idx"].numpy(),
                                  np.asarray(ref["gt_idx"]))
    for k in ("weight", "tss", "target_bboxes_px"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_df_loss(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (3, 50, 4, 16)).astype(np.float32)
    t = rng.uniform(0, 14.99, (3, 50, 4)).astype(np.float32)
    t[0, 0] = [0.0, 14.99, 7.0, 3.5]          # the ends and integers
    got = tl._df_loss(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(jl._df_loss(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the hat form equals the two-sided cross entropy
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    tt = torch.from_numpy(t)
    tlo = tt.long()
    wl = (tlo + 1).float() - tt
    ce = -(lp.gather(-1, tlo[..., None])[..., 0] * wl
           + lp.gather(-1, (tlo + 1)[..., None])[..., 0] * (1 - wl))
    np.testing.assert_allclose(got, ce.mean(-1).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_config_sections_and_build_loss():
    """The loss and optimizer sections carry tpucv's defaults, and
    ``build_loss`` is the loss with those gains."""
    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    ref = JCfg()
    assert vars(cfg.loss) == vars(ref.loss)
    assert vars(cfg.optimizer) == vars(ref.optimizer)
    assert (cfg.optimizer.name, cfg.optimizer.lr,
            cfg.optimizer.warmup_iters, cfg.optimizer.milestones) == \
        ("adam", 1e-3, 1000, (60, 80))
    loss_fn = algo_cls(cfg, device="cpu").build_loss()
    maps, labels, boxes, mask = _inputs("random")
    batch = {"gt_labels": torch.from_numpy(labels),
             "gt_bboxes": torch.from_numpy(boxes),
             "gt_mask": torch.from_numpy(mask)}
    got, _ = loss_fn([torch.from_numpy(m) for m in maps], batch)
    ref_v, _ = jl.yolov8_loss([jnp.asarray(m) for m in maps],
                              jnp.asarray(labels), jnp.asarray(boxes),
                              jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(ref_v), rtol=RTOL)
