"""BaseTrainer — the template-method epoch loop (counterpart of
``tpucv/trainer/base.py``; reference ``core/trainer/base.py:48-295``).

Same skeleton: ``__init__`` wires set_model_algorithm -> load_data ->
initialize_model -> set_optimizer -> set_criterion, ``train()`` owns the
epoch loop, resume, periodic eval + checkpoint, file log + TensorBoard.
Deltas from tpucv:
  * one device, no mesh: ``train.n_model > 1`` and ``train.zero_opt`` wait
    for the port's data parallelism (ROADMAP queue 1 item 14), and
    ``train.eval_map`` for its evaluation harness (item 4); each is
    refused by name rather than ignored;
  * the train state is built once, in ``set_optimizer``, and a resume
    loads into it in place;
  * the device-augmentation seed is the global step, so a resumed run
    draws the parameters an unbroken one would (tpucv's counter restarts
    at 0 on resume; in an unbroken run the two are the same).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpucv_torch.algorithms.base import resolve_device
from tpucv_torch.ckpt.checkpoint import CheckPoint
from tpucv_torch.ops.augment import AffineParams, augment_batch
from tpucv_torch.ops.preprocess import normalize_images
from tpucv_torch.train.state import (TrainState, make_eval_step,
                                     make_train_step)


class MeanMetric:
    """Streaming mean (reference base.py:31-45)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.total += float(v)
        self.count += 1

    def result(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


def _refuse_unported(cfg) -> None:
    t = cfg.train
    if t.n_model > 1:
        raise NotImplementedError(
            f"train.n_model={t.n_model}: channel sharding over a model axis "
            f"waits for the port's data parallelism (ROADMAP queue 1 item "
            f"14); use n_model=1")
    if t.zero_opt:
        raise NotImplementedError(
            "train.zero_opt: ZeRO-1 sharding of the Adam moments waits for "
            "the port's data parallelism (ROADMAP queue 1 item 14)")
    if t.eval_map:
        raise NotImplementedError(
            "train.eval_map: in-training mAP needs evaluate_on_coco / "
            "evaluate_on_voc, not ported yet (ROADMAP queue 1 item 4)")


class BaseTrainer:
    # True for trainers whose loss scales with the batch size (the YOLOv8
    # family's ``mean * B``); controls how grad_accum combines micro-grads
    # (see train/state.py make_train_step).
    LOSS_BATCH_SCALED = False

    def __init__(self, cfg, device="cuda"):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = (torch.bfloat16 if cfg.train.mixed_precision
                              else torch.float32)
        self._aug_seed = 0

        # the loaders come before the model: nothing has touched CUDA yet
        self.set_model_algorithm()
        self.load_data()
        self.initialize_model()
        self.set_optimizer()
        self.set_criterion()
        self._setup_logging()

    # --------------------------------------------------- subclass hooks
    def set_model_algorithm(self):
        raise NotImplementedError

    def load_data(self):
        raise NotImplementedError

    def initialize_model(self):
        self.model = self.algorithm.init_variables(seed=0)
        # pretrained bootstrap (reference use_pretrained_model decorator):
        # partial, shape-matched load from a port checkpoint or a .pth
        pw = self.cfg.train.pretrained_weights
        if pw:
            from tpucv_torch.ckpt.checkpoint import load_pretrained
            if os.path.exists(pw):
                load_pretrained(self.model, pw, self.cfg.model_name,
                                getattr(self, "logger", None))
            else:
                print(f"WARNING: pretrained_weights {pw!r} not found — "
                      f"training from scratch")

    def set_optimizer(self):
        self.state = TrainState.from_config(
            self.model, self.cfg.optimizer, max(len(self.train_loader), 1))
        self.lr_schedule = self.state.schedule

    def set_criterion(self):
        self.loss_fn = self.algorithm.build_loss()

    def build_train_step(self):
        """The train step of this config (``train.state.make_train_step``)."""
        t = self.cfg.train
        accum = max(1, t.grad_accum)
        if t.batch_size % accum:
            raise ValueError(f"train.grad_accum={accum} must divide "
                             f"batch_size={t.batch_size}")
        return make_train_step(
            self.loss_fn, device=self.device,
            ema_decay=self.cfg.optimizer.ema_decay, grad_accum=accum,
            loss_batch_scaled=self.LOSS_BATCH_SCALED,
            mixed_precision=t.mixed_precision)

    # ------------------------------------------------------- batch prep
    def device_batch(self, batch: Dict[str, np.ndarray],
                     train: bool = False) -> Dict[str, torch.Tensor]:
        """A host batch on the device, its images augmented (train, with
        ``device_aug``) or only normalised. Every array is copied before
        this returns, so the loader may reuse its buffers at once."""
        dev = self.device
        host_aug = batch.get("host_aug")
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, copy=True)
               for k, v in batch.items() if k != "host_aug"}
        use_dev_aug = (train and self.cfg.train.device_aug
                       and "gt_bboxes" in batch)
        if not use_dev_aug:
            out["images"] = normalize_images(out["images"], self.compute_dtype)
            return out
        # the parameters are drawn on the host from numpy, as tpucv draws
        # them, from a seed that counts the train batches
        B, S = batch["images"].shape[:2]
        rng = np.random.default_rng(self._aug_seed)
        self._aug_seed += 1
        scale = rng.uniform(0.5, 1.5, B).astype(np.float32)
        max_shift = np.maximum(S * (1.0 - scale), 0.0)
        shift = rng.random((B, 2)).astype(np.float32) * max_shift[:, None]
        flip = rng.random(B) < 0.5
        hsv = (1.0 + (rng.random((B, 3)) * 2 - 1)
               * np.array([0.1, 0.7, 0.4])).astype(np.float32)
        if host_aug is not None:
            # mosaic samples arrive fully augmented (incl. HSV) from the
            # host, like the reference's mosaic path: neutralise the device
            # affine/HSV so they are not augmented twice
            ha = np.asarray(host_aug, bool)
            scale[ha] = 1.0
            shift[ha] = 0.0
            flip[ha] = False
            hsv[ha] = 1.0
        params = AffineParams(*(torch.from_numpy(a).to(dev)
                                for a in (scale, shift, flip, hsv)))
        imgs, boxes = augment_batch(out["images"], out["gt_bboxes"], params,
                                    dtype=self.compute_dtype)
        out["images"] = imgs
        out["gt_bboxes"] = boxes
        # drop boxes augmented to degeneracy
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        out["gt_mask"] = out["gt_mask"] & (w > 2) & (h > 2)
        return out

    # ----------------------------------------------------------- logging
    def _setup_logging(self):
        os.makedirs(self.cfg.log.root, exist_ok=True)
        name = f"{self.cfg.model_name}_{self.cfg.dataset.name}"
        log_path = os.path.join(
            self.cfg.log.root, f"{name}_{time.strftime('%Y%m%d%H%M%S')}.log")
        self.logger = logging.getLogger(f"tpucv_torch.TRAIN.{name}")
        self.logger.setLevel(logging.INFO)
        for h in self.logger.handlers:
            h.close()
        self.logger.handlers.clear()
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        self.logger.addHandler(fh)
        self.logger.addHandler(logging.StreamHandler())
        self.tb = None
        if self.cfg.log.tensorboard_on:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(
                    os.path.join(self.cfg.log.tensorboard_dir, name))
            except Exception as e:  # noqa: BLE001 - logging is optional
                self.logger.info(f"tensorboard disabled: {e}")

    def _read_metrics(self, metrics: Dict[str, torch.Tensor]):
        """The step's metrics on the host: one copy, so one wait for the
        device."""
        vals = torch.stack([v.detach().float() for v in metrics.values()])
        return dict(zip(metrics, vals.tolist()))

    # ------------------------------------------------------------- train
    def train(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        state = self.state
        start_epoch = 0
        if cfg.train.resume_training and cfg.train.last_epoch >= 0:
            path = self._ckpt_path(cfg.train.last_epoch)
            CheckPoint.load(path, state)
            start_epoch = cfg.train.last_epoch + 1
            self.logger.info(f"resumed from {path}")
        train_step = self.build_train_step()

        self.logger.info(f"config: {cfg}")
        n_iter = len(self.train_loader)
        global_step = start_epoch * n_iter
        self._aug_seed = global_step
        done = False
        for epoch in range(start_epoch, cfg.train.epochs):
            self.train_loader.set_epoch(epoch)
            metrics_acc: Dict[str, MeanMetric] = {}
            t_ep = time.time()
            for bi, batch in enumerate(self.train_loader):
                state, metrics = train_step(
                    state, self.device_batch(batch, train=True))
                global_step += 1
                # metrics reach the host only here: a read on every step
                # would make the host wait for the device on every step
                if (bi + 1) % cfg.log.print_interval == 0 or bi == 0:
                    metrics = self._read_metrics(metrics)
                    # failure detection: a non-finite metric means the run
                    # is dead; save a diagnostic checkpoint and stop
                    if not all(np.isfinite(v) for v in metrics.values()):
                        path = self._ckpt_path(epoch).replace(
                            ".ckpt", "-diverged.ckpt")
                        CheckPoint.save(state, path)
                        self.logger.error(
                            f"non-finite metrics at epoch {epoch} step "
                            f"{bi + 1}: {metrics} — diagnostic state saved "
                            f"to {path}")
                        raise FloatingPointError(
                            f"training diverged (step {global_step}): "
                            f"{metrics}")
                    for k, v in metrics.items():
                        metrics_acc.setdefault(k, MeanMetric()).update(v)
                    lr = float(self.lr_schedule(global_step))
                    self.logger.info(
                        f"epoch {epoch} step {bi + 1}/{n_iter} lr={lr:.2e} "
                        + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                    if self.tb:
                        self.tb.add_scalar("lr", lr, global_step)
                        for k, v in metrics.items():
                            self.tb.add_scalar(f"train/{k}", v, global_step)
                if max_steps and global_step >= max_steps:
                    done = True
                    break
            ep_means = " ".join(
                f"{k}={m.result():.4f}" for k, m in metrics_acc.items())
            self.logger.info(
                f"epoch {epoch} done in {time.time() - t_ep:.1f}s "
                f"(means over logged steps: {ep_means})")
            if (epoch + 1) % cfg.train.eval_interval == 0:
                val = self.evaluate_loop(state)
                self.last_eval = val
                self.logger.info(f"eval epoch {epoch}: {val}")
                if self.tb:
                    for k, v in val.items():
                        self.tb.add_scalar(f"val/{k}", v, global_step)
            if (epoch + 1) % cfg.train.save_interval == 0 or done:
                path = self._ckpt_path(epoch)
                CheckPoint.save(state, path)
                self.logger.info(f"saved {path}")
            if done:
                break
        final = self._ckpt_path(cfg.train.epochs - 1, final=True)
        CheckPoint.save(state, final)
        self.logger.info(f"saved final {final}")
        return state

    def _ckpt_path(self, epoch: int, final: bool = False) -> str:
        tag = "final" if final else f"epoch-{epoch}"
        return os.path.join(
            self.cfg.train.save_path,
            f"{self.cfg.model_name}_{self.cfg.dataset.name}_{tag}.ckpt")

    # -------------------------------------------------------------- eval
    def evaluate_loop(self, state: TrainState) -> Dict[str, float]:
        """Mean val loss and components (reference yolo8_train.py:113-129)."""
        eval_step = getattr(self, "_eval_step", None)
        if eval_step is None:
            self._eval_step = eval_step = make_eval_step(
                self.loss_fn, device=self.device,
                mixed_precision=self.cfg.train.mixed_precision)
        acc: Dict[str, MeanMetric] = {}
        for batch in self.val_loader:
            metrics = self._read_metrics(
                eval_step(state, self.device_batch(batch)))
            for k, v in metrics.items():
                acc.setdefault(k, MeanMetric()).update(v)
        return {f"val_{k}": m.result() for k, m in acc.items()}
