"""Batched loader with background prefetch (counterpart of
``tpucv/data/loader.py``: the same batches in the same order).

Replaces torch DataLoader + collate (reference ``core/data/collate.py`` +
``num_workers`` worker processes): samples are already fixed-shape, so a
batch is a plain stack. Two prefetch engines:

* ``num_workers=0`` — one background thread builds batches (enough when the
  dataset is cheap or the host has one core).
* ``num_workers=N`` — N forked worker processes build batches into
  shared-memory rings (zero pickling of the 100+ MB image batches; the main
  process yields zero-copy views). Batches are delivered IN ORDER (worker w
  owns batches w, w+N, ...), and augmentation RNG is reseeded per
  (seed, epoch, batch) so the stream is identical for ANY worker count —
  unlike torch DataLoader, changing num_workers never changes the data.

The yielded arrays are valid until the next ``__next__`` call (the trainer
copies them to the device at once); pass ``copy_batches=True`` to detach.
Workers run numpy/cv2 dataset code only; they must never touch CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from multiprocessing import shared_memory
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def torch_cuda_initialized() -> bool:
    """Whether this process has initialised CUDA through torch; False when
    torch has not been imported at all."""
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def detection_collate(samples) -> Dict[str, np.ndarray]:
    if len(samples[0]) == 4:                # device_aug: + host_aug flag
        imgs, labels, masks, host_aug = zip(*samples)
    else:
        imgs, labels, masks = zip(*samples)
        host_aug = None
    lab = np.stack(labels)
    out = {
        "images": np.stack(imgs),
        "gt_labels": lab[..., 0].astype(np.int32),
        "gt_bboxes": lab[..., 1:5],
        "gt_mask": np.stack(masks),
    }
    if host_aug is not None:
        out["host_aug"] = np.asarray(host_aug, bool)
    return out


def segmentation_collate(samples) -> Dict[str, np.ndarray]:
    imgs, labels, _ = zip(*samples)
    return {"images": np.stack(imgs), "labels": np.stack(labels)}


def _reseed(ds, seed: int, epoch: int, batch_idx: int):
    """Per-batch deterministic augmentation stream (any worker count)."""
    if hasattr(ds, "_rng"):
        ds._rng = np.random.default_rng(
            (seed * 1000003 + epoch) * 1000003 + batch_idx)


class _ShmSlot:
    """One shared-memory batch slot: a dict of fixed-shape arrays."""

    def __init__(self, spec: Dict[str, Tuple[tuple, np.dtype]],
                 name: Optional[str] = None):
        offsets, off = {}, 0
        for k, (shape, dtype) in spec.items():
            off = (off + 127) & ~127           # 128B-align each array
            offsets[k] = off
            off += int(np.prod(shape)) * np.dtype(dtype).itemsize
        if name is None:
            self.shm = shared_memory.SharedMemory(create=True, size=max(off, 1))
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.spec, self.offsets = spec, offsets

    def views(self) -> Dict[str, np.ndarray]:
        return {
            k: np.ndarray(shape, dtype, buffer=self.shm.buf,
                          offset=self.offsets[k])
            for k, (shape, dtype) in self.spec.items()
        }

    def write(self, batch: Dict[str, np.ndarray]) -> int:
        """Write up to the slot capacity; returns the row count (the final
        batch of a drop_last=False epoch can be ragged)."""
        n = next(iter(batch.values())).shape[0]
        for k, v in self.views().items():
            v[:n] = batch[k]
        return n

    def close(self, unlink: bool = False):
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


def _mp_worker(ds, order, bs, wid, nw, n_batches, slot_names, spec,
               collate, seed, epoch, free_q, res_q, stop_ev):
    slots = [_ShmSlot(spec, name) for name in slot_names]
    try:
        for b in range(wid, n_batches, nw):
            while True:                         # bounded get → obeys stop
                if stop_ev.is_set():
                    return
                try:
                    s = free_q.get(timeout=0.2)
                    break
                except queue.Empty:
                    continue
            _reseed(ds, seed, epoch, b)
            idxs = order[b * bs:(b + 1) * bs]
            n = slots[s].write(collate([ds[int(i)] for i in idxs]))
            res_q.put((b, s, n))
    finally:
        for s in slots:
            s.close()


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 collate=detection_collate, num_workers: int = 0,
                 copy_batches: bool = False):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.collate = collate
        self.num_workers = num_workers
        self.copy_batches = copy_batches
        self.epoch = 0
        self._spec = None

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def _make_batch(self, order, b: int) -> Dict[str, np.ndarray]:
        _reseed(self.ds, self.seed, self.epoch, b)
        idxs = order[b * self.bs:(b + 1) * self.bs]
        return self.collate([self.ds[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers > 0:
            return self._iter_mp()
        return self._iter_thread()

    # ------------------------------------------------- thread prefetch
    def _iter_thread(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put so an abandoned iterator (e.g. max_steps break)
            # can't park the worker forever inside a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            for b in range(n_batches):
                if stop.is_set():
                    return
                if not put(self._make_batch(order, b)):
                    return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    # ------------------------------------------- multiprocess prefetch
    def _batch_spec(self) -> Dict[str, Tuple[tuple, np.dtype]]:
        if self._spec is None:
            one = self.collate([self.ds[0]])
            self._spec = {k: ((self.bs,) + v.shape[1:], v.dtype)
                          for k, v in one.items()}
        return self._spec

    def _iter_mp(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n_batches = len(self)
        nw = min(self.num_workers, max(n_batches, 1))
        spec = self._batch_spec()
        depth = max(self.prefetch, 2)
        # fork: datasets inherit via copy-on-write (no pickling). A CUDA
        # context does not survive a fork: a worker that touched CUDA would
        # fail or hang. Workers only run numpy/cv2 dataset code, which keeps
        # this safe, but warn so the failure mode is attributable.
        if torch_cuda_initialized():
            import warnings
            warnings.warn(
                "tpucv_torch Loader(num_workers>0) forks after CUDA "
                "initialisation; workers must not touch CUDA (they only run "
                "numpy/cv2 dataset code). If a worker hangs or fails at "
                "startup, create the Loader before the first CUDA call.",
                RuntimeWarning, stacklevel=3)
        ctx = mp.get_context("fork")

        slots: List[List[_ShmSlot]] = [
            [_ShmSlot(spec) for _ in range(depth)] for _ in range(nw)]
        free_qs = [ctx.Queue() for _ in range(nw)]
        res_qs = [ctx.Queue() for _ in range(nw)]
        stop_ev = ctx.Event()
        for w in range(nw):
            for s in range(depth):
                free_qs[w].put(s)

        procs = [
            ctx.Process(
                target=_mp_worker,
                args=(self.ds, order, self.bs, w, nw, n_batches,
                      [s.shm.name for s in slots[w]], spec, self.collate,
                      self.seed, self.epoch, free_qs[w], res_qs[w], stop_ev),
                daemon=True)
            for w in range(nw)
        ]
        for p in procs:
            p.start()

        held: Optional[Tuple[int, int]] = None   # (worker, slot) in use
        try:
            for b in range(n_batches):
                w = b % nw
                while True:
                    try:
                        bb, s, n = res_qs[w].get(timeout=5.0)
                        break
                    except queue.Empty:
                        if not procs[w].is_alive():
                            raise RuntimeError(
                                f"loader worker {w} died (exitcode "
                                f"{procs[w].exitcode})") from None
                assert bb == b, f"out-of-order batch {bb} != {b}"
                if held is not None:
                    free_qs[held[0]].put(held[1])
                views = {k: v[:n] for k, v in slots[w][s].views().items()}
                if self.copy_batches:
                    yield {k: v.copy() for k, v in views.items()}
                    free_qs[w].put(s)
                else:
                    held = (w, s)
                    yield views
        finally:
            stop_ev.set()
            for p in procs:
                p.join(timeout=2.0)
                if p.is_alive():
                    p.terminate()
            for row in slots:
                for s in row:
                    s.close(unlink=True)
