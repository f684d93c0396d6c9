"""ctypes wrapper over the native host image pipeline (``imagepipe.cpp``;
counterpart of ``tpucv/native/imagepipe.py``).

Threaded JPEG decode and cv2-exact nearest geometry in C++: the host half
of the eval / predict input path (the port keeps resize, pad and normalise
on the device, so the host decodes and places the image on its canvas).
Every entry point returns None when the library is unavailable, or when
the system libjpeg fails the one-time decode check against cv2, and the
callers then take the cv2 path. Per-image failures (non-JPEG, CMYK,
corrupt, oversized) come back in the ``ok`` mask, so a caller recovers
just those images with cv2.
"""

from __future__ import annotations

import ctypes as C
import os
from typing import List, Optional, Tuple

import numpy as np

from tpucv_torch.native import load

_pu8 = C.POINTER(C.c_uint8)
_pi32 = C.POINTER(C.c_int32)


def _lib():
    lib = load("imagepipe")
    if lib is None:
        return None
    if not getattr(lib, "_sigs", False):
        lib.tpucv_decode_to_canvas.restype = C.c_int
        lib.tpucv_decode_to_canvas.argtypes = [
            C.POINTER(C.c_char_p), C.c_int, C.c_int,
            _pu8, _pi32, _pi32, _pu8, C.c_int]
        lib.tpucv_decode_jpeg.restype = C.c_int
        lib.tpucv_decode_jpeg.argtypes = [
            C.c_char_p, _pu8, C.c_int64, _pi32, _pi32]
        lib.tpucv_nearest_resize.restype = None
        lib.tpucv_nearest_resize.argtypes = [
            _pu8, C.c_int, C.c_int, _pu8, C.c_int, C.c_int]
        lib._sigs = True
    return lib


_PARITY: dict = {}


def _decode_parity_ok() -> bool:
    """One-time check: the system libjpeg this library links must decode
    as the libjpeg-turbo inside cv2 does, else native rows and cv2 rows in
    one batch would differ. Without cv2 there is no other path to differ
    from, so the check passes."""
    if "ok" not in _PARITY:
        _PARITY["ok"] = True
        try:
            import tempfile

            import cv2
            rng = np.random.default_rng(0)
            img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
            enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])[1]
            with tempfile.NamedTemporaryFile(suffix=".jpg") as f:
                f.write(enc.tobytes())
                f.flush()
                nat = _decode_jpeg_raw(f.name)
                ref = cv2.cvtColor(
                    cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
            _PARITY["ok"] = nat is not None and np.array_equal(nat, ref)
        except ImportError:
            pass
        except Exception:  # noqa: BLE001 - any failure means: use cv2
            _PARITY["ok"] = False
    return _PARITY["ok"]


def available() -> bool:
    return _lib() is not None and _decode_parity_ok()


def _paths_array(paths: List[str]):
    arr = (C.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def decode_to_canvas(paths: List[str], canvas: int,
                     out: Optional[np.ndarray] = None, n_threads: int = 0):
    """Decode JPEGs into the top-left of per-image uint8 canvases (the
    device letterbox's input layout, ``algorithms/base.py``), on
    ``n_threads`` threads (0: one a core; the bench measures 1, 2 and 4).
    Images larger than the canvas are nearest pre-shrunk to fit,
    with the cv2 path's geometry exactly.

    Returns ``(out, hw, orig, ok)``: out (N, canvas, canvas, 3) uint8,
    hw / orig (N, 2) int32 placed and original dims, ok (N,) bool; or None
    when the library is unavailable. ``out`` may be a preallocated
    (>= N, canvas, canvas, 3) C-contiguous uint8 array whose rows [0, N)
    are zeros: the native code writes each placed image and nothing else,
    so a failed row stays zero.
    """
    if not available():
        return None
    lib = _lib()
    n = len(paths)
    if out is None:
        out = np.zeros((n, canvas, canvas, 3), np.uint8)
    elif not (out.flags.c_contiguous and out.dtype == np.uint8
              and out.shape[1:] == (canvas, canvas, 3)
              and out.shape[0] >= n):
        raise ValueError(
            f"out must be C-contiguous uint8 (>= {n}, {canvas}, "
            f"{canvas}, 3); got {out.dtype} {out.shape}")
    hw = np.ones((n, 2), np.int32)
    orig = np.ones((n, 2), np.int32)
    ok = np.zeros(n, np.uint8)
    if n:
        lib.tpucv_decode_to_canvas(
            _paths_array(paths), n, canvas,
            out.ctypes.data_as(_pu8), hw.ctypes.data_as(_pi32),
            orig.ctypes.data_as(_pi32), ok.ctypes.data_as(_pu8),
            n_threads)
    return out, hw, orig, ok.astype(bool)


def _decode_jpeg_raw(path: str) -> Optional[np.ndarray]:
    """decode_jpeg without the parity gate (the parity check uses it)."""
    lib = _lib()
    if lib is None:
        return None
    h = C.c_int32(0)
    w = C.c_int32(0)
    # a probe buffer sized for typical images; a larger image costs only a
    # header parse before the exact-size retry
    cap = 1 << 22  # 4 MiB, up to about 1180x1180 RGB
    buf = np.empty(cap, np.uint8)
    rc = lib.tpucv_decode_jpeg(os.fsencode(path), buf.ctypes.data_as(_pu8),
                               cap, C.byref(h), C.byref(w))
    if rc == -2:
        cap = int(h.value) * int(w.value) * 3
        buf = np.empty(cap, np.uint8)
        rc = lib.tpucv_decode_jpeg(os.fsencode(path),
                                   buf.ctypes.data_as(_pu8), cap,
                                   C.byref(h), C.byref(w))
    if rc != 0:
        return None
    n = h.value * w.value * 3
    out = buf[:n].reshape(h.value, w.value, 3)
    # a small image must not pin the whole probe buffer through .base
    return out.copy() if n * 2 < buf.nbytes else out


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to RGB uint8 HWC; None on any failure (the caller
    falls back to cv2)."""
    if not _decode_parity_ok():
        return None
    return _decode_jpeg_raw(path)


def nearest_resize(img: np.ndarray,
                   size: Tuple[int, int]) -> Optional[np.ndarray]:
    """``cv2.resize(INTER_NEAREST)``-exact uint8 RGB resize to (h, w);
    None if the library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB uint8, got {img.shape}")
    h, w = size
    src = np.ascontiguousarray(img, np.uint8)
    dst = np.empty((h, w, 3), np.uint8)
    lib.tpucv_nearest_resize(src.ctypes.data_as(_pu8), src.shape[0],
                             src.shape[1], dst.ctypes.data_as(_pu8), h, w)
    return dst
