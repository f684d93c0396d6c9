"""Host C++ libraries, loaded through ctypes (counterpart of
``tpucv/native/``).

The port's compute path is PyTorch and its CUDA kernels; the host work that
tpucv delegates to native code stays native here too: the COCOeval bbox
matcher (``cocoeval.cpp``, pycocotools' C core) and the threaded JPEG
decode (``imagepipe.cpp``). Each source is compiled by g++ at first use
into ``tpucv_torch/_build/`` (``_build.build_native``). Callers fall back
to their numpy / cv2 paths when a library cannot be built.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

_LOCK = threading.Lock()
_LIBS: dict = {}


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and dlopen ``native/<name>.cpp``'s library; None
    when it cannot be built or loaded."""
    from tpucv_torch import _build

    with _LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = ctypes.CDLL(str(_build.build_native(name)))
            except (OSError, RuntimeError):
                _LIBS[name] = None
        return _LIBS[name]
