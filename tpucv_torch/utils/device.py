"""Device selection (counterpart of ``tpucv/utils/device.py``): the CUDA
device with the most free memory, as the reference's
``core/utils/device.py`` picks it."""

from __future__ import annotations

import torch


def get_device(prefer: str = "cuda") -> torch.device:
    """The CUDA device with the most free memory when ``prefer`` is
    ``"cuda"``; any other ``prefer`` names the device itself. Raises when
    CUDA is asked for and absent, rather than moving to the CPU."""
    if prefer != "cuda":
        return torch.device(prefer)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available here; pass 'cpu' to run "
                           "on the CPU")
    free = [torch.cuda.mem_get_info(i)[0]
            for i in range(torch.cuda.device_count())]
    return torch.device("cuda", max(range(len(free)), key=free.__getitem__))


def device_summary() -> str:
    if not torch.cuda.is_available():
        return "cpu (no CUDA device)"
    n = torch.cuda.device_count()
    return f"{n} x {torch.cuda.get_device_name(0)} (cuda {torch.version.cuda})"
