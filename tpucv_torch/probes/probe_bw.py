"""What streaming rate does a trivial read-and-write pass reach on the card?

The counterpart of scripts/probe_pallas_bw.py. It times, each with the
script's fence fit measured(n) = real + K/n at n in {20, 100, 400}:

- ``torch.sum(x + 1, dtype=float32)``: eager PyTorch writes ``x + 1`` and
  reads it again, 3x the array's bytes (XLA fused it into one read);
- ``x + 1``, materialised: the library call for the kernel's function,
  2x the bytes;
- the CUDA kernel ``add_one`` (tpucv_torch/csrc/stream.cu) on the script's
  six (rows, cols) views of the same 1,638,400 x 128 bf16 array (419 MB),
  2x the bytes. The script's Pallas block height ``bh`` is a TPU VMEM knob
  with no counterpart; the views stay, and equal times show the kernel is
  blind to shape. Each view is first checked bit for bit against
  ``add_one_reference``.

    python -m tpucv_torch.probes.probe_bw                 # on the card
    python -m tpucv_torch.probes.probe_bw --device cpu --small
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from tpucv_torch.ops.stream import add_one, add_one_reference
from tpucv_torch.probes.common import (card, fence_fit, parser,
                                       resolve_device, stream_bound_ms)

TOT = 1_638_400               # rows of 128 = 419,430,400 B of bf16
SMALL_TOT = 1024
# the script's (rows, cols, bh) cases, probe_pallas_bw.py:89-92
VIEWS = [(1, 128, 1280), (1, 128, 3200), (1, 128, 10240),
         (16, 2048, 400), (16, 2048, 1600), (64, 8192, 400)]


def views(tot: int):
    """(rows, cols, TPU bh) of the six views of a (tot, 128) array."""
    return [(tot // div, cols, bh) for div, cols, bh in VIEWS]


def mismatches(x: torch.Tensor) -> int:
    """Elements where the kernel's bits differ from ``x + 1``'s."""
    got = add_one(x).view(torch.int16)
    return int((got != add_one_reference(x).view(torch.int16)).sum())


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    tot = SMALL_TOT if args.small else TOT
    ns = (2, 4, 8) if args.small else (20, 100, 400)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((tot, 128), generator=g, device=dev).to(torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    print(f"probe_bw on {card(dev)}: {tot}x128 bf16, {nbytes} B", flush=True)

    rows = []

    def report(name, moved, fn, bad=0):
        real, k, pts = fence_fit(fn, dev, ns)
        raw = "  ".join(f"n={n}:{ms:.4f}" for n, ms in pts)
        gbs = moved / (real * 1e-3) / 1e9 if dev.type == "cuda" else None
        rate = "(cpu)" if gbs is None else f"{gbs:7.0f} GB/s"
        print(f"{name:44s} real {real:8.4f} ms  {rate}   (fence "
              f"K={k:.4f} ms; raw {raw})", flush=True)
        rows.append({"name": name, "bytes": moved, "ms": real, "fence_k_ms": k,
                     "points": pts, "gb_per_s": gbs,
                     "bound_ms": stream_bound_ms(moved), "mismatches": bad})

    report(f"torch add1+sum (r+w+r {3 * nbytes} B)", 3 * nbytes,
           lambda: torch.sum(x + 1, dtype=torch.float32))
    report(f"torch add1 materialized (r+w {2 * nbytes} B)", 2 * nbytes,
           lambda: add_one_reference(x))
    for r, c, bh in views(tot):
        xx = x.view(r, c)
        bad = mismatches(xx)
        if bad:
            raise RuntimeError(f"add_one ({r}x{c}): {bad} elements differ "
                               f"from x + 1")
        report(f"kernel add_one r+w ({r}x{c}; TPU bh={bh})", 2 * nbytes,
               lambda xx=xx: add_one(xx), bad)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
