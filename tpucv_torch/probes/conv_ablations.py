"""Where the 3x3 conv kernel's time goes: ablated and retuned builds of
csrc/conv3x3.cu.

Each ablation is the kernel's source with one part cut out by a textual
edit, built into its own library beside the real one and timed on the
same inputs in one process, in turns (real, ablations..., real):

  nostore   the products run, the outputs are not written
  nomma     the loads and stores run, no products (zeros are stored)
  noload    no input row is loaded (products on whatever the ring holds)
  loadonly  nostore and nomma together: the loads alone
  cp_async_cg   the loads around L1 (cp.async.cg, L2 only)
  mma_sync  mma.sync m16n8k16 at every C (right outputs)

The cut builds compute wrong outputs by design: only their times mean
anything. Shapes: the probe shape 64ch 320^2 B32 (full and gemm1, halo
8-row tiles and rolling) and the y8n p1 / p2 shapes (rolling).

    python -m tpucv_torch.probes.conv_ablations           # on the card
"""

from __future__ import annotations

import ctypes
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from tpucv_torch.ops.conv3x3 import VARIANTS, conv3x3, rolling_tile_rows
from tpucv_torch.probes.common import (ablated_source, build_ablations, card,
                                       conv_bound, conv_inputs, parser,
                                       resolve_device, timed)

# name -> [(text in csrc/conv3x3.cu, its replacement), ...]
NO_STORE = ("if (px < n_valid)\n", "if (px < n_valid && v.x == 0x7fc00001u)\n")
NO_MMA = [("wgmma_n128(d, ", "if (dv == 7) wgmma_n128(d, "),
          ("mma16816(acc[i][nt], a, bfr[nt][0], bfr[nt][1]);",
           "if (a[0] == 0x12345u) acc[i][nt][0] += 1.0f;")]
ABLATIONS = {
    "nostore": [NO_STORE],
    "nomma": NO_MMA,
    "noload": [("cp_async16(slot + (c * kWp + p) * 16",
                "if (q == -7) cp_async16(slot + (c * kWp + p) * 16")],
    "loadonly": [NO_STORE, *NO_MMA],
    "cp_async_cg": [("cp.async.ca.shared.global", "cp.async.cg.shared.global")],
    "mma_sync": [("bool use_wgmma(int C) { return C == 64; }",
                  "bool use_wgmma(int C) { return false; }")],
}
# (tag, B, S, C, mode, variant, tile_rows or None: the rolling default)
CASES = [
    ("probe 64ch 320^2 B32", 32, 320, 64, "halo", "full", 8),
    ("probe 64ch 320^2 B32", 32, 320, 64, "rolling", "full", None),
    ("probe 64ch 320^2 B32", 32, 320, 64, "halo", "gemm1", 8),
    ("y8n p2 32ch 160^2 B128", 128, 160, 32, "rolling", "full", None),
    ("y8n p1 16ch 320^2 B128", 128, 320, 16, "rolling", "full", None),
    ("y8n p1 16ch 320^2 B128", 128, 320, 16, "rolling", "full", 80),
    ("y8n p1 16ch 320^2 B128", 128, 320, 16, "halo", "full", 40),
]


def _ablated_source(name: str) -> str:
    return ablated_source("conv3x3", ABLATIONS[name])


def _build_ablations(out_dir: Path) -> Dict[str, ctypes.CDLL]:
    libs = {}
    for name, path in build_ablations("conv3x3", ABLATIONS, out_dir).items():
        lib = ctypes.CDLL(str(path))
        lib.tpucv_conv3x3.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.tpucv_conv3x3.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(lib, x, w, y, variant, tile_rows):
    B, S, _, C = x.shape

    def run():
        err = lib.tpucv_conv3x3(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, S, C,
            VARIANTS.index(variant), tile_rows,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ablated conv3x3 launch failed: {err}")
    return run


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the ablations are CUDA builds: they run on the card")
    print(f"conv_ablations on {card(dev)}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_ablations(Path(tmp))
        for tag, B, S, C, mode, variant, tile in CASES:
            x, w = conv_inputs(B, S, C, dev)
            y = torch.empty_like(x)
            if tile is None:
                tile = rolling_tile_rows(B, S, C, dev)
            real = [timed(lambda: conv3x3(x, w, mode=mode, variant=variant,
                                          tile_rows=tile), 20, dev)]
            cut = {name: timed(_launcher(lib, x, w, y, variant, tile), 20, dev)
                   for name, lib in libs.items()}
            real.append(timed(lambda: conv3x3(x, w, mode=mode,
                                              variant=variant,
                                              tile_rows=tile), 20, dev))
            bound_ms, _ = conv_bound(B, S, C)
            row = {"tag": tag, "mode": mode, "variant": variant,
                   "tile_rows": tile, "ms": min(real), "ms_runs": real,
                   "bound_ms": bound_ms, **{f"{k}_ms": v
                                            for k, v in cut.items()}}
            print(f"{tag} {mode} {variant} tile={tile}: kernel "
                  f"{min(real):.4f} ms (runs {real[0]:.4f} {real[1]:.4f}), "
                  + ", ".join(f"{k} {v:.4f}" for k, v in cut.items())
                  + f"; bound {bound_ms:.4f}", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
