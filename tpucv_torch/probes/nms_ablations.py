"""Where the NMS kernels' time goes: ablated and retuned builds of
csrc/nms.cu.

Each ablation is the kernels' source with one part cut out or changed by
a textual edit, built into its own library beside the real one; each
library's build and walk are timed alone, on the same inputs in one
process, in turns (real, ablations..., real):

  nochain      block w's boxes are not resolved against its diagonal words
  norows       the kept boxes' rows are not ORed into the removed words
  nobarrier    no barrier a block (the ring races: timing only)
  noprefetch   warps 1-3 load nothing (the walk reads stale shared memory)
  rows_branch  a branch around each kept row's load (right keep masks)
  zero_divides disjoint pairs divide too (right masks)
  warp_divides a warp of disjoint pairs divides too, with operands 1 / 1
               (right masks)
  fast_divide  __fdividef for the IoU (approximate: timing only)

The cut builds compute wrong results by design: only their times mean
anything. Shapes: the served B=8 K=1024 and the bench's B=128 K=512/1024,
class-offset sets from tpucv_torch/ops/nms_cases.py, score-sorted. With
``--sass`` the real library's SASS is written to chiprun_out/nms.sass.

    python -m tpucv_torch.probes.nms_ablations           # on the card
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

import torch

from tpucv_torch import _build
from tpucv_torch.ops.cuda_nms import nms_keep, timing_launchers, typed
from tpucv_torch.ops.nms_cases import class_offset_case
from tpucv_torch.probes.common import (ablated_source, build_ablations,
                                       card, parser, resolve_device,
                                       timed_queued)

# name -> [(text in csrc/nms.cu, its replacement), ...]
CHAIN = "if (((valid & ~r) >> b) & 1u) r |= d[b];"
ROWS = "acc[b & 3] = or_if(acc[b & 3], kept & (1u << b),"
ABLATIONS = {
    "nochain": [(CHAIN, "if (b == 40) r |= d[b];")],
    "norows": [(ROWS, "if (b == 40) " + ROWS)],
    "nobarrier": [("__syncthreads();                   // ... for all",
                   "// no barrier")],
    "noprefetch": [("cp_async16(s_ring[slot] + b * kMaxWords",
                    "if (c < 0) cp_async16(s_ring[slot] + b * kMaxWords"),
                   ("if (warp == 1) cp_async4(", "if (warp == 7) cp_async4(")],
    "rows_branch": [(ROWS, "if ((kept >> b) & 1u) "
                           "acc[b & 3] = or_if(acc[b & 3], 1u,")],
    "zero_divides": [("const bool zero = inter == 0.0f && denom > 0.0f;",
                      "const bool zero = false;")],
    "warp_divides": [("if (__all_sync(kFull, zero)) return 0.0f > thr;", "")],
    "fast_divide": [("__fdiv_rn(zero ? 1.0f : inter, zero ? 1.0f : denom)",
                     "__fdividef(inter, denom)")],
}
SHAPES = [(8, 1024, 0.45), (128, 512, 0.7), (128, 1024, 0.7)]


def _ablated_source(name: str) -> str:
    return ablated_source("nms", ABLATIONS[name])


def _sass(path: Path) -> None:
    lib = _build.lib_path("nms")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(out)
    print(f"SASS of {lib.name}: {path} ({len(out.splitlines())} lines)",
          flush=True)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = parser(__doc__)
    p.add_argument("--sass", action="store_true",
                   help="write the real library's SASS to chiprun_out/")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the ablations are CUDA builds: they run on the card")
    print(f"nms_ablations on {card(dev)}", flush=True)
    _build.build(["nms"])
    if args.sass:
        _sass(Path.cwd() / "chiprun_out" / "nms.sass")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: typed(ctypes.CDLL(str(path))) for name, path in
                build_ablations("nms", ABLATIONS, Path(tmp)).items()}
        for B, K, thr in SHAPES:
            boxes, scores = class_offset_case(K + B, B, K)
            sb = torch.from_numpy(boxes).to(dev)
            ss = torch.from_numpy(scores).to(dev)
            build, walk = timing_launchers(sb, ss, thr)
            build()
            cut = {name: timing_launchers(sb, ss, thr, lib)
                   for name, lib in libs.items()}
            for b, _ in cut.values():
                b()
            real = [(timed_queued(build, 50, dev), timed_queued(walk, 50, dev))]
            times = {name: (timed_queued(b, 50, dev), timed_queued(w, 50, dev))
                     for name, (b, w) in cut.items()}
            real.append((timed_queued(build, 50, dev),
                         timed_queued(walk, 50, dev)))
            whole = timed_queued(lambda: nms_keep(sb, ss, thr), 50, dev)
            row = {"B": B, "K": K, "nms_keep_ms": whole,
                   "build_ms": min(t[0] for t in real),
                   "walk_ms": min(t[1] for t in real), "real_runs": real,
                   **{f"{k}_build_ms": v[0] for k, v in times.items()},
                   **{f"{k}_walk_ms": v[1] for k, v in times.items()}}
            print(f"B={B} K={K}: nms_keep {whole:.4f} ms; build / walk: real "
                  f"{row['build_ms']:.4f} / {row['walk_ms']:.4f} (runs "
                  + " ".join(f"{b:.4f}/{w:.4f}" for b, w in real) + "), "
                  + ", ".join(f"{k} {b:.4f} / {w:.4f}"
                              for k, (b, w) in times.items()), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
