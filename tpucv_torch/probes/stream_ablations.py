"""What add_one's launch choices cost: edited builds of csrc/stream.cu.

The kernel is one 16-byte vector a thread, 1,024-thread CTAs, one CTA a
chunk and the streaming ld/st.global.cs hints. Each edit below changes one
of those by a textual edit of the source, built into its own library
beside the real one:

  nc          ld.global.nc loads and plain stores
  threads256  256-thread CTAs
  unroll2/4/8 U vectors a thread, their U loads issued before any store
              (one CTA a chunk of 1,024 U vectors)
  persistent  2,048 threads an SM of CTAs that stride over the vectors

Every edit computes ``x + 1``: each build is first checked bit for bit on
the probe's array and on a length with a tail, then timed on
probe_bw's 1,638,400 x 128 bf16 array in turns, with ``torch.add(x, 1)``
first and last (torch.add, real, edits..., edits reversed, real,
torch.add; the lower of each pair).

    python -m tpucv_torch.probes.stream_ablations         # on the card
"""

from __future__ import annotations

import ctypes
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

import torch

from tpucv_torch import _build
from tpucv_torch.ops.stream import add_one_reference, launch, typed
from tpucv_torch.probes.common import (ablated_source, build_ablations, card,
                                       parser, resolve_device,
                                       stream_bound_ms, timed)
from tpucv_torch.probes.probe_bw import TOT

# the texts of csrc/stream.cu that the edits replace
BODY = ("const Index i = static_cast<Index>(blockIdx.x) * kThreads + "
        "threadIdx.x;\n  if (i < n_vec) __stcs(out + i, "
        "add_one_vec(__ldcs(in + i)));")
GRID = "const long long grid = (n_vec + kThreads - 1) / kThreads;"
BITS = "out[2] = n_vec + kThreads <= 0xffffffffll ? 32 : 64;"
CLAMP = "out[1] = grid < 1 ? 1 : grid;"


def _unrolled(u: int):
    return [
        (BODY, f"""const Index i0 = static_cast<Index>(blockIdx.x) * (kThreads * {u}) +
                   threadIdx.x;
  uint4 v[{u}];
#pragma unroll
  for (int u = 0; u < {u}; ++u)
    if (i0 + u * kThreads < n_vec) v[u] = __ldcs(in + i0 + u * kThreads);
#pragma unroll
  for (int u = 0; u < {u}; ++u)
    if (i0 + u * kThreads < n_vec)
      __stcs(out + i0 + u * kThreads, add_one_vec(v[u]));"""),
        (GRID, f"const long long grid = (n_vec + kThreads * {u} - 1) / "
               f"(kThreads * {u});"),
        (BITS, f"out[2] = n_vec + kThreads * {u} <= 0xffffffffll ? 32 : 64;"),
    ]


ABLATIONS = {
    "nc": [("__stcs(out + i, add_one_vec(__ldcs(in + i)))",
            "out[i] = add_one_vec(__ldg(in + i))")],
    "threads256": [("constexpr int kThreads = 1024;",
                    "constexpr int kThreads = 256;")],
    "unroll2": _unrolled(2),
    "unroll4": _unrolled(4),
    "unroll8": _unrolled(8),
    "persistent": [
        (BODY, "for (Index i = static_cast<Index>(blockIdx.x) * kThreads + "
               "threadIdx.x; i < n_vec;\n       i += static_cast<Index>"
               "(gridDim.x) * kThreads)\n    __stcs(out + i, "
               "add_one_vec(__ldcs(in + i)));"),
        (CLAMP, "int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n  "
                "cudaDeviceGetAttribute(&sms, "
                "cudaDevAttrMultiProcessorCount, dev);\n  "
                "const long long cap = 2048 / kThreads * sms;\n  "
                "out[1] = grid < 1 ? 1 : (grid < cap ? grid : cap);"),
    ],
}


def _ablated_source(name: str) -> str:
    return ablated_source("stream", ABLATIONS[name])


def _mismatches(x: torch.Tensor, lib: ctypes.CDLL) -> int:
    got = launch(x, lib).view(torch.int16)
    return int((got != add_one_reference(x).view(torch.int16)).sum())


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the ablations are CUDA builds: they run on the card")
    print(f"stream_ablations on {card(dev)}", flush=True)
    _build.build(["stream"])
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((TOT, 128), generator=g, device=dev).to(torch.bfloat16)
    tail = x.view(-1)[:3 * 8 * 8192 + 8 * 517 + 5]
    bound = stream_bound_ms(2 * x.numel() * x.element_size())
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": None}
        libs.update({name: typed(ctypes.CDLL(str(path))) for name, path in
                     build_ablations("stream", ABLATIONS, Path(tmp)).items()})
        for name, lib in libs.items():
            bad = _mismatches(x, lib) + _mismatches(tail, lib)
            if bad:
                raise RuntimeError(f"add_one {name}: {bad} elements differ "
                                   f"from x + 1")
        order = list(libs)
        times = {name: [] for name in order}
        library = [timed(lambda: torch.add(x, 1), 50, dev)]
        for name in order + order[::-1]:
            times[name].append(timed(lambda: launch(x, libs[name]), 50, dev))
        library.append(timed(lambda: torch.add(x, 1), 50, dev))
        for name in order:
            row = {"name": name, "ms": min(times[name]),
                   "ms_runs": times[name], "library_ms": min(library),
                   "library_ms_runs": library, "bound_ms": bound,
                   "mismatches": 0}
            print(f"add_one {name:10s} {row['ms']:.4f} ms (runs "
                  + " ".join(f"{t:.4f}" for t in times[name])
                  + f")   torch.add {row['library_ms']:.4f} ms   bound "
                  f"{bound:.4f} ms", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
