"""Narrow-channel 3x3 conv probe: the CUDA kernel against the library.

The counterpart of scripts/probe_pallas_conv.py. For each of its six
shapes (3x3 stride-1 SAME, Cin = Cout = C, square NHWC input, HWIO
weight: the narrow convs of YOLOv8n p1-p3, SSD conv1_2 and CenterNet) it
runs the kernel tpucv_torch/csrc/conv3x3.cu in both modes (``halo``, with
the script's block height as the row tile, and ``rolling``), ``F.conv2d``
on channels_last bf16 (the library call) and the plain version. Each mode
is held against the plain version (no element further than 2^-7 of its
largest value) and, as the script holds its kernel against XLA, against
the library (relerr <= 2e-2). It prints ms, TF/s, GB/s and the share of
the card's bound (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s).

The TPU-only constraints on S, C and the block height are gone: the port
has no 128-lane packing.

    python -m tpucv_torch.probes.probe_conv                 # on the card
    python -m tpucv_torch.probes.probe_conv --device cpu --small
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpucv_torch.ops.conv3x3 import MODES, conv3x3, conv3x3_reference
from tpucv_torch.probes.common import (card, compare, conv_bound, conv_cost,
                                       conv_inputs, library_conv, parser,
                                       rate_line, resolve_device, tile_rows_of,
                                       timed)

# (tag, B, S, C, BHP), probe_pallas_conv.py:39-46; BHP (packed rows of
# 128/C pixels) becomes the halo mode's row tile
SHAPES = [
    ("y8n p3 64ch 80^2 B128", 128, 80, 64, 1600),
    ("y8n p2 32ch 160^2 B128", 128, 160, 32, 1600),
    ("y8n p1 16ch 320^2 B128", 128, 320, 16, 1600),
    ("ssd conv1_2 64ch 300^2 B64", 64, 300, 64, 1000),
    ("cn 64ch 96^2 B64", 64, 96, 64, 1536),
    ("probe 64ch 320^2 B32", 32, 320, 64, 3200),
]
SMALL_SHAPES = [
    ("tiny 16ch 12^2 B2", 2, 12, 16, 6),
    ("tiny 32ch 10^2 B1", 1, 10, 32, 8),
    ("tiny 64ch 9^2 B2", 2, 9, 64, 15),
]
LIBRARY_RELERR = 2e-2         # the script's bar against XLA


def run_shape(tag, B, S, C, bhp, dev, n=20, n_plain=3) -> List[dict]:
    x, w = conv_inputs(B, S, C, dev)
    nbytes, flops = conv_cost(B, S, C)
    bound_ms, bound_by = conv_bound(B, S, C)
    lib = library_conv(x, w)
    plain = conv3x3_reference(x, w)
    tile = tile_rows_of(bhp, C, S)
    rows = []
    lib_ms = timed(lambda: library_conv(x, w), n, dev)
    plain_ms = timed(lambda: conv3x3_reference(x, w), n_plain, dev)
    print(rate_line(f"{tag} F.conv2d", lib_ms, dev, flops, nbytes, bound_ms),
          flush=True)
    print(rate_line(f"{tag} plain", plain_ms, dev, flops, nbytes, bound_ms),
          flush=True)
    for mode in MODES:
        kw = {"mode": mode, "tile_rows": tile if mode == "halo" else None}
        got = conv3x3(x, w, **kw)
        bad, err, scale = compare(got, plain)
        _, lib_err, lib_scale = compare(got, lib)
        relerr = lib_err / lib_scale
        if bad or relerr > LIBRARY_RELERR:
            raise RuntimeError(f"{tag} {mode}: {bad} elements off the plain "
                               f"version (max err {err} at max {scale}); "
                               f"relerr {relerr} against F.conv2d")
        ms = timed(lambda: conv3x3(x, w, **kw), n, dev)
        print(rate_line(f"{tag} {mode}", ms, dev, flops, nbytes, bound_ms) +
              f"  relerr vs F.conv2d {relerr:.1e}", flush=True)
        rows.append({"tag": tag, "B": B, "S": S, "C": C, "mode": mode,
                     "variant": "full", "tile_rows": kw["tile_rows"],
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "mismatches": bad, "max_abs_err": err,
                     "relerr_vs_library": relerr})
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    print(f"probe_conv on {card(dev)}", flush=True)
    rows = []
    for shape in SMALL_SHAPES if args.small else SHAPES:
        rows += run_shape(*shape, dev)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
