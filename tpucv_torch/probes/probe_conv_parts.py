"""Decompose the 3x3 conv kernel's cost on one shape (64ch 320^2 B32).

The counterpart of scripts/probe_pallas_conv_parts.py, with its case list.
Variants of tpucv_torch/csrc/conv3x3.cu in the halo mode; only ``full``
is the convolution, the others are timing decompositions, each held
against its own plain definition in ``conv3x3_reference``:

  full     the kernel (9 taps, the row tile plus a row above and below)
  nohalo   taps outside the CTA's row tile read zero (what the halo costs)
  noshift  all 9 taps read the centre pixel (what the shifts cost)
  gemm1    one tap, the centre (the product and pipeline floor)

The script's block height ``bhp`` (packed rows of 128/C pixels) becomes
the CTA's row tile: bhp * (128/C) / 320 image rows.

    python -m tpucv_torch.probes.probe_conv_parts                 # on the card
    python -m tpucv_torch.probes.probe_conv_parts --device cpu --small
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpucv_torch.probes.common import (card, parser, resolve_device,
                                       run_conv_cases, tile_rows_of)

B, S, C = 32, 320, 64
SMALL = (2, 16, 64)
# probe_pallas_conv_parts.py:126-135: (name, bhp, variant)
CASES = [
    ("full bhp=1280", 1280, "full"),
    ("full bhp=2560", 2560, "full"),
    ("full bhp=5120", 5120, "full"),
    ("full bhp=640", 640, "full"),
    ("nohalo bhp=1280", 1280, "nohalo"),
    ("noshift bhp=1280", 1280, "noshift"),
    ("gemm1 bhp=1280", 1280, "gemm1"),
    ("noshift bhp=5120", 5120, "noshift"),
]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    shape = SMALL if args.small else (B, S, C)
    print(f"probe_conv_parts on {card(dev)}: B, S, C = {shape}", flush=True)
    cases = [(name, tile_rows_of(bhp, C, S), "halo", variant)
             for name, bhp, variant in CASES]
    return run_conv_cases(cases, *shape, dev)


if __name__ == "__main__":
    main(sys.argv[1:])
