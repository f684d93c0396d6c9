"""The v2 decomposition of the 3x3 conv kernel (64ch 320^2 B32).

The counterpart of scripts/probe_pallas_conv_v2.py, with its case list.
The script's kernels map onto tpucv_torch/csrc/conv3x3.cu as:

  full, slab2   the convolution, halo mode (the TPU's prev/cur/next fetch;
                slab2 only moved the TPU's masks, which the port does not
                have: its zero padding is in the loaded rows)
  fullnomask,   variant ``nomask``, halo mode: no boundary predicates, tap
  slab2nomask   (du, dp) reads flat pixel r + (du-1)*S + (dp-1), zero only
                outside the tensor (what the masks cost)
  roll          the convolution, rolling mode (the lag-one rolling
                scratch: each input row loaded once a strip)

Each is held against its own plain definition. The script's block height
``bhp`` becomes the CTA's row tile (halo) or strip (rolling):
bhp * (128/C) / 320 image rows.

    python -m tpucv_torch.probes.probe_conv_v2                 # on the card
    python -m tpucv_torch.probes.probe_conv_v2 --device cpu --small
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpucv_torch.probes.common import (card, parser, resolve_device,
                                       run_conv_cases, tile_rows_of)
from tpucv_torch.probes.probe_conv_parts import B, C, S, SMALL

# probe_pallas_conv_v2.py:245-255: (name, bhp, the script's mode)
CASES = [
    ("full bhp=1280", 1280, "full"),
    ("fullnomask 1280", 1280, "fullnomask"),
    ("slab2 1280", 1280, "slab2"),
    ("slab2nomask 1280", 1280, "slab2nomask"),
    ("slab2 2560", 2560, "slab2"),
    ("slab2 3200", 3200, "slab2"),
    ("roll 1280", 1280, "roll"),
    ("roll 2560", 2560, "roll"),
    ("roll 3200", 3200, "roll"),
]
# the script's mode -> (the port's mode, variant)
PORT = {"full": ("halo", "full"), "slab2": ("halo", "full"),
        "fullnomask": ("halo", "nomask"), "slab2nomask": ("halo", "nomask"),
        "roll": ("rolling", "full")}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    shape = SMALL if args.small else (B, S, C)
    print(f"probe_conv_v2 on {card(dev)}: B, S, C = {shape}", flush=True)
    cases = [(name, tile_rows_of(bhp, C, S), *PORT[mode])
             for name, bhp, mode in CASES]
    return run_conv_cases(cases, *shape, dev)


if __name__ == "__main__":
    main(sys.argv[1:])
