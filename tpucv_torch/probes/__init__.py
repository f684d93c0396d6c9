"""Measurement probes, the counterparts of tpucv's TPU probe scripts.

Each runs as ``python -m tpucv_torch.probes.<name>`` on the card (or with
``--device cpu --small`` on the plain versions at a tiny size) and has a
``main(argv)`` that returns its measurements as a list of dicts:

- ``probe_bw``          scripts/probe_pallas_bw.py: the streaming kernel
                        ``add_one`` and the card's HBM rate;
- ``probe_conv``        scripts/probe_pallas_conv.py: the 3x3 conv kernel
                        at six narrow-channel shapes against F.conv2d;
- ``probe_conv_parts``  scripts/probe_pallas_conv_parts.py: its cost
                        decomposition (nohalo, noshift, gemm1);
- ``probe_conv_v2``     scripts/probe_pallas_conv_v2.py: the v2
                        decomposition (nomask, rolling);
- ``int8_conv_parts``   no TPU script: the stages of the int8 PTQ conv
                        (quantize, im2col, ``torch._int_mm``, dequant)
                        against F.conv2d bf16.
"""
