"""tpucv_torch — the PyTorch and CUDA port of tpucv for NVIDIA Hopper.

The package mirrors ``tpucv``'s module paths and public function names, so
each piece has an obvious counterpart in the JAX package, which stays the
reference. Plain tensor code is PyTorch; each kernel tpucv wrote in Pallas
for the TPU is a kernel written by hand for ``sm_90a`` under ``csrc/``,
built on first use (``tpucv_torch/_build.py``).

Public functions keep tpucv's layouts: images are NHWC uint8, raw detection
maps are ``(B, H, W, 4*reg_max+nc)`` and boxes are xyxy in pixels. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
