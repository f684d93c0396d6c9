"""Narrow-channel 3x3 convolution through the hand-written CUDA kernel
``csrc/conv3x3.cu`` -- the counterpart of the Pallas probe kernels in
``scripts/probe_pallas_conv.py`` (``build_packed_conv``),
``scripts/probe_pallas_conv_v2.py`` (``make_roll``, ``make``) and
``scripts/probe_pallas_conv_parts.py`` (``make``).

``y = conv3x3(x, w)``: stride 1, SAME zero padding, x NHWC (B, S, S, C)
bf16, w HWIO (3, 3, C, C) bf16 (the JAX probes' layouts), f32 accumulation,
bf16 out, C in {16, 32, 64}.

Modes (one kernel, two job shapes; see the source's header): a job is a
tile of rows by ``COL_TILE`` columns, and a persistent grid (the CTAs that
fit on the card at once) walks the jobs. ``halo`` tiles are ``tile_rows``
rows, each also reading the row above and below; ``rolling`` tiles are
strips, each input row read once a strip.

Variants: ``full`` is the convolution. The TPU probes' timing-only
decompositions keep a plain definition each, so every one is checked:
``nohalo`` (taps outside the job's row tile read zero), ``noshift`` (all 9
taps read the centre pixel), ``gemm1`` (the centre tap alone) and
``nomask`` (tap (du, dp) reads flat pixel r + (du-1)*S + (dp-1) of the
(B*S*S, C) sequence, zero only outside the tensor).

``conv3x3`` is the kernel's wrapper: on a CUDA tensor it launches the
kernel or raises; on a CPU tensor, and only there, it runs
``conv3x3_reference``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

VARIANTS = ("full", "nohalo", "noshift", "gemm1", "nomask")
MODES = ("halo", "rolling")
CHANNELS = (16, 32, 64)
HALO_TILE_ROWS = 8            # halo mode's row tile when none is given
SMEM_MAX = 232448             # dynamic shared memory one block may use
COL_TILE = 128                # output columns a job covers
RING_ROWS = {16: 12, 32: 8, 64: 8}   # input rows the ring holds, by C


class Plan(NamedTuple):
    col_tile: int             # output columns a job covers
    col_tiles: int            # column tiles a row of S pixels takes
    ring_rows: int            # ring slots, one padded input row each
    smem_bytes: int           # dynamic shared memory a CTA takes
    warps: int                # warps a CTA
    wgmma: bool               # products by wgmma (else mma.sync)


def plan(S: int, C: int) -> Plan:
    """The kernel's plan (csrc/conv3x3.cu, ``tpucv_conv3x3_plan``): the
    weight as (tap, ci/8, co, ci%8), a ring of ``RING_ROWS[C]`` input rows of
    ``COL_TILE`` + 2 padded pixels, 16-byte chunk-planar, and the warps'
    output staging; 8 warps and wgmma at C=64, 4 warps and mma.sync below.
    C is one of ``CHANNELS``."""
    weight = 9 * C * C * 2
    slot = (COL_TILE + 2) * C * 2
    warps, tiles = (8, 2) if C == 64 else (4, 4)   # m16 tiles a warp
    stage = warps * min(tiles * 16 * C * 2, 2048)  # its tiles, <= 2 KB
    return Plan(COL_TILE, -(-S // COL_TILE), RING_ROWS[C],
                weight + RING_ROWS[C] * slot + stage, warps, C == 64)


def smem_bytes(S: int, C: int) -> int:
    """Shared memory one CTA needs at S, C (``plan(S, C).smem_bytes``)."""
    return plan(S, C).smem_bytes


def _check(x: torch.Tensor, w: torch.Tensor, variant: str,
           tile_rows: Optional[int]) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"conv3x3 wants x (B, S, S, C), got {tuple(x.shape)}")
    C = x.shape[3]
    if C not in CHANNELS:
        raise ValueError(f"conv3x3 takes C in {CHANNELS}, got {C}")
    if tuple(w.shape) != (3, 3, C, C):
        raise ValueError(f"conv3x3 wants w (3, 3, {C}, {C}) HWIO, got "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 wants bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 wants contiguous x and w")
    if variant == "nohalo" and not tile_rows:
        raise ValueError("the nohalo variant needs tile_rows")
    if tile_rows is not None and tile_rows < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")


def _tap_input(xf: torch.Tensor, padded: Optional[torch.Tensor], a: int,
               b: int,
               variant: str, tile_rows: Optional[int]) -> torch.Tensor:
    """What tap (row offset a, column offset b) reads for every output
    pixel, as (B*S*S, C) f32."""
    B, S, _, C = xf.shape
    if variant in ("noshift", "gemm1"):
        return xf.reshape(-1, C)
    if variant == "nomask":
        flat = xf.reshape(-1, C)
        n, s = flat.shape[0], a * S + b
        out = torch.zeros_like(flat)
        if 0 <= s < n:
            out[:n - s] = flat[s:]
        elif -n < s < 0:
            out[-s:] = flat[:n + s]
        return out
    src = padded[:, 1 + a:1 + a + S, 1 + b:1 + b + S]
    if variant == "nohalo":
        h = torch.arange(S, device=xf.device)
        same_tile = (h + a) // tile_rows == h // tile_rows
        src = src * same_tile.to(src.dtype)[None, :, None, None]
    return src.reshape(-1, C)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, variant: str = "full",
                      tile_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the explicit 9-tap shifted-matmul sum in f32,
    rounded once to bf16 (``tile_rows`` is read by ``nohalo`` alone)."""
    _check(x, w, variant, tile_rows)
    B, S, _, C = x.shape
    xf, wf = x.float(), w.float()
    padded = F.pad(xf, (0, 0, 1, 1, 1, 1)) \
        if variant in ("full", "nohalo") else None
    y = torch.zeros((B * S * S, C), dtype=torch.float32, device=x.device)
    for du in range(3):
        for dv in range(3):
            if variant == "gemm1" and (du, dv) != (1, 1):
                continue
            y += _tap_input(xf, padded, du - 1, dv - 1, variant,
                            tile_rows) @ wf[du, dv]
    return y.reshape(B, S, S, C).to(torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    from tpucv_torch import _build

    lib = _build.load("conv3x3")
    lib.tpucv_conv3x3.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.tpucv_conv3x3.restype = ctypes.c_int
    lib.tpucv_conv3x3_ctas_on_card.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.tpucv_conv3x3_ctas_on_card.restype = ctypes.c_int
    lib.tpucv_conv3x3_plan.argtypes = [ctypes.c_int] + \
        [ctypes.POINTER(ctypes.c_int)] * 5
    lib.tpucv_conv3x3_plan.restype = ctypes.c_int
    lib.tpucv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpucv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: "
                           f"{_lib().tpucv_cuda_error_string(err).decode()}")


def kernel_plan(C: int) -> Tuple[int, int, int, int, bool]:
    """(column tile, ring rows, shared-memory bytes, warps, wgmma) as the
    built kernel reports them, for holding ``plan`` against it on the
    card."""
    out = [ctypes.c_int(0) for _ in range(5)]
    _raise_if(_lib().tpucv_conv3x3_plan(C, *map(ctypes.byref, out)),
              f"conv3x3 plan (C={C})")
    *ints, wgmma = (v.value for v in out)
    return (*ints, bool(wgmma))


@functools.cache
def _ctas_on_card(C: int, device_index: int) -> Tuple[int, int]:
    """(CTAs that fit on the card at once, CTAs an SM) for C."""
    out, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _raise_if(_lib().tpucv_conv3x3_ctas_on_card(
            C, ctypes.byref(out), ctypes.byref(per_sm)),
            f"conv3x3 occupancy query (C={C})")
    return out.value, per_sm.value


def strips_for(B: int, S: int, col_tiles: int, ctas: int) -> int:
    """Strips an image for the rolling mode: the count whose waves of jobs
    (B * col_tiles * strips over ``ctas`` CTAs) take the fewest row steps,
    counting each strip's two halo rows; the fewest strips on a tie."""
    def cost(n):
        return -(-B * col_tiles * n // ctas) * (-(-S // n) + 2)
    return min(range(1, S + 1), key=cost)


def rolling_tile_rows(B: int, S: int, C: int, device: torch.device) -> int:
    """The rolling mode's strip height (``strips_for`` on this card)."""
    ctas, _ = _ctas_on_card(C, device.index or 0)
    return -(-S // strips_for(B, S, plan(S, C).col_tiles, ctas))


def conv3x3(x: torch.Tensor, w: torch.Tensor, mode: str = "rolling",
            variant: str = "full",
            tile_rows: Optional[int] = None) -> torch.Tensor:
    """3x3 stride-1 SAME convolution, NHWC x HWIO, bf16 in and out.

    CUDA tensors launch ``csrc/conv3x3.cu`` on the current stream and count
    the launch in ``conv3x3.launches``; CPU tensors run
    ``conv3x3_reference``. ``tile_rows`` is the halo mode's row tile
    (default ``HALO_TILE_ROWS``) or the rolling mode's strip height
    (default: ``strips_for``'s count a image). Any other input raises."""
    _check(x, w, variant, tile_rows)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    dev = x.device
    if dev.type == "cpu":
        return conv3x3_reference(x, w, variant, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"conv3x3 runs on cuda or cpu tensors, not {dev}")
    B, S, _, C = x.shape
    if smem_bytes(S, C) > SMEM_MAX:
        raise ValueError(f"conv3x3 kernel needs {smem_bytes(S, C)} B of "
                         f"shared memory at S={S}, C={C}; a block has "
                         f"{SMEM_MAX}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 wants 16-byte aligned x and w")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if tile_rows is None:
        tile_rows = HALO_TILE_ROWS if mode == "halo" else \
            rolling_tile_rows(B, S, C, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpucv_conv3x3(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, S, C,
            VARIANTS.index(variant), tile_rows, stream)
    _raise_if(err, f"conv3x3 kernel launch failed (B={B}, S={S}, C={C}, "
                   f"{mode}, {variant}, tile_rows={tile_rows})")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
