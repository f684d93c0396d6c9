"""Deployment / export (counterpart of ``tpucv/deploy.py``).

tpucv exports its jitted inference function as StableHLO and compiles it
ahead of time; the port does the same on ``torch.export`` and
``torch.compile``, under the same four names:

- ``export_stablehlo(fn, *args)``: the text of the exported program;
- ``export_serialized(fn, *args)``: the artifact's bytes
  (``torch.export.save``);
- ``load_serialized(data)``: a callable from those bytes, without the code
  that builds the model;
- ``aot_compile(fn, *args)``: a compiled callable locked to the example
  arguments' shapes.

``fn`` is an ``nn.Module`` or a function of tensors; a function is
exported through a module that holds every ``nn.Module`` its closure
refers to, so their weights travel as the program's parameters and
buffers. The NMS stays the hand-written kernel in every form: its wrapper
calls the ``tpucv::nms_keep`` operator (``ops/cuda_nms.py``), which
``torch.export`` records as one node and ``torch.compile`` leaves opaque.

Also the RepConv fold: ``RepConv``'s 3x3 + 1x1 (+ identity) branches,
each followed by its BatchNorm, fold into one biased 3x3 conv that gives
the eval-mode output before the SiLU.
"""

from __future__ import annotations

import io
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BNStats = Mapping[str, torch.Tensor]   # weight, bias, running_mean, running_var


def _fold(k: torch.Tensor, bn: BNStats, eps: float):
    t = bn["weight"] / torch.sqrt(bn["running_var"] + eps)
    return k * t[:, None, None, None], bn["bias"] - bn["running_mean"] * t


def fuse_repconv_params(dense_k: torch.Tensor, dense_bn: BNStats,
                        one_k: torch.Tensor, one_bn: BNStats,
                        id_bn: Optional[BNStats] = None,
                        eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the branches into (kernel (O, I, 3, 3), bias (O,)).

    ``dense_k`` is the 3x3 kernel and ``one_k`` the 1x1, OIHW; each BN is
    its ``state_dict`` leaves. The 1x1 kernel lands on the 3x3's centre
    tap; the identity branch is the unit kernel on that tap, folded with
    ``id_bn``. BN eps is RepConv's (1e-3)."""
    k3, b3 = _fold(dense_k, dense_bn, eps)
    k1, b1 = _fold(one_k, one_bn, eps)
    k = k3 + F.pad(k1, (1, 1, 1, 1))
    b = b3 + b1
    if id_bn is not None:
        cin = k3.shape[1]
        ident = torch.zeros_like(k3)
        ident[torch.arange(cin), torch.arange(cin), 1, 1] = 1.0
        ki, bi = _fold(ident, id_bn, eps)
        k, b = k + ki, b + bi
    return k, b


class _Program(nn.Module):
    """A function of tensors as a module: the ``nn.Module``s its closure
    refers to become submodules, so ``torch.export`` lifts their weights
    as the program's parameters and buffers rather than constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn
        cells = getattr(fn, "__closure__", None) or ()
        for i, cell in enumerate(cells):
            try:
                value = cell.cell_contents
            except ValueError:           # an empty cell
                continue
            if isinstance(value, nn.Module):
                self.add_module(f"m{i}", value)

    def forward(self, *args):
        return self.fn(*args)


def _module(fn) -> nn.Module:
    return fn if isinstance(fn, nn.Module) else _Program(fn)


def _export(fn, *example_args) -> torch.export.ExportedProgram:
    """``fn`` exported, its ``autocast`` regions traced into the casts
    they made (``run_decompositions({})``, which decomposes no operator).
    Kept as regions, they run autocast again when the loaded program runs,
    and under CUDA's autocast the int8 forward's tensors then part from
    their traced dtypes (a ``cat`` traced bf16 comes out f32, and the
    loaded program's dtype assertion fails)."""
    with torch.no_grad():
        return torch.export.export(
            _module(fn), tuple(example_args)).run_decompositions({})


def export_stablehlo(fn, *example_args) -> str:
    """The text of ``fn``'s exported program at the example arguments: the
    ``torch.export`` ExportedProgram graph (its ATen and custom operators,
    ``tpucv.nms_keep`` among them, and its signature). It is the name's
    counterpart of tpucv's StableHLO text, not StableHLO."""
    return str(_export(fn, *example_args))


def export_serialized(fn, *example_args) -> bytes:
    """A serving artifact: ``fn`` exported at the example arguments (fixed
    shapes) and written by ``torch.export.save``, weights included."""
    buf = io.BytesIO()
    torch.export.save(_export(fn, *example_args), buf)
    return buf.getvalue()


def load_serialized(data: bytes) -> nn.Module:
    """A callable from ``export_serialized``'s bytes: the program's module
    (``torch.export.load(...).module()``), its weights frozen, as a
    serving artifact's are. It needs the ``tpucv::nms_keep`` operator
    registered, which importing ``tpucv_torch.ops`` does, and no code that
    builds a model."""
    import tpucv_torch.ops  # noqa: F401  (registers tpucv::nms_keep)

    return torch.export.load(io.BytesIO(data)).module().requires_grad_(False)


class Compiled:
    """``aot_compile``'s result: the compiled function and the signature
    (shape, dtype, device of each argument) it was compiled for. Another
    signature raises, as a JAX ``Compiled`` does."""

    def __init__(self, fn: Callable, example_args):
        self.signature = self._signature(example_args)
        self.fn = torch.compile(fn, fullgraph=True, dynamic=False)
        with torch.no_grad():
            self.fn(*example_args)                    # compile it now

    @staticmethod
    def _signature(args):
        return tuple((tuple(a.shape), a.dtype, a.device.type)
                     if isinstance(a, torch.Tensor) else a for a in args)

    def __call__(self, *args):
        got = self._signature(args)
        if got != self.signature:
            raise TypeError(f"aot_compile: compiled for {self.signature}, "
                            f"called with {got}")
        with torch.no_grad():
            return self.fn(*args)


def aot_compile(fn, *example_args) -> Compiled:
    """Compile ``fn`` ahead of time for the example arguments, as tpucv's
    ``jax.jit(fn).lower(*args).compile()``: ``torch.compile(fullgraph=
    True, dynamic=False)``, run once at the example arguments so the
    compile happens here; the result raises on any other shape or dtype."""
    return Compiled(fn, example_args)
