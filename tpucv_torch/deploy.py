"""Deploy-time reparameterisation (counterpart of the RepConv fold in
``tpucv/deploy.py``): ``RepConv``'s 3x3 + 1x1 (+ identity) branches,
each followed by its BatchNorm, fold into one biased 3x3 conv that gives
the eval-mode output before the SiLU. Export (``torch.export``) is not
ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

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
