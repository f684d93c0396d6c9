"""Vision Transformer (counterpart of ``tpucv/models/vit.py``): patchify as
a strided conv, pre-norm blocks, learned position embeddings, a class
token.

flax's defaults, matched:
  * ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate="tanh")``;
  * ``nn.LayerNorm`` has eps 1e-6 (torch's default is 1e-5). flax computes
    the variance as E[x²] - E[x]², the port as E[(x - E[x])²], so f32
    outputs part by rounding (``tests/test_torch_vit.py`` bounds it);
  * ``nn.MultiHeadDotProductAttention`` projects q, k and v with separate
    ``DenseGeneral`` kernels (dim, heads, head_dim) and back with ``out``
    (heads, head_dim, dim); here each is an ``nn.Linear`` over the
    flattened heads (``ckpt/convert.py`` reshapes). The query is divided
    by sqrt(head_dim) before q·kᵀ, then softmax and the product with v,
    written out as tpucv does (no fused attention);
  * the tokens come out of the patchify conv in row-major (h, w) order,
    the class token (zeros at init) goes first, and ``pos_embed``
    (normal(0.02) at init) is locked to the input size: (1, 1 + (S/p)², dim).

``forward`` takes tpucv's NHWC input (B, S, S, 3) and returns the logits
(B, nc). Under bf16 autocast the residual stream is bf16, as tpucv's is
with ``dtype=bfloat16``; autocast runs LayerNorm and softmax in f32.

``state_dict`` keys follow tpucv's flax tree: ``patchify``, ``cls``,
``pos_embed``, ``block{i}.{ln1,attn.{query,key,value,out},ln2,mlp.fc1,
mlp.fc2}``, ``ln``, ``head``. At nc 10 and 224², ViT-S/16 has 21,669,514
parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpucv_torch.nn.blocks import Attention, init_weights

LN_EPS = 1e-6


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 dim: int = 384, depth: int = 12, heads: int = 6,
                 img_size: int = 224):
        super().__init__()
        self.depth = depth
        self.patchify = nn.Conv2d(3, dim, patch, patch)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        n_tokens = 1 + (img_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "ViT":
        """Random weights drawn from ``generator``: every kernel LeCun
        normal (std 1/sqrt(fan_in), flax's Dense and Conv init), biases 0,
        LayerNorm the identity, the class token 0 and ``pos_embed``
        normal(0.02), as tpucv initialises them."""
        init_weights(self, generator)
        with torch.no_grad():
            self.cls.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = self.patchify(x.permute(0, 3, 1, 2))            # NHWC -> NCHW
        x = x.flatten(2).transpose(1, 2)                    # (B, N, dim)
        cls = self.cls.to(x.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        # LayerNorm is per token: normalising token 0 alone equals reading
        # it from the normalised sequence, as tpucv does
        return self.head(self.ln(x[:, 0]))
