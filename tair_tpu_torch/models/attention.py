"""Spatial transformer blocks of the SD UNet.

Counterpart of ``tair_tpu/models/attention.py`` (the linear-projection variant
every configuration uses). Every attention goes through ``ops.attention.sdpa``;
every dense layer is quantizable (``layers.QuantLinear``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .layers import GroupNorm32, LayerNorm32, QuantLinear


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, heads: int, dim_head: int, query_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        # the heads this module runs: all of them, or under tensor
        # parallelism (parallel/tp.py) this process's
        self.heads = heads
        self.dim_head = dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.to_q = QuantLinear(query_dim, inner, bias=False)
        self.to_k = QuantLinear(ctx_dim, inner, bias=False)
        self.to_v = QuantLinear(ctx_dim, inner, bias=False)
        self.to_out = QuantLinear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        b, tq, _ = x.shape
        tk = ctx.shape[1]
        q = self.to_q(x).reshape(b, tq, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, tk, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, tk, self.heads, self.dim_head)
        out = sdpa(q, k, v).reshape(b, tq, self.heads * self.dim_head)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = QuantLinear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult)
        self.out = QuantLinear(dim * mult, dim)

    def forward(self, x):
        return self.out(self.geglu(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(heads, dim_head, dim)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(heads, dim_head, dim, context_dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x).to(x.dtype))
        x = x + self.attn2(self.norm2(x).to(x.dtype), context)
        x = x + self.ff(self.norm3(x).to(x.dtype))
        return x


class SpatialTransformer(nn.Module):
    """GroupNorm -> linear proj -> transformer blocks -> linear out, plus the
    input. NCHW in and out; tokens are the flattened spatial grid."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = QuantLinear(channels, inner)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim)
            for _ in range(depth)
        )
        self.proj_out = QuantLinear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for block in self.blocks:
            y = block(y, context)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
