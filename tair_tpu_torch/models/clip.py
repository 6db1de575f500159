"""OpenCLIP text tower, penultimate-layer embeddings.

Counterpart of ``tair_tpu/models/clip.py``: token + positional embedding,
pre-LN causal transformer run through ``layers - 1`` blocks, then ``ln_final``.
Output ``[B, 77, width]`` float32. Its causal attention is plain PyTorch, as
it is plain JAX in the reference. Tokenisation is not part of this module.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm32, MultiHeadAttention


@dataclass(frozen=True)
class CLIPTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    mlp_ratio: int = 4
    # "penultimate" runs layers-1 blocks; "last" runs all of them.
    layer: str = "penultimate"
    # OpenCLIP uses exact GELU; original OpenAI CLIP checkpoints QuickGELU.
    act: str = "gelu"


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: int, act: str = "gelu"):
        super().__init__()
        self.act = act
        self.ln_1 = LayerNorm32(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = LayerNorm32(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, width * mlp_ratio)
        self.mlp_proj = nn.Linear(width * mlp_ratio, width)

    def forward(self, x, mask):
        h = self.ln_1(x).to(x.dtype)
        x = x + self.attn(h, h, h, mask)
        h = self.ln_2(x).to(x.dtype)
        return x + self.mlp_proj(_act(self.act, self.mlp_fc(h)))


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width)
        )
        n_blocks = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, cfg.mlp_ratio, cfg.act)
            for _ in range(n_blocks)
        )
        self.ln_final = LayerNorm32(cfg.width, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, 77] integer -> [B, 77, width] float32 embeddings."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens.long())
        x = x + self.positional_embedding[:t].to(x.dtype)
        causal = torch.ones(t, t, dtype=torch.bool, device=tokens.device).tril()
        for block in self.blocks:
            x = block(x, causal)
        return self.ln_final(x)
