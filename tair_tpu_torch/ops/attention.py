"""Attention primitives: one entry point for every scaled-dot-product
attention of the UNet, the ControlNet and the VAE.

Counterpart of ``tair_tpu/ops/attention.py``. ``sdpa`` goes through the flash
attention kernel for a CUDA tensor and through its plain version for a CPU
tensor; ``einsum_sdpa`` is the explicit reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_plain


def einsum_sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Reference: explicit einsum attention with a float32 softmax."""
    return flash_attention_plain(q, k, v, scale)[0]


def sdpa(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,  # [B, Tk, H, D]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, T, H, D] tensors."""
    return flash_attention(q, k, v, scale)[0]
