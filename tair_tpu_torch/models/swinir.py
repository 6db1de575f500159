"""SwinIR restoration cleaner.

Counterpart of ``tair_tpu/models/swinir.py`` in the configuration the system
uses: pixel-unshuffle x8 input, RSTB layers of Swin blocks with window
attention (relative-position bias, shift mask, plain einsum), 'nearest+conv'
x8 upsampler, '1conv' residual connection. ``forward`` takes and returns NHWC
in [0, 1]; the Swin blocks work on NHWC tokens, the convolutions on NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device_constants import cached
from .layers import LayerNorm32, conv3x3, nearest_upsample_2x, to_nchw, to_nhwc

_MEAN = (0.4488, 0.4371, 0.4040)  # the RGB mean subtracted from the input


@dataclass(frozen=True)
class SwinIRConfig:
    in_chans: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    sf: int = 8
    img_range: float = 1.0
    unshuffle: bool = True
    unshuffle_scale: int = 8
    num_feat: int = 64


def _rel_pos_index(window: int) -> np.ndarray:
    """Static [w*w, w*w] index into the (2w-1)^2 relative position table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).astype(np.int64)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask [nW, N, N] for shifted-window attention (on the
    device, made once per geometry: a copy from the host in every block would
    wait for the device each time)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, window*window, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_merge(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads)
        )
        self.register_buffer(
            "rel_pos_index", torch.from_numpy(_rel_pos_index(window)), persistent=False
        )

    def forward(self, x, mask):
        """x: [B_, N, C] windows; mask: None or [nW, N, N] additive."""
        b_, n, c = x.shape
        head_dim = c // self.heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, self.heads, head_dim).unbind(dim=2)
        bias = self.rel_pos_bias_table.float()[self.rel_pos_index.reshape(-1)]
        bias = bias.reshape(n, n, self.heads).permute(2, 0, 1)[None]  # [1,H,N,N]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * head_dim**-0.5
        logits = logits + bias
        if mask is not None:
            n_w = mask.shape[0]
            logits = logits.reshape(-1, n_w, self.heads, n, n) + mask[None, :, None]
            logits = logits.reshape(-1, self.heads, n, n)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm32(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm32(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):  # NHWC
        b, h, w, c = x.shape
        y = self.norm1(x).to(x.dtype)
        mask = None
        if self.shift > 0:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = cached(("swinir_shift_mask", h, w, self.window, self.shift), x.device,
                          lambda: _shift_attn_mask(h, w, self.window, self.shift))
        wins = self.attn(window_partition(y, self.window), mask)
        y = window_merge(wins, self.window, h, w)
        if self.shift > 0:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + y
        y = self.mlp_fc1(self.norm2(x).to(x.dtype))
        return x + self.mlp_fc2(F.gelu(y))


class RSTB(nn.Module):
    """Residual Swin Transformer Block: depth SwinBlocks + 3x3 conv + skip."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth)
        )
        self.conv = conv3x3(dim, dim)

    def forward(self, x):  # NHWC
        y = x
        for block in self.blocks:
            y = block(y)
        return x + to_nhwc(self.conv(to_nchw(y)))


class SwinIR(nn.Module):
    """Degraded RGB [0,1] NHWC -> clean RGB [0,1] NHWC (float32)."""

    def __init__(self, cfg: SwinIRConfig = SwinIRConfig()):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.in_chans * (cfg.unshuffle_scale**2 if cfg.unshuffle else 1)
        self.conv_first = conv3x3(in_ch, cfg.embed_dim)
        self.patch_norm = LayerNorm32(cfg.embed_dim)
        self.layers = nn.ModuleList(
            RSTB(cfg.embed_dim, depth, heads, cfg.window_size, cfg.mlp_ratio)
            for depth, heads in zip(cfg.depths, cfg.num_heads)
        )
        self.norm = LayerNorm32(cfg.embed_dim)
        self.conv_after_body = conv3x3(cfg.embed_dim, cfg.embed_dim)
        nf = cfg.num_feat
        self.conv_before_upsample = conv3x3(cfg.embed_dim, nf)
        self.up_names = {
            2: ("conv_up1",),
            4: ("conv_up1", "conv_up2"),
            8: ("conv_up1", "conv_up2", "conv_up3"),
        }[cfg.sf]
        for name in self.up_names:
            setattr(self, name, conv3x3(nf, nf))
        self.conv_hr = conv3x3(nf, nf)
        self.conv_last = conv3x3(nf, cfg.in_chans)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_first.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.dtype
        if cfg.in_chans == 3:
            mean = cached(("swinir_mean",), x.device, lambda: np.array(_MEAN), x.dtype)
        else:
            mean = torch.zeros((), dtype=x.dtype, device=x.device)
        x = (x - mean) * cfg.img_range
        h = to_nchw(x)
        if cfg.unshuffle:
            h = F.pixel_unshuffle(h, cfg.unshuffle_scale)
        h = self.conv_first(h.to(dtype))

        y = self.patch_norm(to_nhwc(h)).to(dtype)
        for layer in self.layers:
            y = layer(y)
        y = self.norm(y).to(dtype)
        h = h + self.conv_after_body(to_nchw(y))

        h = F.leaky_relu(self.conv_before_upsample(h), 0.01)
        for name in self.up_names:
            h = F.leaky_relu(getattr(self, name)(nearest_upsample_2x(h)), 0.2)
        h = F.leaky_relu(self.conv_hr(h), 0.2)
        out = to_nhwc(self.conv_last(h))
        return out.float() / cfg.img_range + mean
