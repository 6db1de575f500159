"""SD KL-f8 autoencoder.

Counterpart of ``tair_tpu/models/vae.py``: encoder and decoder ResNet stacks,
one single-head attention block in the middle (through ``sdpa``), diagonal
Gaussian moments. Public methods take and return NHWC; images lie in [-1, 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .layers import GroupNorm32, conv1x1, conv3x3, nearest_upsample_2x, to_nchw, to_nhwc


@dataclass(frozen=True)
class VAEConfig:
    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    double_z: bool = True
    scale_factor: float = 0.18215


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.nin_shortcut = conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial grid (VAE middle)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q = conv1x1(ch, ch)
        self.k = conv1x1(ch, ch)
        self.v = conv1x1(ch, ch)
        self.proj_out = conv1x1(ch, ch)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(t):  # NCHW -> [B, HW, 1, C]
            return t.permute(0, 2, 3, 1).reshape(b, h * w, 1, c).contiguous()

        o = sdpa(tokens(self.q(y)), tokens(self.k(y)), tokens(self.v(y)))
        o = o.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(o)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch)
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            for i in range(cfg.num_res_blocks):
                setattr(self, f"down_{level}_block_{i}", ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            if level != len(cfg.ch_mult) - 1:
                # asymmetric pad (0,1) then a stride-2 conv without padding
                setattr(self, f"down_{level}_downsample", nn.Conv2d(ch, ch, 3, stride=2))
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(ch, out_ch)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for level in range(len(cfg.ch_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(cfg.ch_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv3x3(cfg.z_channels, ch)
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        for level in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                setattr(self, f"up_{level}_block_{i}", ResnetBlock(ch, out_ch))
                ch = out_ch
            if level != 0:
                setattr(self, f"up_{level}_upsample", conv3x3(ch, ch))
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = conv3x3(ch, cfg.out_channels)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(z))))
        for level in reversed(range(len(cfg.ch_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(nearest_upsample_2x(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode_moments(x) -> (mean, logvar); decode(z) -> image. NHWC."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = conv1x1(
            2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
            2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim,
        )
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor):
        moments = self.quant_conv(self.encoder(to_nchw(x).to(self.dtype)))
        mean, logvar = to_nhwc(moments).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(z).to(self.dtype))))
