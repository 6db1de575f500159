"""Alternative stage-1 cleaners: BSRNet (RRDBNet) and SCUNet.

Counterpart of ``tair_tpu/models/cleaners.py``: residual-in-residual dense
blocks with x2 / x4 nearest + conv upsampling, and the swin-conv UNet denoiser
(parallel convolution and shifted-window attention branches fused by 1x1
convolutions, strided-convolution down, transposed-convolution up). Both take
and return NHWC; inside, the convolutions work on NCHW and the Swin blocks
(``models/swinir.py::SwinBlock``, plain einsum attention as in the JAX package)
on NHWC. Module names follow the JAX parameter tree, so
``weights.convert.convert_tree`` loads a JAX tree by rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv3x3, edge_pad, nearest_upsample_2x, to_nchw, to_nhwc
from .swinir import SwinBlock


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", conv3x3(nf + i * gc, gc))
        self.conv5 = conv3x3(nf + 4 * gc, nf)

    def forward(self, x):
        feats = x
        for i in range(4):
            y = F.leaky_relu(getattr(self, f"conv{i + 1}")(feats), 0.2)
            feats = torch.cat([feats, y], dim=1)
        return self.conv5(feats) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock5C(nf, gc)
        self.rdb2 = ResidualDenseBlock5C(nf, gc)
        self.rdb3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@dataclass(frozen=True)
class RRDBNetConfig:
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 23
    gc: int = 32
    sf: int = 4


class RRDBNet(nn.Module):
    """BSRNet / BSRGAN super-resolver: [B, H, W, in_nc] -> [B, sf*H, sf*W, out_nc]."""

    def __init__(self, cfg: RRDBNetConfig = RRDBNetConfig()):
        super().__init__()
        if cfg.sf not in (2, 4):
            raise ValueError(f"RRDBNet upsamples x2 or x4, not x{cfg.sf}")
        self.cfg = cfg
        self.conv_first = conv3x3(cfg.in_nc, cfg.nf)
        for i in range(cfg.nb):
            setattr(self, f"rrdb_{i}", RRDB(cfg.nf, cfg.gc))
        self.trunk_conv = conv3x3(cfg.nf, cfg.nf)
        self.upconv1 = conv3x3(cfg.nf, cfg.nf)
        if cfg.sf == 4:
            self.upconv2 = conv3x3(cfg.nf, cfg.nf)
        self.hr_conv = conv3x3(cfg.nf, cfg.nf)
        self.conv_last = conv3x3(cfg.nf, cfg.out_nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        fea = self.conv_first(to_nchw(x).to(self.conv_first.weight.dtype))
        trunk = fea
        for i in range(cfg.nb):
            trunk = getattr(self, f"rrdb_{i}")(trunk)
        fea = fea + self.trunk_conv(trunk)
        fea = F.leaky_relu(self.upconv1(nearest_upsample_2x(fea)), 0.2)
        if cfg.sf == 4:
            fea = F.leaky_relu(self.upconv2(nearest_upsample_2x(fea)), 0.2)
        out = self.conv_last(F.leaky_relu(self.hr_conv(fea), 0.2))
        return to_nhwc(out)


class ConvTransBlock(nn.Module):
    """Parallel convolution branch and Swin branch, fused by 1x1 convolutions."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        total = conv_dim + trans_dim
        self.conv_dim = conv_dim
        self.conv1_1 = nn.Conv2d(total, total, 1)
        self.cb1 = nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False)
        self.cb2 = nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False)
        self.trans = SwinBlock(
            trans_dim, trans_dim // head_dim, window, window // 2 if shifted else 0, 4.0
        )
        self.conv1_2 = nn.Conv2d(total, total, 1)

    def forward(self, x):  # NCHW
        conv_x, trans_x = torch.split(self.conv1_1(x), [self.conv_dim, x.shape[1] - self.conv_dim], 1)
        conv_x = conv_x + self.cb2(F.relu(self.cb1(conv_x)))
        trans_x = to_nchw(self.trans(to_nhwc(trans_x)))
        return x + self.conv1_2(torch.cat([conv_x, trans_x], dim=1))


@dataclass(frozen=True)
class SCUNetConfig:
    in_nc: int = 3
    dim: int = 64
    config: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2)
    head_dim: int = 32
    window: int = 8


class SCUNet(nn.Module):
    """Swin-conv UNet denoiser; the input is edge-padded to a multiple of 64
    and the output cropped back (float32 NHWC)."""

    def __init__(self, cfg: SCUNetConfig = SCUNetConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.head = nn.Conv2d(cfg.in_nc, d, 3, padding=1, bias=False)
        # (stage, width of each branch of its blocks)
        stages = (("down1", d // 2), ("down2", d), ("down3", 2 * d), ("body", 4 * d),
                  ("up3", 2 * d), ("up2", d), ("up1", d // 2))
        self.depths = {name: n for (name, _), n in zip(stages, cfg.config)}
        for name, cdim in stages:
            for i in range(self.depths[name]):
                setattr(self, f"{name}_{i}",
                        ConvTransBlock(cdim, cdim, cfg.head_dim, cfg.window, shifted=bool(i % 2)))
        self.down1_conv = nn.Conv2d(d, 2 * d, 2, stride=2, bias=False)
        self.down2_conv = nn.Conv2d(2 * d, 4 * d, 2, stride=2, bias=False)
        self.down3_conv = nn.Conv2d(4 * d, 8 * d, 2, stride=2, bias=False)
        self.up3_conv = nn.ConvTranspose2d(8 * d, 4 * d, 2, stride=2, bias=False)
        self.up2_conv = nn.ConvTranspose2d(4 * d, 2 * d, 2, stride=2, bias=False)
        self.up1_conv = nn.ConvTranspose2d(2 * d, d, 2, stride=2, bias=False)
        self.tail = nn.Conv2d(d, cfg.in_nc, 3, padding=1, bias=False)

    def _stack(self, x, name: str):
        for i in range(self.depths[name]):
            x = getattr(self, f"{name}_{i}")(x)
        return x

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x0.shape
        x0 = edge_pad(x0, (-h) % 64, (-w) % 64)
        x1 = self.head(to_nchw(x0).to(self.head.weight.dtype))
        x2 = self.down1_conv(self._stack(x1, "down1"))
        x3 = self.down2_conv(self._stack(x2, "down2"))
        x4 = self.down3_conv(self._stack(x3, "down3"))
        xb = self._stack(x4, "body")
        y = self._stack(self.up3_conv(xb + x4), "up3")
        y = self._stack(self.up2_conv(y + x3), "up2")
        y = self._stack(self.up1_conv(y + x2), "up1")
        out = self.tail(y + x1)
        return to_nhwc(out)[:, :h, :w].float()
