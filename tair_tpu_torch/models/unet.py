"""SD-2.1 UNet and ControlNet.

Counterpart of ``tair_tpu/models/unet.py``. ``forward`` takes and returns NHWC
tensors like the JAX modules; inside, feature maps are NCHW. The decoder
feature taps are taken after output blocks ``cfg.extract_idx`` (after each
tagged block's trailing upsample). Every convolution and dense layer but the
time-embedding MLP and ``emb_proj`` is quantizable (``layers.QuantConv2d`` /
``QuantLinear``): inside ``ops.quant.quantized()`` it runs w8a8, and its sites
run in the JAX package's order, which the calibration record follows.
Gradient checkpointing is not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import SpatialTransformer
from .layers import (
    GroupNorm32,
    TimestepEmbedder,
    conv1x1,
    conv3x3,
    nearest_upsample_2x,
    to_nchw,
    to_nhwc,
)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    # ControlNet only:
    hint_channels: int = 4

    @property
    def extract_idx(self) -> Tuple[int, ...]:
        """Decoder output-block indices whose hidden states feed the spotter."""
        n = self.num_res_blocks + 1
        return tuple(n * (i + 1) - 1 for i in range(len(self.channel_mult)))


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = conv3x3(in_ch, out_ch, quantize=True)
        self.emb_proj = nn.Linear(emb_ch, out_ch)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = conv3x3(out_ch, out_ch, quantize=True)
        self.skip = conv1x1(in_ch, out_ch, quantize=True) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None].to(h.dtype)
        h = self.out_conv(F.silu(self.out_norm(h)))
        skip = x if self.skip is None else self.skip(x)
        return skip + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2, quantize=True)

    def forward(self, x, emb=None, context=None):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, quantize=True)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


def _transformer(cfg: UNetConfig, channels: int) -> SpatialTransformer:
    return SpatialTransformer(
        channels,
        heads=channels // cfg.num_head_channels,
        dim_head=cfg.num_head_channels,
        context_dim=cfg.context_dim,
        depth=cfg.transformer_depth,
    )


class EncoderBlock(nn.Module):
    """ResBlock + optional SpatialTransformer (one UNet input block)."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, attn: bool):
        super().__init__()
        self.res = ResBlock(in_ch, out_ch, cfg.model_channels * 4)
        self.attn = _transformer(cfg, out_ch) if attn else None

    def forward(self, x, emb, context):
        h = self.res(x, emb)
        if self.attn is not None:
            h = self.attn(h, context)
        return h


class DecoderBlock(nn.Module):
    """ResBlock + optional attention + optional upsample (one UNet output block)."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, attn: bool,
                 upsample: bool):
        super().__init__()
        self.res = ResBlock(in_ch, out_ch, cfg.model_channels * 4)
        self.attn = _transformer(cfg, out_ch) if attn else None
        self.up = Upsample(out_ch) if upsample else None

    def forward(self, x, emb, context):
        h = self.res(x, emb)
        if self.attn is not None:
            h = self.attn(h, context)
        if self.up is not None:
            h = self.up(h)
        return h


class MiddleBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.res1 = ResBlock(channels, channels, cfg.model_channels * 4)
        self.attn = _transformer(cfg, channels)
        self.res2 = ResBlock(channels, channels, cfg.model_channels * 4)

    def forward(self, x, emb, context):
        return self.res2(self.attn(self.res1(x, emb), context), emb)


def _encoder_plan(cfg: UNetConfig):
    """Static plan of the encoder tower: ('conv'|'block'|'down', out_ch, attn)."""
    plan = [("conv", cfg.model_channels, False)]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            plan.append(("block", ch, ds in cfg.attention_resolutions))
        if level != len(cfg.channel_mult) - 1:
            plan.append(("down", ch, False))
            ds *= 2
    return plan


def _decoder_plan(cfg: UNetConfig):
    """Static plan of the decoder tower: (out_ch, attn, upsample)."""
    ds = 2 ** (len(cfg.channel_mult) - 1)
    plan = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ch = cfg.model_channels * mult
            attn = ds in cfg.attention_resolutions
            upsample = level > 0 and i == cfg.num_res_blocks
            plan.append((ch, attn, upsample))
            if upsample:
                ds //= 2
    return plan


class _EncoderTower(nn.Module):
    """Shared by UNetModel and ControlNet: time embedding, ``in_conv``, the
    input blocks ``in_<i>`` and ``middle``; returns the channel count of each
    block's output."""

    def _build_encoder(self, cfg: UNetConfig, in_channels: int):
        self.time_embed = TimestepEmbedder(cfg.model_channels)
        self.plan = _encoder_plan(cfg)
        chans = []
        ch = in_channels
        for i, (kind, out_ch, attn) in enumerate(self.plan):
            if kind == "conv":
                self.in_conv = conv3x3(ch, out_ch, quantize=True)
            elif kind == "down":
                setattr(self, f"in_{i}", Downsample(out_ch))
            else:
                setattr(self, f"in_{i}", EncoderBlock(cfg, ch, out_ch, attn))
            ch = out_ch
            chans.append(ch)
        self.middle = MiddleBlock(cfg, ch)
        return chans

    def _run_encoder(self, h, emb, context, after_block=None):
        """The input blocks' outputs; `after_block(i, h)` runs right after
        block i, before block i + 1 (ControlNet's zero convs, in the JAX
        package's order of quantization sites)."""
        hs = []
        for i, (kind, _, _) in enumerate(self.plan):
            if kind == "conv":
                h = self.in_conv(h)
            else:
                h = getattr(self, f"in_{i}")(h, emb, context)
            hs.append(h)
            if after_block is not None:
                after_block(i, h)
        return hs

    @property
    def dtype(self) -> torch.dtype:
        return self.in_conv.weight.dtype


class UNetModel(_EncoderTower):
    """SD UNet; optionally consumes ControlNet residuals and taps decoder feats.

    forward(x, t, context, control=None, extract_features=False)
      x: [B, H, W, in_channels] latent (NHWC), t: [B] integer,
      context: [B, 77, context_dim] CLIP embedding,
      control: optional sequence of 13 NHWC residuals (12 encoder-skip + 1 middle).
    Returns eps [B, H, W, out_channels], and the tuple of NHWC feats if requested.
    """

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        chans = self._build_encoder(cfg, cfg.in_channels)
        ch = chans[-1]
        self.dec_plan = _decoder_plan(cfg)
        for i, (out_ch, attn, upsample) in enumerate(self.dec_plan):
            setattr(
                self, f"out_{i}",
                DecoderBlock(cfg, ch + chans.pop(), out_ch, attn, upsample),
            )
            ch = out_ch
        self.out_norm = GroupNorm32(ch)
        self.out_conv = conv3x3(ch, cfg.out_channels, quantize=True)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        context: torch.Tensor,
        control: Optional[Sequence[torch.Tensor]] = None,
        extract_features: bool = False,
    ):
        dtype = self.dtype
        emb = self.time_embed(t).to(dtype)
        context = context.to(dtype)
        hs = self._run_encoder(to_nchw(x).to(dtype), emb, context)
        h = self.middle(hs[-1], emb, context)

        ctrl = [to_nchw(c) for c in control] if control is not None else None
        if ctrl is not None:
            h = h + ctrl.pop().to(h.dtype)

        feats = []
        extract_idx = set(self.cfg.extract_idx)
        for i in range(len(self.dec_plan)):
            skip = hs.pop()
            if ctrl is not None:
                skip = skip + ctrl.pop().to(skip.dtype)
            h = getattr(self, f"out_{i}")(torch.cat([h, skip], dim=1), emb, context)
            if extract_features and i in extract_idx:
                feats.append(to_nhwc(h))

        eps = self.out_conv(F.silu(self.out_norm(h)))
        eps = to_nhwc(eps).to(x.dtype)
        if extract_features:
            return eps, tuple(feats)
        return eps


class ControlNet(_EncoderTower):
    """UNet-encoder copy with hint concat; emits 13 zero-conv residuals.

    forward(x, hint, t, context) -> tuple of 13 NHWC tensors
    (one per encoder block output + the middle block output).
    """

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        chans = self._build_encoder(cfg, cfg.in_channels + cfg.hint_channels)
        for i, ch in enumerate(chans):
            setattr(self, f"zero_{i}", conv1x1(ch, ch, quantize=True))
        self.middle_out = conv1x1(chans[-1], chans[-1], quantize=True)

    def forward(self, x, hint, t, context):
        dtype = self.dtype
        emb = self.time_embed(t).to(dtype)
        context = context.to(dtype)
        h = to_nchw(torch.cat([x, hint.to(x.dtype)], dim=-1)).to(dtype)
        outs = []
        hs = self._run_encoder(
            h, emb, context,
            after_block=lambda i, h_i: outs.append(to_nhwc(getattr(self, f"zero_{i}")(h_i))),
        )
        outs.append(to_nhwc(self.middle_out(self.middle(hs[-1], emb, context))))
        return tuple(outs)
