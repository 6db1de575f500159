"""Shared neural-net building blocks.

Counterpart of ``tair_tpu/models/layers.py``. Inside the port's modules,
feature maps are NCHW tensors (PyTorch's convolution layout); the public
functions of the models take and return NHWC like the JAX package and permute
at their boundary. Parameter names follow the JAX parameter tree
(``in_conv``, ``res.in_norm``, ...), so ``weights/convert.py`` maps a JAX tree
onto a ``state_dict`` by rule. Normalisation is computed in float32 whatever
the working type and cast back.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] ordering; [N] -> [N, dim] float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_count(channels: int, num_groups: int = 32) -> int:
    """Production channel counts are multiples of 32; tiny configurations fall
    back to fewer groups rather than failing."""
    groups = num_groups
    while channels % groups != 0:
        groups //= 2
    return groups


# Inside `gn_stats_over_batch()`, every GroupNorm32 pools its statistics over
# the batch axis as well as (H, W, channels of the group): the tiled VAE
# (utils/tilevae.py) runs the tiles of one image as one batch, and pooled
# statistics stand in for the whole image's. Read when a module runs.
_GN_STATS_OVER_BATCH: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "gn_stats_over_batch", default=False
)


@contextlib.contextmanager
def gn_stats_over_batch():
    """Within this context, GroupNorm32 statistics pool over the batch axis.
    Only meaningful when the batch rows are tiles of one image."""
    token = _GN_STATS_OVER_BATCH.set(True)
    try:
        yield
    finally:
        _GN_STATS_OVER_BATCH.reset(token)


class GroupNorm32(nn.Module):
    """GroupNorm over NCHW, always computed in float32, cast back to the input
    type; statistics pooled over the batch inside `gn_stats_over_batch`."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = group_count(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if (
            xf.device.type == "cpu" and torch.is_grad_enabled()
            and not xf.requires_grad and self.weight.requires_grad
        ):
            # PyTorch's CPU group-norm backward (seen with 2.13) crashes on a
            # channels-last input that needs no gradient itself: the first
            # trained norm behind a frozen convolution meets exactly that
            xf = xf.contiguous()
        if _GN_STATS_OVER_BATCH.get():
            # population statistics over (batch, channels of the group, H, W),
            # the same weight and bias as the per-image branch
            b, c, h, w = xf.shape
            xg = xf.reshape(b, self.groups, c // self.groups, h, w)
            var, mu = torch.var_mean(xg, dim=(0, 2, 3, 4), correction=0, keepdim=True)
            y = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
            y = y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]
            return y.to(x.dtype)
        y = F.group_norm(xf, self.groups, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis in float32; returns float32 (callers cast)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), (self.dim,), self.weight.float(), self.bias.float(), self.eps
        )


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, quantize: bool = False) -> nn.Conv2d:
    return (QuantConv2d if quantize else nn.Conv2d)(in_ch, out_ch, 3, stride=stride, padding=1)


def conv1x1(in_ch: int, out_ch: int, quantize: bool = False) -> nn.Conv2d:
    return (QuantConv2d if quantize else nn.Conv2d)(in_ch, out_ch, 1)


class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and ``state_dict`` keys) that runs the
    w8a8 product of ``ops/quant.py`` while a ``quant.quantized()`` scope is
    active: the UNet's and ControlNet's convolutions. Its int8 weight is
    made once per parameter version."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._wq = quant.WeightCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.active():
            return quant.w8a8_conv2d(x, self.weight, self.bias, self.stride[0],
                                     self.padding[0], cache=self._wq)
        return super().forward(x)


class QuantLinear(nn.Linear):
    """``nn.Linear`` counterpart of `QuantConv2d`: the UNet's and ControlNet's
    dense layers (not the time-embedding MLP nor ``emb_proj``, which the JAX
    package leaves unquantized)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._wq = quant.WeightCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.active():
            return quant.w8a8_linear(x, self.weight, self.bias, cache=self._wq)
        return super().forward(x)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def edge_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """NHWC `x` padded at the bottom by `ph` rows and at the right by `pw`
    columns that repeat the edge pixels (``jnp.pad(mode="edge")``)."""
    _, h, w, _ = x.shape
    rows = torch.arange(h + ph, device=x.device).clamp(max=h - 1)
    cols = torch.arange(w + pw, device=x.device).clamp(max=w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MultiHeadAttention(nn.Module):
    """Plain multi-head attention with separate query/key/value/out projections
    and an optional boolean mask (True = attend); softmax in float32. Serves
    the CLIP text tower and the spotter decoder, whose attention the JAX
    package leaves to the compiler as well."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask=None):
        b, tq, c = q_in.shape
        tk = k_in.shape[1]
        d = c // self.heads
        q = self.query(q_in).reshape(b, tq, self.heads, d)
        k = self.key(k_in).reshape(b, tk, self.heads, d)
        v = self.value(v_in).reshape(b, tk, self.heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, tq, c)
        return self.out(out)


class TimestepEmbedder(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, model_channels: int):
        super().__init__()
        self.model_channels = model_channels
        self.fc1 = nn.Linear(model_channels, model_channels * 4)
        self.fc2 = nn.Linear(model_channels * 4, model_channels * 4)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.model_channels).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))
