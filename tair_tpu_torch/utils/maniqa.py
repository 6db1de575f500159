"""MANIQA: Multi-dimension Attention Network for no-reference IQA.

Counterpart of ``tair_tpu/utils/maniqa.py`` (Yang et al., CVPRW 2022, the
network of IIGROUP/MANIQA that pyiqa wraps): a ViT-B/8 whose block-6..9 token
features are concatenated over channels, two stages of [transposed attention
blocks (attention across channels) -> 1 x 1 convolution -> a scaled Swin
stage], and per-patch score and weight heads combined as a weighted mean.
The JAX package reconstructed the graph and its key layout from the paper and
the official repository; the port matches that graph.

What the JAX module keeps on purpose, kept here too:

- LayerNorm eps 1e-6 in the ViT (timm passes it) and 1e-5 in the Swin stages
  (torch's default there); neither is flax's nor torch's default everywhere;
- ``TABlock`` scales by ``n ** -0.5`` with n the token count, and reassembles
  ``attn @ v`` by ``.transpose(1, 2).reshape(B, C, N)``, which permutes the
  elements (the official code's quirk, baked into the trained weights);
- the crop protocol: ``num_crops`` 224 x 224 crops whose offsets numpy's
  ``RandomState(seed)`` draws, images smaller than a crop edge-padded first,
  each distinct crop scored once and weighted by how often it was drawn.

The weights are IIGROUP/MANIQA's checkpoint (``MANIQAMetric.from_torch``);
they are not in the repo.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device_constants import cached
from .iqa import TransformerBlock, attend, images_on, load_module, resolve_device, scoring

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 8
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0


class ViTFeatures(nn.Module):
    """timm's ViT: every block's tokens, the class token first."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p, d = cfg.patch_size, cfg.dim
        self.patch_embed = nn.Conv2d(3, d, p, p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg.img_size // p) ** 2 + 1, d))
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.heads, int(d * cfg.mlp_ratio)) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, upto: Optional[int] = None) -> List[torch.Tensor]:
        """``[B, 3, H, W]`` normalised -> the tokens ``[B, 1 + N, D]`` after
        each of the first `upto` blocks (all by default)."""
        x = self.patch_embed(x)
        b, d = x.shape[:2]
        tokens = torch.cat([self.cls_token.expand(b, 1, d), x.flatten(2).transpose(1, 2)], dim=1)
        tokens = tokens + self.pos_embed
        outs = []
        for block in self.blocks[:upto]:
            tokens = block(tokens)
            outs.append(tokens)
        return outs


class TABlock(nn.Module):
    """Attention across the channel axis of ``[B, C, N]`` features; the
    projections act on the token axis N."""

    def __init__(self, n: int):
        super().__init__()
        self.c_q = nn.Linear(n, n)
        self.c_k = nn.Linear(n, n)
        self.c_v = nn.Linear(n, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, N]
        b, c, n = x.shape
        q, k, v = self.c_q(x), self.c_k(x), self.c_v(x)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * n ** -0.5, dim=-1)
        return (attn @ v).transpose(1, 2).reshape(b, c, n) + x  # the official permute quirk


def _rel_pos_index(ws: int) -> np.ndarray:
    """Swin's relative-position index ``[ws^2, ws^2]``."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, D]`` -> ``[B * nW, ws * ws, D]``, the windows of an image consecutive."""
    b, h, w, d = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, d)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, d)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _shift_mask(hh: int, ww: int, ws: int, sh: int) -> np.ndarray:
    """``[nW, ws^2, ws^2]``: -100 between tokens of a shifted window that come
    from different regions of the image, 0 elsewhere."""
    img = np.zeros((1, hh, ww, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -sh), slice(-sh, None)):
        for wsl in (slice(0, -ws), slice(-ws, -sh), slice(-sh, None)):
            img[:, hs, wsl] = cnt
            cnt += 1
    wins = _window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws).numpy()
    return np.where(wins[:, None, :] - wins[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def _on_device(table: str, device: torch.device, *args) -> torch.Tensor:
    """`_rel_pos_index(*args)` (flattened) or `_shift_mask(*args)` on `device`,
    made once."""
    if table == "index":
        return cached(("swin_index", *args), device, lambda: _rel_pos_index(*args).reshape(-1))
    return cached(("swin_mask", *args), device, lambda: _shift_mask(*args))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window = window
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nwb, t, d = x.shape  # [nW * B, ws * ws, D]
        qkv = self.qkv(x).reshape(nwb, t, 3, self.heads, d // self.heads)
        index = _on_device("index", x.device, self.window)
        bias = self.relative_position_bias_table[index].reshape(t, t, self.heads).permute(2, 0, 1)
        bias = bias[None]
        if mask is not None:  # [nW, t, t]; the windows of an image are consecutive
            bias = (bias + mask[:, None]).repeat(nwb // mask.shape[0], 1, 1, 1)
        return self.proj(attend(*qkv.unbind(2), bias=bias))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], heads: int, window: int, shift: int,
                 dim_mlp: int):
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, dim_mlp)
        self.fc2 = nn.Linear(dim_mlp, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H * W, D]
        hh, ww = self.resolution
        b, t, d = x.shape
        ws, sh = self.window, self.shift
        shortcut = x
        x = self.norm1(x).reshape(b, hh, ww, d)
        mask = None
        if sh > 0:
            x = torch.roll(x, (-sh, -sh), dims=(1, 2))
            mask = _on_device("mask", x.device, hh, ww, ws, sh)
        x = _window_reverse(self.attn(_window_partition(x, ws), mask), ws, hh, ww)
        if sh > 0:
            x = torch.roll(x, (sh, sh), dims=(1, 2))
        x = shortcut + x.reshape(b, t, d)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class SwinStage(nn.Module):
    """A scaled Swin stage (the paper's SSTB): ``scale * blocks(x) + x``."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int, heads: int,
                 window: int, dim_mlp: int, scale: float):
        super().__init__()
        self.scale = scale
        ws = min(window, min(resolution))
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, heads, ws,
                      0 if j % 2 == 0 or ws >= min(resolution) else ws // 2, dim_mlp)
            for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        for block in self.blocks:
            x = block(x)
        return self.scale * x + shortcut


@dataclass(frozen=True)
class MANIQAConfig:
    vit: ViTConfig = field(default_factory=ViTConfig)
    extract_blocks: Tuple[int, ...] = (6, 7, 8, 9)
    embed_dim: int = 768          # conv1's output, the first Swin stages' width
    num_tab: int = 2
    depths: Tuple[int, ...] = (2, 2)
    num_heads: Tuple[int, ...] = (4, 4)
    window_size: int = 4
    dim_mlp: int = 768
    scale: float = 0.8

    @property
    def input_size(self) -> int:
        return self.vit.img_size // self.vit.patch_size


class MANIQA(nn.Module):
    def __init__(self, cfg: MANIQAConfig = MANIQAConfig()):
        super().__init__()
        self.cfg = cfg
        g = cfg.input_size
        self.vit = ViTFeatures(cfg.vit)
        for n, (cin, width) in enumerate(
                ((len(cfg.extract_blocks) * cfg.vit.dim, cfg.embed_dim),
                 (cfg.embed_dim, cfg.embed_dim // 2)), start=1):
            for i in range(cfg.num_tab):
                setattr(self, f"tablock{n}_{i}", TABlock(g * g))
            setattr(self, f"conv{n}", nn.Conv2d(cin, width, 1))
            for i, depth in enumerate(cfg.depths):
                setattr(self, f"swin{n}_{i}", SwinStage(width, (g, g), depth, cfg.num_heads[i],
                                                        cfg.window_size, cfg.dim_mlp, cfg.scale))
        half = cfg.embed_dim // 2
        for head in ("fc_score", "fc_weight"):
            setattr(self, f"{head}_0", nn.Linear(half, half))
            setattr(self, f"{head}_3", nn.Linear(half, 1))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The ViT's tokens after each block that MANIQA reads (`extract_blocks`)."""
        feats = self.vit(x, upto=max(self.cfg.extract_blocks) + 1)
        return [feats[i] for i in self.cfg.extract_blocks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 3, S, S] normalised -> [B]
        cfg = self.cfg
        g = cfg.input_size
        x = torch.cat([f[:, 1:] for f in self.features(x)], dim=2)  # [B, N, C]
        b = x.shape[0]
        for n in (1, 2):
            x = x.transpose(1, 2)                                   # [B, C, N]
            for i in range(cfg.num_tab):
                x = getattr(self, f"tablock{n}_{i}")(x)
            x = getattr(self, f"conv{n}")(x.reshape(b, -1, g, g)).flatten(2).transpose(1, 2)
            for i in range(len(cfg.depths)):
                x = getattr(self, f"swin{n}_{i}")(x)

        def head(name):
            return getattr(self, f"{name}_3")(F.relu(getattr(self, f"{name}_0")(x)))[..., 0]

        score = F.relu(head("fc_score"))
        weight = torch.sigmoid(head("fc_weight"))
        return (score * weight).sum(-1) / weight.sum(-1).clamp_min(1e-12)


class MANIQAMetric:
    """``maniqa(images)`` -> ``[B]``, higher is better, for ``[B, H, W, 3]``
    images in [0, 1], by pyiqa's protocol: `num_crops` random crops of the
    ViT's size, scores averaged (the offsets from numpy's ``RandomState(seed)``),
    on `device` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, params: Mapping[str, Any], cfg: MANIQAConfig = MANIQAConfig(),
                 num_crops: int = 20, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_crops = num_crops
        self.seed = seed
        self.net = load_module(lambda: MANIQA(cfg), params, self.device)

    @classmethod
    def from_jax_params(cls, params: Mapping[str, Any], cfg: MANIQAConfig = MANIQAConfig(),
                        **kw) -> "MANIQAMetric":
        """The JAX ``MANIQAMetric``'s ``params`` (as numpy), at its config."""
        return cls(params, cfg, **kw)

    def crops(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the distinct crops, normalised, ``[U * B, 3, S, S]`` crop-major; how
        often each was drawn ``[U, 1]``)."""
        size = self.cfg.vit.img_size
        x = images_on(images, self.device).permute(0, 3, 1, 2)
        mean = cached(("maniqa_mean",), x.device, lambda: np.array(IMAGENET_MEAN), x.dtype)
        std = cached(("maniqa_std",), x.device, lambda: np.array(IMAGENET_STD), x.dtype)
        mean, std = mean.view(1, 3, 1, 1), std.view(1, 3, 1, 1)
        x = (x - mean) / std
        h, w = x.shape[2:]
        if h < size or w < size:
            x = F.pad(x, (0, max(0, size - w), 0, max(0, size - h)), mode="replicate")
            h, w = max(h, size), max(w, size)
        rng = np.random.RandomState(self.seed)
        draws = [(int(rng.randint(0, h - size + 1)), int(rng.randint(0, w - size + 1)))
                 for _ in range(self.num_crops)]
        uniq = sorted(set(draws))
        counts = tuple(draws.count(o) for o in uniq)
        counts = cached(("maniqa_crop_counts", counts), self.device,
                        lambda: np.array(counts, np.float32)[:, None])
        return torch.cat([x[:, :, i:i + size, j:j + size] for i, j in uniq]), counts

    def __call__(self, images) -> torch.Tensor:
        b = images.shape[0]
        with scoring(self.device):
            crops, counts = self.crops(images)
            scores = self.net(crops).reshape(len(counts), b)
            return (scores * counts).sum(0) / self.num_crops

    @classmethod
    def from_torch(cls, path: str, **kw) -> "MANIQAMetric":
        """IIGROUP/MANIQA's checkpoint (``ckpt_koniq10k.pt``) or pyiqa's
        re-export: a state dict in the IIGROUP layout, ``module.`` or not."""
        from ..weights.convert import _strip_module, load_torch_file

        return cls.from_state_dict(_strip_module(load_torch_file(path)), **kw)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any], **kw) -> "MANIQAMetric":
        """The ViT's geometry is read from the shapes; the rest is the
        published configuration (``MANIQAConfig``'s defaults)."""
        from ..weights.convert import convert_maniqa

        sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
        vit_dim = sd["vit.patch_embed.proj.weight"].shape[0]
        depth = 0
        while f"vit.blocks.{depth}.norm1.weight" in sd:
            depth += 1
        n_tokens = sd["vit.pos_embed"].shape[1] - 1
        patch = sd["vit.patch_embed.proj.weight"].shape[-1]
        cfg = MANIQAConfig(
            vit=ViTConfig(img_size=int(round(n_tokens ** 0.5)) * patch, patch_size=patch,
                          dim=vit_dim, depth=depth, heads=max(1, vit_dim // 64)),
            embed_dim=sd["conv1.weight"].shape[0],
        )
        return cls(convert_maniqa(sd, cfg), cfg, **kw)
