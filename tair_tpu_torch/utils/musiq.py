"""MUSIQ: Multi-scale Image Quality Transformer (no-reference IQA).

Counterpart of ``tair_tpu/utils/musiq.py`` (Ke et al., ICCV 2021): the image at
its own size and resized (aspect kept) to a longer side of 384 and of 224;
each scale cut into 32 x 32 patches, each patch encoded by a five-layer BiT
mini-ResNet (weight-standardised convolutions, GroupNorm with eps 1e-4: a root
convolution and one pre-activation bottleneck) and projected; a hashed 2-D
position (a G x G grid shared by the scales) and a scale embedding added; a
class-token transformer (D=384, 14 layers, 6 heads, MLP 1152) regresses the
score from the class token.

The JAX package reconstructed the graph from the paper (neither pyiqa nor the
google-research source was at hand); the port matches that graph, not pyiqa.
The resizes are ``jax.image.resize(..., "bilinear")``, antialiased on a
downscale (``data/resize.py``, not ``F.interpolate``); the hash indices are
numpy, as there. A scale with more patches than ``max_tokens_per_scale`` is
cropped about its centre in patch units, as the TF implementation's fixed
sequence budget. The weights are a MUSIQ state dict in this module's layout
or a published one that ``weights/musiq_shim.py`` renames
(``MUSIQMetric.from_torch``); they are not in the repo.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device_constants import cached
from .iqa import TransformerBlock, images_on, load_module, resolve_device, scoring

PATCH = 32


class StdConv(nn.Conv2d):
    """Weight-standardised convolution (BiT): each output channel's kernel
    normalised over (in, kh, kw) when applied; no bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride, padding=kernel // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        return F.conv2d(x, (w - mu) / torch.sqrt(var + 1e-10), None, self.stride, self.padding)


def _gn(channels: int, groups: int = 32) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-4)


class PreActBottleneck(nn.Module):
    """BiT's pre-activation bottleneck: GroupNorm and ReLU before each
    convolution; a projection of the pre-activated input where the width changes."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        out = mid * 4
        self.gn1 = _gn(cin, min(32, cin))
        if cin != out:
            self.proj = StdConv(cin, out, 1)
        self.conv1 = StdConv(cin, mid, 1)
        self.gn2 = _gn(mid, min(32, mid))
        self.conv2 = StdConv(mid, mid, 3)
        self.gn3 = _gn(mid, min(32, mid))
        self.conv3 = StdConv(mid, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.gn1(x))
        shortcut = self.proj(h) if hasattr(self, "proj") else x
        y = F.relu(self.gn2(self.conv1(h)))
        y = F.relu(self.gn3(self.conv2(y)))
        return shortcut + self.conv3(y)


class PatchEncoder(nn.Module):
    """The paper's five-layer mini-ResNet over ``[N, 3, 32, 32]`` patches ->
    ``[N, hidden]``: root StdConv 7 x 7 / 2, GroupNorm, ReLU, max-pool 3 x 3 / 2,
    one bottleneck, GroupNorm, ReLU, flatten (channels first), projection."""

    def __init__(self, root_width: int = 64, hidden: int = 384):
        super().__init__()
        self.root = StdConv(3, root_width, 7, 2)
        self.root_gn = _gn(root_width, min(32, root_width))
        self.block1 = PreActBottleneck(root_width, root_width)
        self.out_gn = _gn(4 * root_width, min(32, root_width))
        self.embedding = nn.Linear(4 * root_width * (PATCH // 4) ** 2, hidden)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.root_gn(self.root(patches)))
        x = F.max_pool2d(x, 3, 2, padding=1)                 # [N, W, 8, 8]
        x = F.relu(self.out_gn(self.block1(x)))
        return self.embedding(x.reshape(x.shape[0], -1))


@dataclass(frozen=True)
class MUSIQConfig:
    hidden: int = 384
    layers: int = 14
    heads: int = 6
    mlp: int = 1152
    root_width: int = 64
    hash_grid: int = 10                   # G: the spatial hash grid the scales share
    scales: Tuple[int, ...] = (384, 224)  # the longer sides of the resizes (besides the image)
    max_tokens_per_scale: int = 512
    num_outputs: int = 1


class MUSIQBackbone(nn.Module):
    """The transformer over the patch tokens ``[B, T, D]``, given each
    token's hash slot and scale id (``[T]`` each)."""

    def __init__(self, cfg: MUSIQConfig = MUSIQConfig()):
        super().__init__()
        d = cfg.hidden
        self.spatial_embedding = nn.Parameter(torch.zeros(cfg.hash_grid ** 2, d))
        self.scale_embedding = nn.Parameter(torch.zeros(len(cfg.scales) + 1, d))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.blocks = nn.ModuleList(TransformerBlock(d, cfg.heads, cfg.mlp)
                                    for _ in range(cfg.layers))
        self.encoder_norm = nn.LayerNorm(d, eps=1e-6)
        self.head = nn.Linear(d, cfg.num_outputs)

    def forward(self, tokens, hash_idx, scale_idx) -> torch.Tensor:
        b, _, d = tokens.shape
        x = tokens + self.spatial_embedding[hash_idx][None] + self.scale_embedding[scale_idx][None]
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.head(self.encoder_norm(x)[:, 0])[..., 0]  # [B]


def _multiscale(x: torch.Tensor, scales) -> List[torch.Tensor]:
    """``[B, H, W, C]``: the image, and its resizes (aspect kept) to each longer side."""
    from ..data.resize import resize

    _, h, w, _ = x.shape
    out = [x]
    for longer in scales:
        s = longer / max(h, w)
        out.append(resize(x, (max(1, int(round(h * s))), max(1, int(round(w * s)))), "linear"))
    return out


def _crop_to_budget(img: torch.Tensor, gh: int, gw: int, budget: int):
    """(gh, gw, img) with the patch grid cropped about its centre while it
    holds more than `budget` patches."""
    while gh * gw > budget:
        if gh >= gw:
            gh -= 1
        else:
            gw -= 1
    h, w = gh * PATCH, gw * PATCH
    oh = (img.shape[1] - h) // 2 // PATCH * PATCH
    ow = (img.shape[2] - w) // 2 // PATCH * PATCH
    return gh, gw, img[:, oh:oh + h, ow:ow + w]


def _hash_index(g: int, grids) -> np.ndarray:
    """Each token's cell of the g x g hash grid, over the scales' (gh, gw)
    patch grids in turn."""
    out = []
    for gh, gw in grids:
        hi = np.minimum((np.arange(gh) * g) // gh, g - 1)
        hj = np.minimum((np.arange(gw) * g) // gw, g - 1)
        out.append((hi[:, None] * g + hj[None, :]).reshape(-1))
    return np.concatenate(out)


def _scale_index(grids) -> np.ndarray:
    """Each token's scale, over the scales' (gh, gw) patch grids in turn."""
    return np.concatenate([np.full(gh * gw, sid) for sid, (gh, gw) in enumerate(grids)])


class MUSIQ(nn.Module):
    """The multi-scale model over ``[B, H, W, 3]`` images in [0, 1] -> ``[B]``."""

    def __init__(self, cfg: MUSIQConfig = MUSIQConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_encoder = PatchEncoder(cfg.root_width, cfg.hidden)
        self.backbone = MUSIQBackbone(cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        all_tokens, grids = [], []
        for img in _multiscale(images * 2.0 - 1.0, cfg.scales):  # TF's [-1, 1]
            img = F.pad(img, (0, 0, 0, (-img.shape[2]) % PATCH, 0, (-img.shape[1]) % PATCH))
            gh, gw, img = _crop_to_budget(img, img.shape[1] // PATCH, img.shape[2] // PATCH,
                                          cfg.max_tokens_per_scale)
            patches = img.reshape(b, gh, PATCH, gw, PATCH, 3).permute(0, 1, 3, 5, 2, 4)
            tok = self.patch_encoder(patches.reshape(b * gh * gw, 3, PATCH, PATCH))
            all_tokens.append(tok.reshape(b, gh * gw, cfg.hidden))
            grids.append((gh, gw))
        key, dev = (cfg.hash_grid, tuple(grids)), images.device
        return self.backbone(torch.cat(all_tokens, dim=1),
                             cached(("musiq_hash", key), dev, lambda: _hash_index(*key)),
                             cached(("musiq_scale", key), dev, lambda: _scale_index(key[1])))


class MUSIQMetric:
    """``musiq(images)`` -> ``[B]``, higher is better, for ``[B, H, W, 3]``
    images in [0, 1], on `device` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, params: Mapping[str, Any], cfg: MUSIQConfig = MUSIQConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.net = load_module(lambda: MUSIQ(cfg), params, self.device)

    @classmethod
    def from_jax_params(cls, params: Mapping[str, Any], cfg: MUSIQConfig = MUSIQConfig(),
                        device="cuda") -> "MUSIQMetric":
        """The JAX ``MUSIQMetric``'s ``params`` (as numpy), at its config."""
        return cls(params, cfg, device)

    def __call__(self, images) -> torch.Tensor:
        x = images_on(images, self.device)
        with scoring(self.device):
            return self.net(x)

    @classmethod
    def from_torch(cls, path: str, **kw) -> "MUSIQMetric":
        """A state dict in this module's layout, or a published one that
        ``weights/musiq_shim.py`` renames (pyiqa's ``musiq_koniq_ckpt.pth``
        naming families); a naming the shim does not know raises, listing the
        keys left over."""
        from ..weights.convert import load_torch_file

        return cls.from_state_dict(load_torch_file(path), **kw)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any], scales=None, heads=None,
                        **kw) -> "MUSIQMetric":
        """The geometry is read from the shapes, but for the head count and
        the resize scales, which the shapes do not hold: they default to the
        paper's (hidden / 64 heads; longer sides 384 and 224)."""
        from ..weights.convert import convert_musiq
        from ..weights.musiq_shim import shim_musiq_state_dict

        sd = {k: np.asarray(v, np.float32) for k, v in shim_musiq_state_dict(sd).items()}
        hidden = sd["backbone.cls_token"].shape[-1]
        layers = 0
        while f"backbone.blocks.{layers}.norm1.weight" in sd:
            layers += 1
        n_scales = sd["backbone.scale_embedding"].shape[0] - 1
        scales = tuple(scales) if scales is not None else MUSIQConfig().scales
        if len(scales) != n_scales:
            raise ValueError(
                f"checkpoint has {n_scales} resize scales (scale_embedding rows - 1) but "
                f"scales={scales}; pass the model's longer-side list explicitly via "
                "from_state_dict(scales=...)"
            )
        cfg = MUSIQConfig(
            hidden=hidden, layers=layers,
            heads=heads if heads is not None else max(1, hidden // 64),
            mlp=sd["backbone.blocks.0.mlp.fc1.weight"].shape[0],
            root_width=sd["patch_encoder.root.weight"].shape[0],
            hash_grid=int(round(sd["backbone.spatial_embedding"].shape[0] ** 0.5)),
            scales=scales, num_outputs=sd["backbone.head.weight"].shape[0],
        )
        return cls(convert_musiq(sd, cfg), cfg, **kw)
