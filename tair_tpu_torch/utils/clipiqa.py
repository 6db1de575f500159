"""CLIP-IQA: no-reference image quality from CLIP RN50 and an antonym prompt pair.

Counterpart of ``tair_tpu/utils/clipiqa.py`` (Wang et al., AAAI'23): an image
scores the softmax, taken over the pair, of the cosine similarities of its CLIP
image embedding with the prompts "Good photo." and "Bad photo.". The image
tower is OpenAI CLIP's ModifiedResNet (three-convolution stem, average-pool
downsampling in the bottlenecks, inference batch norm, the attention-pool
head); the text side is the port's ``models/clip.CLIPTextTower`` run through
every block with QuickGELU, pooled at the end token and projected, computed
once when the metric is built.

Images are scored at their own size. ``pos_embedding="interpolate"`` (the
default) resizes the 7 x 7 grid embedding to the feature grid as
``jax.image.resize(..., "bilinear")`` does (``data/resize.py``: antialiased
on a downscale, so not ``F.interpolate``); ``"none"`` drops it, the paper's
choice. The weights are an OpenAI CLIP RN50 state dict
(``CLIPIQAMetric.from_torch``); they are not in the repo.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device_constants import cached
from .iqa import attend, images_on, load_module, resolve_device, scoring

# CLIP's preprocessing constants (openai/CLIP clip/clip.py _transform)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

DEFAULT_PROMPTS = ("Good photo.", "Bad photo.")


class BNInfer(nn.Module):
    """Batch norm at inference: an affine map with frozen statistics."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        inv = self.weight * torch.rsqrt(self.var + self.eps)
        return (x - self.mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: every convolution at stride 1, an
    average pool takes the stride after conv2."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, planes, 1), BNInfer(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BNInfer(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), BNInfer(planes * 4)
        self.down = stride > 1 or cin != planes * 4
        if self.down:
            self.down_conv, self.down_bn = _conv(cin, planes * 4, 1), BNInfer(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.down:
            if self.stride > 1:
                identity = F.avg_pool2d(x, self.stride)
            identity = self.down_bn(self.down_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling: the mean token queries the spatial tokens."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 pos_embedding: str = "interpolate"):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.pos_embedding = pos_embedding
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        from ..data.resize import resize

        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)  # [B, 1+HW, C]
        if self.pos_embedding != "none":
            pos, s = self.positional_embedding, self.spacial_dim
            grid = pos[1:].reshape(s, s, c)
            if (h, w) != (s, s):
                grid = resize(grid[None], (h, w), "linear")[0]
            tokens = tokens + torch.cat([pos[:1], grid.reshape(h * w, c)], dim=0)[None]
        hd = c // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, hd)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, hd)
        return self.c_proj(attend(q, k, v))[:, 0]  # [B, output_dim]


@dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)   # RN50
    width: int = 64
    embed_dim: int = 1024
    heads: int = 32
    image_size: int = 224                     # sets the grid of the positional embedding (7 x 7)
    pos_embedding: str = "interpolate"


class ModifiedResNet(nn.Module):
    """CLIP's ResNet (openai/CLIP model.py ModifiedResNet)."""

    def __init__(self, cfg: ModifiedResNetConfig = ModifiedResNetConfig()):
        super().__init__()
        w = cfg.width
        self.conv1, self.bn1 = _conv(3, w // 2, 3, 2), BNInfer(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3), BNInfer(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3), BNInfer(w)
        cin = w
        for stage, n_blocks in enumerate(cfg.layers):
            planes = w * 2 ** stage
            for blk in range(n_blocks):
                stride = 2 if stage > 0 and blk == 0 else 1
                setattr(self, f"layer{stage + 1}_{blk}", Bottleneck(cin, planes, stride))
                cin = planes * 4
        self.block_names = [f"layer{stage + 1}_{blk}"
                            for stage, n in enumerate(cfg.layers) for blk in range(n)]
        self.attnpool = AttentionPool2d(cfg.image_size // 32, w * 32, cfg.heads, cfg.embed_dim,
                                        cfg.pos_embedding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 3, H, W], CLIP-normalised
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.attnpool(x)


class CLIPIQAMetric:
    """``clipiqa(images)`` -> ``[B]`` in (0, 1), higher is better, for
    ``[B, H, W, 3]`` images in [0, 1] at their own size, on `device` (``cuda``
    unless the caller asks for the CPU)."""

    def __init__(self, visual_params: Mapping[str, Any], text_emb, logit_scale: float = 100.0,
                 cfg: ModifiedResNetConfig = ModifiedResNetConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.visual = load_module(lambda: ModifiedResNet(cfg), visual_params, self.device)
        # [2, embed_dim], L2-normalised
        self.text_emb = torch.tensor(np.asarray(text_emb), dtype=torch.float32,
                                     device=self.device)
        self.logit_scale = float(logit_scale)

    @classmethod
    def from_jax_params(cls, visual_params: Mapping[str, Any], text_emb,
                        logit_scale: float = 100.0,
                        cfg: ModifiedResNetConfig = ModifiedResNetConfig(),
                        device="cuda") -> "CLIPIQAMetric":
        """The JAX ``CLIPIQAMetric``'s ``visual_params``, ``text_emb`` and
        ``logit_scale`` (as numpy), at its config."""
        return cls(visual_params, text_emb, logit_scale, cfg, device)

    def __call__(self, images) -> torch.Tensor:
        x = images_on(images, self.device).permute(0, 3, 1, 2)
        with scoring(self.device):
            mean = cached(("clip_mean",), x.device, lambda: np.array(CLIP_MEAN), x.dtype)
            std = cached(("clip_std",), x.device, lambda: np.array(CLIP_STD), x.dtype)
            mean, std = mean.view(1, 3, 1, 1), std.view(1, 3, 1, 1)
            feat = self.visual((x - mean) / std)
            feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
            logits = self.logit_scale * feat @ self.text_emb.T  # [B, 2]
            return torch.softmax(logits, dim=-1)[:, 0]

    @classmethod
    def from_torch(cls, clip_rn50_path: str, prompts: Sequence[str] = DEFAULT_PROMPTS,
                   pos_embedding: str = "interpolate", device="cuda") -> "CLIPIQAMetric":
        """An OpenAI CLIP RN50 state dict (``RN50.pt``'s ``state_dict()`` saved
        plainly, or a re-export under the same names)."""
        from ..weights.convert import load_torch_file

        return cls.from_state_dict(load_torch_file(clip_rn50_path), prompts, pos_embedding,
                                   device)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any], prompts: Sequence[str] = DEFAULT_PROMPTS,
                        pos_embedding: str = "interpolate", device="cuda") -> "CLIPIQAMetric":
        from ..models.clip import CLIPTextConfig, CLIPTextTower
        from ..models.tokenizer import tokenize
        from ..weights.convert import convert_clipiqa

        sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
        width = sd["visual.layer1.0.conv1.weight"].shape[1]
        layers = []
        for stage in range(1, 5):
            n = 0
            while f"visual.layer{stage}.{n}.conv1.weight" in sd:
                n += 1
            layers.append(n)
        spacial = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        cfg = ModifiedResNetConfig(
            layers=tuple(layers), width=width, embed_dim=sd["text_projection"].shape[1],
            # OpenAI's ModifiedResNet: one head per 64 channels of the
            # attention pool's width, which is 32 times the stem's
            heads=width * 32 // 64, image_size=spacial * 32, pos_embedding=pos_embedding,
        )
        # the text side: OpenAI's transformer through every block, QuickGELU
        t_width = sd["ln_final.weight"].shape[0]
        n_layers = 0
        while f"transformer.resblocks.{n_layers}.ln_1.weight" in sd:
            n_layers += 1
        tcfg = CLIPTextConfig(width=t_width, heads=max(1, t_width // 64), layers=n_layers,
                              layer="last", act="quick_gelu")
        tree = convert_clipiqa(sd, cfg, tcfg)
        dev = resolve_device(device)
        tower = load_module(lambda: CLIPTextTower(tcfg), tree["text"], dev)
        tokens = torch.from_numpy(tokenize(list(prompts))).to(dev)
        with scoring(dev):
            hidden = tower(tokens)                                    # [2, 77, W]
            pooled = hidden[torch.arange(hidden.shape[0], device=dev), tokens.argmax(dim=-1)]
            text_emb = pooled @ torch.from_numpy(tree["text_projection"]).to(dev)
            text_emb = text_emb / torch.linalg.vector_norm(text_emb, dim=-1, keepdim=True)
        scale = float(np.exp(tree["logit_scale"])) if "logit_scale" in tree else 100.0
        return cls(tree["visual"], text_emb.cpu().numpy(), scale, cfg, dev)
