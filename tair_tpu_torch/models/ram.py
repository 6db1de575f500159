"""RAM++ (Recognize Anything Plus) open-vocabulary image tagger.

Counterpart of ``tair_tpu/models/ram.py``, which reconstructs the inference
graph of ``ram_plus(image_size=384, vit="swin_l")`` from the published
architecture (its docstring says how far that goes; the ``ram`` package is not
in this environment, and no checkpoint was held against it):

  Swin-L encoder (4 x 4 patch embedding, stages (2, 2, 18, 2) with patch
  merging, windows of 12 at 384 x 384) -> the mean of the final tokens put
  first as the "CLS" token -> ``image_proj`` into the 512-d description space
  -> a softmax over each class's 51 description embeddings against the
  normalised CLS embedding -> ReLU'd ``wordvec_proj`` into the 768-d decoder
  -> 2 post-LN BERT layers [self-attention over the class queries,
  cross-attention to the image tokens, FFN] -> GroupWiseLinear per-class
  logits -> sigmoid > threshold -> tag strings.

The Swin blocks are MANIQA's (``utils/maniqa.SwinBlock``), as they are in the
JAX package. LayerNorm eps is 1e-5 in the encoder and 1e-12 in the BERT layers;
the FFN's GELU is exact. A tagger runs float32 with autocast and TF32 off: a tag
is a sigmoid held against 0.68, so rounding moves tags. Attention is plain
``einsum`` + ``softmax``; no kernel of the port runs here.

The weights are ``ram_plus_swin_large_14m.pth`` with ``ram_tag_list.txt``
(``RAMTagger.from_torch``); they are not in the repo.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.iqa import attend, load_module, resolve_device, scoring
from ..utils.maniqa import IMAGENET_MEAN, IMAGENET_STD, SwinBlock


def _ln5(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


def _ln12(dim: int) -> nn.LayerNorm:
    # BERT keeps layer_norm_eps=1e-12 (q2l_config.json)
    return nn.LayerNorm(dim, eps=1e-12)


@dataclass(frozen=True)
class SwinConfig:
    img_size: int = 384
    patch_size: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 12
    mlp_ratio: float = 4.0

    @property
    def vision_width(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def swin_l_384() -> SwinConfig:
    """swin_large_patch4_window12_384, the ``vit="swin_l"`` encoder."""
    return SwinConfig()


class PatchMerging(nn.Module):
    """torch Swin's downsample: the 2 x 2 neighbourhood concatenated -> LN ->
    Linear(2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = _ln5(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C] -> [B, H/2, W/2, 2C]
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """One classification-Swin stage: `depth` blocks, then a patch merging
    unless it is the last."""

    def __init__(self, dim: int, res: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.dim, self.res = dim, res
        ws = min(window, res)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, (res, res), heads, ws,
                      0 if j % 2 == 0 or ws >= res else ws // 2, int(dim * mlp_ratio))
            for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, res, res, dim]
        b = x.shape[0]
        t = x.reshape(b, self.res * self.res, self.dim)
        for block in self.blocks:
            t = block(t)
        x = t.reshape(b, self.res, self.res, self.dim)
        return self.downsample(x) if self.downsample is not None else x


class SwinBackbone(nn.Module):
    """Classification Swin with BLIP's pooled-token output: ``[B, 3, H, W]``
    normalised -> ``[B, 1 + L, C]``, the mean token first."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size, c.patch_size)
        self.patch_norm = _ln5(c.embed_dim)
        res, dim = c.grid, c.embed_dim
        for i, depth in enumerate(c.depths):
            last = i == len(c.depths) - 1
            setattr(self, f"stage_{i}", SwinStage(dim, res, depth, c.num_heads[i], c.window,
                                                  c.mlp_ratio, downsample=not last))
            if not last:
                res, dim = res // 2, dim * 2
        self.norm = _ln5(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))  # NHWC
        for i in range(len(self.cfg.depths)):
            x = getattr(self, f"stage_{i}")(x)
        b, h, w, d = x.shape
        tokens = self.norm(x.reshape(b, h * w, d))
        return torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, T, D]`` q, k, v -> ``[B, Tq, D]``: softmax(q k^T / sqrt(D / heads)) v per head."""
    b, tq, d = q.shape
    hd = d // heads
    return attend(q.reshape(b, tq, heads, hd), k.reshape(b, -1, heads, hd),
                  v.reshape(b, -1, heads, hd))


class BertTagLayer(nn.Module):
    """One post-LN BERT decoder layer: self-attention over the class queries,
    cross-attention to the image tokens, FFN; LayerNorm eps 1e-12."""

    def __init__(self, hidden: int, heads: int, intermediate: int, enc_width: int):
        super().__init__()
        self.heads = heads
        for p in ("query", "key", "value", "out"):
            setattr(self, f"self_{p}", nn.Linear(hidden, hidden))
        self.self_ln = _ln12(hidden)
        self.cross_query = nn.Linear(hidden, hidden)
        self.cross_key = nn.Linear(enc_width, hidden)
        self.cross_value = nn.Linear(enc_width, hidden)
        self.cross_out = nn.Linear(hidden, hidden)
        self.cross_ln = _ln12(hidden)
        self.ffn_in = nn.Linear(hidden, intermediate)
        self.ffn_out = nn.Linear(intermediate, hidden)
        self.ffn_ln = _ln12(hidden)

    def forward(self, h: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        # h [B, C, hidden], enc [B, 1 + L, width]
        a = _attend(self.self_query(h), self.self_key(h), self.self_value(h), self.heads)
        h = self.self_ln(self.self_out(a) + h)
        a = _attend(self.cross_query(h), self.cross_key(enc), self.cross_value(enc), self.heads)
        h = self.cross_ln(self.cross_out(a) + h)
        f = F.gelu(self.ffn_in(h))  # exact
        return self.ffn_ln(self.ffn_out(f) + h)


@dataclass(frozen=True)
class RAMConfig:
    swin: SwinConfig = field(default_factory=swin_l_384)
    num_class: int = 4585
    des_per_class: int = 51       # LLM description embeddings per tag
    embed_width: int = 512        # CLIP description space (q2l encoder_width)
    hidden: int = 768             # q2l_config hidden_size
    heads: int = 4                # q2l_config num_attention_heads
    intermediate: int = 3072
    layers: int = 2
    threshold: float = 0.68       # ram_plus's default class threshold


class RAMPlus(nn.Module):
    """RAM++'s inference graph: ``[B, H, W, 3]`` ImageNet-normalised images at
    ``cfg.swin.img_size`` -> per-class tag logits ``[B, num_class]``."""

    def __init__(self, cfg: RAMConfig = RAMConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.visual_encoder = SwinBackbone(c.swin)
        self.image_proj = nn.Linear(c.swin.vision_width, c.embed_width)
        self.label_embed = nn.Parameter(torch.zeros(c.num_class * c.des_per_class,
                                                    c.embed_width))
        self.reweight_scale = nn.Parameter(torch.tensor(float(np.log(1.0 / 0.07))))
        self.wordvec_proj = nn.Linear(c.embed_width, c.hidden)
        for i in range(c.layers):
            setattr(self, f"tag_layer_{i}",
                    BertTagLayer(c.hidden, c.heads, c.intermediate, c.embed_width))
        self.fc_w = nn.Parameter(torch.zeros(c.num_class, c.hidden))
        self.fc_b = nn.Parameter(torch.zeros(c.num_class))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        tokens = self.visual_encoder(image.permute(0, 3, 1, 2))
        embeds = self.image_proj(tokens)  # [B, 1 + L, 512]

        # each class's description embeddings weighed by a softmax of their
        # similarity to the normalised pooled embedding
        cls = embeds[:, 0]
        cls = cls / torch.linalg.vector_norm(cls, dim=-1, keepdim=True)
        sims = torch.exp(self.reweight_scale) * (cls @ self.label_embed.T)
        w = torch.softmax(sims.reshape(-1, c.num_class, c.des_per_class), dim=-1)
        per_class = self.label_embed.reshape(c.num_class, c.des_per_class, c.embed_width)
        queries = torch.einsum("bcd,cde->bce", w, per_class)  # [B, C, 512]

        h = F.relu(self.wordvec_proj(queries))
        for i in range(c.layers):
            h = getattr(self, f"tag_layer_{i}")(h, embeds)
        # GroupWiseLinear: one weight row and bias per class
        return (h * self.fc_w[None]).sum(-1) + self.fc_b[None]


def load_tag_list(path: str) -> Tuple[str, ...]:
    with open(path, encoding="utf-8") as f:
        return tuple(line.strip() for line in f if line.strip())


class RAMTagger:
    """Tags a batch of images: a list of tag names per image. `thresholds` is a
    scalar or ``[num_class]`` (``ram_tag_list_threshold.txt``'s layout). The
    network runs on `device` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, params: Mapping[str, Any], cfg: RAMConfig = RAMConfig(),
                 tag_list: Sequence[str] | None = None, thresholds=None, device="cuda"):
        if tag_list is not None and len(tag_list) != cfg.num_class:
            raise ValueError(
                f"tag list has {len(tag_list)} entries, model has "
                f"{cfg.num_class} classes")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tag_list = tuple(tag_list) if tag_list is not None else tuple(
            f"tag_{i}" for i in range(cfg.num_class))
        th = cfg.threshold if thresholds is None else thresholds
        self.thresholds = np.broadcast_to(
            np.asarray(th, np.float32), (cfg.num_class,)).copy()
        self.net = load_module(lambda: RAMPlus(cfg), params, self.device)

    def logits(self, images) -> torch.Tensor:
        """``[B, S, S, 3]`` normalised images -> ``[B, num_class]`` on the device."""
        x = torch.as_tensor(images).to(device=self.device, dtype=torch.float32)
        with scoring(self.device):
            return self.net(x)

    def __call__(self, images) -> list:
        probs = torch.sigmoid(self.logits(images)).cpu().numpy()
        keep = probs > self.thresholds[None]
        return [[self.tag_list[i] for i in np.flatnonzero(row)] for row in keep]

    @classmethod
    def from_torch(cls, path: str, cfg: RAMConfig = RAMConfig(),
                   tag_list_path: str | None = None,
                   threshold_path: str | None = None, **kw) -> "RAMTagger":
        from ..weights.convert import convert_ram_plus, load_torch_file

        params = convert_ram_plus(load_torch_file(path), cfg)
        tags = load_tag_list(tag_list_path) if tag_list_path else None
        th = None
        if threshold_path:
            with open(threshold_path) as f:
                th = np.asarray([float(s) for s in f], np.float32)
        return cls(params, cfg, tag_list=tags, thresholds=th, **kw)


def preprocess(image, size: int) -> torch.Tensor:
    """``[H, W, 3]`` float in [0, 1] (numpy, or a tensor, on its device) ->
    ``[1, size, size, 3]`` normalised: RAM's transform, an antialiased bicubic
    resize with ``jax.image.resize``'s rules, then ImageNet's normalisation."""
    from ..data.resize import resize

    x = torch.as_tensor(image, dtype=torch.float32)
    x = resize(x[None], (size, size), "cubic")
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(x.device, non_blocking=True)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(x.device, non_blocking=True)
    return (x - mean) / std
