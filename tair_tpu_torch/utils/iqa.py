"""What the five learned IQA metrics share, and how the entry points build them.

The metrics (``utils/{lpips,dists,clipiqa,maniqa,musiq}.py``) are the port's
counterparts of the JAX package's modules of the same names. Each is an
``nn.Module`` working in NCHW inside, wrapped by a ``...Metric`` that takes
``[B, H, W, 3]`` images in [0, 1] (tensors or numpy arrays), moves them to its
device and returns ``[B]`` scores there. A metric runs in float32 with
autocast and TF32 off for the length of its call (cuDNN's convolutions run
float32 as TF32 by default on the card, and the trainer's validation runs
under bfloat16 autocast), so a score does not depend on who set those flags.
Its attention is plain ``einsum`` + ``softmax``, as it is in JAX: no kernel
of the port runs in a metric.

`build_metric` reads a config's ``val.<name>_weights`` as the JAX scripts do
(``val.py:104-126``, ``train.py::_aux_val_metrics``): LPIPS and DISTS take
``"backbone:head"``, two checkpoint paths joined by a colon; the others one
path. `score` calls one: LPIPS and DISTS against the reference image, the
others on the restored image alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

# the JAX scripts' learned metrics, and those of them that compare with a reference
METRICS = ("lpips", "dists", "clipiqa", "maniqa", "musiq")
FULL_REFERENCE = ("lpips", "dists")


def resolve_device(device) -> torch.device:
    """`device` as a ``torch.device``; raises for ``cuda`` when there is no card."""
    from ..pipeline import _resolve_device

    return _resolve_device(device)


@contextlib.contextmanager
def scoring(device: torch.device):
    """One metric call: no gradients, float32 with autocast and TF32 off."""
    from ..data.batch_transform import exact_float32

    with torch.no_grad(), exact_float32(device.type):
        yield


def images_on(images, device: torch.device) -> torch.Tensor:
    """``[B, H, W, 3]`` images (a tensor or a numpy array) as float32 on `device`."""
    return torch.as_tensor(images).to(device=device, dtype=torch.float32)


def load_module(build: Callable[[], nn.Module], tree: Mapping, device: torch.device) -> nn.Module:
    """``build()``'s module on `device` holding the parameter tree `tree` in the
    JAX package's layout (nested dicts of numpy arrays), loaded strictly; in
    eval mode with no gradients. The module is built on the meta device, so its
    own initialisation costs nothing."""
    from ..weights.convert import convert_tree

    with torch.device("meta"):
        module = build()
    module = module.to_empty(device=device)
    module.load_state_dict(convert_tree(tree), strict=True)
    return module.eval().requires_grad_(False)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain multi-head attention over ``[B, T, H, D]`` q, k, v:
    ``softmax(q k^T / sqrt(D) + bias) v`` as ``[B, Tq, H * D]``."""
    b, tq, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return out.reshape(b, tq, h * d)


class TransformerBlock(nn.Module):
    """The pre-LN block of timm's ViT, which MANIQA's backbone and MUSIQ's
    encoder share: LayerNorm eps 1e-6, fused qkv, exact GELU."""

    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        b, t, d = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, t, 3, self.heads, d // self.heads)
        x = x + self.proj(attend(*qkv.unbind(2)))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


def build_metric(name: str, path: str, device="cuda"):
    """The metric `name` (one of `METRICS`) from its ``val.<name>_weights``
    entry `path`, on `device`."""
    if name == "lpips":
        from .lpips import LPIPSMetric

        return LPIPSMetric.from_torch(*path.split(":"), device=device)
    if name == "dists":
        from .dists import DISTSMetric

        return DISTSMetric.from_torch(*path.split(":"), device=device)
    if name == "clipiqa":
        from .clipiqa import CLIPIQAMetric

        return CLIPIQAMetric.from_torch(path, device=device)
    if name == "maniqa":
        from .maniqa import MANIQAMetric

        return MANIQAMetric.from_torch(path, device=device)
    if name == "musiq":
        from .musiq import MUSIQMetric

        return MUSIQMetric.from_torch(path, device=device)
    raise ValueError(f"unknown metric {name!r}; choose from {METRICS}")


def score(metric, name: str, restored, reference=None) -> torch.Tensor:
    """``[B]`` scores of the images `restored` (``[B, H, W, 3]`` in [0, 1]):
    against `reference` for LPIPS and DISTS, alone for the others."""
    return metric(restored, reference) if name in FULL_REFERENCE else metric(restored)
