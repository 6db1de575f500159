"""DISTS perceptual distance (VGG16 backbone).

Counterpart of ``tair_tpu/utils/dists.py``, after the official implementation
(Ding et al., "Image Quality Assessment: Unifying Structure and Texture
Similarity"): torchvision's VGG16 convolutions at six levels (the input
included) with each max-pool replaced by L2 pooling, and per channel a
structure (mean) and a texture (variance, covariance) similarity, weighted by
the learned ``alpha`` and ``beta`` normalised by their joint sum. The weights
are torchvision's VGG16 and DISTS's ``weights.pt`` (``DISTSMetric.from_torch``);
they are not in the repo.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device_constants import cached
from .iqa import images_on, load_module, resolve_device, scoring

# VGG16's convolution widths by stage
_VGG_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_CHANNELS = (3,) + tuple(stage[-1] for stage in _VGG_STAGES)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _hann_window(size: int) -> np.ndarray:
    w1 = np.hanning(size)[1:-1]
    win = np.outer(w1, w1)
    return (win / win.sum()).astype(np.float32)


def _l2_pool(x: torch.Tensor, size: int = 5, stride: int = 2) -> torch.Tensor:
    """Hann-windowed L2 pooling of ``[B, C, H, W]``: ``np.hanning(5)[1:-1]``, a
    3-tap [0.25, 0.5, 0.25] window, depthwise over the squares, stride 2,
    padding 1, then ``sqrt(max(., 1e-12))``; in float32."""
    win = cached(("dists_hann", size), x.device, lambda: _hann_window(size))
    c = x.shape[1]
    pad = (size - 2) // 2
    out = F.conv2d((x * x).float(), win.expand(c, 1, *win.shape), stride=stride, padding=pad,
                   groups=c)
    return torch.sqrt(out.clamp_min(1e-12))


class VGG16Features(nn.Module):
    """VGG16's convolutions with L2 pooling between the stages; the six DISTS
    levels, the input first."""

    def __init__(self):
        super().__init__()
        cin = 3
        for si, stage in enumerate(_VGG_STAGES):
            for ci, cout in enumerate(stage):
                setattr(self, f"conv{si}_{ci}", nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:  # [B, 3, H, W]
        feats = [x]
        for si, stage in enumerate(_VGG_STAGES):
            if si > 0:
                x = _l2_pool(x)
            for ci in range(len(stage)):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            feats.append(x)
        return feats


class DISTS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.alpha = nn.Parameter(torch.empty(sum(_CHANNELS)))
        self.beta = nn.Parameter(torch.empty(sum(_CHANNELS)))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The six levels of ``[B, 3, H, W]`` images in [0, 1]."""
        mean = cached(("dists_mean",), x.device, lambda: np.array(_MEAN), x.dtype)
        std = cached(("dists_std",), x.device, lambda: np.array(_STD), x.dtype)
        mean, std = mean.view(1, 3, 1, 1), std.view(1, 3, 1, 1)
        return self.vgg((x - mean) / std)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: ``[B, 3, H, W]`` in [0, 1] -> ``[B]`` distances (0: the same image)."""
        w_sum = self.alpha.sum() + self.beta.sum()
        alphas = torch.split(self.alpha / w_sum, _CHANNELS)
        betas = torch.split(self.beta / w_sum, _CHANNELS)
        c1 = c2 = 1e-6
        score = 0.0
        for xa, xb, al, be in zip(self.features(a), self.features(b), alphas, betas):
            mu_a, mu_b = xa.mean(dim=(2, 3)), xb.mean(dim=(2, 3))
            da, db = xa - mu_a[..., None, None], xb - mu_b[..., None, None]
            var_a, var_b = (da ** 2).mean(dim=(2, 3)), (db ** 2).mean(dim=(2, 3))
            cov = (da * db).mean(dim=(2, 3))
            s1 = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
            s2 = (2 * cov + c2) / (var_a + var_b + c2)
            score = score + (al * s1).sum(-1) + (be * s2).sum(-1)
        return 1.0 - score


class DISTSMetric:
    """``dists(a, b)`` -> ``[B]`` distances of ``[B, H, W, 3]`` images in
    [0, 1], on `device` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = None if params is None else load_module(DISTS, params, self.device)

    @classmethod
    def from_jax_params(cls, params: Mapping[str, Any], device="cuda") -> "DISTSMetric":
        """The JAX ``DISTSMetric``'s tree (``metric.params["params"]``, as numpy)."""
        return cls(params, device)

    @classmethod
    def from_torch(cls, vgg16_path: str, dists_weights_path: str, device="cuda") -> "DISTSMetric":
        """torchvision's VGG16 state dict and DISTS's ``weights.pt`` (``alpha``,
        ``beta``, each ``[1, 1475, 1, 1]``)."""
        from ..weights.convert import convert_dists, load_torch_file

        return cls(convert_dists(load_torch_file(vgg16_path),
                                 load_torch_file(dists_weights_path)), device)

    def __call__(self, a, b) -> torch.Tensor:
        if self.model is None:
            raise RuntimeError(
                "DISTS weights not loaded; use DISTSMetric.from_torch(...) "
                "with a torchvision vgg16 state dict + the official DISTS weights.pt"
            )
        a, b = (images_on(x, self.device).permute(0, 3, 1, 2) for x in (a, b))
        with scoring(self.device):
            return self.model(a, b)
