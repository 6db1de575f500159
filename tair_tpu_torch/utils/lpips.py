"""LPIPS perceptual distance (AlexNet backbone).

Counterpart of ``tair_tpu/utils/lpips.py``: torchvision's AlexNet features at
five levels (the 11 x 11 stride-4 convolution padded by 2; a 3 x 3 stride-2
max-pool after the first two levels only), each level unit-normalised over
its channels, the squared difference weighted by the ``lin{i}`` 1 x 1 heads
and averaged over space. The weights are torchvision's AlexNet and LPIPS's
``lin`` heads (``LPIPSMetric.from_torch``); they are not in the repo.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device_constants import cached
from .iqa import images_on, load_module, resolve_device, scoring

# AlexNet's convolutions: (in channels, out channels, kernel, stride)
_ALEX_CONVS = ((3, 64, 11, 4), (64, 192, 5, 1), (192, 384, 3, 1), (384, 256, 3, 1),
               (256, 256, 3, 1))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        for si, (cin, cout, k, s) in enumerate(_ALEX_CONVS):
            pad = 2 if k == 11 else k // 2
            setattr(self, f"conv{si}_0", nn.Conv2d(cin, cout, k, s, padding=pad))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:  # [B, 3, H, W]
        feats = []
        for si in range(len(_ALEX_CONVS)):
            x = F.relu(getattr(self, f"conv{si}_0")(x))
            feats.append(x)
            if si < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, (_, cout, _, _) in enumerate(_ALEX_CONVS):
            setattr(self, f"lin{i}", nn.Conv2d(cout, 1, 1, bias=False))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five levels of ``[B, 3, H, W]`` images in [0, 1]."""
        shift = cached(("lpips_shift",), x.device, lambda: np.array(_SHIFT), x.dtype)
        scale = cached(("lpips_scale",), x.device, lambda: np.array(_SCALE), x.dtype)
        shift, scale = shift.view(1, 3, 1, 1), scale.view(1, 3, 1, 1)
        return self.alex((x * 2.0 - 1.0 - shift) / scale)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: ``[B, 3, H, W]`` in [0, 1] -> ``[B]`` distances."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self.features(a), self.features(b))):
            xa = xa / torch.linalg.vector_norm(xa, dim=1, keepdim=True).clamp_min(1e-10)
            xb = xb / torch.linalg.vector_norm(xb, dim=1, keepdim=True).clamp_min(1e-10)
            total = total + getattr(self, f"lin{i}")((xa - xb) ** 2).mean(dim=(1, 2, 3))
        return total


class LPIPSMetric:
    """``lpips(a, b)`` -> ``[B]`` distances of ``[B, H, W, 3]`` images in
    [0, 1], on `device` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = None if params is None else load_module(LPIPS, params, self.device)

    @classmethod
    def from_jax_params(cls, params: Mapping[str, Any], device="cuda") -> "LPIPSMetric":
        """The JAX ``LPIPSMetric``'s tree (``metric.params["params"]``, as numpy)."""
        return cls(params, device)

    @classmethod
    def from_torch(cls, alexnet_path: str, lpips_path: str, device="cuda") -> "LPIPSMetric":
        """torchvision's AlexNet state dict and LPIPS's ``lin`` heads file."""
        from ..weights.convert import convert_lpips, load_torch_file

        return cls(convert_lpips(load_torch_file(alexnet_path), load_torch_file(lpips_path)),
                   device)

    def __call__(self, a, b) -> torch.Tensor:
        if self.model is None:
            raise RuntimeError(
                "LPIPS weights not loaded; use LPIPSMetric.from_torch(...) "
                "with torchvision alexnet + lpips lin checkpoints"
            )
        a, b = (images_on(x, self.device).permute(0, 3, 1, 2) for x in (a, b))
        with scoring(self.device):
            return self.model(a, b)
