"""Latent guidance: a pull of the predicted clean latent toward a target.

Counterpart of ``tair_tpu/utils/guidance.py`` (``MSEGuidance``,
``WeightedMSEGuidance``): `n_repeats` gradient steps on -loss, gated by a
timestep window. The gradient is taken by ``torch.autograd.grad`` with respect
to the latent alone, under ``torch.enable_grad()``, so it works inside a
caller's ``no_grad`` and touches no model weight.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MSEGuidance:
    scale: float = 0.0
    t_start: int = 1001
    t_stop: int = -1
    n_repeats: int = 1

    def active(self, t: torch.Tensor) -> torch.Tensor:
        return (t < self.t_start) & (t > self.t_stop)

    def loss(self, pred_x0: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return ((pred_x0 - target) ** 2).sum()

    def __call__(self, pred_x0: torch.Tensor, target: torch.Tensor, t: torch.Tensor):
        guided = pred_x0.detach()
        target = target.detach()
        with torch.enable_grad():
            for _ in range(self.n_repeats):
                x = guided.requires_grad_(True)
                (g,) = torch.autograd.grad(-self.loss(x, target), x)
                guided = (x + self.scale * g).detach()
        gate = self.active(t).to(pred_x0.dtype).reshape(-1, 1, 1, 1)
        return pred_x0 + gate * (guided - pred_x0)


@dataclass(frozen=True)
class WeightedMSEGuidance(MSEGuidance):
    """Edge-aware weighting: flat regions of the target pull harder."""

    def loss(self, pred_x0: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        gray = target.mean(dim=-1, keepdim=True)
        gx = torch.diff(gray, dim=2, append=gray[:, :, -1:]).abs()
        gy = torch.diff(gray, dim=1, append=gray[:, -1:]).abs()
        w = 1.0 - ((gx + gy) * 2.0).clamp(0.0, 1.0)
        return (w * (pred_x0 - target) ** 2).sum()
