"""Diffusion forward process and training loss.

Counterpart of ``tair_tpu/diffusion/diffusion.py``: ``q_sample``, the v target
and the single-step training loss under the eps / x0 / v parameterisations,
over a ``DiffusionSchedule`` whose float64 buffers are read as float32. The
noise of ``p_losses`` is handed in as a tensor or drawn from a
``torch.Generator``, where the JAX function takes a key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .schedules import DiffusionSchedule


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather a[t] and reshape to [b, 1, 1, ...] for broadcasting over ndim."""
    out = a[t.long()]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


@dataclass(frozen=True)
class Diffusion:
    """Training-time diffusion math under eps/x0/v parameterization."""

    schedule: DiffusionSchedule
    parameterization: str = "v"
    loss_type: str = "l2"

    def __post_init__(self):
        if self.parameterization not in ("eps", "x0", "v"):
            raise ValueError(f"unknown parameterization {self.parameterization!r}")
        if self.loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss type {self.loss_type!r}")
        object.__setattr__(self, "_buffers", {})  # (name, device) -> float32 tensor

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def _buf(self, name: str, device: torch.device) -> torch.Tensor:
        buf = self._buffers.get((name, device))
        if buf is None:
            values = np.asarray(getattr(self.schedule, name), dtype=np.float32)
            buf = self._buffers[(name, device)] = torch.from_numpy(values).to(device)
        return buf

    def _coef(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return _extract(self._buf(name, t.device), t, ndim)

    def q_sample(self, z_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (
            self._coef("sqrt_alphas_cumprod", t, z_0.dim()) * z_0
            + self._coef("sqrt_one_minus_alphas_cumprod", t, z_0.dim()) * noise
        )

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return (
            self._coef("sqrt_alphas_cumprod", t, x.dim()) * noise
            - self._coef("sqrt_one_minus_alphas_cumprod", t, x.dim()) * x
        )

    def pred_x_start_from_eps(self, x_t, t, eps):
        return (
            x_t - self._coef("sqrt_one_minus_alphas_cumprod", t, x_t.dim()) * eps
        ) / self._coef("sqrt_alphas_cumprod", t, x_t.dim())

    def pred_x_start_from_v(self, x_t, t, v):
        return (
            self._coef("sqrt_alphas_cumprod", t, x_t.dim()) * x_t
            - self._coef("sqrt_one_minus_alphas_cumprod", t, x_t.dim()) * v
        )

    def target(self, z_0, noise, t):
        if self.parameterization == "x0":
            return z_0
        if self.parameterization == "eps":
            return noise
        return self.get_v(z_0, noise, t)

    def loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        diff = target.float() - pred.float()
        if self.loss_type == "l1":
            return diff.abs().mean()
        return (diff * diff).mean()

    def p_losses(
        self,
        model_fn: Callable,  # (z_t, t, cond) -> (model_output, extracted_feats)
        z_0: torch.Tensor,
        t: torch.Tensor,
        cond,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Single-step training loss; returns (loss, extracted_feats). `noise`
        (z_0's shape) is drawn from `generator` when not given."""
        if noise is None:
            noise = torch.randn(
                z_0.shape, dtype=z_0.dtype, device=z_0.device, generator=generator
            )
        z_t = self.q_sample(z_0, t, noise)
        model_output, extracted_feats = model_fn(z_t, t, cond)
        return self.loss(model_output, self.target(z_0, noise, t)), extracted_feats
