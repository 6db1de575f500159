"""Sampler base: shared schedule plumbing and classifier-free guidance.

Counterpart of ``tair_tpu/sampler/base.py``. The cosine-rescaled guidance
scale is a float32 scalar computed on the host from the integer timestep, as
the JAX function computes it from the traced one, so no step reads the device
for it. ``guided`` is the mix every sampler applies; the JAX spaced sampler's
rule holds for all of them: at scale 1.0, or with no unconditional branch, the
model runs once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerBase:
    training_betas: np.ndarray
    parameterization: str = "v"
    rescale_cfg: bool = False

    @property
    def num_timesteps(self) -> int:
        return len(self.training_betas)

    def get_cfg_scale(self, default_cfg_scale: float, model_t: int) -> float:
        """Cosine-rescaled CFG scale at integer timestep `model_t`, in float32."""
        scale = np.float32(default_cfg_scale)
        if self.rescale_cfg and default_cfg_scale > 1.0:
            frac = ((np.float32(1000.0) - np.float32(model_t)) / np.float32(1000.0)) ** np.float32(5.0)
            cos = np.cos(np.float32(np.pi) * frac, dtype=np.float32)
            scale = np.float32(1.0) + scale * (np.float32(1.0) - cos) / np.float32(2.0)
        return float(scale)

    def guided(self, model_fn, x, model_t: torch.Tensor, t: int, cond, uncond, cfg_scale: float):
        """(model output, features) under classifier-free guidance at integer
        timestep `t` (`model_t` is it for every row): the conditional pass
        alone at scale 1.0 or without `uncond`, else both passes mixed as
        out_u + scale * (out_c - out_u) with JAX's promotion: the difference in
        the outputs' type, the rest in float32. The features are the
        conditional pass's."""
        if uncond is None or float(cfg_scale) == 1.0:
            return model_fn(x, model_t, cond)
        out_c, feats = model_fn(x, model_t, cond)
        out_u, _ = model_fn(x, model_t, uncond)
        scale = self.get_cfg_scale(cfg_scale, t)
        return out_u.float() + scale * (out_c - out_u).float(), feats


def draw_noise(like: torch.Tensor, noises, i: int, generator) -> torch.Tensor:
    """Standard-normal float32 noise shaped as `like` for loop iteration `i`:
    ``noises[i]`` when the caller handed a list in, else drawn from `generator`."""
    if noises is not None:
        return noises[i]
    return torch.randn(like.shape, dtype=torch.float32, device=like.device, generator=generator)


def check_noises(noises, n: int) -> None:
    if noises is not None and len(noises) != n:
        raise ValueError(f"step_noises holds {len(noises)} draws, the chain has {n} steps")
