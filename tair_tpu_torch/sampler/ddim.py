"""DDIM sampler.

Counterpart of ``tair_tpu/sampler/ddim.py``: the pre-fork DDIM update over the
``ddim<steps>`` timesteps, ``eta`` for the stochastic variant, classifier-free
guidance, and the ``(out, feats)`` model contract. The schedule is float32
scalars read on the host; ``lax.scan`` is a Python loop; the noise of each
step is handed in (``step_noises``, one per step in loop order) or drawn from
a ``torch.Generator``, and not drawn at all where its scale is 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..diffusion.schedules import space_timesteps
from .base import SamplerBase, check_noises, draw_noise


@dataclass(frozen=True)
class DDIMSampler(SamplerBase):
    eta: float = 0.0

    def schedule(self, steps: int):
        """(timesteps int, alphas, alphas_prev, sigmas float32) of the chain."""
        used = np.asarray(sorted(space_timesteps(self.num_timesteps, f"ddim{steps}")), np.int32)
        ac = np.concatenate([[1.0], np.cumprod(1.0 - self.training_betas)])
        alphas = ac[used + 1].astype(np.float32)
        alphas_prev = np.concatenate([[1.0], ac[used[:-1] + 1]]).astype(np.float32)
        one = np.float32(1.0)
        sigmas = np.float32(self.eta) * np.sqrt(
            (one - alphas_prev) / (one - alphas) * (one - alphas / alphas_prev)
        )
        return used, alphas, alphas_prev, sigmas

    def sample(
        self,
        model_fn,
        steps: int,
        x_T: torch.Tensor,
        cond,
        uncond=None,
        cfg_scale: float = 1.0,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        timesteps, alphas, alphas_prev, sigmas = self.schedule(steps)
        check_noises(step_noises, steps)
        bs = x_T.shape[0]
        x = x_T
        for i in range(steps):
            idx = steps - 1 - i
            t = int(timesteps[idx])
            model_t = torch.full((bs,), t, dtype=torch.int32, device=x.device)
            out, _ = self.guided(model_fn, x, model_t, t, cond, uncond, cfg_scale)
            out = out.float()
            a, a_prev, sig = alphas[idx], alphas_prev[idx], sigmas[idx]
            sqrt_a, sqrt_1ma = float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))
            if self.parameterization == "v":
                x0 = sqrt_a * x - sqrt_1ma * out
                eps = sqrt_a * out + sqrt_1ma * x
            else:
                eps = out
                x0 = (x - sqrt_1ma * eps) / sqrt_a
            dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sig * sig, np.float32(0.0)))
            x_prev = float(np.sqrt(a_prev)) * x0 + float(dir_coef) * eps
            if sig != 0.0:
                x_prev = x_prev + float(sig) * draw_noise(x, step_noises, i, generator)
            x = x_prev.to(x_T.dtype)
        return x
