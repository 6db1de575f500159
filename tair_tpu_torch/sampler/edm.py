"""EDM / Karras-style samplers: Euler, Heun, DPM++ 2M and the ancestral and
SDE variants.

Counterpart of ``tair_tpu/sampler/edm.py``: the discrete VP model wrapped as a
Karras denoiser D(x, sigma), with x scaled by 1/sqrt(1 + sigma^2) and the
timestep taken as the nearest trained sigma. Sigma is a float32 scalar on the
host, so that nearest timestep is a numpy ``argmin`` (ties to the lower index,
as ``jnp.argmin``) and no step reads the device. The stochastic solvers take
their noises as a list (one per step, in loop order) or draw them from a
``torch.Generator``, where the JAX module folds the step into its key.

Model passes per request of `steps` steps: ``steps`` for every solver but
``heun``, which skips its second evaluation where the next sigma is 0 (the
JAX ``lax.cond``), so ``2 * steps - 1``. The JAX ``dpmpp_2m`` also evaluates
D once before its scan only to multiply the result by 0; here that carry
starts at zeros. Classifier-free guidance doubles every pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .base import SamplerBase, check_noises, draw_noise

SOLVERS = ("euler", "heun", "dpmpp_2m", "euler_ancestral", "dpmpp_2m_sde")


def karras_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0):
    ramp = np.linspace(0, 1, n)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
    return np.append(sigmas, 0.0).astype(np.float32)


@dataclass(frozen=True)
class EDMSampler(SamplerBase):
    solver: str = "dpmpp_2m"
    eta: float = 1.0  # ancestral / SDE noise scale

    def vp_sigmas(self) -> np.ndarray:
        """Float32 sigma of every trained timestep (clamped where alpha_bar = 0)."""
        ac = np.cumprod(1.0 - self.training_betas)
        return np.sqrt((1 - ac) / np.clip(ac, 1e-10, 1.0)).astype(np.float32)

    def timestep_of(self, sigma: np.float32, sigmas_vp: np.ndarray) -> int:
        """The nearest trained timestep to `sigma` (lowest index on a tie)."""
        return int(np.argmin(np.abs(sigmas_vp - sigma)))

    def _denoiser(self, model_fn, cond, uncond, cfg_scale):
        sigmas_vp = self.vp_sigmas()
        sac = np.sqrt(np.cumprod(1.0 - self.training_betas).astype(np.float32))
        s1m = np.sqrt(1.0 - sac * sac)

        def D(x: torch.Tensor, sigma: np.float32) -> torch.Tensor:
            """x in Karras space -> denoised x0 (float32)."""
            t = self.timestep_of(sigma, sigmas_vp)
            x_vp = x / float(np.sqrt(1.0 + sigma * sigma))
            model_t = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
            out, _ = self.guided(model_fn, x_vp, model_t, t, cond, uncond, cfg_scale)
            out = out.float()
            a, s = float(sac[t]), float(s1m[t])
            if self.parameterization == "v":
                return a * x_vp - s * out
            return (x_vp - s * out) / max(a, 1e-8)

        return D

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
        sigma_min: float = 0.0292,
        sigma_max: float = 14.61,
    ) -> torch.Tensor:
        """`step_noises` / `generator` feed the two stochastic solvers (one
        draw per step); the others draw nothing."""
        if self.solver not in SOLVERS:
            raise ValueError(self.solver)
        check_noises(step_noises, steps)
        sig = karras_sigmas(steps, sigma_min, sigma_max)
        D = self._denoiser(model_fn, cond, uncond, cfg_scale)
        x = x_T.float() * float(sig[0])
        eta = np.float32(self.eta)

        if self.solver == "euler":
            for i in range(steps):
                d = (x - D(x, sig[i])) / float(sig[i])
                x = x + d * float(sig[i + 1] - sig[i])

        elif self.solver == "heun":
            for i in range(steps):
                d = (x - D(x, sig[i])) / float(sig[i])
                dt = float(sig[i + 1] - sig[i])
                x_e = x + d * dt
                if sig[i + 1] > 0:
                    d2 = (x_e - D(x_e, sig[i + 1])) / float(sig[i + 1])
                    x = x + (d + d2) / 2 * dt
                else:
                    x = x_e

        elif self.solver == "dpmpp_2m":
            lam = np.log(np.maximum(sig, np.float32(1e-10)))
            x0_prev = None
            for i in range(steps):
                x0 = D(x, sig[i])
                if sig[i + 1] > 0:
                    h = lam[i + 1] - lam[i]
                    if i > 0:
                        r = (lam[i] - lam[i - 1]) / h
                        d = float(1 + 1 / (2 * r)) * x0 - float(1 / (2 * r)) * x0_prev
                    else:
                        d = x0
                    x = float(sig[i + 1] / sig[i]) * x - float(np.expm1(-h)) * d
                else:
                    x = x0  # the final step (sigma -> 0) returns the denoised image
                x0_prev = x0

        elif self.solver == "euler_ancestral":
            for i in range(steps):
                x0 = D(x, sig[i])
                # the noise is drawn at every step, as the JAX scan draws it
                noise = draw_noise(x, step_noises, i, generator)
                if sig[i + 1] > 0:
                    s2, sn2 = sig[i] ** 2, sig[i + 1] ** 2
                    sigma_up = np.minimum(sig[i + 1], eta * np.sqrt(sn2 * (s2 - sn2) / s2))
                    sigma_down = np.sqrt(np.maximum(sn2 - sigma_up ** 2, np.float32(0.0)))
                    d = (x - x0) / float(sig[i])
                    x = x + d * float(sigma_down - sig[i]) + noise * float(sigma_up)
                else:
                    x = x0

        else:  # dpmpp_2m_sde
            # k-diffusion's t = -log(sigma); h = t_next - t ("midpoint" form)
            lam = -np.log(np.maximum(sig, np.float32(1e-10)))
            x0_prev = None
            for i in range(steps):
                x0 = D(x, sig[i])
                noise = draw_noise(x, step_noises, i, generator)
                if sig[i + 1] > 0:
                    h = lam[i + 1] - lam[i]
                    eta_h = eta * h
                    decay = sig[i + 1] / sig[i] * np.exp(-eta_h)
                    mix = -np.expm1(-h - eta_h)
                    x_next = float(decay) * x + float(mix) * x0
                    if i > 0:
                        # midpoint correction from the previous data prediction
                        r = (lam[i] - lam[i - 1]) / h
                        x_next = x_next + float(0.5 * mix / r) * (x0 - x0_prev)
                    amp = sig[i + 1] * np.sqrt(np.maximum(-np.expm1(-2.0 * eta_h), np.float32(0.0)))
                    x = x_next + noise * float(amp)
                else:
                    x = x0
                x0_prev = x0
        return x
