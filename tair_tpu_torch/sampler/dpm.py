"""DPM-Solver++ samplers, multistep and singlestep, orders 1-3.

Counterpart of ``tair_tpu/sampler/dpm.py``: data-prediction ("dpmsolver++")
updates in log-SNR over the trained discrete schedule, time-uniform nodes.
The node tables (``_cont_maps``, ``_nodes_at_t``, ``_t_of_lam``) are the JAX
module's numpy code unchanged, built in float64 and cast to float32 as it casts
them, so the integer timesteps are the same; the updates read them on the host
as float32 scalars. ``lax.scan`` / ``jnp.where`` over the step index are a
Python loop and branches.

Model passes: the multistep solver evaluates each of its ``steps + 1`` nodes
once (the JAX scan evaluates node 0 twice, before the scan and in its first
iteration, on the same input); the singlestep solver ``steps * order + 1``.
Either doubles under classifier-free guidance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .base import SamplerBase


def _cont_maps(training_betas):
    """Continuous-time interpolants of the trained discrete schedule."""
    ac = np.cumprod(1.0 - np.asarray(training_betas, np.float64))
    # zero-terminal-SNR schedules end at alpha_bar = 0 exactly; clamp before
    # the logs or lambda(T) = -inf
    ac = np.clip(ac, 1e-10, 1.0)
    log_alpha = 0.5 * np.log(ac)
    t_grid = np.linspace(1e-3, 1.0, len(ac))
    sigma = np.sqrt(1 - ac)
    lam = log_alpha - np.log(sigma)  # lambda(t), decreasing in t
    return t_grid, lam, log_alpha, len(ac)


def _nodes_at_t(ts, t_grid, lam, log_alpha, n):
    """(alpha, sigma, lambda, discrete-t) at continuous times ts."""
    lam_i = np.interp(ts, t_grid, lam)
    la_i = np.interp(ts, t_grid, log_alpha)
    sig_i = np.exp(la_i - lam_i)
    alpha_i = np.exp(la_i)
    t_disc = np.clip(np.round(ts * (n - 1)).astype(np.int32), 0, n - 1)
    return alpha_i, sig_i, lam_i, t_disc


def _t_of_lam(lam_target, t_grid, lam):
    """Invert lambda(t) (lam is decreasing in t)."""
    return np.interp(lam_target, lam[::-1], t_grid[::-1])


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@dataclass(frozen=True)
class _DPMBase(SamplerBase):
    order: int = 2

    def _check_order(self) -> None:
        if self.order not in (1, 2, 3):
            raise ValueError(f"order must be 1, 2 or 3, got {self.order}")

    def _denoiser(self, model_fn, cond, uncond, cfg_scale):
        """x0 prediction at an integer timestep: (x, t) -> float32 tensor."""
        sac = np.sqrt(_f32(np.cumprod(1.0 - self.training_betas)))
        s1m = np.sqrt(1.0 - sac * sac)

        def denoise(x: torch.Tensor, t: int) -> torch.Tensor:
            model_t = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
            out, _ = self.guided(model_fn, x, model_t, t, cond, uncond, cfg_scale)
            out = out.float()
            a, s = float(sac[t]), float(s1m[t])
            if self.parameterization == "v":
                return a * x - s * out
            return (x - s * out) / max(a, 1e-8)

        return denoise


@dataclass(frozen=True)
class DPMSolverPP(_DPMBase):
    """Multistep DPM-Solver++: order 1 is the DDIM-equivalent update, 2 the
    "2M" solver, 3 adds the second divided difference; the first nodes reduce
    the order (1 at node 0, 2 at node 1)."""

    def schedule(self, steps: int):
        """(alpha, sigma, lambda float32, discrete timesteps int32) at the
        ``steps + 1`` nodes, uniform in t from T to 1e-3."""
        t_grid, lam, log_alpha, n = _cont_maps(self.training_betas)
        ts = np.linspace(1.0, 1e-3, steps + 1)
        alpha, sigma, lam_i, t_disc = _nodes_at_t(ts, t_grid, lam, log_alpha, n)
        return _f32(alpha), _f32(sigma), _f32(lam_i), t_disc

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
        """`step_noises` and `generator` are taken for the samplers' common
        signature; the solver is deterministic and draws nothing."""
        self._check_order()
        alpha, sigma, lam, t_disc = self.schedule(steps)
        denoise = self._denoiser(model_fn, cond, uncond, cfg_scale)
        x = x_T
        x0_prev = x0_prev2 = None
        for i in range(steps):
            h = lam[i + 1] - lam[i]
            x0_cur = denoise(x, int(t_disc[i]))
            phi1 = np.expm1(-h)
            base = float(sigma[i + 1] / sigma[i]) * x - float(alpha[i + 1] * phi1) * x0_cur
            if self.order == 1 or i == 0:
                x_next = base
            else:
                r0 = (lam[i] - lam[i - 1]) / h
                d1_0 = (x0_cur - x0_prev) / float(r0)
                if self.order == 2 or i == 1:
                    x_next = base - float(alpha[i + 1] * phi1) * (0.5 * d1_0)
                else:
                    r1 = (lam[i - 1] - lam[i - 2]) / h
                    d1_1 = (x0_prev - x0_prev2) / float(r1)
                    d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
                    d2 = (d1_0 - d1_1) / float(r0 + r1)
                    phi2 = phi1 / h + 1.0
                    phi3 = phi2 / h - 0.5
                    x_next = (base + float(alpha[i + 1] * phi2) * d1
                              - float(alpha[i + 1] * phi3) * d2)
            x = x_next.to(x_T.dtype)
            x0_prev2, x0_prev = x0_prev, x0_cur
        # denoise to zero: the data prediction at the final node
        return denoise(x, int(t_disc[steps]))


@dataclass(frozen=True)
class DPMSolverPPSingle(_DPMBase):
    """Singlestep DPM-Solver++: each of the `steps` outer lambda intervals is
    solved with `order` model evaluations at intermediate nodes (r1 = 1/2 for
    order 2; r1 = 1/3, r2 = 2/3 for order 3)."""

    def schedule(self, steps: int):
        """Float32 tables of the outer nodes (alpha, sigma, h, timesteps) and
        of the intermediate nodes (alpha, sigma, timesteps at r1 and r2)."""
        t_grid, lam, log_alpha, n = _cont_maps(self.training_betas)
        ts = np.linspace(1.0, 1e-3, steps + 1)
        alp, sig, lam_i, td = _nodes_at_t(ts, t_grid, lam, log_alpha, n)
        h = lam_i[1:] - lam_i[:-1]
        r1 = 0.5 if self.order == 2 else 1.0 / 3.0
        r2 = 2.0 / 3.0
        s1 = _nodes_at_t(_t_of_lam(lam_i[:-1] + r1 * h, t_grid, lam), t_grid, lam, log_alpha, n)
        s2 = _nodes_at_t(_t_of_lam(lam_i[:-1] + r2 * h, t_grid, lam), t_grid, lam, log_alpha, n)
        return dict(
            alp=_f32(alp), sig=_f32(sig), h=_f32(h), td=td,
            alp1=_f32(s1[0]), sig1=_f32(s1[1]), td1=s1[3],
            alp2=_f32(s2[0]), sig2=_f32(s2[1]), td2=s2[3],
            r1=r1, r2=r2,
        )

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
        """`step_noises` and `generator` are taken for the samplers' common
        signature; the solver is deterministic and draws nothing."""
        self._check_order()
        s = self.schedule(steps)
        denoise = self._denoiser(model_fn, cond, uncond, cfg_scale)
        alp, sig = s["alp"], s["sig"]
        r1, r2 = s["r1"], s["r2"]  # Python floats, weak in numpy's promotion as in JAX's
        x = x_T
        for i in range(steps):
            hi = s["h"][i]
            m_s = denoise(x, int(s["td"][i]))
            phi1 = np.expm1(-hi)
            base = float(sig[i + 1] / sig[i]) * x - float(alp[i + 1] * phi1) * m_s
            if self.order == 1:
                x_next = base
            elif self.order == 2:
                phi11 = np.expm1(-r1 * hi)
                x_s1 = float(s["sig1"][i] / sig[i]) * x - float(s["alp1"][i] * phi11) * m_s
                m_s1 = denoise(x_s1, int(s["td1"][i]))
                x_next = base - float((0.5 / r1) * alp[i + 1] * phi1) * (m_s1 - m_s)
            else:
                phi11 = np.expm1(-r1 * hi)
                phi12 = np.expm1(-r2 * hi)
                phi22 = phi12 / (r2 * hi) + 1.0
                phi2 = phi1 / hi + 1.0
                x_s1 = float(s["sig1"][i] / sig[i]) * x - float(s["alp1"][i] * phi11) * m_s
                m_s1 = denoise(x_s1, int(s["td1"][i]))
                x_s2 = (
                    float(s["sig2"][i] / sig[i]) * x
                    - float(s["alp2"][i] * phi12) * m_s
                    + float((r2 / r1) * s["alp2"][i] * phi22) * (m_s1 - m_s)
                )
                m_s2 = denoise(x_s2, int(s["td2"][i]))
                x_next = base + float((1.0 / r2) * alp[i + 1] * phi2) * (m_s2 - m_s)
            x = x_next.to(x_T.dtype)
        # denoise to zero: the data prediction at the final node
        return denoise(x, int(s["td"][steps]))
