"""Spaced DDPM ancestral sampler (the sampler the restore loop uses).

Counterpart of ``tair_tpu/sampler/spaced.py``: ``make_schedule``,
``predict_x0``, ``q_posterior``, ``p_sample``, ``sample`` with the UNet
feature capture at tagged iterations, and ``val_sample_loop``, the
host-driven loop with a per-step feedback hook, and classifier-free guidance
in ``apply_model`` (``SamplerBase.guided``). The step index is a Python int, so
the schedule coefficients and the guidance scale are float32 scalars read on
the host and no step touches the device for them. ``p_sample`` takes the step's noise as an
argument, or draws it from a ``torch.Generator``, where the JAX function takes
a key; ``sample`` takes the chain's noises as a list, where the JAX function
folds the iteration into its key. ``lax.scan`` is a Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..diffusion.schedules import SpacedSchedule
from .base import SamplerBase, check_noises

ModelFn = Callable  # (x, model_t, cond) -> (model_output, feats_tuple)


def _coef(buf: np.ndarray, idx: int) -> float:
    return float(np.float32(buf[idx]))


@dataclass(frozen=True)
class SpacedSampler(SamplerBase):
    def make_schedule(self, num_steps: int) -> SpacedSchedule:
        return SpacedSchedule.create(self.training_betas, num_steps)

    def predict_x0(self, sp: SpacedSchedule, x, t_idx: int, model_output):
        if self.parameterization == "v":
            return (
                _coef(sp.sqrt_alphas_cumprod, t_idx) * x
                - _coef(sp.sqrt_one_minus_alphas_cumprod, t_idx) * model_output
            )
        return (
            _coef(sp.sqrt_recip_alphas_cumprod, t_idx) * x
            - _coef(sp.sqrt_recipm1_alphas_cumprod, t_idx) * model_output
        )

    def q_posterior(self, sp: SpacedSchedule, x0, x_t, t_idx: int):
        mean = (
            _coef(sp.posterior_mean_coef1, t_idx) * x0
            + _coef(sp.posterior_mean_coef2, t_idx) * x_t
        )
        return mean, _coef(sp.posterior_variance, t_idx)

    def apply_model(self, model_fn: ModelFn, x, model_t, cond, uncond=None,
                    cfg_scale: float = 1.0, t: Optional[int] = None):
        """(model output, features), under classifier-free guidance when
        `uncond` is given and `cfg_scale` is not 1.0 (see ``guided``); `t` is
        the integer timestep of every row of `model_t`, read from the host."""
        if t is None:
            t = int(model_t[0])
        return self.guided(model_fn, x, model_t, t, cond, uncond, cfg_scale)

    def p_sample(
        self,
        model_fn: ModelFn,
        sp: SpacedSchedule,
        x: torch.Tensor,
        step_idx: int,  # index into the spaced schedule
        cond,
        uncond=None,
        cfg_scale: float = 1.0,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One ancestral step x_i -> x_{i-1}; returns (x_prev, feats)."""
        bs = x.shape[0]
        t = int(sp.timesteps[step_idx])
        model_t = torch.full((bs,), t, dtype=torch.int32, device=x.device)
        model_output, feats = self.apply_model(
            model_fn, x, model_t, cond, uncond, cfg_scale, t=t
        )
        x0 = self.predict_x0(sp, x, step_idx, model_output.float())
        mean, var = self.q_posterior(sp, x0, x, step_idx)
        if step_idx == 0:
            return mean.to(x.dtype), feats
        if noise is None:
            noise = torch.randn(
                x.shape, dtype=torch.float32, device=x.device, generator=generator
            )
        x_prev = mean + float(np.sqrt(np.float32(var))) * noise
        return x_prev.to(x.dtype), feats

    def sample(
        self,
        model_fn: ModelFn,
        steps: int,
        x_T: torch.Tensor,
        cond,
        uncond=None,
        cfg_scale: float = 1.0,
        feat_iterations: Sequence[int] = (),
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Run the whole spaced-DDPM chain from `x_T`.

        feat_iterations: 1-based iteration numbers (e.g. 10, 20, ..., 50) at
        which the UNet decoder features are kept. Returns (x_0, feats), feats a
        tuple (one per feature level) of float32 tensors [n_tags, B, H, W, C]
        ordered by tag. `step_noises` (one per iteration, in loop order; the
        last step adds none) are drawn from `generator` when not given.
        """
        sp = self.make_schedule(steps)
        total = sp.num_steps
        tags = sorted(int(t) for t in feat_iterations)
        if tags and tags[-1] > total:
            # a tag past the chain's end would never fire
            raise ValueError(
                f"feat_iterations {tags} exceed the {total}-step chain; tags are "
                "1-based iteration numbers"
            )
        check_noises(step_noises, total)
        kept = [None] * len(tags)
        x = x_T
        for i in range(total):
            x, feats = self.p_sample(
                model_fn, sp, x, total - 1 - i, cond, uncond, cfg_scale,
                noise=None if step_noises is None else step_noises[i], generator=generator,
            )
            for j, tag in enumerate(tags):
                if tag == i + 1:
                    kept[j] = tuple(f.float() for f in feats)
        feats = tuple(torch.stack(level) for level in zip(*kept)) if tags else ()
        return x, feats

    # ---- host-driven loop with per-step feedback ---------------------------

    def val_sample_loop(
        self,
        step_fn: Callable,  # (x, step_idx, cond, noise, generator) -> (x_prev, feats)
        steps: int,
        x_T: torch.Tensor,
        cond,
        feedback_fn: Optional[Callable] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The reference's val_sample: per-step OCR -> prompt recycling.

        `step_fn` is one denoising step (``p_sample`` with the model bound);
        `feedback_fn(feats, cond, iteration) -> (cond, info)` runs on the host
        after each step and may rewrite ``cond['c_txt']``. `step_noises` (one
        per iteration, in loop order) are drawn from `generator` when not
        given. Returns (x_0, [info of each step]).
        """
        sp = self.make_schedule(steps)
        total = sp.num_steps
        check_noises(step_noises, total)
        x = x_T
        infos = []
        for i in range(total):
            noise = None if step_noises is None else step_noises[i]
            x, feats = step_fn(x, total - 1 - i, cond, noise, generator)
            if feedback_fn is not None:
                cond, info = feedback_fn(feats, cond, i)
                infos.append(info)
        return x, infos
