"""Noise schedules and timestep respacing (pure numpy; device-agnostic).

The port's own copy of ``tair_tpu/diffusion/schedules.py``: beta schedules,
the zero-terminal-SNR rescale and guided-diffusion timestep respacing. All
schedule construction happens once at setup time on the host in float64; the
sampler reads the buffers as float32 scalars.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Return betas[n_timestep] (float64) for the named schedule."""
    if schedule == "linear":
        # "linear" in SD-lineage means linear in sqrt(beta).
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal-step SNR is exactly zero.

    Implements the correction of arXiv:2305.08891: shift sqrt(alpha_bar) so the
    last entry is 0, rescale so the first entry is unchanged, convert back.
    """
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    first = alphas_bar_sqrt[0].copy()
    last = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = alphas_bar_sqrt - last
    alphas_bar_sqrt = alphas_bar_sqrt * first / (first - last)
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Pick a sorted subset of original timesteps (guided-diffusion respacing).

    `section_counts` is an int, a list of per-section counts, or a string
    ("50", "10,15,20", or "ddimN").
    """
    if isinstance(section_counts, int):
        section_counts = [section_counts]
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return sorted(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} ddim steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return sorted(set(all_steps))


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed training-schedule buffers (all float64 numpy)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)

    def __post_init__(self):
        ac = np.cumprod(1.0 - self.betas, axis=0)
        object.__setattr__(self, "alphas_cumprod", ac)
        object.__setattr__(self, "sqrt_alphas_cumprod", np.sqrt(ac))
        object.__setattr__(self, "sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - ac))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        zero_snr: bool = False,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(
            beta_schedule, timesteps, linear_start, linear_end, cosine_s
        )
        if zero_snr:
            betas = enforce_zero_terminal_snr(betas)
        return cls(betas=betas)


@dataclass(frozen=True)
class SpacedSchedule:
    """Respaced posterior buffers for ancestral (DDPM) sampling.

    A plain immutable value: index i refers to the i-th used timestep in
    increasing order; `timesteps[i]` is the original-schedule timestep fed to
    the model.
    """

    timesteps: np.ndarray                 # [S] int32 original timesteps, ascending
    sqrt_alphas_cumprod: np.ndarray       # [S]
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @classmethod
    def create(cls, training_betas: np.ndarray, num_steps: int) -> "SpacedSchedule":
        num_timesteps = len(training_betas)
        training_alphas_cumprod = np.cumprod(1.0 - training_betas, axis=0)
        used = set(space_timesteps(num_timesteps, str(num_steps)))

        betas = []
        last_ac = 1.0
        for i, ac in enumerate(training_alphas_cumprod):
            if i in used:
                betas.append(1.0 - ac / last_ac)
                last_ac = ac
        betas = np.array(betas, dtype=np.float64)

        alphas = 1.0 - betas
        ac = np.cumprod(alphas, axis=0)
        ac_prev = np.append(1.0, ac[:-1])

        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        if len(post_var) > 1:
            post_logvar = np.log(np.append(post_var[1], post_var[1:]))
        else:
            post_logvar = np.log(np.append(post_var[0], post_var[0]))

        # Under zero-terminal-SNR the last alpha_cumprod is exactly 0; the
        # reciprocal buffers (used only by the eps parameterization) become
        # inf there, matching the reference's behavior.
        with np.errstate(divide="ignore"):
            sqrt_recip_ac = np.sqrt(1.0 / ac)
            sqrt_recipm1_ac = np.sqrt(1.0 / ac - 1.0)

        return cls(
            timesteps=np.array(sorted(used), dtype=np.int32),
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=sqrt_recip_ac,
            sqrt_recipm1_alphas_cumprod=sqrt_recipm1_ac,
            posterior_variance=post_var,
            posterior_log_variance_clipped=post_logvar,
            posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        )
