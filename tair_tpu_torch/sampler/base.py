"""Sampler base: shared schedule plumbing.

Counterpart of ``tair_tpu/sampler/base.py``. Classifier-free guidance beyond
scale 1.0 is not part of this slice, so the cosine-rescaled scale is not here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplerBase:
    training_betas: np.ndarray
    parameterization: str = "v"

    @property
    def num_timesteps(self) -> int:
        return len(self.training_betas)
