"""DiffBIR-style general restoration: cleaner -> ControlLDM sampling -> colour fix.

Counterpart of ``tair_tpu/diffbir_pipeline.py``: a pluggable stage-1 cleaner,
reflect padding to the diffusion stride (64) and a crop back, the VAE encode
(tiled, with GroupNorm statistics pooled over the tiles, above the tile size),
condition noise augmentation, ControlNet `strength`, classifier-free guidance
with an empty-prompt negative branch (cosine-rescaled with `rescale_cfg`),
gaussian-blended tiled latent sampling, five sampler families, post-hoc latent
MSE guidance, the tiled VAE decode and the wavelet colour fix.

Where it departs from the JAX signature: the modules own their weights (no
``params``); the cleaner is a module (``cleaner=``), not an apply function;
randomness comes from a ``torch.Generator``, or the caller hands in `x_T`, the
sampler's `step_noises` and the `noise_aug` draw (`aug_noise`) instead of a key.
Everything runs on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from .data.degradation import reflect_index
from .diffusion.diffusion import Diffusion
from .models.prompt_splice import empty_tokens
from .pipeline import TeReDiff
from .tiling import make_tiled_fn
from .utils.guidance import MSEGuidance
from .utils.metrics import wavelet_reconstruction
from .utils.tilevae import tiled_vae_decode, tiled_vae_encode


def _reflect_pad_end(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """NHWC `x` reflect-padded at the bottom and right only, reflecting again
    where a pad is wider than the image (``jnp.pad(mode="reflect")``)."""
    _, h, w, _ = x.shape
    x = x.index_select(1, reflect_index(h, ph, x.device)[ph:])
    return x.index_select(2, reflect_index(w, pw, x.device)[pw:])


@dataclass(frozen=True)
class DiffBIRPipeline:
    model: TeReDiff
    cleaner: Optional[nn.Module] = None  # lq [0,1] NHWC -> [0,1], same size

    def _clean(self, lq: torch.Tensor) -> torch.Tensor:
        if self.cleaner is not None:
            return self.cleaner(lq).float().clamp(0.0, 1.0)
        return self.model.clean(lq)

    def _make_sampler(self, sampler_type: str, rescale_cfg: bool):
        """spaced | ddim | dpm_solver_{1,2,3} (multistep) | dpm_solver_s{1,2,3}
        or dpm_single_{1,2,3} (singlestep) | edm_<solver> (euler, heun,
        dpmpp_2m, euler_ancestral, dpmpp_2m_sde); another name raises."""
        common = dict(training_betas=self.model.schedule.betas, parameterization="v",
                      rescale_cfg=rescale_cfg)
        if sampler_type == "spaced":
            return self.model.sampler(rescale_cfg=rescale_cfg)
        if sampler_type == "ddim":
            from .sampler.ddim import DDIMSampler

            return DDIMSampler(**common, eta=0.0)
        if sampler_type.startswith("dpm"):
            from .sampler.dpm import DPMSolverPP, DPMSolverPPSingle

            order = int(sampler_type[-1]) if sampler_type[-1].isdigit() else 2
            single = "single" in sampler_type or sampler_type.rstrip("123").endswith("s")
            return (DPMSolverPPSingle if single else DPMSolverPP)(**common, order=order)
        if sampler_type.startswith("edm"):
            from .sampler.edm import SOLVERS, EDMSampler

            solver = sampler_type.removeprefix("edm").lstrip("_") or "dpmpp_2m"
            if solver not in SOLVERS:
                raise ValueError(f"unknown EDM solver {solver!r}; choose from {SOLVERS}")
            return EDMSampler(**common, solver=solver)
        raise NotImplementedError(sampler_type)

    @torch.no_grad()
    def run(
        self,
        lq: torch.Tensor,                 # [B, H, W, 3] in [0,1]
        prompt_tokens: torch.Tensor,      # [B, 77]
        generator: Optional[torch.Generator] = None,
        steps: int = 50,
        cfg_scale: float = 1.0,
        guidance: Optional[MSEGuidance] = None,
        color_fix: bool = True,
        tiled: bool = False,
        tile_size: int = 512,
        tile_stride: int = 256,
        sampler_type: str = "spaced",
        rescale_cfg: bool = False,
        strength: float = 1.0,
        noise_aug: int = 0,
        x_T: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        aug_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Full restoration; returns [B, H, W, 3] in [0,1].

        tiled=True above `tile_size` runs gaussian-blended tiled latent
        sampling (every model evaluation on all latent tiles as one batch) and
        the tiled VAE. `strength` scales the 13 ControlNet residuals for this
        call only; `noise_aug` q-samples the image condition to that timestep.
        `aug_noise` (the latent's shape), `x_T` [B, H'/8, W'/8, 4] at the
        padded size H', W', and `step_noises` are drawn from `generator` in
        that order when not given."""
        b, h, w, _ = lq.shape
        x = _reflect_pad_end(lq, (-h) % 64, (-w) % 64)
        clean = self._clean(x)
        if clean.shape[1:3] != x.shape[1:3]:
            # the JAX pipeline draws x_T at the padded input's size / 8, and the
            # ControlNet cannot join a condition of another size to it
            raise ValueError(
                f"the cleaner maps {tuple(x.shape[1:3])} to {tuple(clean.shape[1:3])}; "
                "DiffBIRPipeline.run needs a cleaner that keeps the size"
            )
        cldm = self.model.cldm
        use_tiles = tiled and (x.shape[1] > tile_size or x.shape[2] > tile_size)
        if use_tiles:
            c_img = tiled_vae_encode(
                cldm, clean * 2.0 - 1.0, tile_size=tile_size, overlap=tile_size - tile_stride
            )
        else:
            c_img = cldm.vae_encode(clean * 2.0 - 1.0, sample=False)
        if noise_aug > 0:
            if aug_noise is None:
                aug_noise = torch.randn(c_img.shape, dtype=torch.float32, device=c_img.device,
                                        generator=generator)
            t_aug = torch.full((b,), noise_aug, dtype=torch.int32, device=c_img.device)
            c_img = Diffusion(schedule=self.model.schedule).q_sample(c_img, t_aug, aug_noise)
        cond = dict(c_txt=cldm.clip_encode_tokens(prompt_tokens), c_img=c_img)
        uncond = None
        if cfg_scale != 1.0:
            # classifier-free guidance: the empty prompt, the same image condition
            empty = torch.from_numpy(empty_tokens(b)).to(prompt_tokens.device)
            uncond = dict(c_txt=cldm.clip_encode_tokens(empty), c_img=c_img)
        if x_T is None:
            x_T = torch.randn((b, x.shape[1] // 8, x.shape[2] // 8, 4), dtype=torch.float32,
                              device=lq.device, generator=generator)

        scales = None if strength == 1.0 else (float(strength),) * 13

        def apply(z, t, c):
            return cldm.apply(z, t, c, extract_features=False, control_scales=scales)

        if use_tiles:
            def apply_tile(z_tile, ci_tile, t, c_txt):
                reps = z_tile.shape[0] // b
                return apply(z_tile, t.repeat(reps),
                             dict(c_txt=c_txt.repeat(reps, 1, 1), c_img=ci_tile))

            tiled_fn = make_tiled_fn(apply_tile, tile_size // 8, tile_stride // 8)

            def model_fn(z, t, cond_in):
                # the caller's text embedding goes into every tile call, so the
                # unconditional branch keeps the empty prompt's
                return tiled_fn(z, cond_in["c_img"], t=t, c_txt=cond_in["c_txt"]), ()
        else:
            def model_fn(z, t, cond_in):
                return apply(z, t, cond_in), ()

        sampler = self._make_sampler(sampler_type, rescale_cfg)
        out = sampler.sample(
            model_fn, steps, x_T, cond, uncond=uncond, cfg_scale=cfg_scale,
            step_noises=step_noises, generator=generator,
        )
        # the spaced sampler returns (x, features); the others return x
        z0 = out[0] if isinstance(out, tuple) else out
        if guidance is not None:
            # a post-hoc pull of the latent toward the condition
            z0 = guidance(z0, cond["c_img"], torch.zeros((b,), dtype=torch.int32,
                                                          device=z0.device))
        if use_tiles:
            restored = tiled_vae_decode(
                cldm, z0, tile_size=tile_size // 8, overlap=(tile_size - tile_stride) // 8
            )
        else:
            restored = cldm.vae_decode(z0)
        restored = ((restored.float() + 1.0) / 2.0).clamp(0.0, 1.0)
        if color_fix:
            restored = wavelet_reconstruction(restored, clean).clamp(0.0, 1.0)
        return restored[:, :h, :w]
