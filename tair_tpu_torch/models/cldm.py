"""ControlLDM: UNet + ControlNet + VAE + CLIP composite.

Counterpart of ``tair_tpu/models/cldm.py``: the controlled forward applying 13
control scales, latent scaling, the CLIP encode of token ids or of prompts (tokenized on the
host), ``prepare_condition``, and the w8a8 serving knobs of the ControlNet +
UNet step (``quantized``, ``quant_static_amax``, ``quant_min_ratio``,
``calibrate_quant``; ``ops/quant.py``). The four sub-models are child
modules, so ``state_dict`` keys start with ``unet.``, ``controlnet.``,
``vae.`` and ``clip.`` like the JAX parameter tree; the quant knobs change no
parameter.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import quant

from .clip import CLIPTextConfig, CLIPTextTower
from .tokenizer import tokenize
from .unet import ControlNet, UNetConfig, UNetModel
from .vae import AutoencoderKL, VAEConfig


class ControlLDM(nn.Module):
    def __init__(
        self,
        unet_cfg: UNetConfig = UNetConfig(),
        vae_cfg: VAEConfig = VAEConfig(),
        clip_cfg: CLIPTextConfig = CLIPTextConfig(),
        controlnet_cfg: Optional[UNetConfig] = None,
        latent_scale_factor: float = 0.18215,
        control_scales: Tuple[float, ...] = (1.0,) * 13,
        quantized: bool = False,
        quant_static_amax: Optional[Union[float, Sequence[float]]] = None,
        quant_min_ratio: Optional[float] = None,
    ):
        super().__init__()
        self.unet = UNetModel(unet_cfg)
        self.controlnet = ControlNet(controlnet_cfg or unet_cfg)
        self.vae = AutoencoderKL(vae_cfg)
        self.clip = CLIPTextTower(clip_cfg)
        self.scale_factor = latent_scale_factor
        self.control_scales = control_scales
        # w8a8 serving of the ControlNet + UNet step (ops/quant.py): dynamic
        # per-tensor activation scales unless quant_static_amax gives one
        # float (every site) or one per site (from calibrate_quant);
        # quant_min_ratio quantizes only the sites whose weight has that many
        # times the activation's elements (None: every site)
        self.quantized = quantized
        self.quant_static_amax = quant_static_amax
        self.quant_min_ratio = quant_min_ratio

    def replace(self, **quant_fields) -> "ControlLDM":
        """A copy with other quant fields (``quantized``, ``quant_static_amax``,
        ``quant_min_ratio``) that shares every module and parameter: the JAX
        package's ``dataclasses.replace`` of those fields."""
        unknown = set(quant_fields) - {"quantized", "quant_static_amax", "quant_min_ratio"}
        if unknown:
            raise TypeError(f"ControlLDM.replace takes quant fields only, not {sorted(unknown)}")
        out = copy.copy(self)  # the copy's module and parameter dicts are this one's
        out.__dict__.update(quant_fields)
        return out

    def vae_encode(
        self,
        image: torch.Tensor,
        sample: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent: the mode, or a sample whose
        standard-normal `noise` (the latent's shape) is handed in or drawn
        with `generator`."""
        mean, logvar = self.vae.encode_moments(image)
        if sample:
            if noise is None:
                noise = torch.randn(
                    mean.shape, dtype=mean.dtype, device=mean.device, generator=generator
                )
            z = mean + torch.exp(0.5 * logvar) * noise
        else:
            z = mean
        return z * self.scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def clip_encode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.clip(tokens)

    def clip_encode(self, texts: Union[str, List[str]]) -> torch.Tensor:
        """Prompt(s) -> [B, 77, D]: tokenized on the host, encoded on the
        text tower's device."""
        device = self.clip.token_embedding.weight.device
        return self.clip_encode_tokens(torch.from_numpy(tokenize(texts)).to(device).long())

    def prepare_condition(
        self, cond_img: torch.Tensor, texts: Union[str, List[str]]
    ) -> Dict[str, torch.Tensor]:
        """cond_img in [0,1] NHWC (the cleaner's output); texts are prompts.
        c_img is the autoencoder's mode, not a sample."""
        return dict(
            c_txt=self.clip_encode(texts),
            c_img=self.vae_encode(cond_img * 2.0 - 1.0, sample=False),
        )

    def _control_and_unet(self, x_noisy, t, cond, extract_features, control_scales):
        c_txt = cond["c_txt"]
        if cond.get("c_img") is not None:
            control = self.controlnet(x_noisy, cond["c_img"], t, c_txt)
            scales = self.control_scales if control_scales is None else control_scales
            control = tuple(c * s for c, s in zip(control, scales))
        else:
            control = None
        return self.unet(
            x_noisy, t, c_txt, control=control, extract_features=extract_features
        )

    def calibrate_quant(
        self,
        x_noisy: torch.Tensor,
        t: torch.Tensor,
        cond: Dict[str, torch.Tensor],
        record: Optional[List[float]] = None,
    ) -> List[float]:
        """Static-PTQ calibration pass: runs the ControlNet + UNet forward
        eagerly on the dynamic w8a8 path (under this model's
        ``quant_min_ratio``) and records each site's activation abs-max in
        the order ``quant_static_amax`` consumes them. Pass the same `record`
        over a calibration set to max-merge; serve with
        ``cldm.replace(quant_static_amax=tuple(record))``. One host
        synchronisation a site."""
        record = [] if record is None else record
        with torch.no_grad(), quant.selective(self.quant_min_ratio), \
                quant.quantized(True, calibrate=record):
            self._control_and_unet(x_noisy, t, cond, False, None)
        return record

    def apply(
        self,
        x_noisy: torch.Tensor,
        t: torch.Tensor,
        cond: Dict[str, torch.Tensor],
        extract_features: bool = True,
        control_scales: Optional[Tuple[float, ...]] = None,
    ):
        """(x_t, t, cond) -> (model_output, extracted_feats).

        cond: {c_txt: [B,77,D], c_img: [B,h,w,4]}; c_img optional (then the
        UNet runs uncontrolled). `control_scales` (13 floats) replace the
        module's own for this call: the JAX package's ``dataclasses.replace``
        of ``control_scales``, which leaves the shared module as it was. The
        ControlNet and UNet run under this model's quant fields.
        """
        with quant.selective(self.quant_min_ratio), \
                quant.quantized(self.quantized, static_act_amax=self.quant_static_amax):
            return self._control_and_unet(
                x_noisy, t, cond, extract_features, control_scales
            )
