"""ControlLDM: UNet + ControlNet + VAE + CLIP composite.

Counterpart of ``tair_tpu/models/cldm.py``: the controlled forward applying 13
control scales, latent scaling, the CLIP encode of token ids or of prompts (tokenized on the
host), and ``prepare_condition``. The four
sub-models are child modules, so ``state_dict`` keys start with ``unet.``,
``controlnet.``, ``vae.`` and ``clip.`` like the JAX parameter tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

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
    ):
        super().__init__()
        self.unet = UNetModel(unet_cfg)
        self.controlnet = ControlNet(controlnet_cfg or unet_cfg)
        self.vae = AutoencoderKL(vae_cfg)
        self.clip = CLIPTextTower(clip_cfg)
        self.scale_factor = latent_scale_factor
        self.control_scales = control_scales

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
        of ``control_scales``, which leaves the shared module as it was.
        """
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
