"""End-to-end restoration pipeline: the fused text-aware restore loop.

Counterpart of ``tair_tpu/pipeline.py`` for its serving path,
``TeReDiff.restore_fused_feedback``: LQ -> SwinIR cleaner -> VAE encode ->
CLIP encode of the empty prompt -> spaced-DDPM steps, each running ControlNet
+ UNet, the TESTR spotter on the UNet's decoder features, the on-device TAG
prompt splice and a CLIP re-encode -> VAE decode -> clamp; for
``TeReDiff.restore_with_ocr_feedback`` (the same loop with the prompt rebuilt
on the host each step, CAPTION or TAG style: ``val``'s default path); for
``TeReDiff.restore`` (a fixed prompt, the UNet features kept at tagged
iterations: the trainer's validation and untexted tiled restoration); and for
what the train step needs of the bundle: ``TeReDiff.spotter_loss_fn`` and
``build_*_model`` that keep float32 master weights (``training=True``).

Where it departs from the JAX signature: the modules own their weights, so no
``params`` argument; randomness comes from a ``torch.Generator`` (or the
caller hands in ``x_T`` and the step noises) instead of a key; ``lax.scan`` is
a Python loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from .diffusion.schedules import DiffusionSchedule
from .models.cldm import ControlLDM
from .models.clip import CLIPTextConfig
from .models.prompt_splice import empty_tokens, splice_tag_prompt
from .models.swinir import SwinIR, SwinIRConfig
from .models.unet import UNetConfig
from .models.vae import VAEConfig
from .sampler.spaced import SpacedSampler
from .spotter.testr import TESTR, TESTRConfig, spotter_inference

Device = Union[str, torch.device]

# layers the JAX package initialises to zero; init_parameters gives them
# small noise instead so that every path of a randomly initialised model is live
_ZERO_INIT_SUFFIXES = (
    "proj_out.weight", "out_conv.weight", "middle_out.weight",
    "sampling_offsets.weight", "attention_weights.weight",
    "ctrl_point_coord.fc2.weight",
)
_ZERO_INIT_GAIN = 0.1


def _resolve_device(device: Device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this entry point runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


class TeReDiff(nn.Module):
    """The model bundle: cleaner + ControlLDM + TESTR spotter."""

    def __init__(self, cldm: ControlLDM, swinir: SwinIR, testr: TESTR):
        super().__init__()
        self.cldm = cldm
        self.swinir = swinir
        self.testr = testr
        self.schedule = DiffusionSchedule.create(
            timesteps=1000,
            beta_schedule="linear",
            linear_start=0.00085,
            linear_end=0.0120,
            zero_snr=True,
        )

    @classmethod
    def create(
        cls, cldm: ControlLDM, swinir: SwinIR, testr: Optional[TESTR] = None
    ) -> "TeReDiff":
        if testr is None:
            m = cldm.unet.cfg.model_channels
            mults = cldm.unet.cfg.channel_mult
            # decoder tap channels, deepest first (UNetConfig.extract_idx order)
            chans = tuple(m * mults[len(mults) - 1 - i] for i in range(len(mults)))
            testr = TESTR(TESTRConfig(in_channels=chans))
        return cls(cldm=cldm, swinir=swinir, testr=testr)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator):
        """Random parameters from `generator`, drawn on the parameters' device:
        weights normal with variance 1/fan_in, norm scales 1, biases 0,
        embeddings normal. The layers the JAX package starts at zero get
        a tenth of that, so the control, spotter and output paths
        carry signal in a smoke run; the msda offset biases keep their
        directional init."""
        for name, p in self.named_parameters():
            if name.endswith("sampling_offsets.bias"):
                continue
            if p.dim() == 1:
                if name.endswith(".weight"):
                    p.fill_(1.0)
                else:
                    p.zero_()
                continue
            if name.endswith("_embed"):  # level / control-point / text queries
                std = 1.0
            elif name.endswith(
                ("rel_pos_bias_table", "positional_embedding", "token_embedding.weight")
            ):
                std = 0.02
            else:
                fan_in = p[0].numel()
                std = 1.0 / math.sqrt(fan_in)
                if name.endswith(_ZERO_INIT_SUFFIXES) or ".zero_" in name:
                    std *= _ZERO_INIT_GAIN
            noise = torch.randn(
                p.shape, dtype=torch.float32, device=p.device, generator=generator
            )
            p.copy_((noise * std).to(p.dtype))
        return self

    def sampler(self, rescale_cfg: bool = False) -> SpacedSampler:
        return SpacedSampler(
            training_betas=self.schedule.betas, parameterization="v", rescale_cfg=rescale_cfg
        )

    # ---- stages -----------------------------------------------------------

    def clean(self, lq: torch.Tensor) -> torch.Tensor:
        """LQ [0,1] NHWC -> cleaned [0,1] (clipped)."""
        return self.swinir(lq).clamp(0.0, 1.0)

    def spotter_apply(self, feats):
        return self.testr(feats)

    def spotter_loss_fn(self, criterion_cfg=None):
        """Adapter for the train step: (feats, batch) -> (loss, aux), the
        spotter on the UNet's decoder features under the TESTR set criterion.
        criterion_cfg: optional ``CriterionConfig`` (e.g. the matcher)."""
        from .spotter.losses import CriterionConfig, set_criterion

        cfg = criterion_cfg if criterion_cfg is not None else CriterionConfig()

        def fn(feats, batch):
            out = self.spotter_apply(feats)
            targets = {
                k: batch[k] for k in ("inst_mask", "boxes", "ctrl_points", "texts")
            }
            losses = set_criterion(out, targets, cfg)
            aux = {
                "loss_ocr_ce": losses["loss_ce"],
                "loss_ocr_ctrl_points": losses["loss_ctrl_points"],
                "loss_ocr_texts": losses["loss_texts"],
            }
            return losses["loss_total"], aux

        return fn

    @torch.no_grad()
    def restore(
        self,
        lq: torch.Tensor,
        prompt_tokens: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        steps: int = 50,
        cfg_scale: float = 1.0,
        feat_iterations: Sequence[int] = (),
        negative_tokens: Optional[torch.Tensor] = None,
        rescale_cfg: bool = False,
        x_T: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Restoration with a fixed prompt: returns (restored [0,1], clean,
        feats), feats the UNet decoder features at `feat_iterations` (see
        ``SpacedSampler.sample``). prompt_tokens: [B, 77] (tokenized on the
        host); `negative_tokens` [B, 77] give the unconditional branch of
        classifier-free guidance at `cfg_scale` (cosine-rescaled with
        `rescale_cfg`). `x_T` [B, H/8, W/8, 4] and the step noises are drawn
        from `generator` when not given."""
        clean = self.clean(lq)
        c_img = self.cldm.vae_encode(clean * 2.0 - 1.0, sample=False)
        cond = dict(c_txt=self.cldm.clip_encode_tokens(prompt_tokens), c_img=c_img)
        uncond = None
        if negative_tokens is not None:
            uncond = dict(c_txt=self.cldm.clip_encode_tokens(negative_tokens), c_img=c_img)
        b, h, w, _ = lq.shape
        if x_T is None:
            x_T = torch.randn(
                (b, h // 8, w // 8, 4), dtype=torch.float32, device=lq.device,
                generator=generator,
            )
        x0, feats = self.sampler(rescale_cfg).sample(
            self.cldm.apply, steps, x_T, cond, uncond=uncond, cfg_scale=cfg_scale,
            feat_iterations=feat_iterations, step_noises=step_noises, generator=generator,
        )
        restored = self.cldm.vae_decode(x0)
        return ((restored.float() + 1.0) / 2.0).clamp(0.0, 1.0), clean, feats

    @torch.no_grad()
    def restore_with_ocr_feedback(
        self,
        lq: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        steps: int = 50,
        prompt_style: str = "CAPTION",
        score_threshold: float = 0.5,
        initial_prompt: str = "",
        x_T: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """The reference's val_sample: every denoising step runs the spotter on
        the UNet decoder features, decodes the transcriptions on the host,
        rebuilds the prompt (``make_caption`` for CAPTION, ``make_tag_prompt``
        for TAG), tokenizes it and re-encodes it as the next step's
        cross-attention conditioning.

        Each step copies the decode (scores, keep, polygons, recs) to the host
        as ONE packed float32 tensor: one host synchronisation per step. The
        new tokens go back from pinned memory without one. `x_T` and `step_noises` are drawn
        from `generator` when not given, as in ``restore_fused_feedback``.
        Returns (restored [0,1], ts_results): one list per step of one dict
        per image (timestep, pred_texts, pred_prompt, pred_polys int32 [n, Np,
        2], scores float32 [n]).
        """
        import numpy as np

        from .data.satext import make_caption, make_tag_prompt
        from .models.tokenizer import tokenize
        from .spotter.charset import decode_text

        if prompt_style not in ("CAPTION", "TAG"):
            raise ValueError(f"prompt_style {prompt_style!r}: choose CAPTION or TAG")
        sampler = self.sampler()
        sp = sampler.make_schedule(steps)
        b, h, w, _ = lq.shape
        dev = lq.device

        clean = self.clean(lq)
        cond = dict(
            c_txt=self.cldm.clip_encode([initial_prompt] * b),
            c_img=self.cldm.vae_encode(clean * 2.0 - 1.0, sample=False),
        )

        def step_fn(x, step_idx, cond, noise, gen):
            return sampler.p_sample(
                self.cldm.apply, sp, x, step_idx, cond, noise=noise, generator=gen
            )

        ts_results = []

        def feedback(feats, cond, i):
            res = spotter_inference(self.spotter_apply(feats), score_threshold, image_size=h)
            k, n_pts = res["polygons"].shape[1:3]
            packed = torch.cat([
                res["scores"][..., None], res["keep"][..., None].float(),
                res["polygons"].reshape(b, k, 2 * n_pts), res["recs"].float(),
            ], dim=-1).cpu().numpy()  # the step's one device-to-host copy
            scores, keep = packed[..., 0], packed[..., 1] > 0.5
            polys = packed[..., 2 : 2 + 2 * n_pts].reshape(b, k, n_pts, 2)
            recs = packed[..., 2 + 2 * n_pts :].astype(np.int64)
            prompts, step_info = [], []
            for bi in range(b):
                texts = [decode_text(r) for r, kp in zip(recs[bi], keep[bi]) if kp]
                prompt = make_caption(texts) if prompt_style == "CAPTION" else make_tag_prompt(texts)
                prompts.append(prompt)
                step_info.append(dict(
                    timestep=int(sp.timesteps[sp.num_steps - 1 - i]),
                    pred_texts=texts,
                    pred_prompt=prompt,
                    pred_polys=polys[bi][keep[bi]].astype(np.int32),
                    scores=scores[bi][keep[bi]],
                ))
            tokens = torch.from_numpy(tokenize(prompts)).long()
            if dev.type == "cuda":  # a copy from pageable memory would wait for the card
                tokens = tokens.pin_memory()
            tokens = tokens.to(dev, non_blocking=True)
            cond = dict(cond, c_txt=self.cldm.clip_encode_tokens(tokens))
            ts_results.append(step_info)
            return cond, step_info

        if x_T is None:
            x_T = torch.randn(
                (b, h // 8, w // 8, 4), dtype=torch.float32, device=dev, generator=generator
            )
        x0, _ = sampler.val_sample_loop(
            step_fn, steps, x_T, cond, feedback, step_noises=step_noises, generator=generator
        )
        restored = self.cldm.vae_decode(x0)
        return ((restored.float() + 1.0) / 2.0).clamp(0.0, 1.0), ts_results

    @torch.no_grad()
    def restore_fused_feedback(
        self,
        lq: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        steps: int = 50,
        score_threshold: float = 0.5,
        max_words: int = 4,
        spotter_every: int = 1,
        return_spots: bool = False,
        x_T: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """The text-aware restore loop: every denoising step runs the spotter
        on the UNet features, assembles the predicted text into a TAG prompt
        on the device and re-encodes it through CLIP for the next step's
        cross-attention, with no host round-trip.

        lq: [B, H, W, 3] in [0, 1] on the model's device. `x_T` [B, H/8, W/8, 4]
        and `step_noises` (one [B, H/8, W/8, 4] per step, in loop order) are
        drawn from `generator` when not given. `spotter_every=k` refreshes the
        prompt on every k-th step only.
        Returns (restored [0,1], final_tokens [B,77]); with return_spots=True
        additionally the last spotter decode (scores, keep, polygons, recs).

        The CLIP re-encode runs on every spotter step: it is bit-identical to
        re-using the embedding when the tokens did not change, and comparing
        the tokens would cost a host synchronisation per step.
        """
        sampler = self.sampler()
        sp = sampler.make_schedule(steps)
        total = sp.num_steps
        b, h, w, _ = lq.shape
        dev = lq.device

        clean = self.clean(lq)
        c_img = self.cldm.vae_encode(clean * 2.0 - 1.0, sample=False)
        tokens = torch.from_numpy(empty_tokens(b)).to(dev).long()
        c_txt = self.cldm.clip_encode_tokens(tokens)

        if x_T is None:
            x_T = torch.randn(
                (b, h // 8, w // 8, 4), dtype=torch.float32, device=dev,
                generator=generator,
            )
        if step_noises is not None and len(step_noises) != total:
            raise ValueError(f"step_noises holds {len(step_noises)} draws, the chain has {total} steps")

        tc = self.testr.cfg
        spots = {
            "scores": torch.zeros((b, tc.num_proposals), dtype=torch.float32, device=dev),
            "keep": torch.zeros((b, tc.num_proposals), dtype=torch.bool, device=dev),
            "polygons": torch.zeros(
                (b, tc.num_proposals, tc.num_ctrl_points, 2), dtype=torch.float32, device=dev
            ),
            "recs": torch.zeros((b, tc.num_proposals, tc.num_chars), dtype=torch.long, device=dev),
        }

        x = x_T
        for i in range(total):
            cond = dict(c_txt=c_txt, c_img=c_img)
            x, feats = sampler.p_sample(
                self.cldm.apply, sp, x, total - 1 - i, cond,
                noise=None if step_noises is None else step_noises[i],
                generator=generator,
            )
            if (i % spotter_every) == (spotter_every - 1):
                out = self.spotter_apply(feats)
                res = spotter_inference(out, score_threshold, image_size=h)
                tokens = splice_tag_prompt(
                    res["recs"], res["scores"], res["keep"], max_words
                )
                c_txt = self.cldm.clip_encode_tokens(tokens)
                spots = {k: res[k] for k in spots}

        restored = self.cldm.vae_decode(x)
        restored = ((restored.float() + 1.0) / 2.0).clamp(0.0, 1.0)
        if return_spots:
            return restored, tokens, spots
        return restored, tokens


def cast_params_for_inference(model: nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Cast float32 weights to `dtype` for serving (in place). Norm scales are
    cast back up inside the float32 norm islands."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    for buf in model.buffers():
        if buf.dtype == torch.float32:
            buf.data = buf.data.to(dtype)
    return model


def _assemble(cldm_args, swinir_cfg, testr_cfg, dtype, device, training=False) -> TeReDiff:
    if training and dtype != torch.float32:
        raise ValueError(
            "a model built for training keeps float32 master weights; the train "
            "step's compute_dtype sets the working type"
        )
    device = _resolve_device(device)
    with torch.device(device):
        model = TeReDiff.create(
            cldm=ControlLDM(**cldm_args),
            swinir=SwinIR(swinir_cfg),
            testr=TESTR(testr_cfg),
        )
    model = model.to(device)  # buffers made from numpy are born on the CPU
    if device.type == "cuda":
        # NHWC in memory under the NCHW shapes: the layout of cuDNN's
        # tensor-core convolutions, and it makes the NHWC boundary permutes views
        model = model.to(memory_format=torch.channels_last)
    if dtype != torch.float32:
        cast_params_for_inference(model, dtype)
    return model.train() if training else model.eval()


def build_default_model(
    dtype: torch.dtype = torch.bfloat16, device: Device = "cuda", training: bool = False,
    testr_overrides: Optional[dict] = None, quantized: bool = False,
    quant_static_amax=None, quant_min_ratio: Optional[float] = None,
) -> TeReDiff:
    """Production geometry (SD-2.1 UNet/ControlNet/VAE, OpenCLIP-H text tower,
    SwinIR cleaner, TESTR spotter). Parameters are uninitialised storage of
    `dtype` on `device` until a ``state_dict`` is loaded or
    ``init_parameters`` is called. `training=True` gives the model the train
    step takes: float32 parameters (pass ``dtype=torch.float32``), in train
    mode; which of them a stage trains is set by ``train.step.make_optimizer``.
    `testr_overrides`: ``TESTRConfig`` fields to change (``enc_topk``...); a
    field the port's config lacks raises. `quantized=True` serves the
    ControlNet + UNet step w8a8 (``ops/quant.py``; an inference-only
    approximation): `quant_static_amax` fixes the activation scales (one
    float, or one per site from ``ControlLDM.calibrate_quant``),
    `quant_min_ratio` quantizes only the weight-dominated sites."""
    return _assemble(
        dict(unet_cfg=UNetConfig(), vae_cfg=VAEConfig(), clip_cfg=CLIPTextConfig(),
             quantized=quantized, quant_static_amax=quant_static_amax,
             quant_min_ratio=quant_min_ratio),
        SwinIRConfig(),
        _with_overrides(TESTRConfig(), testr_overrides),
        dtype,
        device,
        training,
    )


def _with_overrides(cfg: TESTRConfig, overrides: Optional[dict]) -> TESTRConfig:
    unknown = sorted(set(overrides or {}) - {f.name for f in dataclasses.fields(TESTRConfig)})
    if unknown:
        raise ValueError(f"testr_overrides names fields the port's TESTRConfig lacks: {unknown}")
    return dataclasses.replace(cfg, **(overrides or {}))


def build_tiny_model(
    dtype: torch.dtype = torch.float32, device: Device = "cuda", training: bool = False,
    testr_overrides: Optional[dict] = None, quantized: bool = False,
    quant_static_amax=None, quant_min_ratio: Optional[float] = None,
) -> TeReDiff:
    """Small geometry for tests: same topology, tiny widths; `testr_overrides`
    and the quant fields as for `build_default_model`."""
    return _assemble(
        dict(
            unet_cfg=UNetConfig(model_channels=32, num_head_channels=16, context_dim=64),
            vae_cfg=VAEConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
            clip_cfg=CLIPTextConfig(width=64, heads=4, layers=3),
            quantized=quantized, quant_static_amax=quant_static_amax,
            quant_min_ratio=quant_min_ratio,
        ),
        SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4, num_feat=8),
        _with_overrides(
            TESTRConfig(
                d_model=32,
                n_heads=4,
                num_encoder_layers=1,
                num_decoder_layers=2,
                dim_feedforward=64,
                num_proposals=10,
                num_ctrl_points=16,
                num_chars=25,
                in_channels=(128, 128, 64, 32),
            ),
            testr_overrides,
        ),
        dtype,
        device,
        training,
    )
