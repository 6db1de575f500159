"""Training state and the train step.

Counterpart of ``tair_tpu/train/step.py``: per step, the frozen prologue
(SwinIR clean, VAE encode of the ground truth and of the cleaned input, CLIP
encode) without gradients, a uniform timestep draw, the v-parameterisation
diffusion loss (plus the weighted OCR loss in stages 2 and 3), and an AdamW
update of the stage's trainable subset.

Where it departs from the JAX signature: the model owns its parameters, so the
state holds the model and a ``torch.optim.AdamW`` instead of a parameter tree
and an optax state; randomness comes from a ``torch.Generator`` or is handed in
as tensors (``draws``); the mesh and sharding arguments belong to the parallel
slice. Precision: parameters stay float32 (master weights) and, with
``compute_dtype=torch.bfloat16``, the forward runs under ``torch.autocast``, so
matrix products and convolutions compute in bfloat16 while norms, softmax
statistics and losses stay float32, as the JAX package trains
(``param_dtype=float32, dtype=bfloat16``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion.diffusion import Diffusion
from ..pipeline import TeReDiff
from .stages import apply_trainable_mask

# optax.adamw's defaults, which the JAX package trains with; torch's own
# default weight decay is a hundred times larger
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclass
class TrainState:
    step: int                     # calls of the train step so far (micro-batches)
    model: TeReDiff
    optimizer: torch.optim.Optimizer
    grad_accum: int = 1


def make_optimizer(
    model: TeReDiff, stage: str, learning_rate: float
) -> torch.optim.AdamW:
    """AdamW over the stage's trainable subset. Sets ``requires_grad`` from the
    stage's mask; frozen parameters stay out of the optimizer, so they get no
    update and no weight decay."""
    mask = apply_trainable_mask(model, stage)
    trained = [p for name, p in model.named_parameters() if mask[name]]
    if not trained:
        raise ValueError(f"stage {stage!r} trains no parameter of this model")
    return torch.optim.AdamW(
        trained, lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )


def create_train_state(
    model: TeReDiff, stage: str, learning_rate: float, grad_accum: int = 1
) -> TrainState:
    """grad_accum > 1: each train-step call adds one micro-batch gradient, and
    the AdamW update fires once every `grad_accum` calls on the micro-batch
    mean."""
    if grad_accum < 1:
        raise ValueError("grad_accum must be at least 1")
    optimizer = make_optimizer(model, stage, learning_rate)
    optimizer.zero_grad(set_to_none=True)
    return TrainState(step=0, model=model, optimizer=optimizer, grad_accum=grad_accum)


def diffusion_loss_fn(
    model: TeReDiff,
    diffusion: Diffusion,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    spotter_loss_fn: Optional[Callable] = None,
    ocr_loss_weight: float = 0.0,
    timestep_max: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: gt [B,H,W,3] in [-1,1]; lq [B,H,W,3] in [0,1]; tokens [B,77];
    for the OCR loss also inst_mask, boxes, ctrl_points, texts.

    Returns (total_loss, aux dict). timestep_max > 0 restricts t ~ U(0,
    timestep_max). The three random draws (`vae_noise` [B,h,w,4], `t` [B],
    `noise` [B,h,w,4]) are taken from `draws` where it has them and from
    `generator` otherwise.
    """
    if not 0 <= timestep_max <= diffusion.num_timesteps:
        raise ValueError(
            f"timestep_max {timestep_max} lies outside the schedule's "
            f"{diffusion.num_timesteps} steps"
        )
    draws = draws or {}
    bsz = batch["gt"].shape[0]
    dev = batch["gt"].device

    with torch.no_grad():  # the frozen parts
        clean = model.clean(batch["lq"])
        z_0 = model.cldm.vae_encode(
            batch["gt"], sample=True, noise=draws.get("vae_noise"), generator=generator
        ).float()
        cond = dict(
            c_txt=model.cldm.clip_encode_tokens(batch["tokens"]),
            c_img=model.cldm.vae_encode(clean * 2.0 - 1.0, sample=False).float(),
        )
    t = draws.get("t")
    if t is None:
        t_hi = timestep_max if timestep_max > 0 else diffusion.num_timesteps
        t = torch.randint(0, t_hi, (bsz,), device=dev, generator=generator)

    diff_loss, feats = diffusion.p_losses(
        model.cldm.apply, z_0, t, cond, noise=draws.get("noise"), generator=generator
    )

    aux = {"loss_diffusion": diff_loss}
    total = diff_loss
    if spotter_loss_fn is not None and ocr_loss_weight > 0.0:
        ocr_loss, ocr_aux = spotter_loss_fn(feats, batch)
        total = total + ocr_loss_weight * ocr_loss
        aux["loss_ocr"] = ocr_loss
        aux.update(ocr_aux)
    aux["loss_total"] = total
    return total, aux


def make_train_step(
    model: TeReDiff,
    diffusion: Diffusion,
    spotter_loss_fn: Optional[Callable] = None,
    ocr_loss_weight: float = 0.0,
    timestep_max: int = 0,
    compute_dtype: torch.dtype = torch.float32,
):
    """Build the train step: (state, batch, generator=None, draws=None) ->
    (state, aux). `state` is updated in place and returned; `aux` holds
    detached loss scalars. `compute_dtype=torch.bfloat16` runs the forward
    under autocast."""

    def step_fn(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this train step")
        device_type = batch["gt"].device.type
        with torch.autocast(
            device_type, dtype=compute_dtype, enabled=compute_dtype != torch.float32
        ):
            loss, aux = diffusion_loss_fn(
                model, diffusion, batch, generator=generator, draws=draws,
                spotter_loss_fn=spotter_loss_fn, ocr_loss_weight=ocr_loss_weight,
                timestep_max=timestep_max,
            )
        # gradients add up in .grad: dividing each micro-batch's loss makes
        # their sum the micro-batch mean
        (loss / state.grad_accum).backward()
        state.step += 1
        if state.step % state.grad_accum == 0:
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        return state, {k: v.detach() for k, v in aux.items()}

    return step_fn
