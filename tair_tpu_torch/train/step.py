"""Training state and the train step.

Counterpart of ``tair_tpu/train/step.py``: per step, the frozen prologue
(SwinIR clean, VAE encode of the ground truth and of the cleaned input, CLIP
encode) without gradients, a uniform timestep draw, the v-parameterisation
diffusion loss (plus the weighted OCR loss in stages 2 and 3), and an AdamW
update of the stage's trainable subset.

Where it departs from the JAX signature: the model owns its parameters, so the
state holds the model and a ``torch.optim.AdamW`` instead of a parameter tree
and an optax state; randomness comes from a ``torch.Generator`` or is handed in
as tensors (``draws``, `make_draws`); in place of the mesh and sharding
arguments, a data-parallel state carries a ``parallel.fsdp.GradientSync``,
and each process steps on its rows of the global batch with its rows of the
global batch's draws, so n processes compute the one-process step of the
global batch (the JAX step's global view). Precision: parameters stay float32 (master weights) and, with
``compute_dtype=torch.bfloat16``, the forward runs under ``torch.autocast``, so
matrix products and convolutions compute in bfloat16 while norms, softmax
statistics and losses stay float32, as the JAX package trains
(``param_dtype=float32, dtype=bfloat16``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion.diffusion import Diffusion
from ..parallel.fsdp import GradientSync
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
    # data parallelism: the gradient reduction and the mean of the losses
    # over the processes; None in a single process
    sync: Optional[GradientSync] = None


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
    return _AdamW(
        trained, lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )


class _AdamW(torch.optim.AdamW):
    """AdamW whose update runs FSDP's sharded parameters (DTensors) and the
    others in two passes: the multi-tensor update takes no mix of the two.
    One parameter group, as a single process has, keeps the checkpoint's
    layout; the optimizer's hooks run once, around both passes."""

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        # no DTensor exists before its module is loaded (and loading it costs
        # seconds that a single process need not pay)
        dtensor = sys.modules.get("torch.distributed.tensor")

        def is_sharded(p) -> bool:
            return dtensor is not None and isinstance(p, dtensor.DTensor)

        whole = [g["params"] for g in self.param_groups]
        kinds = {is_sharded(p) for ps in whole for p in ps}
        # AdamW's own step: torch wraps each optimizer class's step in its
        # hooks, which have run around this one
        update = torch.optim.AdamW.step
        update = update.__wrapped__ if getattr(update, "hooked", False) else update
        try:
            for sharded in sorted(kinds):
                for g, ps in zip(self.param_groups, whole):
                    g["params"] = [p for p in ps if is_sharded(p) is sharded]
                update(self)
        finally:
            for g, ps in zip(self.param_groups, whole):
                g["params"] = ps
        return loss


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


def make_draws(
    generator: torch.Generator,
    batch_size: int,
    latent_hw: Tuple[int, int],
    t_hi: int,
    device: torch.device,
    vae_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The step's three draws for a batch of `batch_size` (the global batch
    under data parallelism, whose rows each process then takes), in the
    order JAX's loss function splits its key: ``vae_noise`` [B, h, w, 4] in
    `vae_dtype`, the dtype of the VAE's moments it is added to (JAX draws it
    in ``mean.dtype``: the train step's compute dtype under autocast), ``t``
    [B] in ``[0, t_hi)``, ``noise`` [B, h, w, 4] in float32, the dtype of the
    latent the port's loss keeps."""
    shape = (batch_size, *latent_hw, 4)
    return dict(
        vae_noise=torch.randn(shape, dtype=vae_dtype, device=device, generator=generator),
        t=torch.randint(0, t_hi, (batch_size,), device=device, generator=generator),
        noise=torch.randn(shape, device=device, generator=generator),
    )


def _moments_dtype(model: TeReDiff, device_type: str) -> torch.dtype:
    """The dtype of the VAE's moments: autocast's where it is on, else the
    VAE's parameters'."""
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return next(model.cldm.vae.parameters()).dtype


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
    `noise` [B,h,w,4]) are `draws`, or else `make_draws` from `generator`.
    """
    if not 0 <= timestep_max <= diffusion.num_timesteps:
        raise ValueError(
            f"timestep_max {timestep_max} lies outside the schedule's "
            f"{diffusion.num_timesteps} steps"
        )
    gt = batch["gt"]
    if draws is None:
        t_hi = timestep_max if timestep_max > 0 else diffusion.num_timesteps
        draws = make_draws(generator, gt.shape[0], (gt.shape[1] // 8, gt.shape[2] // 8),
                           t_hi, gt.device, _moments_dtype(model, gt.device.type))
    elif set(draws) != {"vae_noise", "t", "noise"}:
        raise ValueError(f"draws holds {sorted(draws)}, not vae_noise, t and noise")

    with torch.no_grad():  # the frozen parts
        clean = model.clean(batch["lq"])
        z_0 = model.cldm.vae_encode(gt, sample=True, noise=draws["vae_noise"]).float()
        cond = dict(
            c_txt=model.cldm.clip_encode_tokens(batch["tokens"]),
            c_img=model.cldm.vae_encode(clean * 2.0 - 1.0, sample=False).float(),
        )
    diff_loss, feats = diffusion.p_losses(
        model.cldm.apply, z_0, draws["t"], cond, noise=draws["noise"]
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
        # their sum the micro-batch mean; processes reduce only on the update
        update = (state.step + 1) % state.grad_accum == 0
        if state.sync is not None:
            state.sync.before_backward(update)
        (loss / state.grad_accum).backward()
        if state.sync is not None:
            state.sync.after_backward(update)
        state.step += 1
        if update:
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        aux = {k: v.detach() for k, v in aux.items()}
        if state.sync is not None:
            aux = state.sync.mean(aux)
        return state, aux

    return step_fn
