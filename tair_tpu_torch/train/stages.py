"""Per-stage trainable-parameter masks.

Counterpart of ``tair_tpu/train/stages.py``, over parameter names instead of
a parameter tree (``named_parameters()`` of the port's ``TeReDiff`` carries the
JAX tree's names behind a ``cldm.`` prefix for the four sub-models of the
ControlLDM):
  stage1 "image_restoration_module": controlnet + UNet attention layers
  stage2 "text_spotting_module":     testr only
  stage3 "all_modules":              union of the two
VAE / CLIP / SwinIR are always frozen.
"""

from __future__ import annotations

from typing import Dict, Iterable, Union

from torch import nn

STAGE_ALIASES = {
    "stage1": "image_restoration_module",
    "stage2": "text_spotting_module",
    "stage3": "all_modules",
}
_STAGES = ("image_restoration_module", "text_spotting_module", "all_modules")


def _names(params: Union[nn.Module, Iterable[str]]):
    if isinstance(params, nn.Module):
        return [name for name, _ in params.named_parameters()]
    return list(params)


def trainable_mask(params: Union[nn.Module, Iterable[str]], stage: str) -> Dict[str, bool]:
    """{parameter name: True where the given stage trains it}, for a model or
    an iterable of its parameter names."""
    stage = STAGE_ALIASES.get(stage, stage)
    if stage not in _STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    train_restoration = stage in ("image_restoration_module", "all_modules")
    train_spotter = stage in ("text_spotting_module", "all_modules")

    def decide(name: str) -> bool:
        parts = name.split(".")
        if parts[0] == "cldm":
            parts = parts[1:]
        top = parts[0]
        if top == "controlnet":
            return train_restoration
        if top == "unet":
            return train_restoration and "attn" in name
        if top == "testr":
            return train_spotter
        return False  # vae / clip / swinir always frozen

    return {name: decide(name) for name in _names(params)}


def count_trainable(mask: Dict[str, bool]) -> int:
    return sum(bool(m) for m in mask.values())


def apply_trainable_mask(model: nn.Module, stage: str) -> Dict[str, bool]:
    """Set ``requires_grad`` of every parameter of `model` from the stage's
    mask (and drop the gradient of a parameter that is frozen now). Returns
    the mask."""
    mask = trainable_mask(model, stage)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if not mask[name]:
            p.grad = None
    return mask
