"""JAX-layout trees -> checkpoints under the reference's names.

The inverses of the readers in ``weights/convert.py``, from the same tables run
backwards: each ``export_*`` takes one part's tree in the JAX layout (nested
dicts of numpy arrays; for the port's model, ``to_jax_params(model.state_dict(),
jax_param_shapes(model))``) and gives the {name: array} dict of the reference's
checkpoint for it, every branch of the table included. ``convert_*(export_*(tree))``
giving the tree back holds a table against the model's real parameter tree. The
tests and ``chip_smoke.py`` build reference-layout checkpoints with them from
seeded parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from . import convert as _c

Tree = Mapping[str, Any]
StateDict = Dict[str, np.ndarray]


def _export(table, tree: Tree, cfg, prefix: str) -> StateDict:
    r = _c.Reader({}, prefix, export=True)
    table(tree, r, cfg)
    return r.sd


def export_unet(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_unet` (SD-2.1 ``model.diffusion_model`` names)."""
    return _export(_c._unet_table, tree, cfg, prefix)


def export_controlnet(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_controlnet` (DiffBIR's ControlNet names)."""
    return _export(_c._controlnet_table, tree, cfg, prefix)


def export_vae(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_vae` (SD's ``first_stage_model`` names)."""
    return _export(_c._vae_table, tree, cfg, prefix)


def export_clip(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_clip` (open_clip's text-branch names)."""
    return _export(_c._clip_table, tree, cfg, prefix)


def export_swinir(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_swinir` (Real-ESRGAN's SwinIR names, no ``module.``)."""
    return _export(_c._swinir_table, tree, cfg, prefix)


def export_bsrnet(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_bsrnet` (BSRGAN's ``RRDBNet`` names)."""
    return _export(_c._bsrnet_table, tree, cfg, prefix)


def export_scunet(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_scunet` (SCUNet's names)."""
    return _export(_c._scunet_table, tree, cfg, prefix)


def export_testr(tree: Tree, cfg, prefix: str = "testr.") -> StateDict:
    """Inverse of `convert_testr` (adet's ``TransformerDetector`` names)."""
    return _export(_c._testr_table, tree, cfg, prefix)
