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


# ---- the learned IQA metrics' checkpoints ------------------------------------

def export_lpips(tree: Tree) -> tuple:
    """Inverse of `convert_lpips`: (torchvision AlexNet's ``features.*``,
    LPIPS's ``lin{i}.model.1.weight``)."""
    return (_export(_c._alexnet_table, tree["alex"], None, ""),
            _export(_c._lpips_lin_table, tree, None, ""))


def export_dists(tree: Tree) -> tuple:
    """Inverse of `convert_dists`: (torchvision VGG16's ``features.*``,
    DISTS's ``weights.pt`` with ``alpha`` and ``beta`` as [1, C, 1, 1])."""
    return (_export(_c._vgg16_table, tree["vgg"], None, ""),
            _export(_c._dists_table, tree, None, ""))


def export_clipiqa(tree: Tree, visual_cfg, text_cfg) -> StateDict:
    """Inverse of `convert_clipiqa`: an OpenAI CLIP RN50 state dict
    (``visual.*``, the text transformer, ``text_projection``, ``logit_scale``)."""
    return _export(_c._clipiqa_table, tree, (visual_cfg, text_cfg), "")


def export_maniqa(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_maniqa`: IIGROUP/MANIQA's names, under `prefix`
    (``module.`` for a checkpoint saved from ``DataParallel``)."""
    return _export(_c._maniqa_table, tree, cfg, prefix)


def export_retinaface(tree: Tree, prefix: str = "") -> StateDict:
    """Inverse of `convert_retinaface`: facexlib's names, under `prefix`
    (``module.`` as in a checkpoint saved from ``DataParallel``)."""
    return _export(_c._retinaface_table, tree, None, prefix)


def export_ram_plus(tree: Tree, cfg, prefix: str = "") -> StateDict:
    """Inverse of `convert_ram_plus`: ``ram_plus_swin_large_14m.pth``'s names
    (``reweight_scale`` as [1], ``fc.W`` as [1, C, hidden], ``fc.b`` as [1, C])."""
    return _export(_c._ram_plus_table, tree, cfg, prefix)


# utils/musiq's layout -> a BiT/timm-flavoured published naming (wrapped in
# ``module.``), which only weights/musiq_shim.py maps back: name prefixes, then
# the blocks' leaf names
_MUSIQ_PUBLISHED = (
    ("patch_encoder.root.weight", "conv_root.weight"),
    ("patch_encoder.root_gn.", "gn_root."),
    ("patch_encoder.block1.proj.weight", "block1.downsample.weight"),
    ("patch_encoder.block1.", "block1."),
    ("patch_encoder.out_gn.", "gn_out."),
    ("patch_encoder.embedding.", "embedding."),
    ("backbone.cls_token", "cls_token"),
    ("backbone.spatial_embedding", "pos_embed"),
    ("backbone.scale_embedding", "scale_embed"),
    ("backbone.blocks.", "transformer.blocks."),
    ("backbone.encoder_norm.", "transformer.norm."),
    ("backbone.head.", "fc_score."),
)
_MUSIQ_PUBLISHED_LEAVES = ((".norm1.", ".ln_1."), (".norm2.", ".ln_2."),
                           (".attn.proj.", ".attn.out_proj."), (".mlp.fc1.", ".linear1."),
                           (".mlp.fc2.", ".linear2."))


def export_musiq(tree: Tree, cfg, published: bool = False) -> StateDict:
    """Inverse of `convert_musiq`: utils/musiq's layout, or with
    ``published=True`` a BiT/timm-flavoured naming under ``module.`` that only
    the shim reads."""
    sd = _export(_c._musiq_table, tree, cfg, "")
    if not published:
        return sd
    out = {}
    for name, value in sd.items():
        for src, dst in _MUSIQ_PUBLISHED:
            if name.startswith(src):
                name = dst + name[len(src):]
                break
        for src, dst in _MUSIQ_PUBLISHED_LEAVES:
            name = name.replace(src, dst)
        out[f"module.{name}"] = value
    return out
