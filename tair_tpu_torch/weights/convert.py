"""JAX parameter tree -> ``state_dict`` of the port's ``TeReDiff``.

The port's modules are named after the JAX parameter tree, so the mapping is a
rule per leaf rather than a table per model:

  ``a/b/kernel`` 4-D  -> ``a.b.weight``  HWIO -> OIHW        (convolution)
  ``a/b/kernel`` 2-D  -> ``a.b.weight``  transposed          (dense)
  ``attn/{query,key,value}/kernel`` [in, H, D] and ``bias`` [H, D], and
  ``attn/out/kernel`` [H, D, out]   -> flattened over (H, D) (multi-head attention)
  ``scale`` -> ``weight`` (norms), ``embedding`` -> ``weight`` (token table)
  a ``GroupNorm_0`` level (the float32 GroupNorm wrapper's inner module) is dropped
  ``block_<i>`` under a spatial transformer, a CLIP tower or an RSTB layer ->
  ``blocks.<i>``; ``layer_<i>`` of SwinIR -> ``layers.<i>``
  bare parameters (``positional_embedding``, ``rel_pos_bias_table``,
  ``level_embed``, ``ctrl_point_embed``, ``text_embed``) keep their names.

The tree is plain nested dicts of numpy arrays (``jax.device_get`` of the
params); nothing of JAX is imported here. A leaf that no rule takes raises,
and the result is meant for ``load_state_dict(strict=True)``, which raises on
any parameter of the port that no leaf filled. ``to_jax_tree`` and
``to_jax_params`` go the other way, given a tree of the JAX shapes, so that
parameters or gradients of the port can be held against the JAX package's leaf
by leaf.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

BUNDLE_KEYS = ("unet", "controlnet", "vae", "clip", "swinir", "testr")
# where each top-level tree of the JAX bundle lives in the port's TeReDiff
_PREFIX = {
    "unet": "cldm.unet",
    "controlnet": "cldm.controlnet",
    "vae": "cldm.vae",
    "clip": "cldm.clip",
    "swinir": "swinir",
    "testr": "testr",
}
_BARE = {
    "positional_embedding", "rel_pos_bias_table", "level_embed",
    "ctrl_point_embed", "text_embed",
}
_MHA_PROJ = {"query", "key", "value"}
_INDEXED = re.compile(r"^(block|layer)_(\d+)$")


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> Iterator:
    for key, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, path + (key,))
        else:
            yield path + (key,), np.asarray(node)


def _module_path(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        if p == "GroupNorm_0":
            continue
        m = _INDEXED.match(p)
        if m:
            parts.append(f"{m.group(1)}s.{m.group(2)}")
        else:
            parts.append(p)
    return ".".join(parts)


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    base = _module_path(tuple(mods))
    if leaf in _BARE and arr.ndim == 2:
        return (f"{base}.{leaf}" if base else leaf), arr
    if leaf == "embedding" and arr.ndim == 2:
        return f"{base}.weight", arr
    if leaf == "scale" and arr.ndim == 1:
        return f"{base}.weight", arr
    if leaf == "kernel":
        if arr.ndim == 4:
            return f"{base}.weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return f"{base}.weight", arr.T
        if arr.ndim == 3 and parent in _MHA_PROJ:
            return f"{base}.weight", arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 3 and parent == "out":
            return f"{base}.weight", arr.reshape(-1, arr.shape[-1]).T
    if leaf == "bias":
        if arr.ndim == 1:
            return f"{base}.bias", arr
        if arr.ndim == 2 and parent in _MHA_PROJ:
            return f"{base}.bias", arr.reshape(-1)
    raise ValueError(
        f"no rule for JAX leaf {'/'.join(path)} of shape {arr.shape}"
    )


def _invert_leaf(path: Tuple[str, ...], value: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """A converted value back in the layout of the JAX leaf at `path`, whose
    shape is `shape`: the inverse of `_convert_leaf`'s transposes and folds."""
    parent = path[-2] if len(path) > 1 else ""
    if path[-1] == "kernel":
        if len(shape) == 4:
            return value.transpose(2, 3, 1, 0)
        if len(shape) == 2:
            return value.T
        if len(shape) == 3 and (parent in _MHA_PROJ or parent == "out"):
            return value.T.reshape(shape)
    return value.reshape(shape)


def to_jax_tree(
    state: Mapping[str, torch.Tensor], like: Mapping[str, Any]
) -> Dict[str, Any]:
    """The reverse of `convert_tree`: values keyed by the port's parameter
    names (a ``state_dict``, or gradients by name) laid out as the JAX tree
    `like` (nested dicts whose leaves have a ``shape``), as numpy arrays. A
    name that `state` lacks gives ``None`` at its leaf."""

    def walk(tree, path):
        res = {}
        for key, node in tree.items():
            if isinstance(node, Mapping):
                res[key] = walk(node, path + (key,))
                continue
            shape = tuple(node.shape)
            name, _ = _convert_leaf(path + (key,), np.empty(shape, np.float32))
            value = state.get(name)
            res[key] = (
                None if value is None
                else _invert_leaf(path + (key,), value.detach().cpu().float().numpy(), shape)
            )
        return res

    return walk(like, ())


def to_jax_params(
    state: Mapping[str, torch.Tensor], like: Mapping[str, Any]
) -> Dict[str, Any]:
    """The reverse of `from_jax_params` for the top-level trees that `like`
    holds: ``TeReDiff.state_dict()`` layout (or gradients by parameter name)
    -> {unet, controlnet, ...} trees shaped as `like`."""
    out = {}
    for top, tree in like.items():
        prefix = _PREFIX[top] + "."
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        out[top] = to_jax_tree(sub, tree)
    return out


def convert_tree(
    tree: Mapping[str, Any], dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """One module's JAX params (nested dicts of numpy arrays) -> the
    ``state_dict`` of its counterpart in the port."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        name, value = _convert_leaf(path, arr)
        if name in state:
            raise ValueError(f"two JAX leaves map to {name}")
        state[name] = torch.from_numpy(np.ascontiguousarray(value)).to(dtype)
    return state


def from_jax_params(
    params: Mapping[str, Any], dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """Whole-bundle JAX params {unet, controlnet, vae, clip, swinir, testr} as
    nested dicts of numpy arrays -> ``TeReDiff.state_dict()`` layout."""
    unknown = set(params) - set(BUNDLE_KEYS)
    if unknown:
        raise ValueError(f"unknown top-level trees in the JAX bundle: {sorted(unknown)}")
    state: Dict[str, torch.Tensor] = {}
    for top in BUNDLE_KEYS:
        if top in params:
            for name, value in convert_tree(params[top], dtype).items():
                state[f"{_PREFIX[top]}.{name}"] = value
    return state


class LeafShape:
    """A leaf of `jax_param_shapes`' tree: the JAX leaf's shape, no data."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)

    def __repr__(self) -> str:
        return f"LeafShape{self.shape}"


def _jax_leaf(module: torch.nn.Module, parent: Optional[torch.nn.Module], key: str,
              value: torch.Tensor) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(the JAX names below the module's path, the JAX shape) of the port's
    parameter `key` of `module`; `parent` owns `module`."""
    from ..models.layers import GroupNorm32, MultiHeadAttention

    shape = tuple(value.shape)
    if isinstance(module, torch.nn.Conv2d) and key == "weight":
        o, i, kh, kw = shape
        return ("kernel",), (kh, kw, i, o)
    if isinstance(module, torch.nn.ConvTranspose2d) and key == "weight":
        # flax ConvTranspose(transpose_kernel=True) keeps [kh, kw, out, in],
        # the forward convolution's kernel, which the conv rule maps to
        # PyTorch's [in, out, kh, kw]
        i, o, kh, kw = shape
        return ("kernel",), (kh, kw, o, i)
    if isinstance(module, torch.nn.Linear):
        out_f, in_f = module.out_features, module.in_features
        heads = parent.heads if isinstance(parent, MultiHeadAttention) else None
        proj = next(
            (n for n, m in parent.named_children() if m is module), None
        ) if heads else None
        if key == "weight":
            if proj in _MHA_PROJ:
                return ("kernel",), (in_f, heads, out_f // heads)
            if proj == "out":
                return ("kernel",), (heads, in_f // heads, out_f)
            return ("kernel",), (in_f, out_f)
        if proj in _MHA_PROJ:
            return ("bias",), (heads, out_f // heads)
        return ("bias",), shape
    if isinstance(module, torch.nn.Embedding):
        return ("embedding",), shape
    if key in _BARE:
        return (key,), shape
    inner = ("GroupNorm_0",) if isinstance(module, GroupNorm32) else ()
    if key == "weight" and value.dim() == 1:
        return inner + ("scale",), shape
    if key == "bias" and value.dim() == 1:
        return inner + ("bias",), shape
    raise ValueError(f"no JAX name for parameter {key} of a {type(module).__name__}")


def _jax_module_path(path: str) -> Tuple[str, ...]:
    """``in_1.attn.blocks.0`` -> (in_1, attn, block_0): the inverse of
    `_module_path` (``GroupNorm_0`` levels are added by `_jax_leaf`)."""
    out, parts, i = [], path.split(".") if path else [], 0
    while i < len(parts):
        if parts[i] in ("blocks", "layers") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i][:-1]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def _shapes_of(model: torch.nn.Module, tops) -> Dict[str, Any]:
    """{top: JAX tree of `LeafShape`s} of `model`'s parameters, each under the
    first (top, prefix) of `tops` whose prefix (``""`` for the whole model)
    starts its name."""
    modules = dict(model.named_modules())
    tree: Dict[str, Any] = {}
    for name, value in model.named_parameters():
        top, prefix = next(
            (t, p) for t, p in tops if not p or name.startswith(p + ".")
        )
        rel = name[len(prefix) + 1:] if prefix else name
        owner, _, key = rel.rpartition(".")
        full_owner = ".".join(filter(None, (prefix, owner)))
        parent_name = full_owner.rpartition(".")[0]
        leaf_names, shape = _jax_leaf(
            modules[full_owner], modules.get(parent_name), key, value
        )
        path = _jax_module_path(owner) + leaf_names
        back, _ = _convert_leaf(path, np.empty(shape, np.float32))
        if back != rel:
            raise ValueError(f"{name} maps to JAX {'/'.join(path)}, which maps back to {back}")
        node = tree.setdefault(top, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = LeafShape(shape)
    return tree


def jax_param_shapes(model: torch.nn.Module) -> Dict[str, Any]:
    """The JAX parameter tree of the port's `TeReDiff` {unet, controlnet, vae,
    clip, swinir, testr}: nested dicts whose leaves are `LeafShape`s, the `like`
    argument of `to_jax_params`. Worked out from the port's modules, so no
    JAX is needed; every leaf round-trips through `_convert_leaf` to the
    parameter it came from."""
    return _shapes_of(model, [(top, _PREFIX[top]) for top in BUNDLE_KEYS])


def module_param_shapes(module: torch.nn.Module) -> Dict[str, Any]:
    """The JAX parameter tree of one stand-alone module of the port (a cleaner:
    ``RRDBNet``, ``SCUNet``), laid out as `jax_param_shapes` lays out a part of
    the bundle: the `like` of `to_jax_tree`. Its JAX tree loads through
    `convert_tree`; cleaners are not parts of the bundle, so `BUNDLE_KEYS` and
    `from_jax_params` do not name them."""
    return _shapes_of(module, [("", "")]).get("", {})
