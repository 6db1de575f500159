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
from typing import Any, Dict, Iterator, Mapping, Tuple

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
