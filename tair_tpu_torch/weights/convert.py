"""JAX parameter tree -> ``state_dict`` of the port's ``TeReDiff``; and the
released PyTorch checkpoints -> JAX parameter trees.

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
  ``level_embed``, ``ctrl_point_embed``, ``text_embed``) keep their names, and
  so do those of the IQA metrics whatever their rank (inference batch norm's
  ``mean`` and ``var``, DISTS' ``alpha`` and ``beta``, the ViTs' ``cls_token``
  and ``pos_embed``, Swin's ``relative_position_bias_table``, MUSIQ's
  ``spatial_embedding`` and ``scale_embedding``; RAM++'s ``label_embed``,
  ``reweight_scale``, ``fc_w`` and ``fc_b``).

The tree is plain nested dicts of numpy arrays (``jax.device_get`` of the
params); nothing of JAX is imported here. A leaf that no rule takes raises,
and the result is meant for ``load_state_dict(strict=True)``, which raises on
any parameter of the port that no leaf filled. ``to_jax_tree`` and
``to_jax_params`` go the other way, given a tree of the JAX shapes, so that
parameters or gradients of the port can be held against the JAX package's leaf
by leaf.

The readers of the released checkpoints (``load_torch_file``, ``convert_*``,
``load_pretrained_sd_bundle``, ``_cast_like``, at the end of the file) give
trees in the same JAX layout, so they reach the port's modules through
`from_jax_params` or an npz in the JAX layout, and the rules above stay the
only layout rules.
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
# bare parameters of the IQA metrics (utils/{clipiqa,dists,maniqa,musiq}.py), of any rank
_BARE_ANY_RANK = {
    "mean", "var", "alpha", "beta", "cls_token", "pos_embed",
    "relative_position_bias_table", "spatial_embedding", "scale_embedding",
    # RAM++ (models/ram.py): the description table, its softmax scale and the
    # per-class output weights
    "label_embed", "reweight_scale", "fc_w", "fc_b",
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
    if leaf in _BARE and arr.ndim == 2 or leaf in _BARE_ANY_RANK:
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
    if key in _BARE or key in _BARE_ANY_RANK:
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


def _jax_leaves(model: torch.nn.Module, tops) -> Iterator[Tuple[str, str, Tuple[str, ...], Tuple[int, ...]]]:
    """(parameter name, top, JAX path below the top, JAX shape) of each of
    `model`'s parameters, under the first (top, prefix) of `tops` whose prefix
    (``""`` for the whole model) starts its name."""
    modules = dict(model.named_modules())
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
        yield name, top, path, shape


def _shapes_of(model: torch.nn.Module, tops) -> Dict[str, Any]:
    """{top: JAX tree of `LeafShape`s} of `model`'s parameters (`_jax_leaves`)."""
    tree: Dict[str, Any] = {}
    for _, top, path, shape in _jax_leaves(model, tops):
        node = tree.setdefault(top, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = LeafShape(shape)
    return tree


def jax_leaves(model: torch.nn.Module) -> Iterator[Tuple[str, Tuple[str, ...], Tuple[int, ...]]]:
    """(parameter name, JAX path from the bundle's top, JAX shape) of each
    parameter of the port's `TeReDiff`: the leaves of `jax_param_shapes`."""
    for name, top, path, shape in _jax_leaves(
        model, [(top, _PREFIX[top]) for top in BUNDLE_KEYS]
    ):
        yield name, (top,) + path, shape


def torch_axes(path: Tuple[str, ...], ndim: int) -> Tuple[int, ...]:
    """For each axis of the JAX leaf at `path` (of rank `ndim`), the axis of
    the port's parameter that holds it: `_convert_leaf`'s transposes and
    folds, read off a probe array (two JAX axes folded into one land on the
    same axis)."""
    probe = np.arange(int(np.prod(range(2, 2 + ndim)))).reshape(tuple(range(2, 2 + ndim)))
    _, value = _convert_leaf(path, probe)
    coords = np.unravel_index(value, probe.shape)
    axes = []
    for c in coords:
        moving = [d for d in range(value.ndim) if (np.diff(c, axis=d) != 0).any()]
        if len(moving) != 1:
            raise ValueError(f"JAX leaf {'/'.join(path)}: an axis spreads over {moving}")
        axes.append(moving[0])
    return tuple(axes)


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


# --------------------------------------------------------------------------
# Reading the released PyTorch checkpoints
#
# The reference's files name their tensors after the reference's modules
# (``input_blocks.1.0.in_layers.2.weight``, ``transformer.resblocks.3.attn
# .in_proj_weight`` ...). The tables below say which reference tensor feeds
# which leaf of the JAX-layout tree; the tree then reaches the port's modules
# through `from_jax_params` (or an npz in the JAX layout), so the layout rules
# of `_convert_leaf` stay the only ones. The tables are those of the JAX
# package's ``weights/convert.py``, kept here so that the port needs no JAX.
#
# Each table is written once, as a function ``_<part>_table(out, r, cfg)``
# whose every step is `_move` (or `_mha`). A `Reader` over a checkpoint runs
# it forwards (``convert_<part>``: reference tensors -> leaves of `out`); a
# `Reader` made with ``export=True`` runs it backwards (``weights/export.py``:
# the leaves of the tree `out` -> reference tensors).
# --------------------------------------------------------------------------

Params = Dict[str, Any]
TorchDict = Dict[str, np.ndarray]


def t_conv(w: np.ndarray) -> np.ndarray:
    """Convolution kernel, PyTorch [O, I, kh, kw] -> JAX [kh, kw, I, O]."""
    return np.transpose(w, (2, 3, 1, 0))


def t_conv_inv(w: np.ndarray) -> np.ndarray:
    """JAX [kh, kw, I, O] -> PyTorch [O, I, kh, kw]."""
    return np.transpose(w, (3, 2, 0, 1))


def t_lin(w: np.ndarray) -> np.ndarray:
    """Dense kernel, PyTorch [out, in] <-> JAX [in, out]."""
    return np.transpose(w)


def _same(w: np.ndarray) -> np.ndarray:
    return w


def _set(tree: Params, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def _get(tree: Mapping[str, Any], path: str) -> np.ndarray:
    node = tree
    for p in path.split("/"):
        node = node[p]
    return np.asarray(node)


def _has(tree: Mapping[str, Any], path: str) -> bool:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, Mapping) or p not in node:
            return False
        node = node[p]
    return True


class Reader:
    """Reads the tensors of a checkpoint under `prefix` and records which it
    read (`used`) and which a table asked for but the file lacks
    (`missing`); `unused()` is what the file holds under `prefix` that no
    table read. With ``export=True`` a table runs backwards through it: `sd`
    receives, under `prefix`, each reference tensor that the tree's leaves
    give (`put`)."""

    def __init__(self, sd: TorchDict, prefix: str = "", export: bool = False):
        self.sd = sd
        self.prefix = prefix
        self.export = export
        self.used: set = set()
        self.missing: set = set()

    def __call__(self, key: str) -> np.ndarray:
        full = self.prefix + key
        if full not in self.sd:
            self.missing.add(full)
            raise KeyError(full)
        self.used.add(full)
        return np.asarray(self.sd[full])

    def sub(self, prefix: str) -> "Reader":
        """A reader of the names under this one's prefix + `prefix` that keeps
        its records (`used`, `missing`) in this one's."""
        r = Reader(self.sd, self.prefix + prefix, self.export)
        r.used, r.missing = self.used, self.missing
        return r

    def put(self, key: str, value: np.ndarray) -> None:
        self.sd[self.prefix + key] = value

    def has(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def unused(self) -> set:
        return {k for k in self.sd if k.startswith(self.prefix)} - self.used


def _move(out: Params, dst: str, r: Reader, src: str, fwd=_same, inv=_same) -> None:
    """The step of every table: the reference tensor `src` (a name under the
    reader's prefix) is the leaf `dst` of `out` after `fwd`. Run backwards
    (``r.export``), `out` is the tree read and ``inv(leaf)`` goes to `src`."""
    if r.export:
        r.put(src, inv(_get(out, dst)))
    else:
        _set(out, dst, fwd(r(src)))


def _present(out: Params, dst: str, r: Reader, src: str) -> bool:
    """Whether an optional module is there: the tensor `src` in the checkpoint
    read, the subtree `dst` in the tree exported."""
    return _has(out, dst) if r.export else r.has(src)


def _conv(out: Params, dst: str, r: Reader, src: str, bias: bool = True) -> None:
    _move(out, f"{dst}/kernel", r, f"{src}.weight", t_conv, t_conv_inv)
    if bias:
        _move(out, f"{dst}/bias", r, f"{src}.bias")


def _lin(out: Params, dst: str, r: Reader, src: str, bias: bool = True) -> None:
    _move(out, f"{dst}/kernel", r, f"{src}.weight", t_lin, t_lin)
    if bias:
        _move(out, f"{dst}/bias", r, f"{src}.bias")


def _norm(out: Params, dst: str, r: Reader, src: str) -> None:
    _move(out, f"{dst}/scale", r, f"{src}.weight")
    _move(out, f"{dst}/bias", r, f"{src}.bias")


def _gn32(out: Params, dst: str, r: Reader, src: str) -> None:
    # the float32 GroupNorm wrapper holds its norm as a module named GroupNorm_0
    _norm(out, f"{dst}/GroupNorm_0", r, src)


_QKV = ("query", "key", "value")


def _mha(out: Params, dst: str, r: Reader, src: str, heads: int) -> None:
    """``nn.MultiheadAttention`` (packed ``in_proj``) -> per-head query, key,
    value kernels [C, heads, C/heads] and the output kernel [heads, C/heads, C]."""
    if r.export:
        kernels = [_get(out, f"{dst}/{n}/kernel") for n in _QKV]  # [C, heads, hd]
        c = kernels[0].shape[0]
        r.put(f"{src}.in_proj_weight", np.concatenate([t_lin(k.reshape(c, c)) for k in kernels]))
        r.put(f"{src}.in_proj_bias",
              np.concatenate([_get(out, f"{dst}/{n}/bias").reshape(c) for n in _QKV]))
    else:
        w = r(f"{src}.in_proj_weight")  # [3C, C]
        b = r(f"{src}.in_proj_bias")
        c = w.shape[1]
        for i, name in enumerate(_QKV):
            kw = t_lin(w[i * c : (i + 1) * c])  # [C, C] (in, out)
            _set(out, f"{dst}/{name}/kernel", kw.reshape(c, heads, c // heads))
            _set(out, f"{dst}/{name}/bias", b[i * c : (i + 1) * c].reshape(heads, c // heads))
    _move(out, f"{dst}/out/kernel", r, f"{src}.out_proj.weight",  # [C, C] (out, in)
          lambda w: t_lin(w).reshape(heads, -1, w.shape[0]),
          lambda k: t_lin(k.reshape(-1, k.shape[-1])))
    _move(out, f"{dst}/out/bias", r, f"{src}.out_proj.bias")


def _resblock(out: Params, dst: str, r: Reader, src: str) -> None:
    _gn32(out, f"{dst}/in_norm", r, f"{src}.in_layers.0")
    _conv(out, f"{dst}/in_conv", r, f"{src}.in_layers.2")
    _lin(out, f"{dst}/emb_proj", r, f"{src}.emb_layers.1")
    _gn32(out, f"{dst}/out_norm", r, f"{src}.out_layers.0")
    _conv(out, f"{dst}/out_conv", r, f"{src}.out_layers.3")
    if _present(out, f"{dst}/skip", r, f"{src}.skip_connection.weight"):
        _conv(out, f"{dst}/skip", r, f"{src}.skip_connection")


def _spatial_transformer(out: Params, dst: str, r: Reader, src: str, depth: int = 1):
    _gn32(out, f"{dst}/norm", r, f"{src}.norm")
    _lin(out, f"{dst}/proj_in", r, f"{src}.proj_in")
    for d in range(depth):
        blk_src = f"{src}.transformer_blocks.{d}"
        blk = f"{dst}/block_{d}"
        for attn in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _lin(out, f"{blk}/{attn}/{n}", r, f"{blk_src}.{attn}.{n}", bias=False)
            _lin(out, f"{blk}/{attn}/to_out", r, f"{blk_src}.{attn}.to_out.0")
        for i in (1, 2, 3):
            _norm(out, f"{blk}/norm{i}", r, f"{blk_src}.norm{i}")
        _lin(out, f"{blk}/ff/geglu/proj", r, f"{blk_src}.ff.net.0.proj")
        _lin(out, f"{blk}/ff/out", r, f"{blk_src}.ff.net.2")
    _lin(out, f"{dst}/proj_out", r, f"{src}.proj_out")


def _read(table, sd: TorchDict, cfg, prefix: str) -> Tuple[Params, Reader]:
    r = Reader(sd, prefix)
    out: Params = {}
    table(out, r, cfg)
    return out, r


def _unet_encoder(out: Params, r: Reader, cfg, zero_convs: bool) -> None:
    """The time embedding and input blocks shared by the UNet and the
    ControlNet (whose every input block also has a zero convolution)."""
    from ..models.unet import _encoder_plan

    _lin(out, "time_embed/fc1", r, "time_embed.0")
    _lin(out, "time_embed/fc2", r, "time_embed.2")
    _conv(out, "in_conv", r, "input_blocks.0.0")
    for i, (kind, _ch, attn) in enumerate(_encoder_plan(cfg)):
        src = f"input_blocks.{i}"
        if kind == "down":
            _conv(out, f"in_{i}/conv", r, f"{src}.0.op")
        elif kind != "conv":
            _resblock(out, f"in_{i}/res", r, f"{src}.0")
            if attn:
                _spatial_transformer(out, f"in_{i}/attn", r, f"{src}.1",
                                     cfg.transformer_depth)
        if zero_convs:
            _conv(out, f"zero_{i}", r, f"zero_convs.{i}.0")
    _resblock(out, "middle/res1", r, "middle_block.0")
    _spatial_transformer(out, "middle/attn", r, "middle_block.1", cfg.transformer_depth)
    _resblock(out, "middle/res2", r, "middle_block.2")


def _unet_table(out: Params, r: Reader, cfg) -> None:
    from ..models.unet import _decoder_plan

    _unet_encoder(out, r, cfg, zero_convs=False)
    for i, (_ch, attn, upsample) in enumerate(_decoder_plan(cfg)):
        src = f"output_blocks.{i}"
        _resblock(out, f"out_{i}/res", r, f"{src}.0")
        layer = 1
        if attn:
            _spatial_transformer(out, f"out_{i}/attn", r, f"{src}.{layer}",
                                 cfg.transformer_depth)
            layer += 1
        if upsample:
            _conv(out, f"out_{i}/up/conv", r, f"{src}.{layer}.conv")
    _gn32(out, "out_norm", r, "out.0")
    _conv(out, "out_conv", r, "out.2")


def convert_unet(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """SD-2.1 ``UNetModel`` tensors under `prefix` -> the UNet's JAX tree."""
    return _read(_unet_table, sd, cfg, prefix)


def _controlnet_table(out: Params, r: Reader, cfg) -> None:
    _unet_encoder(out, r, cfg, zero_convs=True)
    _conv(out, "middle_out", r, "middle_block_out.0")


def convert_controlnet(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """DiffBIR's ControlNet checkpoint -> the ControlNet's JAX tree."""
    return _read(_controlnet_table, sd, cfg, prefix)


def _copy_tree(tree: Mapping[str, Any]) -> Params:
    return {k: _copy_tree(v) if isinstance(v, Mapping) else v for k, v in tree.items()}


def controlnet_from_unet(unet_params: Params, controlnet_params: Params) -> Params:
    """The ControlNet started from the UNet's weights: every leaf the two
    share by name and shape is copied; the input convolution, which also reads
    the hint, gets the UNet's kernel with its extra input channels zero.
    The zero convolutions keep the values of `controlnet_params`."""
    out = _copy_tree(controlnet_params)

    def walk(src, dst):
        for k, v in src.items():
            if k not in dst:
                continue
            if isinstance(v, Mapping):
                walk(v, dst[k])
                continue
            s, d = np.asarray(v), np.asarray(dst[k])
            if s.shape == d.shape:
                dst[k] = s
            elif s.ndim == 4 and d.ndim == 4 and s.shape[:2] == d.shape[:2]:
                pad = np.zeros(s.shape[:2] + (d.shape[2] - s.shape[2], s.shape[3]), s.dtype)
                dst[k] = np.concatenate([s, pad], axis=2)

    walk(unet_params, out)
    return out


def _vae_resblock(out, dst, r, src):
    _gn32(out, f"{dst}/norm1", r, f"{src}.norm1")
    _conv(out, f"{dst}/conv1", r, f"{src}.conv1")
    _gn32(out, f"{dst}/norm2", r, f"{src}.norm2")
    _conv(out, f"{dst}/conv2", r, f"{src}.conv2")
    if _present(out, f"{dst}/nin_shortcut", r, f"{src}.nin_shortcut.weight"):
        _conv(out, f"{dst}/nin_shortcut", r, f"{src}.nin_shortcut")


def _vae_attn(out, dst, r, src):
    _gn32(out, f"{dst}/norm", r, f"{src}.norm")
    for n in ("q", "k", "v", "proj_out"):
        _conv(out, f"{dst}/{n}", r, f"{src}.{n}")


def _vae_table(out: Params, r: Reader, cfg) -> None:
    enc, dec = out.setdefault("encoder", {}), out.setdefault("decoder", {})
    levels = len(cfg.ch_mult)

    _conv(enc, "conv_in", r, "encoder.conv_in")
    for lvl in range(levels):
        for i in range(cfg.num_res_blocks):
            _vae_resblock(enc, f"down_{lvl}_block_{i}", r, f"encoder.down.{lvl}.block.{i}")
        if lvl != levels - 1:
            _conv(enc, f"down_{lvl}_downsample", r, f"encoder.down.{lvl}.downsample.conv")
    _vae_resblock(enc, "mid_block_1", r, "encoder.mid.block_1")
    _vae_attn(enc, "mid_attn", r, "encoder.mid.attn_1")
    _vae_resblock(enc, "mid_block_2", r, "encoder.mid.block_2")
    _gn32(enc, "norm_out", r, "encoder.norm_out")
    _conv(enc, "conv_out", r, "encoder.conv_out")

    _conv(dec, "conv_in", r, "decoder.conv_in")
    _vae_resblock(dec, "mid_block_1", r, "decoder.mid.block_1")
    _vae_attn(dec, "mid_attn", r, "decoder.mid.attn_1")
    _vae_resblock(dec, "mid_block_2", r, "decoder.mid.block_2")
    for lvl in range(levels):
        for i in range(cfg.num_res_blocks + 1):
            _vae_resblock(dec, f"up_{lvl}_block_{i}", r, f"decoder.up.{lvl}.block.{i}")
        if lvl != 0:
            _conv(dec, f"up_{lvl}_upsample", r, f"decoder.up.{lvl}.upsample.conv")
    _gn32(dec, "norm_out", r, "decoder.norm_out")
    _conv(dec, "conv_out", r, "decoder.conv_out")

    _conv(out, "quant_conv", r, "quant_conv")
    _conv(out, "post_quant_conv", r, "post_quant_conv")


def convert_vae(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """SD's ``first_stage_model`` (``AutoencoderKL``) -> the VAE's JAX tree."""
    return _read(_vae_table, sd, cfg, prefix)


def _clip_table(out: Params, r: Reader, cfg) -> None:
    _move(out, "token_embedding/embedding", r, "token_embedding.weight")
    _move(out, "positional_embedding", r, "positional_embedding")
    n_blocks = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
    for i in range(n_blocks):
        src, dst = f"transformer.resblocks.{i}", f"block_{i}"
        _norm(out, f"{dst}/ln_1", r, f"{src}.ln_1")
        _norm(out, f"{dst}/ln_2", r, f"{src}.ln_2")
        _mha(out, f"{dst}/attn", r, f"{src}.attn", cfg.heads)
        _lin(out, f"{dst}/mlp_fc", r, f"{src}.mlp.c_fc")
        _lin(out, f"{dst}/mlp_proj", r, f"{src}.mlp.c_proj")
    _norm(out, "ln_final", r, "ln_final")


def convert_clip(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """open_clip's text branch (``token_embedding``, ``positional_embedding``,
    ``transformer.resblocks.N``, ``ln_final``) -> the CLIP tower's JAX tree;
    the blocks past the one the tower stops at are left unused."""
    return _read(_clip_table, sd, cfg, prefix)


def _strip_module(sd: TorchDict) -> TorchDict:
    """Drop the ``module.`` that a checkpoint saved from ``DataParallel`` puts
    before every name."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


# SwinIR's upsampling convolutions by scale factor
SWINIR_UPSAMPLERS = {2: ("conv_up1",), 4: ("conv_up1", "conv_up2"),
                     8: ("conv_up1", "conv_up2", "conv_up3")}


def _swinir_table(out: Params, r: Reader, cfg) -> None:
    _conv(out, "conv_first", r, "conv_first.1" if cfg.unshuffle else "conv_first")
    _norm(out, "patch_norm", r, "patch_embed.norm")
    for li, depth in enumerate(cfg.depths):
        for bi in range(depth):
            src = f"layers.{li}.residual_group.blocks.{bi}"
            dst = f"layer_{li}/block_{bi}"
            _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
            _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
            _lin(out, f"{dst}/attn/qkv", r, f"{src}.attn.qkv")
            _lin(out, f"{dst}/attn/proj", r, f"{src}.attn.proj")
            _move(out, f"{dst}/attn/rel_pos_bias_table", r,
                  f"{src}.attn.relative_position_bias_table")
            _lin(out, f"{dst}/mlp_fc1", r, f"{src}.mlp.fc1")
            _lin(out, f"{dst}/mlp_fc2", r, f"{src}.mlp.fc2")
        _conv(out, f"layer_{li}/conv", r, f"layers.{li}.conv")
    _norm(out, "norm", r, "norm")
    _conv(out, "conv_after_body", r, "conv_after_body")
    _conv(out, "conv_before_upsample", r, "conv_before_upsample.0")
    for name in SWINIR_UPSAMPLERS[cfg.sf]:
        _conv(out, name, r, name)
    _conv(out, "conv_hr", r, "conv_hr")
    _conv(out, "conv_last", r, "conv_last")


def convert_swinir(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """Real-ESRGAN's SwinIR (``module.`` stripped; the first convolution is
    ``conv_first.1`` after a pixel unshuffle) -> the cleaner's JAX tree."""
    return _read(_swinir_table, _strip_module(sd), cfg, prefix)


def _bsrnet_table(out: Params, r: Reader, cfg) -> None:
    _conv(out, "conv_first", r, "conv_first")
    for i in range(cfg.nb):
        for j in range(3):
            for k in range(5):
                _conv(out, f"rrdb_{i}/rdb{j + 1}/conv{k + 1}", r,
                      f"RRDB_trunk.{i}.RDB{j + 1}.conv{k + 1}")
    _conv(out, "trunk_conv", r, "trunk_conv")
    _conv(out, "upconv1", r, "upconv1")
    if cfg.sf == 4:
        _conv(out, "upconv2", r, "upconv2")
    _conv(out, "hr_conv", r, "HRconv")
    _conv(out, "conv_last", r, "conv_last")


def convert_bsrnet(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """BSRNet / BSRGAN ``RRDBNet`` (``conv_first``, ``RRDB_trunk.N.RDBM.convK``,
    ``trunk_conv``, ``upconv1/2``, ``HRconv``, ``conv_last``) -> its JAX tree."""
    return _read(_bsrnet_table, _strip_module(sd), cfg, prefix)


def _rel_table(rel: np.ndarray) -> np.ndarray:
    """SCUNet's relative bias [heads, 2w-1, 2w-1] -> the [(2w-1)^2, heads] table."""
    return np.transpose(rel, (1, 2, 0)).reshape(-1, rel.shape[0])


def _rel_table_inv(table: np.ndarray) -> np.ndarray:
    side = int(round(np.sqrt(table.shape[0])))
    return table.reshape(side, side, -1).transpose(2, 0, 1)


def _scunet_table(out: Params, r: Reader, cfg) -> None:
    def swin_block(dst, src):
        t = f"{src}.trans_block"
        _norm(out, f"{dst}/trans/norm1", r, f"{t}.ln1")
        _norm(out, f"{dst}/trans/norm2", r, f"{t}.ln2")
        _lin(out, f"{dst}/trans/attn/qkv", r, f"{t}.msa.embedding_layer")
        _lin(out, f"{dst}/trans/attn/proj", r, f"{t}.msa.linear")
        _move(out, f"{dst}/trans/attn/rel_pos_bias_table", r,
              f"{t}.msa.relative_position_params", _rel_table, _rel_table_inv)
        _lin(out, f"{dst}/trans/mlp_fc1", r, f"{t}.mlp.0")
        _lin(out, f"{dst}/trans/mlp_fc2", r, f"{t}.mlp.2")
        _conv(out, f"{dst}/conv1_1", r, f"{src}.conv1_1")
        _conv(out, f"{dst}/conv1_2", r, f"{src}.conv1_2")
        _conv(out, f"{dst}/cb1", r, f"{src}.conv_block.0", bias=False)
        _conv(out, f"{dst}/cb2", r, f"{src}.conv_block.2", bias=False)

    # the convolutions without a bias; a transposed convolution's [in, out,
    # kh, kw] becomes [kh, kw, out, in] by the same transpose
    n = cfg.config
    _conv(out, "head", r, "m_head.0", bias=False)
    for stage, blocks in (("down1", n[0]), ("down2", n[1]), ("down3", n[2])):
        for i in range(blocks):
            swin_block(f"{stage}_{i}", f"m_{stage}.{i}")
        _conv(out, f"{stage}_conv", r, f"m_{stage}.{blocks}", bias=False)
    for i in range(n[3]):
        swin_block(f"body_{i}", f"m_body.{i}")
    for stage, blocks in (("up3", n[4]), ("up2", n[5]), ("up1", n[6])):
        _conv(out, f"{stage}_conv", r, f"m_{stage}.0", bias=False)
        for i in range(blocks):
            swin_block(f"{stage}_{i}", f"m_{stage}.{i + 1}")
    _conv(out, "tail", r, "m_tail.0", bias=False)


def convert_scunet(sd: TorchDict, cfg, prefix: str = "") -> Tuple[Params, Reader]:
    """SCUNet denoiser (``m_head.0``, ``m_{down,up}N`` / ``m_body`` blocks of
    ``ConvTransBlock``, ``m_tail.0``) -> its JAX tree. The window attention's
    relative bias is stored [heads, 2w-1, 2w-1] and becomes the [(2w-1)^2,
    heads] table."""
    return _read(_scunet_table, _strip_module(sd), cfg, prefix)


def _msda(out: Params, dst: str, r: Reader, src: str) -> None:
    for n in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _lin(out, f"{dst}/{n}", r, f"{src}.{n}")


# the norms, dense layers and attentions of one TESTR decoder layer
_DEC_NORMS = ("norm_intra", "norm_inter", "norm_cross", "norm3", "norm_intra_text",
              "norm_inter_text", "norm_cross_text", "norm3_text")
_DEC_LINEARS = ("linear1", "linear2", "linear1_text", "linear2_text")
_DEC_MHAS = ("attn_intra", "attn_inter", "attn_intra_text", "attn_inter_text")


def _testr_table(out: Params, r: Reader, cfg) -> None:
    for i in range(len(cfg.in_channels)):
        src, dst = f"diff_feat_proj.{i}", f"diff_feat_proj_{i}"
        _conv(out, f"{dst}/conv1", r, f"{src}.0")
        _norm(out, f"{dst}/gn1", r, f"{src}.1")
        _conv(out, f"{dst}/conv2", r, f"{src}.3")
        _norm(out, f"{dst}/gn2", r, f"{src}.4")

    _move(out, "ctrl_point_embed", r, "ctrl_point_embed.weight")
    _move(out, "text_embed", r, "text_embed.weight")
    # the heads are shared across decoder layers; the file stores one copy at 0
    _lin(out, "ctrl_point_class", r, "ctrl_point_class.0")
    for i in range(3):
        _lin(out, f"ctrl_point_coord/fc{i}", r, f"ctrl_point_coord.0.layers.{i}")
    _lin(out, "text_class", r, "text_class")

    t = "transformer/"
    _move(out, t + "level_embed", r, "transformer.level_embed")
    _lin(out, t + "enc_output", r, "transformer.enc_output")
    _norm(out, t + "enc_output_norm", r, "transformer.enc_output_norm")
    _lin(out, t + "pos_trans", r, "transformer.pos_trans")
    _norm(out, t + "pos_trans_norm", r, "transformer.pos_trans_norm")
    _lin(out, t + "bbox_class_embed", r, "bbox_class")
    for i in range(3):
        _lin(out, t + f"bbox_embed/fc{i}", r, f"bbox_coord.layers.{i}")

    for i in range(cfg.num_encoder_layers):
        src, dst = f"transformer.encoder.layers.{i}", t + f"enc_{i}"
        _msda(out, f"{dst}/self_attn", r, f"{src}.self_attn")
        _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
        _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
        _lin(out, f"{dst}/linear1", r, f"{src}.linear1")
        _lin(out, f"{dst}/linear2", r, f"{src}.linear2")

    for i in range(cfg.num_decoder_layers):
        src, dst = f"transformer.decoder.layers.{i}", t + f"dec_{i}"
        _msda(out, f"{dst}/attn_cross", r, f"{src}.attn_cross")
        _msda(out, f"{dst}/attn_cross_text", r, f"{src}.attn_cross_text")
        for n in _DEC_MHAS:
            _mha(out, f"{dst}/{n}", r, f"{src}.{n}", cfg.n_heads)
        for n in _DEC_NORMS:
            _norm(out, f"{dst}/{n}", r, f"{src}.{n}")
        for n in _DEC_LINEARS:
            _lin(out, f"{dst}/{n}", r, f"{src}.{n}")


def convert_testr(sd: TorchDict, cfg, prefix: str = "testr.") -> Tuple[Params, Reader]:
    """TESTR's detectron2 checkpoint (``model`` of the ``.pkl``, names under
    `prefix`) -> the spotter's JAX tree. A non-strict load: the backbone's
    tensors stay unused and a leaf the file lacks keeps its init."""
    return _read(_testr_table, sd, cfg, prefix)


# --------------------------------------------------------------------------
# The learned IQA metrics' checkpoints
#
# The trees are those of the JAX package's metric modules (utils/{lpips,dists,
# clipiqa,maniqa,musiq}.py); they reach the port's through `convert_tree`. A
# metric's file is read whole: a tensor that no table reads raises, unless the
# published file carries it for a part that the metric never runs (`_UNREAD`).
# --------------------------------------------------------------------------

# what the published files hold beside the metric's tensors: the classifiers of
# torchvision's AlexNet and VGG16; the update counts of torch's batch norms and
# OpenAI CLIP's three integers; the ViT's final norm and head under MANIQA and
# the buffers its Swin stages derive from their shape; RetinaFace's batch norms'
# update counts; the Swin buffers of RAM++'s encoder
_UNREAD = {
    "torchvision": re.compile(r"^classifier\."),
    "clip": re.compile(r"\.num_batches_tracked$|^(input_resolution|context_length|vocab_size)$"),
    "maniqa": re.compile(r"^vit\.(norm|head)\.|\.relative_position_index$|\.attn_mask$"),
    "retinaface": re.compile(r"\.num_batches_tracked$"),
    "ram_plus": re.compile(r"\.relative_position_index$|\.attn_mask$"),
}


def _read_whole(table, sd: TorchDict, cfg, prefix: str = "",
                unread: Optional[str] = None) -> Params:
    """`table` run forwards over `sd`: its tree, after checking that every
    tensor under `prefix` was read or is one that `_UNREAD[unread]` names."""
    out, r = _read(table, sd, cfg, prefix)
    skip = _UNREAD.get(unread)
    left = sorted(k for k in r.unused() if not (skip and skip.search(k[len(prefix):])))
    if left:
        raise ValueError(f"{len(left)} tensors of the checkpoint are read by no table: "
                         f"{left[:20]}{' ...' if len(left) > 20 else ''}")
    return out


# torchvision's ``features`` indices of the convolutions: AlexNet, and VGG16 by stage
ALEXNET_FEATURES = (0, 3, 6, 8, 10)
VGG16_FEATURES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def _alexnet_table(out: Params, r: Reader, cfg=None) -> None:
    for si, idx in enumerate(ALEXNET_FEATURES):
        _conv(out, f"conv{si}_0", r, f"features.{idx}")


def _lpips_lin_table(out: Params, r: Reader, cfg=None) -> None:
    for i in range(len(ALEXNET_FEATURES)):
        _conv(out, f"lin{i}", r, f"lin{i}.model.1", bias=False)


def convert_lpips(alexnet_sd: TorchDict, lin_sd: TorchDict) -> Params:
    """torchvision's AlexNet (``features.*``) and LPIPS's ``lin{i}.model.1``
    heads -> utils/lpips.LPIPS's tree (the JAX package reads them in
    ``LPIPSMetric.from_torch``)."""
    return {"alex": _read_whole(_alexnet_table, alexnet_sd, None, unread="torchvision"),
            **_read_whole(_lpips_lin_table, lin_sd, None)}


def _vgg16_table(out: Params, r: Reader, cfg=None) -> None:
    for si, stage in enumerate(VGG16_FEATURES):
        for ci, idx in enumerate(stage):
            _conv(out, f"conv{si}_{ci}", r, f"features.{idx}")


def _dists_table(out: Params, r: Reader, cfg=None) -> None:
    # stored [1, C, 1, 1]
    for name in ("alpha", "beta"):
        _move(out, name, r, name, lambda w: w.reshape(-1), lambda w: w.reshape(1, -1, 1, 1))


def convert_dists(vgg16_sd: TorchDict, dists_sd: TorchDict) -> Params:
    """torchvision's VGG16 (``features.*``) and DISTS's ``weights.pt``
    (``alpha``, ``beta``) -> utils/dists.DISTS's tree (the JAX package reads
    them in ``DISTSMetric.from_torch``)."""
    return {"vgg": _read_whole(_vgg16_table, vgg16_sd, None, unread="torchvision"),
            **_read_whole(_dists_table, dists_sd, None)}


def _bn(out: Params, dst: str, r: Reader, src: str) -> None:
    """torch's BatchNorm2d at inference -> utils/clipiqa.BNInfer."""
    _norm(out, dst, r, src)
    _move(out, f"{dst}/mean", r, f"{src}.running_mean")
    _move(out, f"{dst}/var", r, f"{src}.running_var")


def _clip_rn50_visual_table(out: Params, r: Reader, cfg) -> None:
    for i in (1, 2, 3):
        _conv(out, f"conv{i}", r, f"conv{i}", bias=False)
        _bn(out, f"bn{i}", r, f"bn{i}")
    for stage, n_blocks in enumerate(cfg.layers):
        for blk in range(n_blocks):
            src, dst = f"layer{stage + 1}.{blk}", f"layer{stage + 1}_{blk}"
            for i in (1, 2, 3):
                _conv(out, f"{dst}/conv{i}", r, f"{src}.conv{i}", bias=False)
                _bn(out, f"{dst}/bn{i}", r, f"{src}.bn{i}")
            # OpenAI's downsample is Sequential("-1": AvgPool2d, "0": conv, "1": bn)
            if _present(out, f"{dst}/down_conv", r, f"{src}.downsample.0.weight"):
                _conv(out, f"{dst}/down_conv", r, f"{src}.downsample.0", bias=False)
                _bn(out, f"{dst}/down_bn", r, f"{src}.downsample.1")
    _move(out, "attnpool/positional_embedding", r, "attnpool.positional_embedding")
    for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _lin(out, f"attnpool/{p}", r, f"attnpool.{p}")


def convert_clip_rn50_visual(sd: TorchDict, cfg) -> Params:
    """OpenAI CLIP's ModifiedResNet image tower (the ``visual.*`` tensors of a
    CLIP RN50 state dict) -> utils/clipiqa.ModifiedResNet's tree."""
    return _read_whole(_clip_rn50_visual_table, sd, cfg, "visual.", unread="clip")


def _clipiqa_table(out: Params, r: Reader, cfg) -> None:
    visual_cfg, text_cfg = cfg
    _clip_rn50_visual_table(out.setdefault("visual", {}), r.sub("visual."), visual_cfg)
    _clip_table(out.setdefault("text", {}), r, text_cfg)
    _move(out, "text_projection", r, "text_projection")
    if _present(out, "logit_scale", r, "logit_scale"):
        _move(out, "logit_scale", r, "logit_scale")


def convert_clipiqa(sd: TorchDict, visual_cfg, text_cfg) -> Params:
    """A whole OpenAI CLIP RN50 state dict -> {visual, text, text_projection,
    logit_scale (where the file has it)}: the image tower's tree, the text
    tower's (models/clip.CLIPTextTower, every block), and the two tensors
    that CLIP-IQA's text embedding and logits take."""
    return _read_whole(_clipiqa_table, sd, (visual_cfg, text_cfg), unread="clip")


def _maniqa_table(out: Params, r: Reader, cfg) -> None:
    _conv(out, "vit/patch_embed", r, "vit.patch_embed.proj")
    _move(out, "vit/cls_token", r, "vit.cls_token", lambda w: w.reshape(1, 1, -1))
    _move(out, "vit/pos_embed", r, "vit.pos_embed")
    for i in range(cfg.vit.depth):
        src, dst = f"vit.blocks.{i}", f"vit/block_{i}"
        _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
        _lin(out, f"{dst}/qkv", r, f"{src}.attn.qkv")
        _lin(out, f"{dst}/proj", r, f"{src}.attn.proj")
        _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
        _lin(out, f"{dst}/fc1", r, f"{src}.mlp.fc1")
        _lin(out, f"{dst}/fc2", r, f"{src}.mlp.fc2")

    for n in (1, 2):
        for i in range(cfg.num_tab):
            for p in ("c_q", "c_k", "c_v"):
                _lin(out, f"tablock{n}_{i}/{p}", r, f"tablock{n}.{i}.{p}")
        _conv(out, f"conv{n}", r, f"conv{n}")
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                src, dst = f"swintransformer{n}.layers.{i}.blocks.{j}", f"swin{n}_{i}/block_{j}"
                _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
                _lin(out, f"{dst}/attn/qkv", r, f"{src}.attn.qkv")
                _lin(out, f"{dst}/attn/proj", r, f"{src}.attn.proj")
                _move(out, f"{dst}/attn/relative_position_bias_table", r,
                      f"{src}.attn.relative_position_bias_table")
                _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
                _lin(out, f"{dst}/fc1", r, f"{src}.mlp.fc1")
                _lin(out, f"{dst}/fc2", r, f"{src}.mlp.fc2")
    for head in ("fc_score", "fc_weight"):
        _lin(out, f"{head}_0", r, f"{head}.0")
        _lin(out, f"{head}_3", r, f"{head}.3")


def convert_maniqa(sd: TorchDict, cfg) -> Params:
    """IIGROUP/MANIQA's checkpoint (``module.`` stripped: timm's ViT-B/8 as
    ``vit.*``, ``tablock{1,2}``, ``conv{1,2}``, ``swintransformer{1,2}``,
    ``fc_score``, ``fc_weight``) -> utils/maniqa.MANIQA's tree."""
    return _read_whole(_maniqa_table, sd, cfg, unread="maniqa")


def _musiq_table(out: Params, r: Reader, cfg) -> None:
    pe = "patch_encoder"
    _conv(out, f"{pe}/root", r, f"{pe}.root", bias=False)
    _norm(out, f"{pe}/root_gn", r, f"{pe}.root_gn")
    for gn in ("gn1", "gn2", "gn3"):
        _norm(out, f"{pe}/block1/{gn}", r, f"{pe}.block1.{gn}")
    for conv in ("conv1", "conv2", "conv3", "proj"):
        if _present(out, f"{pe}/block1/{conv}", r, f"{pe}.block1.{conv}.weight"):
            _conv(out, f"{pe}/block1/{conv}", r, f"{pe}.block1.{conv}", bias=False)
    _norm(out, f"{pe}/out_gn", r, f"{pe}.out_gn")
    _lin(out, f"{pe}/embedding", r, f"{pe}.embedding")

    bb = "backbone"
    _move(out, f"{bb}/spatial_embedding", r, f"{bb}.spatial_embedding")
    _move(out, f"{bb}/scale_embedding", r, f"{bb}.scale_embedding")
    _move(out, f"{bb}/cls_token", r, f"{bb}.cls_token", lambda w: w.reshape(1, 1, -1))
    for i in range(cfg.layers):
        src, dst = f"{bb}.blocks.{i}", f"{bb}/block_{i}"
        _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
        _lin(out, f"{dst}/qkv", r, f"{src}.attn.qkv")
        _lin(out, f"{dst}/proj", r, f"{src}.attn.proj")
        _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
        _lin(out, f"{dst}/fc1", r, f"{src}.mlp.fc1")
        _lin(out, f"{dst}/fc2", r, f"{src}.mlp.fc2")
    _norm(out, f"{bb}/encoder_norm", r, f"{bb}.encoder_norm")
    _lin(out, f"{bb}/head", r, f"{bb}.head")


def convert_musiq(sd: TorchDict, cfg) -> Params:
    """A MUSIQ state dict in utils/musiq's layout (``patch_encoder.*``,
    ``backbone.*``; weights/musiq_shim.py renames a published one into it)
    -> utils/musiq.MUSIQ's tree."""
    return _read_whole(_musiq_table, sd, cfg)


# --------------------------------------------------------------------------
# The face detector and the tagger (utils/retinaface.py, models/ram.py): the
# JAX package's ``convert_retinaface`` and ``convert_ram_plus`` as tables.
# --------------------------------------------------------------------------

# torchvision's ResNet-50 blocks per stage, the RetinaFace body
RESNET50_LAYERS = (3, 4, 6, 3)


def _retinaface_table(out: Params, r: Reader, cfg=None) -> None:
    def conv_bn(dst, src):  # torch Sequential(conv, bn, leaky relu): `.0`, `.1`
        _conv(out, f"{dst}/conv", r, f"{src}.0", bias=False)
        _bn(out, f"{dst}/bn", r, f"{src}.1")

    _conv(out, "body/conv1", r, "body.conv1", bias=False)
    _bn(out, "body/bn1", r, "body.bn1")
    for stage, n_blocks in enumerate(RESNET50_LAYERS):
        for blk in range(n_blocks):
            src, dst = f"body.layer{stage + 1}.{blk}", f"body/layer{stage + 1}_{blk}"
            for i in (1, 2, 3):
                _conv(out, f"{dst}/conv{i}", r, f"{src}.conv{i}", bias=False)
                _bn(out, f"{dst}/bn{i}", r, f"{src}.bn{i}")
            if _present(out, f"{dst}/down_conv", r, f"{src}.downsample.0.weight"):
                _conv(out, f"{dst}/down_conv", r, f"{src}.downsample.0", bias=False)
                _bn(out, f"{dst}/down_bn", r, f"{src}.downsample.1")
    for i in (1, 2, 3):
        conv_bn(f"fpn_output{i}", f"fpn.output{i}")
    for i in (1, 2):
        conv_bn(f"fpn_merge{i}", f"fpn.merge{i}")
    for i in (1, 2, 3):
        conv_bn(f"ssh{i}/conv3x3", f"ssh{i}.conv3X3")
        conv_bn(f"ssh{i}/conv5x5_1", f"ssh{i}.conv5X5_1")
        conv_bn(f"ssh{i}/conv5x5_2", f"ssh{i}.conv5X5_2")
        conv_bn(f"ssh{i}/conv7x7_2", f"ssh{i}.conv7X7_2")
        conv_bn(f"ssh{i}/conv7x7_3", f"ssh{i}.conv7x7_3")  # lower case in the file
    for i in range(3):
        for head, dst in (("ClassHead", "class_head"), ("BboxHead", "bbox_head"),
                          ("LandmarkHead", "ldm_head")):
            _conv(out, f"{dst}{i}", r, f"{head}.{i}.conv1x1")


def convert_retinaface(sd: TorchDict) -> Params:
    """facexlib's / biubug6's RetinaFace-ResNet50 (``detection_Resnet50_Final.pth``,
    ``module.`` stripped: ``body.*``, ``fpn.output{1,2,3}``, ``fpn.merge{1,2}``,
    ``ssh{1,2,3}.*``, ``{Class,Bbox,Landmark}Head.{0,1,2}.conv1x1``) ->
    utils/retinaface.RetinaFace's tree."""
    return _read_whole(_retinaface_table, sd, None, unread="retinaface")


def _ram_plus_table(out: Params, r: Reader, cfg) -> None:
    ve = "visual_encoder"
    _conv(out, f"{ve}/patch_embed", r, f"{ve}.patch_embed.proj")
    _norm(out, f"{ve}/patch_norm", r, f"{ve}.patch_embed.norm")
    for i, depth in enumerate(cfg.swin.depths):
        for j in range(depth):
            src, dst = f"{ve}.layers.{i}.blocks.{j}", f"{ve}/stage_{i}/block_{j}"
            _norm(out, f"{dst}/norm1", r, f"{src}.norm1")
            _lin(out, f"{dst}/attn/qkv", r, f"{src}.attn.qkv")
            _lin(out, f"{dst}/attn/proj", r, f"{src}.attn.proj")
            _move(out, f"{dst}/attn/relative_position_bias_table", r,
                  f"{src}.attn.relative_position_bias_table")
            _norm(out, f"{dst}/norm2", r, f"{src}.norm2")
            _lin(out, f"{dst}/fc1", r, f"{src}.mlp.fc1")
            _lin(out, f"{dst}/fc2", r, f"{src}.mlp.fc2")
        if i < len(cfg.swin.depths) - 1:
            ds = f"{ve}.layers.{i}.downsample"
            _norm(out, f"{ve}/stage_{i}/downsample/norm", r, f"{ds}.norm")
            _lin(out, f"{ve}/stage_{i}/downsample/reduction", r, f"{ds}.reduction", bias=False)
    _norm(out, f"{ve}/norm", r, f"{ve}.norm")

    _move(out, "label_embed", r, "label_embed")
    # stored as torch.ones(1) * log(1 / 0.07)
    _move(out, "reweight_scale", r, "reweight_scale", lambda w: w.reshape(()),
          lambda w: w.reshape(1))
    _lin(out, "image_proj", r, "image_proj")
    _lin(out, "wordvec_proj", r, "wordvec_proj")
    for i in range(cfg.layers):
        src, dst = f"tagging_head.encoder.layer.{i}", f"tag_layer_{i}"
        for tsrc, tdst in (("attention", "self"), ("crossattention", "cross")):
            for p in ("query", "key", "value"):
                _lin(out, f"{dst}/{tdst}_{p}", r, f"{src}.{tsrc}.self.{p}")
            _lin(out, f"{dst}/{tdst}_out", r, f"{src}.{tsrc}.output.dense")
            _norm(out, f"{dst}/{tdst}_ln", r, f"{src}.{tsrc}.output.LayerNorm")
        _lin(out, f"{dst}/ffn_in", r, f"{src}.intermediate.dense")
        _lin(out, f"{dst}/ffn_out", r, f"{src}.output.dense")
        _norm(out, f"{dst}/ffn_ln", r, f"{src}.output.LayerNorm")
    # GroupWiseLinear's W [1, C, hidden] and b [1, C]
    n, hidden = cfg.num_class, cfg.hidden
    _move(out, "fc_w", r, "fc.W", lambda w: w.reshape(n, hidden), lambda w: w.reshape(1, n, hidden))
    _move(out, "fc_b", r, "fc.b", lambda w: w.reshape(n), lambda w: w.reshape(1, n))


def convert_ram_plus(sd: TorchDict, cfg) -> Params:
    """RAM++'s checkpoint (``ram_plus_swin_large_14m.pth``, ``module.`` or not:
    the Swin ``visual_encoder``, ``label_embed``, ``reweight_scale``,
    ``image_proj``, ``wordvec_proj``, the ``tagging_head``'s BERT layers and
    ``fc.W`` / ``fc.b``) -> models/ram.RAMPlus's tree, in the layout that the
    JAX package reconstructs (its ``models/ram.py`` says how far that goes)."""
    return _read_whole(_ram_plus_table, _strip_module(sd), cfg, unread="ram_plus")


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        # numpy has no bfloat16: widen it (exactly); `_cast_like` then casts to
        # the dtype of the tree the values go into
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def load_torch_file(path: str) -> TorchDict:
    """A checkpoint as {name: numpy array}: a PyTorch ``.pt`` / ``.pth`` /
    ``.ckpt`` file, or a detectron2 ``.pkl`` (a pickled dict of numpy arrays,
    read with ``encoding="latin1"``). A dict under ``state_dict`` (Lightning)
    is taken first, then one under ``params``, then one under ``model`` when
    no other key starts with ``model.`` (detectron2, ``torch.save({"model":
    ...})``).

    PyTorch files are read with ``torch.load(weights_only=False)``: Lightning
    checkpoints pickle objects besides tensors (hyper-parameters, callback
    state), which the safe loader refuses. Unpickling runs code the file
    names, so read only checkpoints from a source you trust. bfloat16 tensors
    are read as float32."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            sd = pickle.load(f, encoding="latin1")
    else:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("params"), dict):
        sd = sd["params"]
    if isinstance(sd, dict) and "model" in sd and all(
        not k.startswith("model.") for k in sd if k != "model"
    ):
        sd = sd["model"]
    return {k: _to_numpy(v) for k, v in sd.items()}


# where each part of the SD-2.1 bundle lives in its checkpoint
SD_BUNDLE_PREFIX = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    "clip": "cond_stage_model.model.",
}


def load_pretrained_sd_bundle(params: Params, sd: TorchDict, model) -> Params:
    """The SD-2.1 checkpoint's UNet, autoencoder and CLIP text tower cast
    into the JAX-layout tree `params` of the port's `model` (a ``TeReDiff``);
    the other parts of `params` are kept."""
    cldm = model.cldm
    unet, _ = convert_unet(sd, cldm.unet.cfg, SD_BUNDLE_PREFIX["unet"])
    vae, _ = convert_vae(sd, cldm.vae.cfg, SD_BUNDLE_PREFIX["vae"])
    clip, _ = convert_clip(sd, cldm.clip.cfg, SD_BUNDLE_PREFIX["clip"])
    return {**params, "unet": _cast_like(unet, params["unet"]),
            "vae": _cast_like(vae, params["vae"]),
            "clip": _cast_like(clip, params["clip"])}


def _cast_like(src: Mapping[str, Any], like: Mapping[str, Any],
               path: Tuple[str, ...] = ()) -> Params:
    """`like`'s tree with each leaf that `src` has at the same path taken
    from `src`, cast to the dtype of `like`'s leaf; a leaf `src` lacks keeps
    its value in `like`, and a leaf of another shape raises, naming its path."""
    out: Params = {}
    for key, node in like.items():
        here = path + (key,)
        got = src.get(key) if isinstance(src, Mapping) else None
        if isinstance(node, Mapping):
            out[key] = _cast_like(got if isinstance(got, Mapping) else {}, node, here)
        elif got is None or isinstance(got, Mapping):
            out[key] = node
        else:
            value, init = np.asarray(got), np.asarray(node)
            if value.shape != init.shape:
                raise ValueError(f"{'/'.join(here)}: {value.shape} != {init.shape}")
            out[key] = value.astype(init.dtype)
    return out
