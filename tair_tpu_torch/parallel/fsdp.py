"""Fully-sharded data parallelism of the port's training over the "data" axis.

Counterpart of ``tair_tpu/parallel/fsdp.py``. The placement rule is the JAX
package's, leaf for leaf: it reads the JAX layout's shape of each parameter,
keeps leaves under `_MIN_ELEMS` elements replicated, and otherwise shards the
largest axis that the data axis divides. A parameter and its AdamW moments
have one shape, so they land alike. The port holds torch layouts (OIHW
against HWIO, ``[out, in]`` against ``[in, out]``), so the chosen JAX axis is
mapped to the torch axis that holds it through ``weights.convert``'s layout
rules (`shard_dims`).

`apply_fsdp` applies the rule with FSDP2's ``fully_shard``: one unit per block
that ``use_checkpoint`` recomputes (the UNet's and the ControlNet's encoder,
middle and decoder blocks, the spotter's encoder and decoder layers), then one
per sub-model for the rest of its parameters. FSDP2 gathers a unit's
parameters in its ``forward`` and reduce-scatters (averages) their gradients
in the backward; the train step never calls the bundle's own ``forward``, but
each unit's ``forward`` (and the autoencoder's ``encode_moments`` / ``decode``,
registered) does run. The replicated leaves stay out of FSDP
(``ignored_params``) and `GradientSync` averages their gradients with one
bucketed all-reduce after the backward of an update step.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..weights.convert import jax_leaves, torch_axes
from .mesh import DATA_AXIS, MODEL_AXIS
from .tp import _spec_for, slice_weight, tp_weights

# Leaves smaller than this stay replicated: sharding a bias or a norm vector
# saves nothing and costs a gather per use.
_MIN_ELEMS = 8192
# the all-reduces flatten at most about this many bytes into one
_BUCKET_BYTES = 256 << 20

Spec = Tuple[Optional[str], ...]  # a JAX PartitionSpec's entries; () = replicated


def _leaf_spec(path: str, shape, n_data: int, n_model: int = 1) -> Spec:
    """The JAX package's rule for one leaf at ``/``-joined `path` of the JAX
    layout's `shape`: the model axis claims its axis first (``parallel.tp``'s
    rules), then the data axis takes the largest other axis it divides.
    Sizes are read on the global shape."""
    if shape is None or len(shape) == 0:
        return ()
    base: List[Optional[str]] = list(_spec_for(path, shape, n_model)) if n_model > 1 else []
    base += [None] * (len(shape) - len(base))
    size = 1
    for d in shape:
        size *= d
    if n_data > 1 and size >= _MIN_ELEMS:
        for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if base[ax] is None and shape[ax] % n_data == 0 and shape[ax] >= n_data:
                base[ax] = DATA_AXIS
                break
    if all(ax is None for ax in base):
        return ()
    return tuple(base)


def fsdp_specs(shapes: Mapping[str, Sequence[int]], n_data: int,
               n_model: int = 1) -> Dict[str, Spec]:
    """{``/``-joined JAX path: spec} for leaves given by their JAX shapes."""
    return {path: _leaf_spec(path, tuple(shape), n_data, n_model)
            for path, shape in shapes.items()}


def fraction_for(leaves: Mapping[str, Tuple[Sequence[int], int]],
                 n_data: int, n_model: int = 1) -> Tuple[int, int, int]:
    """(sharded bytes, total bytes, bytes per device) of leaves given as
    {path: (JAX shape, bytes per element)} under the rule."""
    specs = fsdp_specs({p: s for p, (s, _) in leaves.items()}, n_data, n_model)
    sharded = total = per_dev = 0
    for path, (shape, itemsize) in leaves.items():
        size = 1
        for d in shape:
            size *= d
        b = size * itemsize
        total += b
        denom = 1
        for name in specs[path]:
            denom *= {DATA_AXIS: n_data, MODEL_AXIS: n_model}.get(name, 1)
        if denom > 1:
            sharded += b
        per_dev += b // denom
    return sharded, total, per_dev


def jax_leaf_shapes(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{parameter name: (``/``-joined JAX path, JAX shape)} of the port's bundle."""
    return {name: ("/".join(path), shape) for name, path, shape in jax_leaves(model)}


def shard_dims(model: nn.Module, n_data: int, n_model: int = 1) -> Dict[str, Optional[int]]:
    """{parameter name: the torch axis the rule gives the data axis, or None
    (not sharded over the data axis)}. Read on the unsharded model (the JAX
    layout's global shapes): under tensor parallelism, before
    ``parallel.tp.shard_params_tp``, whose local slices keep the names and
    the axes."""
    out = {}
    for name, path, shape in jax_leaves(model):
        spec = _leaf_spec("/".join(path), shape, n_data, n_model)
        out[name] = (torch_axes(path, len(shape))[spec.index(DATA_AXIS)]
                     if DATA_AXIS in spec else None)
    return out


def sharded_fraction(model: nn.Module, n_data: int,
                     moments: Iterable[nn.Parameter] = (),
                     n_model: int = 1) -> Tuple[int, int, int]:
    """`fraction_for` of the model's parameters, plus two AdamW moments (of
    the parameter's shape) for each of `moments`: the memory story to print
    at start-up. Read on the unsharded model, as `shard_dims`."""
    paths = jax_leaf_shapes(model)
    leaves = {path: (shape, model.get_parameter(name).element_size())
              for name, (path, shape) in paths.items()}
    names = {id(p): name for name, p in model.named_parameters()}
    for p in moments:
        path, shape = paths[names[id(p)]]
        for k in ("exp_avg", "exp_avg_sq"):
            leaves[f"opt/{k}/{path}"] = (shape, p.element_size())
    return fraction_for(leaves, n_data, n_model)


def checkpointed_blocks(model: nn.Module) -> List[nn.Module]:
    """The bundle's units that ``use_checkpoint`` recomputes (``nn.remat``'s):
    the UNet's and the ControlNet's encoder, middle and decoder blocks, the
    spotter's encoder and decoder layers."""
    from ..models.unet import DecoderBlock, EncoderBlock, MiddleBlock
    from ..spotter.transformer import CompositeDecoderLayer, EncoderLayer

    blocks = (EncoderBlock, MiddleBlock, DecoderBlock, EncoderLayer, CompositeDecoderLayer)
    return [m for m in model.modules() if isinstance(m, blocks)]


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The bundle's FSDP units, innermost first: `checkpointed_blocks`, then
    the sub-models."""
    cldm = model.cldm
    return checkpointed_blocks(model) + [
        cldm.unet, cldm.controlnet, model.testr, cldm.vae, cldm.clip, model.swinir,
    ]


def apply_fsdp(model: nn.Module, mesh,
               dims: Optional[Mapping[str, Optional[int]]] = None) -> List[nn.Parameter]:
    """Shard `model` (a ``TeReDiff``, its trainable mask already set) in place
    over `mesh`'s data axis by the rule; returns the parameters that stay
    replicated, whose gradients `GradientSync` averages. `dims`: `shard_dims`
    read before tensor parallelism cut the model (by default, read on
    `model`, which must then be whole); FSDP then shards each local slice on
    the torch axis that holds the JAX axis the rule gave the data axis."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    if dims is None:
        dims = shard_dims(model, data_mesh.size())
    names = {id(p): name for name, p in model.named_parameters()}
    replicated = [p for name, p in model.named_parameters() if dims[name] is None]
    with torch.no_grad():
        for name, p in model.named_parameters():
            # FSDP2 shards only contiguous tensors (a channels-last convolution
            # weight is not); its all-gathered parameter is contiguous anyway
            if dims[name] is not None and not p.is_contiguous():
                p.data = p.data.contiguous()

    def placement(p: nn.Parameter):
        return Shard(dims[names[id(p)]])

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement,
                    ignored_params=set(replicated))
    for method in ("encode_moments", "decode"):
        register_fsdp_forward_method(model.cldm.vae, method)
    return replicated


def local_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes that this process holds of `tensors` (a DTensor's local shard)."""
    return sum(_local(t).numel() * t.element_size() for t in tensors)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of `t`: gathered where it is a DTensor (every process of its
    mesh must call)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _optimizer_names(model: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The parameter names in the optimizer's state-dict order."""
    names = {id(p): name for name, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def full_state(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(model state dict, optimizer state dict) with every sharded tensor
    gathered (`whole_tensors`): the layout of a single-process run. A
    collective."""
    layers = tp_weights(model)
    model_sd = model.state_dict()
    names = _optimizer_names(model, optimizer)
    opt_sd = optimizer.state_dict()
    # new dicts: the optimizer's state dict holds its live per-parameter dicts
    opt_sd["state"] = {i: dict(s) for i, s in opt_sd["state"].items()}
    keys = [("model", k) for k in model_sd] + [
        ("opt", i, k) for i, s in opt_sd["state"].items() for k in s if k != "step"]
    tensors = [model_sd[k[1]] if k[0] == "model" else opt_sd["state"][k[1]][k[2]] for k in keys]
    owners = [layers.get(k[1] if k[0] == "model" else names[int(k[1])]) for k in keys]
    for key, t in zip(keys, whole_tensors(tensors, owners)):
        if key[0] == "model":
            model_sd[key[1]] = t
        else:
            opt_sd["state"][key[1]][key[2]] = t
    return model_sd, opt_sd


def whole_tensors(tensors: Sequence[torch.Tensor], layers: Sequence) -> List[torch.Tensor]:
    """The whole of each of `tensors`: FSDP's shards gathered over the data
    axis, then, where `layers` names the tensor's ``ParallelLinear`` (a
    weight, or an AdamW moment of one), the tensor-parallel slices gathered
    over the model axis and put back at their global features (GEGLU's are
    not one chunk). The pieces of many tensors travel in one all-gather a
    bucket (`_all_gather_many`): a collective per tensor would cost each
    process thousands of round trips a checkpoint. A collective."""
    from torch.distributed.tensor import DTensor, Shard

    out = list(tensors)
    # FSDP: every sharded tensor is a DTensor on the one data mesh, cut in
    # even chunks on one axis (the rule shards only an axis the mesh divides)
    sharded = [i for i, t in enumerate(out) if isinstance(t, DTensor)]
    if sharded:
        group = out[sharded[0]].device_mesh.get_group()
        for i in sharded:
            (place,) = out[i].placements
            if not isinstance(place, Shard) or out[i].device_mesh.get_group() != group:
                raise ValueError("a sharded tensor that is not FSDP's over the data mesh")
        pieces = _all_gather_many([out[i].to_local() for i in sharded], group)
        for i, parts in zip(sharded, pieces):
            out[i] = torch.cat(parts, dim=out[i].placements[0].dim)
    cut = [i for i, layer in enumerate(layers) if layer is not None and layer.n > 1]
    for group in {id(layers[i].group): layers[i].group for i in cut}.values():
        mine = [i for i in cut if layers[i].group is group]
        pieces = _all_gather_many([out[i] for i in mine], group)
        for i, parts in zip(mine, pieces):
            layer = layers[i]
            whole = parts[0].new_empty(
                [d * layer.n if a == layer.axis else d for a, d in enumerate(parts[0].shape)])
            whole.index_copy_(layer.axis, layer.all_index.reshape(-1).to(whole.device),
                              torch.cat(parts, layer.axis))
            out[i] = whole
    return out


def _all_gather_many(tensors: Sequence[torch.Tensor], group) -> List[List[torch.Tensor]]:
    """For each of `tensors` (the same shape on every process of `group`),
    every process's, in rank order: flattened into buckets of one dtype of
    at most about `_BUCKET_BYTES`, one all-gather a bucket."""
    n = dist.get_world_size(group)
    out: List[List[torch.Tensor]] = [[] for _ in tensors]
    order: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        order.setdefault(t.dtype, []).append(i)
    for idx in order.values():
        start = 0
        while start < len(idx):
            end, size = start, 0
            while end < len(idx) and (end == start or size < _BUCKET_BYTES):
                t = tensors[idx[end]]
                size += t.numel() * t.element_size()
                end += 1
            bucket = idx[start:end]
            flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
            gathered = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(gathered, flat, group=group)
            offset = 0
            for i in bucket:
                t = tensors[i]
                out[i] = [g[offset:offset + t.numel()].view(t.shape) for g in gathered]
                offset += t.numel()
            start = end
    return out


def load_full_state(model: nn.Module, optimizer: torch.optim.Optimizer, model_sd, opt_sd) -> None:
    """Load a gathered state (`full_state`'s layout) into a sharded model and
    its optimizer: each process keeps its tensor-parallel slice and its
    FSDP shard of each tensor, cut from the whole state that every process
    holds (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    layers = tp_weights(model)

    def like(value, ref, name):
        if name in layers:
            value = slice_weight(layers[name], value)
        if isinstance(ref, DTensor) and not isinstance(value, DTensor):
            return distribute_tensor(value.to(ref.device, ref.dtype), ref.device_mesh,
                                     ref.placements, src_data_rank=None)
        return value

    current = model.state_dict()
    model.load_state_dict({k: like(v, current[k], k) for k, v in model_sd.items()},
                          strict=True)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    names = _optimizer_names(model, optimizer)
    state = {}
    for i, s in opt_sd["state"].items():
        p, name = params[int(i)], names[int(i)]
        state[i] = {k: (v if k == "step" else like(v, p, name)) for k, v in s.items()}
    optimizer.load_state_dict({**opt_sd, "state": state})


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum `tensors` in place over the processes of `group`: flattened into
    buckets of one dtype, one all-reduce per bucket."""
    _all_reduce_buckets(tensors, group, 1)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average `tensors` in place over the processes of `group`, as
    `all_reduce_sum`."""
    _all_reduce_buckets(tensors, group, dist.get_world_size(group))


def _all_reduce_buckets(tensors: Sequence[torch.Tensor], group, divisor: int) -> None:
    if dist.get_world_size(group) == 1:
        return
    buckets: Dict[torch.dtype, List[List[torch.Tensor]]] = {}
    filled: Dict[torch.dtype, int] = {}
    for t in tensors:
        lists = buckets.setdefault(t.dtype, [[]])
        if filled.get(t.dtype, 0) >= _BUCKET_BYTES:
            lists.append([])
            filled[t.dtype] = 0
        lists[-1].append(t)
        filled[t.dtype] = filled.get(t.dtype, 0) + t.numel() * t.element_size()
    for lists in buckets.values():
        for bucket in lists:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            if divisor > 1:
                flat.div_(divisor)
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


class GradientSync:
    """The gradient reduction of a parallel train step, done where the step
    knows what it is (the step's ``forward`` is not one module's, so no
    forward hook of a wrapper could): under FSDP the units reduce-scatter
    their own gradients over the data axis, and only on an update step
    (``before_backward``); after the update step's backward
    (``after_backward``) the gradients that tensor parallelism leaves partial
    (`partial`, ``parallel.tp.partial_grad_params``) are summed over the
    model axis (`model_group`; on FSDP's local shard where FSDP holds them),
    then the replicated parameters' gradients (all of them without FSDP) are
    averaged over the data axis (`group`). Also averages a step's loss
    scalars over the data axis (`mean`): a model axis' processes hold the
    same ones. `partial` is read after `apply_fsdp`, whose parameters
    replace those it shards."""

    def __init__(self, replicated: Sequence[nn.Parameter], units: Sequence[nn.Module] = (),
                 group=None, partial: Sequence[nn.Parameter] = (), model_group=None):
        self.replicated = [p for p in replicated if p.requires_grad]
        self.units = list(units)
        self.group = group
        self.partial = [p for p in partial if p.requires_grad]
        if self.partial and model_group is None:
            raise ValueError("partial gradients need the model axis' group")
        self.model_group = model_group

    def before_backward(self, update: bool) -> None:
        for unit in self.units:
            unit.set_requires_gradient_sync(update, recurse=False)

    def after_backward(self, update: bool) -> None:
        if not update:
            return
        for p in self.partial + self.replicated:
            if p.grad is None:  # none of this process's rows or features reached it;
                p.grad = torch.zeros_like(p)  # every process must reduce the same buckets
        if self.partial:
            all_reduce_sum([_local(p.grad) for p in self.partial], self.model_group)
        all_reduce_mean([p.grad for p in self.replicated], self.group)

    def mean(self, scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = sorted(scalars)
        flat = torch.stack([scalars[k].detach().float() for k in keys])
        all_reduce_mean([flat], self.group)
        return dict(zip(keys, flat.unbind()))
