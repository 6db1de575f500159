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
from .mesh import DATA_AXIS

# Leaves smaller than this stay replicated: sharding a bias or a norm vector
# saves nothing and costs a gather per use.
_MIN_ELEMS = 8192
# `all_reduce_mean` flattens at most about this many bytes into one all-reduce
_BUCKET_BYTES = 256 << 20

Spec = Tuple[Optional[str], ...]  # a JAX PartitionSpec's entries; () = replicated


def _leaf_spec(shape, n_data: int) -> Spec:
    """The JAX package's rule for one leaf of the JAX layout's `shape` (its
    data-axis placement: tensor parallelism is not ported)."""
    if shape is None or len(shape) == 0:
        return ()
    base: List[Optional[str]] = [None] * len(shape)
    size = 1
    for d in shape:
        size *= d
    if n_data > 1 and size >= _MIN_ELEMS:
        for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if shape[ax] % n_data == 0 and shape[ax] >= n_data:
                base[ax] = DATA_AXIS
                break
    if all(ax is None for ax in base):
        return ()
    return tuple(base)


def fsdp_specs(shapes: Mapping[str, Sequence[int]], n_data: int) -> Dict[str, Spec]:
    """{``/``-joined JAX path: spec} for leaves given by their JAX shapes."""
    return {path: _leaf_spec(tuple(shape), n_data) for path, shape in shapes.items()}


def fraction_for(leaves: Mapping[str, Tuple[Sequence[int], int]],
                 n_data: int) -> Tuple[int, int, int]:
    """(sharded bytes, total bytes, bytes per device) of leaves given as
    {path: (JAX shape, bytes per element)} under the rule."""
    specs = fsdp_specs({p: s for p, (s, _) in leaves.items()}, n_data)
    sharded = total = per_dev = 0
    for path, (shape, itemsize) in leaves.items():
        size = 1
        for d in shape:
            size *= d
        b = size * itemsize
        total += b
        denom = n_data if DATA_AXIS in specs[path] else 1
        if denom > 1:
            sharded += b
        per_dev += b // denom
    return sharded, total, per_dev


def jax_leaf_shapes(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{parameter name: (``/``-joined JAX path, JAX shape)} of the port's bundle."""
    return {name: ("/".join(path), shape) for name, path, shape in jax_leaves(model)}


def shard_dims(model: nn.Module, n_data: int) -> Dict[str, Optional[int]]:
    """{parameter name: the torch axis the rule shards, or None (replicated)}."""
    out = {}
    for name, path, shape in jax_leaves(model):
        spec = _leaf_spec(shape, n_data)
        out[name] = torch_axes(path, len(shape))[spec.index(DATA_AXIS)] if spec else None
    return out


def sharded_fraction(model: nn.Module, n_data: int,
                     moments: Iterable[nn.Parameter] = ()) -> Tuple[int, int, int]:
    """`fraction_for` of the model's parameters, plus two AdamW moments (of
    the parameter's shape) for each of `moments`: the memory story to print
    at start-up."""
    paths = jax_leaf_shapes(model)
    leaves = {path: (shape, model.get_parameter(name).element_size())
              for name, (path, shape) in paths.items()}
    names = {id(p): name for name, p in model.named_parameters()}
    for p in moments:
        path, shape = paths[names[id(p)]]
        for k in ("exp_avg", "exp_avg_sq"):
            leaves[f"opt/{k}/{path}"] = (shape, p.element_size())
    return fraction_for(leaves, n_data)


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


def apply_fsdp(model: nn.Module, mesh) -> List[nn.Parameter]:
    """Shard `model` (a ``TeReDiff``, its trainable mask already set) in place
    over `mesh`'s data axis by the rule; returns the parameters that stay
    replicated, whose gradients `GradientSync` averages."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    dims = shard_dims(model, data_mesh.size())
    names = {id(p): name for name, p in model.named_parameters()}
    replicated = [p for name, p in model.named_parameters() if dims[name] is None]

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


def full_state(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(model state dict, optimizer state dict) with every sharded tensor
    gathered: the layout of a single-process run. A collective."""
    model_sd = {k: full_tensor(v) for k, v in model.state_dict().items()}
    opt_sd = optimizer.state_dict()
    opt_sd["state"] = {
        i: {k: full_tensor(v) for k, v in s.items()} for i, s in opt_sd["state"].items()
    }
    return model_sd, opt_sd


def load_full_state(model: nn.Module, optimizer: torch.optim.Optimizer, model_sd, opt_sd) -> None:
    """Load a gathered state (`full_state`'s layout) into a sharded model and
    its optimizer: each process keeps its shard of each tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def like(value, ref):
        if isinstance(ref, DTensor) and not isinstance(value, DTensor):
            return distribute_tensor(
                value.to(ref.device, ref.dtype), ref.device_mesh, ref.placements
            )
        return value

    current = model.state_dict()
    model.load_state_dict({k: like(v, current[k]) for k, v in model_sd.items()}, strict=True)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for i, s in opt_sd["state"].items():
        p = params[int(i)]
        state[i] = {k: (v if k == "step" else like(v, p)) for k, v in s.items()}
    optimizer.load_state_dict({**opt_sd, "state": state})


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average `tensors` in place over the processes of `group`: flattened
    into buckets of one dtype, one all-reduce per bucket."""
    n = dist.get_world_size(group)
    if n == 1:
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
            flat.div_(n)
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


class GradientSync:
    """The gradient reduction of a data-parallel train step, done where the
    step knows what it is (the step's ``forward`` is not one module's, so no
    forward hook of a wrapper could): under FSDP the units reduce-scatter
    their own gradients, and only on an update step (``before_backward``);
    the replicated parameters' gradients (all of them without FSDP) are
    averaged after the update step's backward (``after_backward``). Also
    averages a step's loss scalars over the processes (`mean`)."""

    def __init__(self, replicated: Sequence[nn.Parameter], units: Sequence[nn.Module] = (),
                 group=None):
        self.replicated = [p for p in replicated if p.requires_grad]
        self.units = list(units)
        self.group = group

    def before_backward(self, update: bool) -> None:
        for unit in self.units:
            unit.set_requires_gradient_sync(update, recurse=False)

    def after_backward(self, update: bool) -> None:
        if not update:
            return
        for p in self.replicated:
            if p.grad is None:  # none of this process's rows reached it; every
                p.grad = torch.zeros_like(p)  # process must reduce the same buckets
        all_reduce_mean([p.grad for p in self.replicated], self.group)

    def mean(self, scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = sorted(scalars)
        flat = torch.stack([scalars[k].detach().float() for k in keys])
        all_reduce_mean([flat], self.group)
        return dict(zip(keys, flat.unbind()))
