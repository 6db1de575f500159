"""Tensor-parallel serving: Megatron's column/row pairing over the "model" axis.

Counterpart of ``tair_tpu/parallel/tp.py``. The rule tables are the JAX
package's, leaf for leaf (`tensor_parallel_specs`): on the JAX layout of each
parameter (``weights.convert``'s paths and shapes, as ``parallel.fsdp`` reads
them), the qkv projections, the first product of each FFN (GEGLU's fused
projection included), ``proj_in`` and msda's ``value_proj`` shard their output
features (column-parallel; the MHA kernels ``[emb, heads, head_dim]`` their
heads), the attention outputs, the second FFN product, ``proj_out`` and msda's
``output_proj`` their input features (row-parallel); a leaf whose axis the
model axis does not divide (or that is shorter than two shards) stays
replicated, and so does everything else (convolutions, norms, embeddings,
biases).

JAX lets GSPMD insert the collectives; here `shard_params_tp` writes them. It
replaces each sharded ``nn.Linear`` by a `ParallelLinear` holding this
process's slice of the weight (the torch axis that holds the JAX axis, by
``weights.convert.torch_axes``) and the replicated bias. On its own a
column-parallel layer gathers its output features and a row-parallel one
slices its input features and all-reduces its output, so any module that
holds one keeps its full-width semantics (``SpatialTransformer``'s
``proj_in`` is followed by a LayerNorm over all channels: it gathers). Where
a column-parallel layer feeds a row-parallel one through elementwise work or
through attention over whole heads, the pair keeps its features local: the
FFNs (GEGLU's projection sharded half by half, so that each process holds the
value and gate columns that match), the UNet's attention when the shard
boundary is a head boundary (else q, k and v are gathered), the MHA of CLIP
and of the spotter's decoder, and msda, where each process runs the kernel
on the heads of its value table, with the lanes of those heads taken from the
replicated offsets and weights. The row-parallel output adds the bias once,
on the first process of the axis; with one process every layer computes what
the unsharded one does, bit for bit.

The collectives are autograd functions in Megatron's pairs, so the same
layers train: a column layer's input is the identity forward and all-reduced
backward (`copy_to_model`), its gather keeps this process's slice of the
gradient; a row layer's slice of a replicated input all-reduces its gradient,
and its output all-reduce passes the gradient through. Every replicated
activation then holds its whole gradient on every process, and so does every
parameter that each process computes whole (the convolutions, the norms
outside a sequence-parallel layer). The parameters that a process uses only
in part hold a partial sum over the axis, which `partial_grad_params` lists
and ``parallel.fsdp.GradientSync`` sums: a column layer's bias (sliced), a
row layer's (added on the first process only), msda's offsets and weights
(their lanes cut to the local heads) and every parameter of a
sequence-parallel encoder layer (which sees this process's tokens only).

In a quantized scope (``ops/quant.py``) a UNet or ControlNet layer runs
w8a8 as the JAX package's global program does on whole tensors: a
column-parallel site sees the whole activation and whole weight rows, so its
scales are the global ones as they are; a row-parallel site takes the
axis' maximum of the activation's abs-max and of each output channel's
weight abs-max, and sums the int32 products over the axis before the
rescale (`quant.w8a8_linear_row`), which makes it bit-equal to one process's
site.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import QuantLinear
from ..ops import quant
from ..weights.convert import jax_leaves, torch_axes
from .collectives import copy_to_model, gather_features, reduce_sum, slice_features
from .mesh import MODEL_AXIS

Spec = Tuple[Optional[str], ...]  # a JAX PartitionSpec's entries; () = replicated

# path suffixes -> which JAX kernel axis carries the sharded features. Dense
# kernels are [in, out]; MHA packs [emb, heads, head_dim] (q, k, v) and
# [heads, head_dim, emb] (out)
_COLUMN = (  # shard the last axis (output features)
    "to_q/kernel", "to_k/kernel", "to_v/kernel",
    "ff/geglu/proj/kernel", "mlp_fc/kernel", "linear1/kernel",
    "linear1_text/kernel", "value_proj/kernel", "proj_in/kernel",
)
_COLUMN_HEADS = (  # MHA q, k, v: shard the heads axis (axis 1 of 3)
    "attn/query/kernel", "attn/key/kernel", "attn/value/kernel",
    "attn_intra/query/kernel", "attn_intra/key/kernel", "attn_intra/value/kernel",
    "attn_inter/query/kernel", "attn_inter/key/kernel", "attn_inter/value/kernel",
    "attn_intra_text/query/kernel", "attn_inter_text/query/kernel",
    "attn_intra_text/key/kernel", "attn_inter_text/key/kernel",
    "attn_intra_text/value/kernel", "attn_inter_text/value/kernel",
)
_ROW = (  # shard the first axis (input features)
    "to_out/kernel", "ff/out/kernel", "mlp_proj/kernel", "linear2/kernel",
    "linear2_text/kernel", "output_proj/kernel", "proj_out/kernel",
)
_ROW_HEADS = (  # MHA out: [heads, head_dim, emb] -> shard the heads (axis 0)
    "attn/out/kernel", "attn_intra/out/kernel", "attn_inter/out/kernel",
    "attn_intra_text/out/kernel", "attn_inter_text/out/kernel",
)


def _spec_for(path: str, shape: Sequence[int], n_model: int) -> Spec:
    """The JAX package's rule for the leaf at ``/``-joined `path` of JAX
    `shape`."""
    def fits(axis):
        return shape[axis] % n_model == 0 and shape[axis] >= 2 * n_model

    nd = len(shape)
    if any(path.endswith(s) for s in _COLUMN) and nd >= 2 and fits(-1):
        return (None,) * (nd - 1) + (MODEL_AXIS,)
    if any(path.endswith(s) for s in _COLUMN_HEADS) and nd == 3 and fits(1):
        return (None, MODEL_AXIS, None)
    if any(path.endswith(s) for s in _ROW) and nd >= 2 and fits(0):
        return (MODEL_AXIS,) + (None,) * (nd - 1)
    if any(path.endswith(s) for s in _ROW_HEADS) and nd == 3 and fits(0):
        return (MODEL_AXIS, None, None)
    return ()


def tensor_parallel_specs(shapes: Mapping[str, Sequence[int]], n_model: int) -> Dict[str, Spec]:
    """{``/``-joined JAX path: spec} for leaves given by their JAX shapes."""
    return {path: _spec_for(path, tuple(shape), n_model) for path, shape in shapes.items()}


def count_sharded(leaves: Mapping[str, Tuple[Sequence[int], int]],
                  n_model: int) -> Tuple[int, int, int]:
    """(sharded leaves, their bytes, total bytes) of leaves given as {path:
    (JAX shape, bytes per element)} under the rules."""
    n = sharded = total = 0
    for path, (shape, itemsize) in leaves.items():
        size = 1
        for d in shape:
            size *= d
        total += size * itemsize
        if MODEL_AXIS in _spec_for(path, tuple(shape), n_model):
            n += 1
            sharded += size * itemsize
    return n, sharded, total


def shard_dims(model: nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """{parameter name: the torch axis the rules shard, or None (replicated)}."""
    out = {}
    for name, path, shape in jax_leaves(model):
        spec = _spec_for("/".join(path), shape, n_model)
        out[name] = torch_axes(path, len(shape))[spec.index(MODEL_AXIS)] if spec else None
    return out


class ParallelLinear(nn.Module):
    """One process's part of a sharded ``nn.Linear`` (the same ``weight`` and
    ``bias`` names; the weight is the local slice, the bias whole).

    "column": the weight holds the output features `index` (global indices,
    in local order); the output is gathered to all features, unless
    ``gather`` is off (the caller then takes the local features).
    "row": the weight holds the input features `index`; the input is sliced
    to them, unless ``local_input`` is on (the caller hands over the local
    features), and the partial products are all-reduced, the bias added once
    (on the axis' first process). `all_index` [n, width] holds every
    process's `index`, by which a checkpoint gathers the layer."""

    def __init__(self, lin: nn.Linear, kind: str, all_index: torch.Tensor, group, n: int,
                 rank: int):
        super().__init__()
        if kind not in ("column", "row"):
            raise ValueError(f"kind must be column or row, got {kind!r}")
        self.kind, self.group, self.n, self.rank = kind, group, n, rank
        self.in_features, self.out_features = lin.in_features, lin.out_features
        self.axis = 0 if kind == "column" else 1  # the torch axis of the weight that is cut
        dev = lin.weight.device
        self.register_buffer("all_index", all_index.to(dev), persistent=False)
        self.register_buffer("index", self.all_index[rank], persistent=False)
        with torch.no_grad():
            local = lin.weight.index_select(self.axis, self.index).contiguous()
        self.weight = nn.Parameter(local, requires_grad=lin.weight.requires_grad)
        self.bias = lin.bias
        self.gather = True
        self.local_input = False
        # a UNet or ControlNet layer (``QuantLinear``) runs w8a8 in a quantized scope
        self.quantizable = isinstance(lin, QuantLinear)
        self._wq = quant.WeightCache()

    def extra_repr(self) -> str:
        return (f"{self.kind}, in={self.in_features}, out={self.out_features}, "
                f"shard {self.rank} of {self.n}")

    def local_bias(self) -> Optional[torch.Tensor]:
        """A column layer's bias at its output features (a differentiable
        slice of the whole bias)."""
        if self.bias is None or self.n == 1:
            return self.bias
        return self.bias.index_select(0, self.index)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        quantized = self.quantizable and quant.active()
        if self.kind == "column":
            x = copy_to_model(x, self.group)
            if quantized:
                y = quant.w8a8_linear(x, self.weight, self.local_bias(), cache=self._wq,
                                      shards=self.n)
            else:
                y = F.linear(x, self.weight, self.local_bias())
            return self.gather_features(y) if self.gather else y
        if not self.local_input:
            x = self.local_features(x)
        if quantized and not quant.row_skipped(x, self.weight, self.n):
            return quant.w8a8_linear_row(x, self.weight, self.bias, self.group, cache=self._wq)
        y = F.linear(x, self.weight, self.bias if self.rank == 0 else None)
        return reduce_sum(y, self.group)

    def local_features(self, x: torch.Tensor) -> torch.Tensor:
        """This process's features (`index`) of a full-width input."""
        return slice_features(x, self.index, self.group) if self.n > 1 else x

    def gather_features(self, y: torch.Tensor) -> torch.Tensor:
        """Every process's local output features, joined in rank order: the
        global order, as a gathered layer's features are cut in contiguous
        chunks."""
        return gather_features(y, self.group, self.n, self.rank)


def _chunk(size: int, n: int, rank: int) -> torch.Tensor:
    per = size // n
    return torch.arange(rank * per, (rank + 1) * per)


def _geglu_index(size: int, n: int, rank: int) -> Optional[torch.Tensor]:
    """GEGLU's value and gate halves, each cut on its own: this process holds
    the value columns and the gate columns that match."""
    half = size // 2
    if size % 2 or half % n:
        return None
    return torch.cat([_chunk(half, n, rank), half + _chunk(half, n, rank)])


def _pairs(model: nn.Module) -> List[Tuple[nn.Module, Tuple[str, ...], str, str]]:
    """(module, its column-parallel layers, its row-parallel layer, what is
    kept local between them) for every module whose layers can keep their
    features local: "ffn" (elementwise between), "geglu", "heads" (attention
    over heads), "msda"."""
    from ..models.attention import CrossAttention, FeedForward
    from ..models.clip import ResidualAttentionBlock
    from ..models.layers import MultiHeadAttention
    from ..spotter.ms_deform_attn import MSDeformAttn
    from ..spotter.transformer import CompositeDecoderLayer, EncoderLayer

    out = []
    for m in model.modules():
        if isinstance(m, CrossAttention):
            out.append((m, ("to_q", "to_k", "to_v"), "to_out", "heads"))
        elif isinstance(m, MultiHeadAttention):
            out.append((m, ("query", "key", "value"), "out", "heads"))
        elif isinstance(m, FeedForward):
            out.append((m, ("geglu.proj",), "out", "geglu"))
        elif isinstance(m, ResidualAttentionBlock):
            out.append((m, ("mlp_fc",), "mlp_proj", "ffn"))
        elif isinstance(m, EncoderLayer):
            out.append((m, ("linear1",), "linear2", "ffn"))
        elif isinstance(m, CompositeDecoderLayer):
            for s in ("", "_text"):
                out.append((m, (f"linear1{s}",), f"linear2{s}", "ffn"))
        elif isinstance(m, MSDeformAttn):
            out.append((m, ("value_proj",), "output_proj", "msda"))
    return out


def shard_params_tp(mesh, model: nn.Module) -> Tuple[int, int]:
    """Shard `model` (a ``TeReDiff``) in place on `mesh`'s "model" axis by the
    rules; binds the axis' process group to the spotter encoder's sequence
    parallelism too (`bind_sequence_parallel`). Returns (sharded layers,
    process count on the axis). With one process on the axis every layer is
    replaced all the same and computes what it did.

    A spotter encoder layer that is sequence-parallel on the model axis keeps
    its weights whole: its processes hold different tokens, so a partial
    product of one could not be summed with another's (GSPMD gathers the
    weights there)."""
    from ..spotter.transformer import EncoderLayer

    n = mesh[MODEL_AXIS].size()
    dims = shard_dims(model, n)
    for prefix, m in model.named_modules():
        if isinstance(m, EncoderLayer) and m.sp_axis == MODEL_AXIS:
            for name, _ in m.named_parameters(prefix=prefix):
                dims[name] = None
    count = shard_layers(model, dims, mesh.get_group(MODEL_AXIS), n,
                         mesh.get_local_rank(MODEL_AXIS))
    bind_sequence_parallel(mesh, model)
    return count, n


def shard_layers(model: nn.Module, dims: Mapping[str, Optional[int]], group, n: int,
                 rank: int) -> int:
    """`shard_params_tp`'s work on any module: each ``nn.Linear`` whose
    weight `dims` shards (on torch axis 0: column-parallel, 1: row-parallel)
    becomes a `ParallelLinear` of process `rank` of `n` in `group`, the pairs
    kept local where they can be. Returns the layers replaced."""
    modules = dict(model.named_modules())

    def sharded(name: str) -> Optional[str]:
        axis = dims.get(f"{name}.weight")
        if axis is None or not isinstance(modules.get(name), nn.Linear):
            return None
        return "column" if axis == 0 else "row"

    prefix = {id(m): name for name, m in modules.items()}
    # the layers whose features are GEGLU's halves, each cut on its own (not
    # one contiguous chunk)
    geglu = set()
    # layer name -> the side of a pair it is on: "column" (no gather) or "row"
    # (local input)
    local: Dict[str, str] = {}
    for m, cols, row, how in _pairs(model):
        base = prefix[id(m)] + "." if prefix[id(m)] else ""
        names = [base + c for c in cols]
        if any(sharded(c) != "column" for c in names) or sharded(base + row) != "row":
            continue
        width = modules[names[0]].out_features
        if how == "geglu":
            if _geglu_index(width, n, rank) is None:
                continue
            geglu.add(names[0])  # the row-parallel side takes the value chunk, its default
        elif how in ("heads", "msda"):
            heads = m.heads if how == "heads" else m.n_heads
            if heads % n:
                continue
            per = heads // n
            if how == "heads":
                m.heads = per
            else:
                m.head_range = (rank * per, (rank + 1) * per)
                m.tp_group = group
        for c in names:
            local[c] = "column"
        local[base + row] = "row"

    count = 0
    for name, module in list(modules.items()):
        kind = sharded(name)
        if kind is None:
            continue
        width = module.out_features if kind == "column" else module.in_features
        cut = _geglu_index if name in geglu else _chunk
        all_index = torch.stack([cut(width, n, r) for r in range(n)])
        layer = ParallelLinear(module, kind, all_index, group, n, rank)
        if local.get(name) == "column":
            layer.gather = False
        elif local.get(name) == "row":
            layer.local_input = True
        parent, _, child = name.rpartition(".")
        setattr(modules[parent] if parent else model, child, layer)
        count += 1
    return count


def bind_sequence_parallel(mesh, model: nn.Module) -> int:
    """Give every spotter encoder layer whose ``sp_axis`` names an axis of
    `mesh` that axis' process group (the sequence-parallel encoder of
    ``TESTRConfig.enc_sp_axis``). Returns the layers bound."""
    from ..spotter.transformer import EncoderLayer

    bound = 0
    for m in model.modules():
        if isinstance(m, EncoderLayer) and m.sp_axis:
            m.sp_group = mesh.get_group(m.sp_axis)
            bound += 1
    return bound


def partial_grad_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters whose gradient each process of the model axis holds in
    part, to be summed over the axis after the backward
    (``parallel.fsdp.GradientSync``): a `ParallelLinear`'s bias (sliced by a
    column layer, added on the first process by a row layer), the offsets
    and weights of an msda that runs its local heads (their lanes cut), and
    every parameter of a sequence-parallel encoder layer (this process's
    tokens only). Every other parameter is computed whole on each process."""
    from ..spotter.ms_deform_attn import MSDeformAttn
    from ..spotter.transformer import EncoderLayer

    out: Dict[int, nn.Parameter] = {}
    for m in model.modules():
        params: Sequence[Optional[nn.Parameter]] = ()
        if isinstance(m, ParallelLinear):
            params = (m.bias,)
        elif isinstance(m, MSDeformAttn) and m.head_range is not None:
            params = (*m.sampling_offsets.parameters(), *m.attention_weights.parameters())
        elif isinstance(m, EncoderLayer) and m.sp_group is not None:
            params = tuple(m.parameters())
        out.update((id(p), p) for p in params if p is not None)
    return list(out.values())


def tp_weights(model: nn.Module) -> Dict[str, ParallelLinear]:
    """{weight name in the state dict: its `ParallelLinear`}."""
    return {f"{name}.weight" if name else "weight": m for name, m in model.named_modules()
            if isinstance(m, ParallelLinear)}


def slice_weight(layer: ParallelLinear, t: torch.Tensor) -> torch.Tensor:
    """This process's slice of a whole tensor of `layer`'s global weight shape."""
    if layer.n == 1:
        return t
    return t.index_select(layer.axis, layer.index.to(t.device)).contiguous()
