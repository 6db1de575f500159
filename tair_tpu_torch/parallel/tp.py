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

Serving only: the collectives are plain ``torch.distributed`` calls, outside
autograd. The w8a8 path raises under more than one process on the axis (a
per-tensor dynamic scale over a row-parallel shard is not the global one).
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
    (on the axis' first process)."""

    def __init__(self, lin: nn.Linear, kind: str, index: torch.Tensor, group, n: int,
                 rank: int):
        super().__init__()
        if kind not in ("column", "row"):
            raise ValueError(f"kind must be column or row, got {kind!r}")
        self.kind, self.group, self.n, self.rank = kind, group, n, rank
        self.in_features, self.out_features = lin.in_features, lin.out_features
        axis = 0 if kind == "column" else 1
        dev = lin.weight.device
        self.register_buffer("index", index.to(dev), persistent=False)
        with torch.no_grad():
            local = lin.weight.index_select(axis, self.index).contiguous()
        self.weight = nn.Parameter(local, requires_grad=lin.weight.requires_grad)
        self.bias = lin.bias
        local_bias = None
        if lin.bias is not None and kind == "column" and n > 1:
            with torch.no_grad():
                local_bias = lin.bias.index_select(0, self.index)
        self.register_buffer("local_bias", local_bias, persistent=False)
        self.gather = True
        self.local_input = False
        # a UNet or ControlNet layer (``QuantLinear``) runs w8a8 in a quantized scope
        self.quantizable = isinstance(lin, QuantLinear)
        self._wq = quant.WeightCache()

    def extra_repr(self) -> str:
        return (f"{self.kind}, in={self.in_features}, out={self.out_features}, "
                f"shard {self.rank} of {self.n}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantizable and quant.active():
            if self.n > 1:
                raise ValueError(
                    "w8a8 is not served under tensor parallelism: a per-tensor scale over "
                    "a shard is not the global one (ROADMAP queue)"
                )
            return quant.w8a8_linear(x, self.weight, self.bias, cache=self._wq)
        if self.kind == "column":
            bias = self.bias if self.local_bias is None else self.local_bias
            y = F.linear(x, self.weight, bias)
            return self.gather_features(y) if self.gather else y
        if not self.local_input:
            x = self.local_features(x)
        y = F.linear(x, self.weight, self.bias if self.rank == 0 else None)
        dist.all_reduce(y, group=self.group)
        return y

    def local_features(self, x: torch.Tensor) -> torch.Tensor:
        """This process's features (`index`) of a full-width input."""
        return x.index_select(-1, self.index) if self.n > 1 else x

    def gather_features(self, y: torch.Tensor) -> torch.Tensor:
        """Every process's local output features, joined in rank order: the
        global order, as a gathered layer's features are cut in contiguous
        chunks."""
        parts = [torch.empty_like(y) for _ in range(self.n)]
        dist.all_gather(parts, y.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)


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
    # layer name -> its local features, where not a contiguous chunk (GEGLU)
    index: Dict[str, torch.Tensor] = {}
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
            idx = _geglu_index(width, n, rank)
            if idx is None:
                continue
            index[names[0]] = idx  # the row-parallel side takes the value chunk, its default
        elif how in ("heads", "msda"):
            heads = m.heads if how == "heads" else m.n_heads
            if heads % n:
                continue
            per = heads // n
            if how == "heads":
                m.heads = per
            else:
                m.head_range = (rank * per, (rank + 1) * per)
        for c in names:
            local[c] = "column"
        local[base + row] = "row"

    count = 0
    for name, module in list(modules.items()):
        kind = sharded(name)
        if kind is None:
            continue
        width = module.out_features if kind == "column" else module.in_features
        idx = index.get(name, _chunk(width, n, rank))
        layer = ParallelLinear(module, kind, idx, group, n, rank)
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
