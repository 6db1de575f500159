"""Collectives over a mesh axis as autograd functions, in Megatron's pairs.

Tensor parallelism (``parallel/tp.py``) and the sequence-parallel spotter
encoder (``spotter/transformer.py``) train through these: each forward is the
collective that serving runs, and each backward is its transpose, so every
replicated activation holds its whole gradient on every process of the axis.

  ``copy_to_model``   identity      | all-reduce (sum) of the gradient
  ``slice_features``  a slice       | the slice's gradient in the whole width, all-reduced
  ``gather_features`` all-gather    | this process's slice of the gradient
  ``reduce_sum``      all-reduce    | identity
  ``gather_tokens``   all-gather of token slices | this process's token rows
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SliceFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.save_for_backward(index)
        return x.index_select(-1, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(g.shape[:-1] + (ctx.width,))
        full.index_copy_(-1, index, g)
        dist.all_reduce(full, group=ctx.group)
        return full, None, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n, rank):
        ctx.rank, ctx.width = rank, y.shape[-1]
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w : (ctx.rank + 1) * w], None, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        dist.all_reduce(y, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, total, group, n, rank):
        ctx.rank, ctx.per, ctx.pad = rank, x.shape[1], x.shape[1] * n - total
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)[:, :total]

    @staticmethod
    def backward(ctx, g):
        if ctx.pad:
            g = torch.cat([g, g.new_zeros((g.shape[0], ctx.pad) + tuple(g.shape[2:]))], dim=1)
        return g[:, ctx.rank * ctx.per : (ctx.rank + 1) * ctx.per], None, None, None, None


def _group(group):
    """`group`, which every collective here needs: None would be the whole
    world's group, not the axis'."""
    if group is None:
        raise ValueError("a collective of a mesh axis needs that axis' process group")
    return group


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as it is; its gradient summed over `group`: the entry of a
    replicated tensor into work that each process does in part (a
    column-parallel layer, the local heads' lanes of msda, a sequence-parallel
    layer)."""
    return _CopyToModel.apply(x, _group(group))


def slice_features(x: torch.Tensor, index: torch.Tensor, group) -> torch.Tensor:
    """The features `index` of a replicated `x` (last axis); the gradient of
    the slice is placed in the whole width and summed over `group`."""
    return _SliceFeatures.apply(x, index, _group(group))


def gather_features(y: torch.Tensor, group, n: int, rank: int) -> torch.Tensor:
    """The `n` processes' features of `y` joined in rank order (last axis);
    the backward keeps this process's slice of the gradient."""
    return _GatherFeatures.apply(y, _group(group), n, rank)


def reduce_sum(y: torch.Tensor, group) -> torch.Tensor:
    """`y` summed over `group`, in place (a fresh product's partial sums);
    the gradient passes through to every partial."""
    return _ReduceSum.apply(y, _group(group))


def gather_tokens(x: torch.Tensor, total: int, group, n: int, rank: int) -> torch.Tensor:
    """Every process's token slice (axis 1, ceil(total / n) tokens each, the
    last ones padded) joined and the padding dropped: [B, total, ...]; the
    backward keeps this process's token rows of the gradient."""
    return _GatherTokens.apply(x, total, _group(group), n, rank)
