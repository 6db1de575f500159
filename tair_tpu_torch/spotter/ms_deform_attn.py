"""Multi-scale deformable attention.

Counterpart of ``tair_tpu/spotter/ms_deform_attn.py``. The math of every core
is grid_sample(align_corners=False, padding_mode='zeros'): each (head, level,
point) sample reads its four bilinear corners, corners outside the level count
as zero, and the samples are summed with the attention weights. The cores are
layout alternates of that one function:

``ms_deform_attn_core``
    four row gathers per level; the reference the others are held against.
``ms_deform_attn_core_patch``
    one gather of the clamped 2x2 patch per level. The JAX package kept it as
    the first step away from the reference; no module selects it.
``ms_deform_attn_core_flat``
    every (level, point, corner) sample as one row index into ``[B*H*S, D]``
    and a single row gather. The JAX module's own default, chosen there for
    short query axes (the decoder's cross-attention), where building a packed
    table is not paid back.
``ms_deform_attn_core_flatpatch``
    one gather of a ``4*D``-wide row per sample point from the packed table of
    ``ops.patchify`` (each position's 2x2 neighbourhood in one row), with the
    corner weighting as two constant matrix products (``reduce="mxu"``) or a
    plain contraction (``"einsum"``). Chosen there for long query axes (the
    encoder, Q = S), where the table is built once for many gathered rows.
``ms_deform_attn_core_flatlanes``
    ``flatpatch`` with every per-sample tensor kept lane-packed as
    ``[B, Q, H*L*P]``, the per-level loop replaced by per-lane constants. The
    JAX encoder and decoder layers select it; it is this package's default,
    with ``ops.msda_reduce.msda_corner_reduce`` (``reduce="kernel"``) weighting
    the corners and summing over (level, point). ``"mxu"``, ``"fused"`` and
    ``"mask"`` are the same reduce in tensor ops, in the three associations the
    JAX package measured against each other.

The packed table is built by ``patchify="concat"`` (``patchify_value``),
``"roll"`` (``patchify_value_roll``: shifted slices of the flattened level;
rows that no core can reach hold wrapped neighbours), ``"conv"``
(``patchify_value_conv``: im2col, channel-major lanes, ``flatpatch`` only) or
``"kernel"`` (``ops.patchify.patchify_value_kernel``, the CUDA kernel; the JAX
package calls its counterpart ``"pallas"``). Long query axes are processed in
``q_chunk`` blocks by a Python loop, the table built once outside it.

Under autograd the gradient reaches ``value`` (through the row gather and the
patch packing), the sampling locations (through the bilinear fractions in the
corner weights) and the attention weights; the row indices carry none. The
row gather's gradient is a scatter-add of up to hundreds of rows into one
packed row: ``gather_rows`` accumulates it in float32 whatever the rows' type,
so that in bfloat16 neither the sum's length nor the order in which a CUDA
device adds the rows shows beyond float32 rounding.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda_reduce import msda_corner_reduce
from ..ops.patchify import patchify_value, patchify_value_kernel

CORES = ("flat", "flatpatch", "flatlanes")
FLATPATCH_REDUCES = ("mxu", "einsum")
FLATLANES_REDUCES = ("kernel", "mxu", "fused", "mask")


def ms_deform_attn_core(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],  # ((h, w), ...) per level
    sampling_locations: torch.Tensor,    # [B, Q, H, L, P, 2] normalized [0,1]
    attention_weights: torch.Tensor,     # [B, Q, H, L, P]
) -> torch.Tensor:                       # [B, Q, H*D]
    b, s, h, d = value.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    if len(spatial_shapes) != n_levels or sum(hh * ww for hh, ww in spatial_shapes) != s:
        raise ValueError("spatial_shapes do not match the value and location tensors")

    out = torch.zeros((b, q, h, d), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v = value[:, start : start + hl * wl].permute(0, 2, 1, 3)  # [B, H, hw, D]
        start += hl * wl

        loc = sampling_locations[:, :, :, lvl].float()  # [B, Q, H, P, 2]
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0

        acc = torch.zeros((b, h, q, n_points, d), dtype=torch.float32, device=value.device)
        for dx, dy, w in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            idx = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()  # [B,Q,H,P]
            idx = idx.permute(0, 2, 1, 3).reshape(b, h, q * n_points)
            g = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, d))
            g = g.reshape(b, h, q, n_points, d)
            wm = (w * valid).permute(0, 2, 1, 3)  # [B,H,Q,P]
            acc = acc + g.float() * wm[..., None]

        aw = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).float()  # [B,H,Q,P]
        out = out + torch.einsum("bhqpd,bhqp->bqhd", acc, aw)

    return out.reshape(b, q, h * d).to(value.dtype)


def _check_levels(value: torch.Tensor, spatial_shapes, n_levels: int) -> None:
    if len(spatial_shapes) != n_levels or (
        sum(hh * ww for hh, ww in spatial_shapes) != value.shape[1]
    ):
        raise ValueError("spatial_shapes do not match the value and location tensors")


def _clamped_axis(coord: torch.Tensor, size: int):
    """One axis of the clamped 2x2 patch. `coord` is the sample's pixel
    coordinate (location * size - 0.5). Returns the patch start (long, clamped
    to [0, max(size - 2, 0)]), the two patch positions ``[..., 2]`` (float) and
    their weights ``[..., 2]``: the position that is the true left corner takes
    1 - f, the true right corner f, and both vanish when both true corners
    fall outside the grid (zero padding)."""
    c0 = torch.floor(coord)
    f = (coord - c0)[..., None]
    c0 = c0[..., None]
    s0 = c0.clamp(0, max(size - 2, 0))
    j = s0 + torch.arange(2, device=coord.device, dtype=coord.dtype)  # [..., 2]
    zero = torch.zeros((), dtype=coord.dtype, device=coord.device)
    w = torch.where(j == c0, 1.0 - f, torch.where(j == c0 + 1, f, zero))
    w = w * ((c0 + 1 >= 0) & (c0 <= size - 1))
    return s0[..., 0].long(), j, w


def _map_query_chunks(fn: Callable[..., torch.Tensor], q_chunk: int, *per_query):
    """`fn` over blocks of `q_chunk` queries of tensors ``[B, Q, ...]``: pad the
    query axis with zeros to a multiple of the block, loop, cut. One call when
    Q fits a block."""
    if q_chunk < 1:
        raise ValueError(f"q_chunk must be positive, got {q_chunk}")
    q = per_query[0].shape[1]
    if q <= q_chunk:
        return fn(*per_query)
    pad = (-q) % q_chunk
    if pad:
        per_query = tuple(
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in per_query
        )
    outs = [
        fn(*(t[:, i : i + q_chunk] for t in per_query))
        for i in range(0, q + pad, q_chunk)
    ]
    return torch.cat(outs, dim=1)[:, :q]


def ms_deform_attn_core_patch(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,    # [B, Q, H, L, P, 2] in [0,1]
    attention_weights: torch.Tensor,     # [B, Q, H, L, P]
) -> torch.Tensor:
    """Patch-gather variant: per level, each sample point fetches its clamped
    2x2 patch with one gather (four positions per point in one index tensor)
    and weights the four corners by their true bilinear weights, zero for a
    corner outside the grid. A level one pixel high or wide has no second
    patch row or column: its position is clamped and its weight zeroed."""
    b, s, h, d = value.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    _check_levels(value, spatial_shapes, n_levels)

    out = torch.zeros((b, q, h, d), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v = value[:, start : start + hl * wl].permute(0, 2, 1, 3)  # [B, H, hw, D]
        start += hl * wl

        loc = sampling_locations[:, :, :, lvl].float()  # [B, Q, H, P, 2]
        _, jx, wx = _clamped_axis(loc[..., 0] * wl - 0.5, wl)
        _, jy, wy = _clamped_axis(loc[..., 1] * hl - 0.5, hl)
        wx = wx * (jx <= wl - 1)
        wy = wy * (jy <= hl - 1)
        w2x2 = wy[..., :, None] * wx[..., None, :]  # [B,Q,H,P,2,2]

        idx = (
            jy.clamp(max=hl - 1)[..., :, None] * wl + jx.clamp(max=wl - 1)[..., None, :]
        ).long()  # [B,Q,H,P,2,2]
        idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(b, h, q * n_points * 4)
        patches = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, d))
        patches = patches.reshape(b, h, q, n_points, 2, 2, d)

        aw = attention_weights[:, :, :, lvl].float()  # [B,Q,H,P]
        wgt = (w2x2 * aw[..., None, None]).permute(0, 2, 1, 3, 4, 5)  # [B,H,Q,P,2,2]
        out = out + torch.einsum("bhqpyxd,bhqpyx->bqhd", patches.float(), wgt)

    return out.reshape(b, q, h * d).to(value.dtype)


def ms_deform_attn_core_flat(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,    # [B, Q, H, L, P, 2] in [0,1]
    attention_weights: torch.Tensor,     # [B, Q, H, L, P]
    q_chunk: int = 2048,
) -> torch.Tensor:
    """Flat-take formulation: all (level, point, corner) samples become row
    indices into one ``[B*H*S, D]`` operand and a single row gather fetches
    them. Long query axes run in `q_chunk` blocks to bound the gathered
    intermediate."""
    b, s, h, d = value.shape
    n_levels, n_points = sampling_locations.shape[3:5]
    _check_levels(value, spatial_shapes, n_levels)
    dev = value.device
    v2d = value.permute(0, 2, 1, 3).reshape(b * h * s, d)
    bh = (
        torch.arange(b, device=dev)[:, None, None, None] * h
        + torch.arange(h, device=dev)[None, None, :, None]
    )  # [B, 1, H, 1]

    def block(locs, wts):
        q = locs.shape[1]
        rows, wgts = [], []
        start = 0
        for lvl, (hl, wl) in enumerate(spatial_shapes):
            loc = locs[:, :, :, lvl].float()  # [B, Q, H, P, 2]
            x = loc[..., 0] * wl - 0.5
            y = loc[..., 1] * hl - 0.5
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            fx = x - x0
            fy = y - y0
            aw = wts[:, :, :, lvl].float()  # [B, Q, H, P]
            for dx, dy, wc in (
                (0, 0, (1 - fx) * (1 - fy)),
                (1, 0, fx * (1 - fy)),
                (0, 1, (1 - fx) * fy),
                (1, 1, fx * fy),
            ):
                xi = x0 + dx
                yi = y0 + dy
                valid = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
                pos = start + (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
                rows.append(bh * s + pos)
                wgts.append(wc * valid * aw)
            start += hl * wl
        idx = torch.stack(rows, dim=-1)   # [B, Q, H, P, L*4], in bounds by construction
        wgt = torch.stack(wgts, dim=-1)   # [B, Q, H, P, L*4]
        g = gather_rows(v2d, idx.reshape(-1))
        g = g.reshape(b, q, h, n_points, n_levels * 4, d)
        out = torch.einsum("bqhpcd,bqhpc->bqhd", g.float(), wgt)
        return out.reshape(b, q, h * d).to(value.dtype)

    return _map_query_chunks(block, q_chunk, sampling_locations, attention_weights)


def patchify_value_roll(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
) -> torch.Tensor:                       # [B*H*S, 4*D]
    """The corner-major table of `patchify_value` from shifted slices of the
    spatially flattened ``[B, H, hl*wl*D]`` view of each level. Rows that can
    never be gathered (x == wl-1 or y == hl-1: every core clamps the patch
    start to wl-2 / hl-2) hold wrapped neighbours instead of zeros; every
    reachable row is equal to `patchify_value`'s, except in a level one pixel
    wide and more than one high, whose only column is reachable and holds the
    next row's value in its (0,1) lanes (as in the JAX package: build such a
    level's table another way)."""
    b, s, h, d = value.shape
    vt = value.permute(0, 2, 1, 3)  # [B, H, S, D]
    pieces = []
    start = 0
    for (hl, wl) in spatial_shapes:
        n = hl * wl
        z = vt[:, :, start : start + n].reshape(b, h, n * d)
        start += n
        zpad = torch.cat([z, z.new_zeros((b, h, (wl + 1) * d))], dim=-1)
        corners = [z.reshape(b, h, n, d)] + [
            zpad[:, :, k : k + n * d].reshape(b, h, n, d)
            for k in (d, wl * d, (wl + 1) * d)  # (0,1), (1,0), (1,1)
        ]
        pieces.append(torch.cat(corners, dim=-1))
    return torch.cat(pieces, dim=2).reshape(b * h * s, 4 * d)


def patchify_value_conv(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
) -> torch.Tensor:                       # [B*H*S, D*4] channel-major
    """2x2-neighbourhood packing as one im2col per level. The lane layout is
    CHANNEL-MAJOR: lane = c*4 + corner, corners in (0,0),(0,1),(1,0),(1,1)
    order, so the corner weights are spread and summed differently from the
    corner-major layout of `patchify_value` (see `ms_deform_attn_core_flatpatch`)."""
    b, s, h, d = value.shape
    vt = value.permute(0, 2, 1, 3)  # [B, H, S, D]
    pieces = []
    start = 0
    for (hl, wl) in spatial_shapes:
        vl = vt[:, :, start : start + hl * wl].reshape(b * h, hl, wl, d)
        start += hl * wl
        padded = F.pad(vl.permute(0, 3, 1, 2), (0, 1, 0, 1))  # [BH, D, hl+1, wl+1]
        p = F.unfold(padded, kernel_size=2)                    # [BH, D*4, hl*wl]
        pieces.append(p.transpose(1, 2).reshape(b, h, hl * wl, 4 * d))
    return torch.cat(pieces, dim=2).reshape(b * h * s, 4 * d)


_PATCHIFY = {
    "concat": patchify_value,
    "roll": patchify_value_roll,
    "conv": patchify_value_conv,
    "kernel": patchify_value_kernel,
}


def _packed_table(value, spatial_shapes, patchify: str, value_patched, choices):
    if value_patched is not None:
        return value_patched
    if patchify not in choices:
        raise ValueError(f"patchify must be one of {choices}, got {patchify!r}")
    return _PATCHIFY[patchify](value, spatial_shapes)


def ms_deform_attn_core_flatpatch(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,    # [B, Q, H, L, P, 2] in [0,1]
    attention_weights: torch.Tensor,     # [B, Q, H, L, P]
    q_chunk: int = 2048,
    value_patched: Optional[torch.Tensor] = None,
    reduce: str = "mxu",
    patchify: str = "concat",
) -> torch.Tensor:                       # [B, Q, H*D]
    """Patchified flat-take: one ``4*D``-wide row gather per sample point from
    the packed table instead of four ``D``-wide corner gathers. The patch start
    is clamped into the level and the per-corner weights are matched to the
    patch's actual coordinates (cf. `ms_deform_attn_core_patch`).

    ``reduce="mxu"``: the corner weights are spread over their lanes by a
    constant ``[4, 4D]`` matrix product, in the gathered rows' type, and the
    four corners and the K = P*L samples are summed by a constant ``[4D, D]``
    product in float32. ``reduce="einsum"`` is the plain contraction with
    float32 weights. A `value_patched` table built by `patchify_value_conv`
    needs ``patchify="conv"`` beside it, which names the channel-major lanes."""
    b, s, h, d = value.shape
    n_levels, n_points = sampling_locations.shape[3:5]
    _check_levels(value, spatial_shapes, n_levels)
    if reduce not in FLATPATCH_REDUCES:
        raise ValueError(f"reduce must be one of {FLATPATCH_REDUCES}, got {reduce!r}")
    dev = value.device
    vp = _packed_table(value, spatial_shapes, patchify, value_patched, tuple(_PATCHIFY))
    cmajor = patchify == "conv"  # lane = c*4 + corner, not corner*D + c
    bh = (
        torch.arange(b, device=dev)[:, None, None, None] * h
        + torch.arange(h, device=dev)[None, None, :, None]
    )  # [B, 1, H, 1]

    def block(locs, wts):
        q = locs.shape[1]
        rows, wgts = [], []
        start = 0
        for lvl, (hl, wl) in enumerate(spatial_shapes):
            loc = locs[:, :, :, lvl].float()  # [B, Q, H, P, 2]
            sx, _, wx = _clamped_axis(loc[..., 0] * wl - 0.5, wl)
            sy, _, wy = _clamped_axis(loc[..., 1] * hl - 0.5, hl)
            # corner order matches the table's rows: (0,0), (0,1), (1,0), (1,1)
            w4 = (wy[..., :, None] * wx[..., None, :]).reshape(b, q, h, n_points, 4)
            aw = wts[:, :, :, lvl].float()  # [B, Q, H, P]
            rows.append(bh * s + start + sy * wl + sx)
            wgts.append(w4 * aw[..., None])
            start += hl * wl
        idx = torch.stack(rows, dim=-1)   # [B, Q, H, P, L], in bounds by construction
        wgt = torch.stack(wgts, dim=-2)   # [B, Q, H, P, L, 4]
        g = gather_rows(vp, idx.reshape(-1))
        if reduce == "einsum":
            if cmajor:
                g = g.reshape(b, q, h, n_points, n_levels, d, 4)
                out = torch.einsum("bqhpldc,bqhplc->bqhd", g.float(), wgt)
            else:
                g = g.reshape(b, q, h, n_points, n_levels, 4, d)
                out = torch.einsum("bqhplcd,bqhplc->bqhd", g.float(), wgt)
        else:
            k = n_points * n_levels
            g = g.reshape(b, q, h, k, 4 * d)
            eye4 = torch.eye(4, dtype=g.dtype, device=dev)
            eyed = torch.eye(d, dtype=torch.float32, device=dev)
            if cmajor:
                # lane j weights corner j%4; lane j sums into channel j//4
                spread = eye4.repeat(1, d)                    # [4, 4d]
                seg = eyed.repeat_interleave(4, dim=0)        # [4d, d]
            else:
                # lane j weights corner j//d; lane j sums into channel j%d
                spread = eye4.repeat_interleave(d, dim=1)     # [4, 4d]
                seg = eyed.repeat(4, 1)                       # [4d, d]
            w_lanes = wgt.reshape(b, q, h, k, 4).to(g.dtype) @ spread  # [B,Q,H,K,4d]
            out = torch.einsum("bqhkc,cd->bqhd", (g * w_lanes).float(), seg)
        return out.reshape(b, q, h * d).to(value.dtype)

    return _map_query_chunks(block, q_chunk, sampling_locations, attention_weights)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.table_meta = (table.shape, table.dtype)
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, dg):
        (rows,) = ctx.saved_tensors
        shape, dtype = ctx.table_meta
        acc = torch.zeros(shape, dtype=torch.float32, device=dg.device)
        acc.index_add_(0, rows, dg.float())
        return acc.to(dtype), None


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, rows)`` whose gradient with respect to `table`
    is summed in float32 and cast to the table's type once."""
    return _GatherRows.apply(table, rows)


def _lane_consts(spatial_shapes, n_heads: int, n_points: int) -> Dict[str, np.ndarray]:
    """Per-lane constant vectors for the packed core; lane order (h, l, p),
    p fastest. Returns dict of [H*L*P] numpy arrays."""
    L = len(spatial_shapes)
    lanes = n_heads * L * n_points
    lvl = np.zeros((lanes,), np.int64)
    h_of = np.zeros((lanes,), np.int64)
    for h in range(n_heads):
        for l in range(L):
            s = (h * L + l) * n_points
            lvl[s : s + n_points] = l
            h_of[s : s + n_points] = h
    wl = np.asarray([w for (_, w) in spatial_shapes], np.float32)[lvl]
    hl = np.asarray([h_ for (h_, _) in spatial_shapes], np.float32)[lvl]
    starts = np.cumsum([0] + [h_ * w for (h_, w) in spatial_shapes])[:-1]
    start = starts.astype(np.int64)[lvl]
    return dict(lvl=lvl, h=h_of, wl=wl, hl=hl, start=start)


@functools.lru_cache(maxsize=64)
def _lane_tensors(spatial_shapes, n_heads: int, n_points: int, device: torch.device):
    """`_lane_consts` as tensors on `device`, made once per geometry."""
    c = _lane_consts(spatial_shapes, n_heads, n_points)
    out = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
    out["inv_wl"] = torch.from_numpy(1.0 / c["wl"]).to(device)
    out["inv_hl"] = torch.from_numpy(1.0 / c["hl"]).to(device)
    return out


def _corner_masks(d: int, device) -> torch.Tensor:
    """[4, 4D] float32: row c is 1 on the lanes of corner c (corner-major)."""
    return torch.eye(4, dtype=torch.float32, device=device).repeat_interleave(d, dim=1)


def ms_deform_attn_core_flatlanes(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    locx: torch.Tensor,                  # [B, Q, H*L*P] packed, lane=(h,l,p)
    locy: torch.Tensor,                  # [B, Q, H*L*P]
    attn: torch.Tensor,                  # [B, Q, H*L*P] softmaxed per head
    value_patched: Optional[torch.Tensor] = None,
    q_chunk: int = 16384,
    reduce: str = "kernel",
    patchify: str = "concat",
) -> torch.Tensor:                       # [B, Q, H*D]
    """Lane-packed flatpatch core. ``reduce="kernel"`` (the default) hands the
    gathered rows and the four packed corner weights to `msda_corner_reduce`,
    which launches its CUDA kernel on a CUDA tensor. ``"mxu"`` spreads the
    weights by a ``[4, 4D]`` matrix product in the rows' type and sums corners
    and K by a ``[4D, D]`` product; ``"fused"`` builds the lane weights from
    corner masks, sums over K first and the corners after; ``"mask"`` builds
    them the same way and sums corners and K in one contraction. The table is
    corner-major: ``patchify`` is ``concat``, ``roll`` or ``kernel``."""
    b, s, h, d = value.shape
    lanes = locx.shape[2]
    L = len(spatial_shapes)
    if lanes % (h * L) or sum(hh * ww for hh, ww in spatial_shapes) != s:
        raise ValueError("spatial_shapes do not match the value and location tensors")
    if reduce not in FLATLANES_REDUCES:
        raise ValueError(f"reduce must be one of {FLATLANES_REDUCES}, got {reduce!r}")
    p = lanes // (h * L)
    k = L * p
    dev = value.device

    c = _lane_tensors(tuple(map(tuple, spatial_shapes)), h, p, dev)
    wl, hlv, start, h_vec = c["wl"], c["hl"], c["start"], c["h"]

    # "conv" lays its lanes out channel-major, which no reduce here reads
    vp = _packed_table(
        value, spatial_shapes, patchify, value_patched, ("concat", "roll", "kernel")
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # per-axis weights at the clamped patch columns s0 + {0, 1}: the column
    # that is the true left corner takes 1-f, the true right corner f, and
    # both vanish when both true corners fall outside the grid (zero padding)
    def axis_weights(s0, v0, fv, size):
        m = ((v0 + 1.0 >= 0.0) & (v0 <= size - 1.0)).float()
        left = (
            torch.where(s0 == v0, 1.0 - fv, zero)
            + torch.where(s0 == v0 + 1.0, fv, zero)
        ) * m
        right = (
            torch.where(s0 + 1.0 == v0, 1.0 - fv, zero)
            + torch.where(s0 + 1.0 == v0 + 1.0, fv, zero)
        ) * m
        return left, right

    def block(lx, ly, aw):
        q = lx.shape[1]
        x = lx.float() * wl - 0.5
        y = ly.float() * hlv - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        sx = torch.minimum(torch.maximum(x0, zero), torch.clamp(wl - 2.0, min=0.0))
        sy = torch.minimum(torch.maximum(y0, zero), torch.clamp(hlv - 2.0, min=0.0))
        wxl, wxr = axis_weights(sx, x0, fx, wl)
        wyl, wyr = axis_weights(sy, y0, fy, hlv)

        aw = aw.float()
        # per-corner combined weights, still packed [B, Q, lanes]
        w00 = wxl * wyl * aw
        w01 = wxr * wyl * aw
        w10 = wxl * wyr * aw
        w11 = wxr * wyr * aw

        rows = (
            (torch.arange(b, device=dev)[:, None, None] * h + h_vec) * s
            + start
            + sy.long() * wl.long()
            + sx.long()
        )  # [B, Q, lanes], in bounds by construction
        g = gather_rows(vp, rows.reshape(-1))  # [B*Q*lanes, 4D]

        if reduce == "kernel":
            out = msda_corner_reduce(
                g,
                w00.reshape(b * q, lanes),
                w01.reshape(b * q, lanes),
                w10.reshape(b * q, lanes),
                w11.reshape(b * q, lanes),
                k,
            )  # [B*Q*H, D] float32
            return out.reshape(b, q, h * d).to(value.dtype)

        g = g.reshape(b, q, h, k, 4 * d)
        seg = torch.eye(d, dtype=torch.float32, device=dev).repeat(4, 1)  # [4d, d]
        if reduce == "mxu":
            w4 = torch.stack([w00, w01, w10, w11], dim=-1).reshape(b, q, h, k, 4)
            spread = _corner_masks(d, dev).to(g.dtype)                    # [4, 4d]
            w_lanes = w4.to(g.dtype) @ spread                             # [B,Q,H,K,4d]
            out = torch.einsum("bqhkc,cd->bqhd", (g * w_lanes).float(), seg)
        else:
            cm = _corner_masks(d, dev)
            w_lanes = (
                w00[..., None] * cm[0]
                + w01[..., None] * cm[1]
                + w10[..., None] * cm[2]
                + w11[..., None] * cm[3]
            ).reshape(b, q, h, k, 4 * d)
            if reduce == "fused":
                red = (g.float() * w_lanes).sum(dim=3)                    # [B,Q,H,4D]
                out = torch.einsum("bqhc,cd->bqhd", red, seg)
            else:  # "mask"
                out = torch.einsum("bqhkc,cd->bqhd", g.float() * w_lanes, seg)
        return out.reshape(b, q, h * d).to(value.dtype)

    return _map_query_chunks(block, q_chunk, locx, locy, attn)


def directional_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Deformable-DETR's sampling-offset bias init: heads point at compass
    directions, points at increasing radii."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # [H, 2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Deformable attention module: offsets/weights from query, gather+reduce.

    forward(query [B,Q,C], reference_points [B,Q,L,2|4],
            value_flatten [B,S,C], spatial_shapes) -> [B,Q,C]

    ``core`` selects the gather formulation (``flat``, ``flatpatch``,
    ``flatlanes``), ``patchify`` the construction of the packed table of the
    two packed cores, ``reduce_mode`` the corner reduce of ``flatlanes``
    (``flatpatch`` runs its ``mxu`` reduce, as in the JAX module) and
    ``q_chunk`` the query block. The parameters are the same for every choice.
    """

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, core: str = "flatlanes",
                 reduce_mode: str = "kernel", patchify: str = "concat",
                 q_chunk: int = 2048):
        super().__init__()
        self.d_model = d_model
        self.n_levels = n_levels
        self.n_heads = n_heads
        self.n_points = n_points
        self.core = core
        self.reduce_mode = reduce_mode
        self.patchify = patchify
        self.q_chunk = q_chunk
        lanes = n_heads * n_levels * n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, lanes * 2)
        self.attention_weights = nn.Linear(d_model, lanes)
        self.output_proj = nn.Linear(d_model, d_model)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(directional_bias_init(n_heads, n_levels, n_points))
            )
            self.attention_weights.weight.zero_()

    def forward(self, query, reference_points, value_flatten, spatial_shapes):
        b, q, _ = query.shape
        s = value_flatten.shape[1]
        h, l, p = self.n_heads, self.n_levels, self.n_points
        d = self.d_model // h
        lanes = h * l * p
        if self.core not in CORES:
            raise ValueError(f"core must be one of {CORES}, got {self.core!r}")

        value = self.value_proj(value_flatten).reshape(b, s, h, d)
        off_flat = self.sampling_offsets(query).float()  # lanes are (h,l,p,2), xy minor
        attn = self.attention_weights(query).reshape(b, q, h, l * p)
        attn = torch.softmax(attn.float(), dim=-1)

        if self.core == "flatlanes":
            offx = off_flat[..., 0::2]
            offy = off_flat[..., 1::2]
            consts = _lane_tensors(tuple(map(tuple, spatial_shapes)), h, p, query.device)
            lvl = consts["lvl"]

            def lanes_of(v):  # [B, Q, L] -> [B, Q, lanes]
                return v.float().index_select(-1, lvl)

            inv_wl, inv_hl = consts["inv_wl"], consts["inv_hl"]
            if reference_points.shape[-1] == 2:
                locx = lanes_of(reference_points[..., 0]) + offx * inv_wl
                locy = lanes_of(reference_points[..., 1]) + offy * inv_hl
            else:  # cxcywh reference boxes
                locx = lanes_of(reference_points[..., 0]) + (
                    offx / p * lanes_of(reference_points[..., 2]) * 0.5
                )
                locy = lanes_of(reference_points[..., 1]) + (
                    offy / p * lanes_of(reference_points[..., 3]) * 0.5
                )
            out = ms_deform_attn_core_flatlanes(
                value, spatial_shapes, locx, locy, attn.reshape(b, q, lanes),
                q_chunk=self.q_chunk, reduce=self.reduce_mode, patchify=self.patchify,
            )
            return self.output_proj(out)

        offsets = off_flat.reshape(b, q, h, l, p, 2)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            sizes = torch.tensor(
                [[w_, h_] for (h_, w_) in spatial_shapes], dtype=torch.float32,
                device=query.device,
            )  # [L, 2] as (w, h)
            loc = ref[:, :, None, :, None, :] + offsets / sizes[None, None, None, :, None, :]
        else:  # cxcywh reference boxes
            loc = (
                ref[:, :, None, :, None, :2]
                + offsets / p * ref[:, :, None, :, None, 2:] * 0.5
            )
        attn = attn.reshape(b, q, h, l, p)
        if self.core == "flat":
            out = ms_deform_attn_core_flat(
                value, spatial_shapes, loc, attn, q_chunk=self.q_chunk
            )
        else:
            out = ms_deform_attn_core_flatpatch(
                value, spatial_shapes, loc, attn, q_chunk=self.q_chunk,
                patchify=self.patchify,
            )
        return self.output_proj(out)
