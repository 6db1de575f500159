"""Multi-scale deformable attention.

Counterpart of ``tair_tpu/spotter/ms_deform_attn.py`` for the lane-packed
``flatlanes`` core with the kernel reduce: every per-sample-point tensor keeps
the (head, level, point) axis folded to ``H*L*P`` lanes, each sample point
gathers one packed row holding its 2x2 bilinear neighbourhood, and
``ops.msda_reduce.msda_corner_reduce`` weights the corners and sums over
(level, point). The math is grid_sample(align_corners=False,
padding_mode='zeros'). ``ms_deform_attn_core`` is the four-gathers-per-level
reference that the tests hold the packed core against. The other cores and
reduce modes of the JAX module are layout alternates of the same function and
are not part of this slice; neither is query chunking.

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
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.msda_reduce import msda_corner_reduce


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


def patchify_value(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
) -> torch.Tensor:                       # [B*H*S, 4*D]
    """Pack each position's 2x2 bilinear neighbourhood into one row:
    row(y, x) = [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)], zeros past the
    border, so every sample point is a single gathered row."""
    b, s, h, d = value.shape
    vt = value.permute(0, 2, 1, 3)  # [B, H, S, D]
    pieces = []
    start = 0
    for (hl, wl) in spatial_shapes:
        vl = vt[:, :, start : start + hl * wl].reshape(b, h, hl, wl, d)
        start += hl * wl
        packed = vl.new_zeros((b, h, hl, wl, 4 * d))
        packed[..., :d] = vl
        packed[:, :, :, : wl - 1, d : 2 * d] = vl[:, :, :, 1:]
        packed[:, :, : hl - 1, :, 2 * d : 3 * d] = vl[:, :, 1:]
        packed[:, :, : hl - 1, : wl - 1, 3 * d :] = vl[:, :, 1:, 1:]
        pieces.append(packed.reshape(b, h, hl * wl, 4 * d))
    return torch.cat(pieces, dim=2).reshape(b * h * s, 4 * d)


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


def ms_deform_attn_core_flatlanes(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    locx: torch.Tensor,                  # [B, Q, H*L*P] packed, lane=(h,l,p)
    locy: torch.Tensor,                  # [B, Q, H*L*P]
    attn: torch.Tensor,                  # [B, Q, H*L*P] softmaxed per head
) -> torch.Tensor:                       # [B, Q, H*D]
    b, s, h, d = value.shape
    _, q, lanes = locx.shape
    L = len(spatial_shapes)
    p = lanes // (h * L)
    dev = value.device

    c = _lane_tensors(tuple(map(tuple, spatial_shapes)), h, p, dev)
    wl, hlv, start, h_vec = c["wl"], c["hl"], c["start"], c["h"]

    vp = patchify_value(value, spatial_shapes)

    x = locx.float() * wl - 0.5
    y = locy.float() * hlv - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sx = torch.minimum(torch.maximum(x0, zero), torch.clamp(wl - 2.0, min=0.0))
    sy = torch.minimum(torch.maximum(y0, zero), torch.clamp(hlv - 2.0, min=0.0))

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

    wxl, wxr = axis_weights(sx, x0, fx, wl)
    wyl, wyr = axis_weights(sy, y0, fy, hlv)

    aw = attn.float()
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
    out = msda_corner_reduce(
        g,
        w00.reshape(b * q, lanes),
        w01.reshape(b * q, lanes),
        w10.reshape(b * q, lanes),
        w11.reshape(b * q, lanes),
        L * p,
    )  # [B*Q*H, D] float32
    return out.reshape(b, q, h * d).to(value.dtype)


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
    """

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model = d_model
        self.n_levels = n_levels
        self.n_heads = n_heads
        self.n_points = n_points
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

        value = self.value_proj(value_flatten).reshape(b, s, h, d)
        off_flat = self.sampling_offsets(query).float()  # lanes are (h,l,p,2), xy minor
        offx = off_flat[..., 0::2]
        offy = off_flat[..., 1::2]
        attn = self.attention_weights(query).reshape(b, q, h, l * p)
        attn = torch.softmax(attn.float(), dim=-1).reshape(b, q, lanes)

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

        out = ms_deform_attn_core_flatlanes(value, spatial_shapes, locx, locy, attn)
        return self.output_proj(out)
