"""2x2-neighbourhood row packing for multi-scale deformable attention: the
CUDA kernel's wrapper and its plain version.

Counterpart of ``tair_tpu/ops/patchify.py``. The packed msda cores gather one
row per sample point from a table in which row ``(b, h, y, x)`` holds the
position's bilinear neighbourhood, corner-major:

    table[(b*H + h)*S + s, c*D:(c+1)*D] = value[b, s + dy*wl + dx, h, :]   (c = 2*dy + dx)

with zeros where ``x + dx`` or ``y + dy`` leaves the level. ``patchify_value``
builds it with tensor ops, level by level; ``patchify_value_kernel`` builds it
with one launch of ``csrc/patchify.cu`` on a CUDA tensor and through
``patchify_value`` only for a tensor that lies on the CPU. Both move values
and never round, so they agree bit for bit. ``patchify_value_kernel`` is
differentiable: its backward is the transposed shift-and-add, summed in
float32 and cast to the cotangent's type, in tensor ops on either device (the
JAX package has no backward kernel for it either).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

Shapes = Sequence[Tuple[int, int]]
MAX_LEVELS = 8

# kernel launches made by the wrapper (never raised by the plain version)
launches = {"fwd": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(value: torch.Tensor, spatial_shapes: Shapes) -> None:
    if value.dim() != 4:
        raise ValueError("value must be [B, S, H, D]")
    if sum(hl * wl for hl, wl in spatial_shapes) != value.shape[1]:
        raise ValueError("spatial_shapes do not add up to the value's token count")
    if any(hl < 1 or wl < 1 for hl, wl in spatial_shapes):
        raise ValueError("every level needs at least one row and one column")


def patchify_value(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Shapes,
) -> torch.Tensor:                       # [B*H*S, 4*D]
    """Pack each position's 2x2 bilinear neighbourhood into one row:
    row(y, x) = [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)], zeros past the
    border, so every sample point is a single gathered row."""
    _check(value, spatial_shapes)
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


def patchify_value_bwd_plain(
    dtable: torch.Tensor,                # [B*H*S, 4*D] cotangent of the table
    value_shape: Tuple[int, int, int, int],
    spatial_shapes: Shapes,
) -> torch.Tensor:                       # [B, S, H, D] in the cotangent's type
    """Transpose of "read four shifted copies": corner (dy, dx) of row (y, x)
    read v(y+dy, x+dx), so its cotangent is added back there. Float32 sums."""
    b, s, h, d = value_shape
    g = dtable.reshape(b, h, s, 4 * d)
    out = torch.zeros((b, h, s, d), dtype=torch.float32, device=dtable.device)
    start = 0
    for (hl, wl) in spatial_shapes:
        gl = g[:, :, start : start + hl * wl].reshape(b, h, hl, wl, 4 * d).float()
        acc = out[:, :, start : start + hl * wl].view(b, h, hl, wl, d)
        start += hl * wl
        acc += gl[..., :d]
        acc[:, :, :, 1:] += gl[:, :, :, : wl - 1, d : 2 * d]
        acc[:, :, 1:] += gl[:, :, : hl - 1, :, 2 * d : 3 * d]
        acc[:, :, 1:, 1:] += gl[:, :, : hl - 1, : wl - 1, 3 * d :]
    return out.permute(0, 2, 1, 3).to(dtable.dtype)


def _launch(value: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    b, s, h, d = value.shape
    per = 16 // value.element_size() if 16 % value.element_size() == 0 else 0
    if not per or d % per:
        raise ValueError(
            f"patchify kernel needs D a multiple of one 16-byte piece "
            f"({per or '?'} elements of {value.dtype}), got D={d}"
        )
    if len(spatial_shapes) > MAX_LEVELS:
        raise ValueError(f"patchify kernel takes at most {MAX_LEVELS} levels")
    # the kernel reads value through its strides; a view whose rows do not
    # start on 16-byte boundaries is copied once
    if (
        value.stride(3) != 1
        or any(st % per for st in value.stride()[:3])
        or value.data_ptr() % 16
    ):
        value = value.contiguous()
    out = torch.empty((b * h * s, 4 * d), dtype=value.dtype, device=value.device)

    lib = _build.library("patchify")
    fn = lib.patchify_value_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 2
        + [ctypes.c_int64]
        + [ctypes.c_int] * 4
        + [ctypes.c_int64] * 3
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    level_hw = (ctypes.c_int * (2 * len(spatial_shapes)))(
        *(int(n) for hw in spatial_shapes for n in hw)
    )
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            value.data_ptr(), out.data_ptr(), b, s, h, d, value.element_size(),
            *value.stride()[:3], level_hw, len(spatial_shapes), stream,
        )
    if err == -1:
        raise ValueError(
            f"patchify kernel does not take value {tuple(value.shape)} {value.dtype} "
            f"with levels {tuple(spatial_shapes)}"
        )
    if err != 0:
        raise RuntimeError(f"patchify_value_fwd launch failed with CUDA error {err}")
    launches["fwd"] += 1
    return out


class _PatchifyValue(torch.autograd.Function):
    """The packing kernel; on a CPU tensor, its plain version. The backward
    is tensor ops on either device."""

    @staticmethod
    def forward(ctx, value, spatial_shapes):
        ctx.value_shape = tuple(value.shape)
        ctx.spatial_shapes = spatial_shapes
        if value.device.type == "cuda":
            return _launch(value, spatial_shapes)
        return patchify_value(value, spatial_shapes)

    @staticmethod
    def backward(ctx, dtable):
        return patchify_value_bwd_plain(dtable, ctx.value_shape, ctx.spatial_shapes), None


def patchify_value_kernel(
    value: torch.Tensor,                 # [B, S, H, D]
    spatial_shapes: Shapes,
) -> torch.Tensor:                       # [B*H*S, 4*D], value's type
    _check(value, spatial_shapes)
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"patchify_value_kernel has no kernel for device {value.device}")
    return _PatchifyValue.apply(value, tuple((int(hl), int(wl)) for hl, wl in spatial_shapes))
