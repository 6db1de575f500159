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

The kernel works through a table of tiles (``band_schedule``), one per block:
a band of image rows of one level, one batch element and a group of heads. The
wrapper builds the table once per geometry, keeps it on the device, and binds
the kernel's C entry once. ``_launch_per_piece`` launches the kernel's first
design (one thread per 16-byte piece); no path of the port calls it, and
``chip_smoke.py`` times it in turns with the band design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

Shapes = Sequence[Tuple[int, int]]
MAX_LEVELS = 8  # of the first design's level table

# the band kernel's block and its shared-memory slab (csrc/patchify.cu
# kThreads, kSlabBytes), and the wrapper's tiles: heads per tile (the largest
# divisor of H not above HEAD_GROUP) and output rows of one head per tile (a
# band of max(1, BAND_TOKENS // wl) image rows)
THREADS = 256
SLAB_BYTES = 96 * 1024
HEAD_GROUP = 2
BAND_TOKENS = 64
TILE_FIELDS = ("b", "h0", "start", "hl", "wl", "y0", "rows", "x0", "cols")

# kernel launches made by the wrapper (never raised by the plain version): the
# band kernel, and the first design (only ever launched by chip_smoke.py's timing)
launches = {"fwd": 0, "fwd_per_piece": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(shape: torch.Size, spatial_shapes: Shapes) -> None:
    if len(shape) != 4:
        raise ValueError("value must be [B, S, H, D]")
    if sum(hl * wl for hl, wl in spatial_shapes) != shape[1]:
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
    _check(value.shape, spatial_shapes)
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


def _divisor_at_most(n: int, cap: int) -> int:
    return max(k for k in range(1, min(cap, n) + 1) if n % k == 0)


def band_schedule(
    spatial_shapes: Shapes, b: int, h: int, d: int, elem_bytes: int,
    head_group: int = HEAD_GROUP, band_tokens: int = BAND_TOKENS,
) -> Tuple[np.ndarray, int, int]:
    """The band kernel's tiles for value [b, S, h, d] of `elem_bytes`-byte
    elements: (int32 [n, 9] with the fields of TILE_FIELDS, heads per tile,
    the largest tile's slab bytes). A tile is `rows` image rows from `y0` and
    `cols` columns from `x0` of one level (first token `start`, hl x wl) of
    batch element `b`, for heads h0 .. h0 + G - 1. Its slab holds those rows
    plus the row below and the column to the right where the level has them,
    each token's G*d values: never more than SLAB_BYTES. A level whose two
    rows do not fit is cut into runs of columns. Tiles cover every (batch,
    head, level, row, column) once, in the order batch, level, head group,
    band, column run."""
    if d * elem_bytes % 16 or 4 * d * elem_bytes > 16 * THREADS:
        raise ValueError(
            f"the patchify kernel needs D * {elem_bytes} bytes a multiple of 16 and at "
            f"most {4 * THREADS} bytes, got D={d}"
        )
    g = _divisor_at_most(h, head_group)
    # a 2 x 2 slab fits, and one token of the group is at most a piece a thread
    while g > 1 and (4 * g * d * elem_bytes > SLAB_BYTES or g * d * elem_bytes > 16 * THREADS):
        g = _divisor_at_most(h, g - 1)
    tok = g * d * elem_bytes  # one token of the group in the slab
    tiles = []
    start = 0
    for hl, wl in spatial_shapes:
        cols = wl if 2 * wl * tok <= SLAB_BYTES else SLAB_BYTES // (2 * tok) - 1
        rows = min(max(band_tokens // cols, 1), hl)
        while rows > 1 and (rows + 1) * (cols + (cols < wl)) * tok > SLAB_BYTES:
            rows -= 1
        for bb in range(b):
            for h0 in range(0, h, g):
                for y0 in range(0, hl, rows):
                    for x0 in range(0, wl, cols):
                        tiles.append((bb, h0, start, hl, wl, y0, min(rows, hl - y0),
                                      x0, min(cols, wl - x0)))
        start += hl * wl
    t = np.asarray(tiles, dtype=np.int32).reshape(-1, len(TILE_FIELDS))
    _, _, _, hl, wl, y0, rows, x0, cols = t.T.astype(np.int64)
    staged = (rows + (y0 + rows < hl)) * (cols + (x0 + cols < wl)) * tok
    return t, g, int(staged.max(initial=0))


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# value, out, tiles, n_tiles, S, H, D, G, elem_bytes, strides, slab bytes, stream
_FWD_ARGTYPES = [_PTR] * 3 + [_INT] * 6 + [_I64] * 3 + [_INT, _PTR]
# value, out, B, S, H, D, elem_bytes, strides, level_hw, n_levels, stream
_PER_PIECE_ARGTYPES = [_PTR] * 2 + [_I64] + [_INT] * 4 + [_I64] * 3 + [_PTR, _INT, _PTR]
_FWD = {}  # the band kernel's C entry, bound at its first call


@functools.lru_cache(maxsize=None)
def _plan(levels, shape: torch.Size, elem_bytes: int, device: torch.device) -> tuple:
    """The band kernel's tiles for one geometry, on the device: (tiles, their
    count, heads per tile, slab bytes). Checked and made at the geometry's
    first call, before any CUDA graph captures a launch of it. A process sees
    few geometries, and a plan is never evicted: the kernel reads the tile
    table through its address, so a captured launch stays valid as long as
    the process."""
    _check(shape, levels)
    b, _, h, d = shape
    tiles, g, slab = band_schedule(levels, b, h, d, elem_bytes)
    return torch.from_numpy(tiles).to(device), len(tiles), g, slab


def _kernel_input(value: torch.Tensor) -> torch.Tensor:
    """value as the kernels read it: through its strides, or, for a view whose
    rows do not start on 16-byte boundaries, a contiguous copy."""
    if value.dim() != 4:
        raise ValueError("value must be [B, S, H, D]")
    es = value.element_size()
    per = 16 // es if 16 % es == 0 else 0
    if not per or value.shape[3] % per:
        raise ValueError(
            f"patchify kernel needs D a multiple of one 16-byte piece "
            f"({per or '?'} elements of {value.dtype}), got D={value.shape[3]}"
        )
    if (
        value.stride(3) != 1
        or any(st % per for st in value.stride()[:3])
        or value.data_ptr() % 16
    ):
        value = value.contiguous()
    return value


def _raise_for(err: int, value: torch.Tensor, levels) -> None:
    if err == -1:
        raise ValueError(
            f"patchify kernel does not take value {tuple(value.shape)} {value.dtype} "
            f"with levels {tuple(levels)}"
        )
    if err != 0:
        raise RuntimeError(f"patchify_value_fwd launch failed with CUDA error {err}")


def _launch(value: torch.Tensor, levels: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """One launch of the band kernel."""
    value = _kernel_input(value)
    b, s, h, d = value.shape
    tiles, n, g, slab = _plan(levels, value.shape, value.element_size(), value.device)
    out = torch.empty((b * h * s, 4 * d), dtype=value.dtype, device=value.device)
    fn = _FWD.get("fwd")
    if fn is None:
        fn = _FWD["fwd"] = _build.library("patchify").patchify_value_fwd
        fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    dev = value.device.index
    args = (value.data_ptr(), out.data_ptr(), tiles.data_ptr(), n, s, h, d, g,
            value.element_size(), *value.stride()[:3], slab,
            # the current stream's handle, without building a Stream object
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    _raise_for(err, value, levels)
    launches["fwd"] += 1
    return out


def _launch_per_piece(value: torch.Tensor, levels: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """One launch of the first design, with its wrapper's host work as it was:
    the entry typed, the level array made and the device entered on every
    call."""
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"the first patchify design takes at most {MAX_LEVELS} levels")
    value = _kernel_input(value)
    b, s, h, d = value.shape
    out = torch.empty((b * h * s, 4 * d), dtype=value.dtype, device=value.device)
    fn = _build.library("patchify").patchify_value_fwd_per_piece
    fn.argtypes, fn.restype = _PER_PIECE_ARGTYPES, ctypes.c_int
    level_hw = (ctypes.c_int * (2 * len(levels)))(*(n for hw in levels for n in hw))
    with torch.cuda.device(value.device):
        err = fn(
            value.data_ptr(), out.data_ptr(), b, s, h, d, value.element_size(),
            *value.stride()[:3], level_hw, len(levels),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_for(err, value, levels)
    launches["fwd_per_piece"] += 1
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
    levels = tuple((int(hl), int(wl)) for hl, wl in spatial_shapes)
    if value.device.type == "cuda":
        if value.requires_grad and torch.is_grad_enabled():
            return _PatchifyValue.apply(value, levels)
        # no graph to record: no autograd bookkeeping; the levels are checked
        # with the geometry's first call
        return _launch(value, levels)
    _check(value.shape, levels)
    if value.device.type != "cpu":
        raise RuntimeError(f"patchify_value_kernel has no kernel for device {value.device}")
    return _PatchifyValue.apply(value, levels)
