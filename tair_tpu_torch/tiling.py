"""Tiled (patch-based) restoration: batched split -> restore -> blend-merge,
and gaussian-blended tiled application of a function (tiled latent sampling).

Counterpart of ``tair_tpu/tiling.py``: 128² input patches with a 16-px
overlap, each upscaled x4 (bicubic) and restored at 512², merged with a linear
edge-fade window at the 512-px patch / 64-px overlap scale and cropped to 4x
the original size. All patches of an image form one batch (or ``chunk``-sized
batches of it), as in the JAX package.

Where it departs from the JAX module: images are tensors [H, W, C] on any
device; the x4 upscale is ``data.resize.resize`` (``jax.image.resize``'s
Keys cubic, a = -0.5, not ``F.interpolate``'s -0.75); randomness is a
``torch.Generator`` (see ``restore_tiled``). The merge is a Python loop over
the patches in row-major order in float32, so the overlaps sum in the order
of JAX's ``lax.scan``. ``make_tiled_fn`` runs all tiles through one batched
call and blends them with ``gaussian_window`` on a float32 canvas, in the
JAX function's order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data.resize import resize
from .models.layers import edge_pad
from .utils.device_constants import cached


def split_grid(height: int, width: int, patch: int = 128, overlap: int = 16):
    """Grid geometry: (n_h, n_w, padded_h, padded_w)."""
    stride = patch - overlap
    n_h = math.ceil((height - overlap) / stride)
    n_w = math.ceil((width - overlap) / stride)
    return n_h, n_w, (n_h - 1) * stride + patch, (n_w - 1) * stride + patch


def split_with_overlap(image: torch.Tensor, patch: int = 128, overlap: int = 16) -> torch.Tensor:
    """[H, W, C] -> [N, patch, patch, C], row-major; zero-pad bottom/right."""
    h, w, _ = image.shape
    stride = patch - overlap
    n_h, n_w, ph, pw = split_grid(h, w, patch, overlap)
    x = F.pad(image, (0, 0, 0, pw - w, 0, ph - h))
    return torch.stack([
        x[r * stride : r * stride + patch, c * stride : c * stride + patch]
        for r in range(n_h) for c in range(n_w)
    ])


def fade_window(patch: int, overlap: int) -> np.ndarray:
    """Linear edge fade on all four sides (the fork's val_patches.py:151-163)."""
    window = np.ones((patch, patch), np.float32)
    for i in range(overlap):
        k = (i + 1) / overlap
        window[i, :] *= k
        window[-(i + 1), :] *= k
        window[:, i] *= k
        window[:, -(i + 1)] *= k
    return window


def merge_with_overlap(
    patches: torch.Tensor,          # [N, P, P, C] restored patches (row-major)
    original_hw: Tuple[int, int],   # size the INPUT image had
    in_patch: int = 128,
    in_overlap: int = 16,
    out_patch: int = 512,
    out_overlap: int = 64,
) -> torch.Tensor:
    """Weighted blend-merge; returns [H*scale, W*scale, C] float32 where scale
    = out_patch / in_patch."""
    h0, w0 = original_hw
    n_h, n_w, _, _ = split_grid(h0, w0, in_patch, in_overlap)
    stride = out_patch - out_overlap
    fh = (n_h - 1) * stride + out_patch
    fw = (n_w - 1) * stride + out_patch
    c = patches.shape[-1]
    dev = patches.device

    window = cached(("fade_window", out_patch, out_overlap), dev,
                    lambda: fade_window(out_patch, out_overlap))[..., None]
    canvas = torch.zeros((fh, fw, c), dtype=torch.float32, device=dev)
    weights = torch.zeros((fh, fw, 1), dtype=torch.float32, device=dev)
    for i in range(n_h * n_w):
        hs, ws = (i // n_w) * stride, (i % n_w) * stride
        region = (slice(hs, hs + out_patch), slice(ws, ws + out_patch))
        canvas[region] = canvas[region] + patches[i].float() * window
        weights[region] = weights[region] + window
    merged = canvas / weights.clamp(min=1e-8)
    return merged[: h0 * out_patch // in_patch, : w0 * out_patch // in_patch]


def restore_tiled(
    restore_batch_fn: Callable,
    image: torch.Tensor,            # [H, W, C] LQ in [0,1]
    generator: Optional[torch.Generator] = None,
    patch: int = 128,
    overlap: int = 16,
    out_scale: int = 4,
    chunk: Optional[int] = None,
    return_aux: bool = False,
):
    """Split -> batched restore -> merge. `restore_batch_fn(lq_batch,
    generator)` maps [B, patch*out_scale, patch*out_scale, C] -> the same
    shape (the patches are upscaled x out_scale with the cubic kernel first
    and clipped to [0, 1]). `chunk` bounds the batch: the patches are
    restored in ceil(N/chunk) batches of `chunk`, the last padded with zero
    patches. Each batch draws its randomness from `generator` in turn, after
    the batches before it (the JAX module folds the chunk index into its key
    instead), so a chunked run is reproducible from the generator's seed.

    return_aux=True: `restore_batch_fn` returns (restored, aux), aux a dict
    of tensors with a leading per-patch dimension; then (merged, aux) is
    returned with aux's tensors joined to [n_patches, ...] (per-patch
    spotter decodes for a submission dump)."""
    h, w, c = image.shape
    patches = split_with_overlap(image, patch, overlap)
    n = patches.shape[0]
    big = patch * out_scale

    def call(p):
        up = resize(p.float(), (big, big), "cubic").clamp(0.0, 1.0)
        out = restore_batch_fn(up, generator)
        return out if return_aux else (out, None)

    if chunk is None or chunk == n:
        restored, aux = call(patches)
    else:
        # chunk at the small patch size: only `chunk` patches are ever held
        # at the restore resolution
        pad = (-n) % chunk
        patches_p = F.pad(patches, (0, 0, 0, 0, 0, 0, 0, pad))
        outs, auxes = [], []
        for i in range(patches_p.shape[0] // chunk):
            ri, ai = call(patches_p[i * chunk : (i + 1) * chunk])
            outs.append(ri)
            auxes.append(ai)
        restored = torch.cat(outs, 0)[:n]
        aux = (
            {k: torch.cat([a[k] for a in auxes], 0)[:n] for k in auxes[0]}
            if return_aux else None
        )

    merged = merge_with_overlap(restored, (h, w), patch, overlap, big, overlap * out_scale)
    return (merged, aux) if return_aux else merged


def gaussian_window(patch: int, var: float = 0.01) -> np.ndarray:
    """DiffBIR's gaussian tile weights: a separable gaussian over normalized
    tile coordinates, peaked at the tile centre (float32 [patch, patch])."""
    xs = (np.arange(patch) - patch / 2 + 0.5) / patch
    g = np.exp(-(xs**2) / (2 * var)) / np.sqrt(2 * np.pi * var)
    return np.outer(g, g).astype(np.float32)


def make_tiled_fn(fn: Callable, size: int, stride: int, window: str = "gaussian"):
    """Gaussian-blended sliding-window application of a function that keeps
    the spatial size (DiffBIR's make_tiled_fn, used for tiled latent sampling);
    `window="fade"` blends with `fade_window` instead, its linear ramps as wide
    as the tiles' overlap (at least 1; none with a stride of 0).

    `fn(x_tile, *extra_tiles, **kwargs)` maps [n_tiles * B, size, size, C] (the
    tiles in row-major order, each tile's B rows together; any extra arrays
    tiled over the same H, W grid; keyword arguments passed through as they
    are) -> [n_tiles * B, size, size, C']. The last row and column of tiles
    snap to the edge; an axis smaller than the tile is edge-padded and cropped
    back; an input no larger than one tile goes to `fn` whole. The blend sums
    in float32 with a 1e-12 floor on the weights and returns the tiles' dtype.
    The window and the weight map are made once per grid and device."""
    if window == "gaussian":
        win_np, win_key = gaussian_window(size), ("gaussian_window", size)
    else:
        overlap = stride and max(size - stride, 1)
        win_np, win_key = fade_window(size, overlap), ("fade_window", size, overlap)
    grids = {}  # (padded h, padded w, device) -> (tile positions, window, 1 / weights)

    def starts(extent: int):
        ss = list(range(0, extent - size + 1, stride))
        if not ss or ss[-1] != extent - size:
            ss.append(extent - size)
        return ss

    def grid(h: int, w: int, device):
        key = (h, w, device)
        if key not in grids:
            pos = [(i, j) for i in starts(h) for j in starts(w)]
            win = cached(win_key, device, lambda: win_np)[..., None]
            weights = torch.zeros((1, h, w, 1), dtype=torch.float32, device=device)
            for i, j in pos:
                weights[:, i : i + size, j : j + size] += win
            # corner gaussian weights get as small as ~5e-9; the floor stays below them
            grids[key] = pos, win, weights.clamp(min=1e-12)
        return grids[key]

    def tiled(x: torch.Tensor, *extras: torch.Tensor, **kwargs) -> torch.Tensor:
        b, h, w, _ = x.shape
        if h <= size and w <= size:
            return fn(x, *extras, **kwargs)
        ph, pw = max(size - h, 0), max(size - w, 0)
        if ph or pw:
            x = edge_pad(x, ph, pw)
            extras = tuple(edge_pad(e, ph, pw) for e in extras)
        pos, win, weights = grid(h + ph, w + pw, x.device)

        def grab(a):
            return torch.cat([a[:, i : i + size, j : j + size] for (i, j) in pos], dim=0)

        tiles_out = fn(grab(x), *[grab(e) for e in extras], **kwargs)
        co = tiles_out.shape[-1]
        tiles_out = tiles_out.reshape(len(pos), b, size, size, co)
        canvas = torch.zeros((b, h + ph, w + pw, co), dtype=torch.float32, device=x.device)
        for k, (i, j) in enumerate(pos):
            canvas[:, i : i + size, j : j + size] += tiles_out[k].float() * win
        return (canvas / weights).to(tiles_out.dtype)[:, :h, :w]

    return tiled
