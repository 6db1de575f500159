"""Separable image resampling with the semantics of ``jax.image``.

The degradation pipeline of the JAX package resizes with ``jax.image.resize``
and ``jax.image.scale_and_translate``, and its results depend on their exact
rules, none of which ``F.interpolate`` shares:

- pixel centres at ``i + 0.5``; output pixel ``j`` samples the input at
  ``(j + 0.5 - translation) / scale - 0.5``, translation in output pixels;
- ``"linear"`` is the triangle kernel and ``"cubic"`` Keys' kernel with
  a = -0.5 (``F.interpolate``'s bicubic uses -0.75);
- with ``antialias`` a downscale widens the kernel by 1 / scale;
- each output's weights are divided by their sum, so the borders renormalise,
  and an output whose sample point falls outside the input gets no weight;
- ``resize`` leaves an axis whose size does not change untouched.

Each axis's weight matrix [in, out] is built on the host in numpy float32, in
the order of JAX's ``compute_weight_mat``, and applied on the tensor's device
as two matrix products.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

METHODS = ("linear", "cubic")


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0), ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix(
    in_size: int, out_size: int, inv_scale: np.float32, translation: np.float32,
    method: str, antialias: bool,
) -> np.ndarray:
    """[in_size, out_size] float32 weights of one axis (JAX's
    ``compute_weight_mat``). `inv_scale` is 1 / scale as the caller's float32."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; choose from {METHODS}")
    f32 = np.float32
    inv_scale = f32(inv_scale)
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (
        (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
        - f32(translation) * inv_scale - f32(0.5)
    )
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(f32))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0) * f32(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def _apply(img: torch.Tensor, wh, ww) -> torch.Tensor:
    """img [B, H, W, C]; wh [H, H'] or None, ww [W, W'] or None."""
    if wh is not None:
        wh = torch.from_numpy(wh).to(device=img.device, dtype=img.dtype)
        img = torch.einsum("bhwc,hk->bkwc", img, wh)
    if ww is not None:
        ww = torch.from_numpy(ww).to(device=img.device, dtype=img.dtype)
        img = torch.einsum("bhwc,wk->bhkc", img, ww)
    return img


def resize(img: torch.Tensor, out_hw: Tuple[int, int], method: str, antialias: bool = True):
    """``jax.image.resize`` of an NHWC image to spatial size `out_hw`."""
    _, h, w, _ = img.shape
    mats = []
    for n_in, n_out in ((h, out_hw[0]), (w, out_hw[1])):
        if n_in == n_out:
            mats.append(None)
            continue
        # JAX takes the scale as a Python float: 1 / scale is formed in double
        # and rounded to float32 where it meets the float32 sample grid
        inv = np.float32(1.0 / (n_out / n_in))
        mats.append(weight_matrix(n_in, n_out, inv, np.float32(0.0), method, antialias))
    return _apply(img, *mats)


def scale_and_translate(
    img: torch.Tensor, out_hw: Tuple[int, int], scale: float, translation: float,
    method: str, antialias: bool = True,
):
    """``jax.image.scale_and_translate`` of an NHWC image over its two spatial
    axes with one float32 `scale` and `translation` (in output pixels) for
    both."""
    _, h, w, _ = img.shape
    scale = np.float32(scale)
    inv = np.float32(1.0) / scale
    return _apply(
        img,
        weight_matrix(h, out_hw[0], inv, np.float32(translation), method, antialias),
        weight_matrix(w, out_hw[1], inv, np.float32(translation), method, antialias),
    )
