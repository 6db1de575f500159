"""Degradation ops on the device: blur, unsharp mask, noise, canvas resize.

Counterpart of ``tair_tpu/data/degradation.py``. Images are NHWC float32 on
any device. The random fields of the noises come in as tensors (the JAX
functions take a key instead) or are drawn from a ``torch.Generator`` on the
image's device. Poisson noise quantises to 256 levels, as the JAX function
does.

``filter2d`` pads by reflection as ``jnp.pad(..., "reflect")`` does, which
reflects again when the pad is wider than the image (``F.pad`` raises there).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .resize import scale_and_translate


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of the n + 2 * pad positions of a reflect-padded
    axis of size n, reflecting as often as the pad needs (numpy's rule)."""
    pos = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(pos)
    period = 2 * (n - 1)
    m = pos.remainder(period)
    return torch.where(m < n, m, period - m)


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC image padded by `pad` pixels on both spatial axes, by reflection."""
    _, h, w, _ = img.shape
    img = img.index_select(1, reflect_index(h, pad, img.device))
    return img.index_select(2, reflect_index(w, pad, img.device))


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], kernel [B,k,k] (odd k) -> same-size correlation of each
    image with its own kernel over a reflect-padded border."""
    b, h, w, c = img.shape
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"filter2d takes an odd kernel size, got {k}")
    p = k // 2
    x = reflect_pad(img, p)
    # batch folded into channel groups: one grouped convolution
    x = x.permute(0, 3, 1, 2).reshape(1, b * c, h + 2 * p, w + 2 * p)
    weight = kernel.to(img.dtype)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    out = F.conv2d(x, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _gaussian_kernel_1d(radius: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sigma<=0 -> 0.3*((k-1)*0.5-1)+0.8."""
    k = radius
    if sigma <= 0:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def usm_sharpen(
    img: torch.Tensor, radius: int = 51, weight: float = 0.5, threshold: float = 10.0
) -> torch.Tensor:
    """Unsharp mask with a soft threshold mask (RealESRGAN's USMSharp)."""
    g1 = _gaussian_kernel_1d(radius)
    kernel = torch.from_numpy(np.outer(g1, g1)).to(img.device)[None]
    kernel = kernel.expand(img.shape[0], -1, -1)
    blur = filter2d(img, kernel)
    residual = img - blur
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d(mask, kernel)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img


def add_gaussian_noise(
    img: torch.Tensor,
    sigma: torch.Tensor,       # [B] in [0, 255] scale
    gray_mask: torch.Tensor,   # [B] in {0,1}
    clip: bool = True,
    normal: Optional[torch.Tensor] = None,       # [B,H,W,C] standard normal
    normal_gray: Optional[torch.Tensor] = None,  # [B,H,W,1]
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    b, h, w, c = img.shape
    if normal is None:
        normal = torch.randn(img.shape, device=img.device, generator=generator)
    if normal_gray is None:
        normal_gray = torch.randn((b, h, w, 1), device=img.device, generator=generator)
    sigma = sigma.reshape(b, 1, 1, 1) / 255.0
    g = gray_mask.reshape(b, 1, 1, 1).float()
    out = img + (normal * sigma) * (1 - g) + (normal_gray * sigma) * g
    return out.clamp(0.0, 1.0) if clip else out


def add_poisson_noise(
    img: torch.Tensor,
    scale: torch.Tensor,       # [B]
    gray_mask: torch.Tensor,   # [B] in {0,1}
    clip: bool = True,
    levels: float = 256.0,
    poisson: Optional[torch.Tensor] = None,       # [B,H,W,C] counts drawn at base*levels
    poisson_gray: Optional[torch.Tensor] = None,  # [B,H,W] counts drawn at luma*levels
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    b = img.shape[0]
    base = torch.round(img * 255.0).clamp(0, 255) / 255.0
    if poisson is None:
        poisson = torch.poisson(base * levels, generator=generator)
    noise = poisson.float() / levels - base

    luma = torch.round(
        (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]) * 255.0
    ).clamp(0, 255) / 255.0
    if poisson_gray is None:
        poisson_gray = torch.poisson(luma * levels, generator=generator)
    noise_g = (poisson_gray.float() / levels - luma)[..., None]

    g = gray_mask.reshape(b, 1, 1, 1).float()
    s = scale.reshape(b, 1, 1, 1)
    out = img + (noise * (1 - g) + noise_g * g) * s
    return out.clamp(0.0, 1.0) if clip else out


def resize_on_canvas(
    img: torch.Tensor,      # [B, H, W, C]: content fills the top-left corner
    pixel_scale: float,     # out_content_px = in_content_px * s
    out_shape: Tuple[int, int],
    method: str = "linear",
) -> torch.Tensor:
    """Rescale top-left-anchored content onto a canvas of `out_shape`: input
    pixel i maps to output coordinate i * scale, so content on [0:n) lands on
    [0:n*s); the rest of the canvas stays about zero (a few pixels of bleed
    from the resampling kernel at the content's edge)."""
    return scale_and_translate(img, out_shape, pixel_scale, 0.0, method, antialias=True)
