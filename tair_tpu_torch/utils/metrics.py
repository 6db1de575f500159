"""Image-quality metrics (PSNR, SSIM) and the wavelet colour fix.

Counterpart of ``tair_tpu/utils/metrics.py``. Images are NHWC float tensors;
every metric computes in float32 and returns one value per image. The learned
no-reference metrics of the JAX package (NIQE, MUSIQ, MANIQA, CLIP-IQA) and the
perceptual ones (LPIPS, DISTS) are not part of the port yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.degradation import reflect_pad


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over NHWC batches -> [B]."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val**2 / mse.clamp(min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _depthwise(x: torch.Tensor, window: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """VALID depthwise correlation of NHWC x with one 2D window."""
    c = x.shape[-1]
    k = window.shape[0]
    weight = window[None, None].expand(c, 1, k, k)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def ssim(
    a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
    size: int = 11, sigma: float = 1.5,
) -> torch.Tensor:
    """Standard single-scale SSIM (gaussian window), per image -> [B]."""
    a = a.float()
    b = b.float()
    w = _gaussian_window(size, sigma, a.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_a = _depthwise(a, w)
    mu_b = _depthwise(b, w)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _depthwise(a * a, w) - mu_aa
    s_bb = _depthwise(b * b, w) - mu_bb
    s_ab = _depthwise(a * b, w) - mu_ab

    m = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / ((mu_aa + mu_bb + c1) * (s_aa + s_bb + c2))
    return m.mean(dim=(1, 2, 3))


def _gaussian_blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    """3x3 binomial blur with dilation `radius` over a reflect-padded border
    (reflected again where the pad is wider than the image, as ``jnp.pad``)."""
    k1 = torch.tensor([0.25, 0.5, 0.25], device=x.device)
    return _depthwise(reflect_pad(x, radius), torch.outer(k1, k1), dilation=radius)


def wavelet_decompose(x: torch.Tensor, levels: int = 5):
    """(high_freq, low_freq) via iterated dilated blurs."""
    high = torch.zeros_like(x)
    low = x
    for i in range(levels):
        blurred = _gaussian_blur(low, 2**i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_reconstruction(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Keep content's high frequencies, adopt style's colour (low frequencies):
    the DiffBIR colour fix."""
    content_high, _ = wavelet_decompose(content)
    _, style_low = wavelet_decompose(style)
    return content_high + style_low
