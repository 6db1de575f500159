"""Deformable convolution v1 and modulated v2.

Counterpart of ``tair_tpu/ops/deform_conv.py`` (detectron2's deformable
convolution): the deformable im2col is one batched bilinear gather building
``[B, H', W', K*Cin]``, and the convolution one product with the weight
reshaped to ``[K*Cin, Cout]``; autograd gives the col2im. NHWC, the weight
HWIO, as in the JAX function. Plain PyTorch; no path of the package calls it
yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sampling import bilinear_sample_nhwc


def deform_conv2d(
    x: torch.Tensor,        # [B, H, W, Cin]
    offsets: torch.Tensor,  # [B, H', W', K*2] (dy, dx per kernel tap)
    weight: torch.Tensor,   # [kh, kw, Cin, Cout]
    bias: Optional[torch.Tensor] = None,  # [Cout]
    mask: Optional[torch.Tensor] = None,  # [B, H', W', K] modulation (v2)
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:          # [B, H', W', Cout] in x's type
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    k = kh * kw
    out_h = (h + 2 * padding - kh) // stride + 1
    out_w = (w + 2 * padding - kw) // stride + 1
    if tuple(offsets.shape[:3]) != (b, out_h, out_w):
        raise ValueError(f"offsets {tuple(offsets.shape)} vs output ({b},{out_h},{out_w})")

    # base sampling grid per output position and kernel tap
    dev = x.device
    ys = torch.arange(out_h, device=dev) * stride - padding
    xs = torch.arange(out_w, device=dev) * stride - padding
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev), torch.arange(kw, device=dev),
                            indexing="ij")
    ky = ky.reshape(-1).float()  # [K]
    kx = kx.reshape(-1).float()

    off = offsets.reshape(b, out_h, out_w, k, 2)
    y_pos = ys[None, :, None, None] + ky[None, None, None, :] + off[..., 0]
    x_pos = xs[None, None, :, None] + kx[None, None, None, :] + off[..., 1]

    sampled = bilinear_sample_nhwc(x, x_pos, y_pos)  # [B, H', W', K, Cin]
    if mask is not None:
        sampled = sampled * mask[..., None]

    cols = sampled.reshape(b, out_h, out_w, k * cin)
    wmat = weight.reshape(k * cin, cout)
    out = torch.einsum("bhwk,ko->bhwo", cols.float(), wmat.float()).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out
