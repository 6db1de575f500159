"""Bilinear gather from NHWC images, shared by the deformable ops.

Counterpart of ``tair_tpu/ops/sampling.py``: zero padding outside the image,
the bilinear interpolation of torchvision's and detectron2's deformable
convolution and ROIAlign. Plain PyTorch on tensors of any device; no path of
the package calls it yet.
"""

from __future__ import annotations

import torch


def bilinear_sample_nhwc(
    img: torch.Tensor,  # [B, H, W, C]
    x: torch.Tensor,    # [B, ...] pixel x coordinates (0 .. W-1 grid)
    y: torch.Tensor,    # [B, ...] the same shape as x
) -> torch.Tensor:      # [B, ..., C]
    """The four corners of each (x, y) gathered as rows of the flattened
    image and weighted by their bilinear fractions. A corner outside the image
    weighs 0; its row index is clamped into the image first, as the JAX gather
    clamps (torch's would raise)."""
    b, h, w, c = img.shape
    flat = img.reshape(b * h * w, c)
    sample_shape = x.shape[1:]
    x = x.reshape(b, -1)
    y = y.reshape(b, -1)
    boff = torch.arange(b, dtype=torch.int32, device=img.device)[:, None] * (h * w)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    rows, wgts = [], []
    for dx, dy, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (1, 0, fx * (1 - fy)),
        (0, 1, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi = x0 + dx
        yi = y0 + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).to(torch.int32)
        rows.append(boff + idx)
        wgts.append(wgt * valid)

    idx = torch.stack(rows, -1)  # [B, N, 4]
    wgt = torch.stack(wgts, -1)  # [B, N, 4]
    g = flat[idx.reshape(-1).long()].reshape(b, -1, 4, c)
    out = torch.einsum("bnkc,bnk->bnc", g, wgt.to(g.dtype))
    return out.reshape((b,) + tuple(sample_shape) + (c,))
