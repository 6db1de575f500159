"""ROIAlignRotated by bilinear grid sampling.

Counterpart of ``tair_tpu/ops/roi_align_rotated.py`` (detectron2's
ROIAlignRotated): each rotated ROI (cx, cy, w, h, angle in degrees, image
coordinates) is pooled to a fixed P x P output by averaging
``sampling_ratio``^2 bilinear samples per bin; one batched gather and a mean,
no loop over ROIs. NHWC. Plain PyTorch; no path of the package calls it yet.
"""

from __future__ import annotations

import torch

from .sampling import bilinear_sample_nhwc


def roi_align_rotated(
    feats: torch.Tensor,  # [B, H, W, C]
    rois: torch.Tensor,   # [N, 6]: (batch index, cx, cy, w, h, angle_deg)
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:        # [N, P, P, C]
    p = output_size
    s = sampling_ratio
    n = rois.shape[0]

    batch_idx = rois[:, 0].to(torch.int32)  # truncated, as JAX's astype
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    w = torch.clamp(rois[:, 3] * spatial_scale, min=1.0)
    h = torch.clamp(rois[:, 4] * spatial_scale, min=1.0)
    theta = torch.deg2rad(rois[:, 5])

    # sample grid in ROI-local coordinates, bin-averaged: p*s points per axis
    g = (torch.arange(p * s, dtype=torch.float32, device=rois.device) + 0.5) / (p * s) - 0.5
    ly, lx = torch.meshgrid(g, g, indexing="ij")  # [ps, ps]

    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    rx = lx[None] * w[:, None, None]
    ry = ly[None] * h[:, None, None]
    x = cx[:, None, None] + rx * cos_t - ry * sin_t  # [N, ps, ps]
    y = cy[:, None, None] + rx * sin_t + ry * cos_t

    per_roi_feats = feats[batch_idx.long()]  # [N, H, W, C]
    sampled = bilinear_sample_nhwc(per_roi_feats, x, y)  # [N, ps, ps, C]
    c = sampled.shape[-1]
    return sampled.reshape(n, p, s, p, s, c).mean(dim=(2, 4))
