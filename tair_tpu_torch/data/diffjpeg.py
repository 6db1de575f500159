"""Differentiable JPEG on the device.

Counterpart of ``tair_tpu/data/diffjpeg.py``: RGB -> YCbCr, 2x2 chroma
averaging, 8x8 block DCT as two small matrix products over all blocks at once,
quality-scaled quantisation with a differentiable rounding surrogate, inverse
DCT, nearest chroma upsampling, merge. Input NHWC in [0, 1]; sizes that are
not multiples of 16 are edge-padded and cropped back.
"""

from __future__ import annotations


import numpy as np
import torch

from ..utils.device_constants import cached

Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)

C_TABLE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D so that coeffs = D @ x @ D.T."""
    d = np.zeros((8, 8), np.float32)
    for u in range(8):
        alpha = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            d[u, x] = alpha * np.cos((2 * x + 1) * u * np.pi / 16)
    return d


_DCT = _dct_matrix()


def _constant(name: str, device: torch.device) -> torch.Tensor:
    """One of the module's constant arrays on `device`, copied there once."""
    return cached(("diffjpeg", name), device, lambda: _CONSTANTS[name])


def quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """Standard JPEG quality -> quantisation scale."""
    q = torch.where(quality < 50, 5000.0 / quality, 200.0 - quality * 2.0)
    return q / 100.0


def _diff_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) + (x - round(x))^3: zero at integers, smooth gradient."""
    r = torch.round(x)
    return r + (x - r) ** 3


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8*W/8, 8, 8]."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _dct2d(blocks: torch.Tensor) -> torch.Tensor:
    d = _constant("dct", blocks.device)
    return torch.einsum("ux,bnxy,vy->bnuv", d, blocks, d)


def _idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    d = _constant("dct", coeffs.device)
    return torch.einsum("xu,bnuv,yv->bnxy", d, coeffs, d)


_RGB_TO_YCC = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    np.float32,
)
_YCC_TO_RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], np.float32
)


_CONSTANTS = {
    "dct": _DCT, "y_table": Y_TABLE, "c_table": C_TABLE,
    "rgb_to_ycc": _RGB_TO_YCC, "ycc_to_rgb": _YCC_TO_RGB,
    "ycc_shift": np.array([0.0, 128.0, 128.0], np.float32),
    "rgb_shift": np.array([0.0, -128.0, -128.0], np.float32),
}


def rgb_to_ycbcr(x255: torch.Tensor) -> torch.Tensor:
    m = _constant("rgb_to_ycc", x255.device)
    shift = _constant("ycc_shift", x255.device)
    return torch.einsum("bhwc,oc->bhwo", x255, m) + shift


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    m = _constant("ycc_to_rgb", x.device)
    shift = _constant("rgb_shift", x.device)
    return torch.einsum("bhwc,oc->bhwo", x + shift, m)


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _upsample_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x[:, :, None, :, None].expand(b, h, 2, w, 2).reshape(b, 2 * h, 2 * w)


def diff_jpeg(image: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """image [B,H,W,3] in [0,1]; quality [B] in [1,100] -> compressed [0,1]."""
    b, h0, w0, _ = image.shape
    ph, pw = (-h0) % 16, (-w0) % 16
    if ph or pw:
        rows = torch.arange(h0 + ph, device=image.device).clamp(max=h0 - 1)
        cols = torch.arange(w0 + pw, device=image.device).clamp(max=w0 - 1)
        image = image.index_select(1, rows).index_select(2, cols)
    b, h, w, _ = image.shape
    factor = quality_to_factor(quality.float())  # [B]

    ycc = rgb_to_ycbcr(image.float() * 255.0)
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    cb, cr = _avg_pool_2x(cb), _avg_pool_2x(cr)

    def compress(chan, table):
        blocks = _blockify(chan) - 128.0
        coeff = _dct2d(blocks)
        qt = _constant(table, chan.device)[None, None] * factor[:, None, None, None]
        return _diff_round(coeff / qt), qt

    def decompress(coeff, qt, hh, ww):
        return _unblockify(_idct2d(coeff * qt) + 128.0, hh, ww)

    y_q, y_t = compress(y, "y_table")
    cb_q, c_t = compress(cb, "c_table")
    cr_q, _ = compress(cr, "c_table")

    y = decompress(y_q, y_t, h, w)
    cb = _upsample_2x(decompress(cb_q, c_t, h // 2, w // 2))
    cr = _upsample_2x(decompress(cr_q, c_t, h // 2, w // 2))

    rgb = ycbcr_to_rgb(torch.stack([y, cb, cr], dim=-1))
    rgb = (rgb / 255.0).clamp(0.0, 1.0)
    return rgb[:, :h0, :w0]
