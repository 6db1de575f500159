"""Image files of the entry points: listing, loading, saving.

Counterpart of ``val.py:21-44`` (``list_images``, ``load_image``,
``save_image``). PNG files of 8-bit grey, grey + alpha, RGB or RGBA, not
interlaced, are read by ``read_png`` on the standard library (zlib), and
every PNG is written by ``utils.png.write_png``. Any other file (JPEG, BMP,
WebP, palette or 16-bit PNG, interlaced PNG) and any resize to a requested
size go through PIL, imported where it is needed, as the JAX script does:
``Image.open(path).convert("RGB")`` and a bicubic resize.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from .png import write_png

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def list_images(directory: str) -> list:
    """Image files only, sorted (a stray README must not abort an eval)."""
    return sorted(n for n in os.listdir(directory) if n.lower().endswith(IMG_EXTS))


def _chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _png_header(data: bytes) -> Optional[tuple]:
    """(width, height, bit depth, colour type, interlace) of a PNG, or None."""
    if not data.startswith(_PNG_SIGNATURE):
        return None
    kind, body = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return w, h, depth, colour, interlace


def png_is_readable(data: bytes) -> bool:
    """True for the PNGs ``read_png`` decodes."""
    head = _png_header(data)
    return head is not None and head[2] == 8 and head[3] in _CHANNELS and head[4] == 0


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = row + prior
        elif ftype in (3, 4):  # Average and Paeth depend on the bytes just decoded
            filt, up = row.tolist(), prior.tolist()
            cur_l = [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                c = up[x - bpp] if x >= bpp else 0
                pred = (a + up[x]) >> 1 if ftype == 3 else _paeth(a, up[x], c)
                cur_l[x] = (filt[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey / grey+alpha / RGB / RGBA PNG to
    [H, W, channels] uint8."""
    if not png_is_readable(data):
        raise ValueError("read_png takes 8-bit non-interlaced grey, grey+alpha, RGB or RGBA PNGs")
    w, h, _, colour, _ = _png_header(data)
    channels = _CHANNELS[colour]
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    raw = zlib.decompress(idat)
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {h * (stride + 1)} expected")
    return _unfilter(raw, h, stride, channels).reshape(h, w, channels)


def _to_rgb(pixels: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of grey / grey+alpha / RGB / RGBA (alpha dropped)."""
    if pixels.shape[2] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return pixels[..., :3]


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]; resized bicubically (PIL) to size x size
    when `size` is given and differs."""
    with open(path, "rb") as f:
        data = f.read()
    if png_is_readable(data):
        rgb = _to_rgb(read_png(data))
        if size is None or rgb.shape[:2] == (size, size):
            return rgb.astype(np.float32) / 255.0
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    if size is not None and (img.height != size or img.width != size):
        img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, arr) -> None:
    """Write an [H, W, 3] image in [0, 1] as an 8-bit PNG (values clipped and
    truncated to 0..255, as the JAX script stores them)."""
    arr = np.asarray(arr)
    write_png(path, (np.clip(arr, 0, 1) * 255).astype(np.uint8))
