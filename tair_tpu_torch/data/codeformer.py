"""CodeFormer-style first-order degradation (DiffBIR's face path).

Counterpart of ``tair_tpu/data/codeformer.py``: blur -> random downsample ->
Gaussian noise -> JPEG -> back to the canvas, the single-stage degradation
beside the two-stage RealESRGAN pipeline of ``batch_transform.py``.

The host dataset (numpy and PIL, the same ``RandomState`` draws in the same
order, so items equal the JAX package's bit for bit) loads and crops the HQ
image and draws each item's parameters: blur kernel, downsample factor, noise
sigma, JPEG quality. ``codeformer_degrade_batch`` applies them to a batch on
its device. The down / up round trip is two ``jax.image.scale_and_translate``
passes on the full canvas (linear; antialiased going down, not going up), with
JAX's float32 chain: ``inv = 1 / max(scale, 1)`` and the scale ``1 / inv`` on
the way up. The per-item scales come from `collate_codeformer` as host numbers,
so their weight matrices are built in numpy and sent to the device without a
host synchronisation.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .degradation import add_gaussian_noise, filter2d
from .diffjpeg import diff_jpeg
from .kernels import random_mixed_kernel
from ..utils.device_constants import to_device
from .resize import weight_matrix


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top : top + size, left : left + size]


def random_crop(img: np.ndarray, size: int, rng: np.random.RandomState) -> np.ndarray:
    h, w = img.shape[:2]
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return img[top : top + size, left : left + size]


@dataclass
class CodeformerDataset:
    """Host side: the HQ crop and each item's degradation parameters.

    `records` take the SA-Text loader's schema (image_path, prompt, text, bbox,
    poly, text_enc, img_name), so the two datasets are interchangeable at the
    training loop."""

    records: List[Dict]
    out_size: int = 512
    crop_type: str = "center"  # none | center | random
    blur_kernel_size: int = 41
    kernel_list: Sequence[str] = ("iso", "aniso")
    kernel_prob: Sequence[float] = (0.5, 0.5)
    blur_sigma: Tuple[float, float] = (0.1, 10.0)
    downsample_range: Tuple[float, float] = (0.8, 8.0)
    noise_range: Optional[Tuple[float, float]] = (0.0, 20.0)
    jpeg_range: Optional[Tuple[int, int]] = (60, 100)
    seed: int = 0
    backend: object = None

    def __post_init__(self):
        if self.crop_type not in ("none", "center", "random"):
            raise ValueError(self.crop_type)

    def __len__(self) -> int:
        return len(self.records)

    def _load(self, path: str) -> Optional[np.ndarray]:
        from PIL import Image

        from .file_backend import HardDiskBackend

        if self.backend is None:
            self.backend = HardDiskBackend()
        try:
            img = Image.open(io.BytesIO(self.backend.get(path))).convert("RGB")
        except Exception:
            return None
        return np.asarray(img, np.uint8)

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % (2**31))
        rec = self.records[index]
        img = self._load(rec["image_path"])
        retries = 0
        while img is None and retries < 5:
            index = rng.randint(0, len(self.records))
            rec = self.records[index]
            img = self._load(rec["image_path"])
            retries += 1
        if img is None:
            raise RuntimeError(f"failed to load any image near {rec['image_path']}")

        s = self.out_size
        if self.crop_type == "none":
            assert img.shape[0] == s and img.shape[1] == s
        elif img.shape[0] != s or img.shape[1] != s:
            from PIL import Image

            if min(img.shape[:2]) < s:  # the short side up to the crop first
                scale = s / min(img.shape[:2])
                img = np.asarray(
                    Image.fromarray(img).resize(
                        (round(img.shape[1] * scale), round(img.shape[0] * scale)),
                        Image.BICUBIC,
                    )
                )
            img = (
                center_crop(img, s)
                if self.crop_type == "center"
                else random_crop(img, s, rng)
            )

        kernel = random_mixed_kernel(
            rng,
            self.blur_kernel_size,
            self.kernel_list,
            self.kernel_prob,
            sigma_range=self.blur_sigma,
        )
        nr, jr = self.noise_range, self.jpeg_range
        return dict(
            hq=(img / 255.0).astype(np.float32),
            kernel=kernel.astype(np.float32),
            scale=np.float32(rng.uniform(*self.downsample_range)),
            noise_sigma=np.float32(rng.uniform(*nr) if nr else 0.0),
            jpeg_quality=np.float32(rng.uniform(*jr) if jr else 100.0),
            prompt=rec.get("prompt", ""),
            text=rec.get("text", []),
            bbox=rec.get("bbox"),
            poly=rec.get("poly"),
            text_enc=rec.get("text_enc"),
            img_name=rec.get("img_name", ""),
        )


def collate_codeformer(items: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in ("hq", "kernel", "scale", "noise_sigma", "jpeg_quality"):
        out[k] = np.stack([it[k] for it in items])
    out["prompt"] = [it["prompt"] for it in items]
    out["img_name"] = [it["img_name"] for it in items]
    return out


def down_up_matrices(scale, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per item, the ``[B, size, size]`` weights of the downsample and of the
    upsample back (one axis; the canvas is square), in JAX's float32 chain."""
    f32 = np.float32
    inv = f32(1.0) / np.maximum(np.asarray(scale, f32), f32(1.0))
    down, up = [], []
    for inv_s in inv:
        up_scale = f32(1.0) / inv_s
        # scale_and_translate takes the scale and inverts it itself
        down.append(weight_matrix(size, size, f32(1.0) / inv_s, f32(0.0), "linear", True))
        up.append(weight_matrix(size, size, f32(1.0) / up_scale, f32(0.0), "linear", False))
    return np.stack(down), np.stack(up)


def _resample(img: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """img ``[B, H, W, C]`` through each item's axis weights ``[B, in, out]``."""
    img = torch.einsum("bhwc,bhk->bkwc", img, wh)
    return torch.einsum("bhwc,bwk->bhkc", img, ww)


def codeformer_degrade_batch(
    hq: torch.Tensor,             # [B, S, S, 3] in [0, 1]
    kernel: torch.Tensor,         # [B, k, k]
    scale,                        # [B] downsample factor, host numbers
    noise_sigma,                  # [B] in [0, 255] scale
    jpeg_quality,                 # [B] in [1, 100]
    generator: Optional[torch.Generator] = None,
    normal: Optional[torch.Tensor] = None,       # [B, S, S, 3] standard normal
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gt in [-1, 1], lq in [0, 1]) on hq's device. The noise field is
    `normal` when given (the JAX function's draw, in the tests), else drawn
    from `generator` on the device."""
    from .batch_transform import exact_float32

    dev = hq.device
    b, s, w, _ = hq.shape
    if s != w:
        raise ValueError(f"codeformer_degrade_batch takes a square canvas, got {s} x {w}")
    down, up = (to_device(m, dev, torch.float32) for m in down_up_matrices(scale, s))
    sigma = to_device(noise_sigma, dev, torch.float32)
    quality = to_device(jpeg_quality, dev, torch.float32)
    with exact_float32(dev.type):
        hq = hq.float()
        lq = filter2d(hq, kernel.to(device=dev, dtype=torch.float32))
        lq = _resample(_resample(lq, down, down), up, up)
        # gray noise is off in this pipeline: its field is never drawn
        lq = add_gaussian_noise(lq, sigma, torch.zeros(b, device=dev), normal=normal,
                                normal_gray=lq.new_zeros(1, 1, 1, 1), generator=generator)
        lq = diff_jpeg(lq, quality).clamp(0.0, 1.0)
        return hq * 2.0 - 1.0, lq
