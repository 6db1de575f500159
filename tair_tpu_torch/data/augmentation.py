"""Text-aware data augmentation for standalone spotter training.

The port's copy of ``tair_tpu/data/augmentation.py`` (numpy, PIL for the
resize): the counterpart of the reference's adet ``data/{augmentation.py,
dataset_mapper.py}`` (RandomCropWithInstance / ResizeShortestEdge / hflip in
DatasetMapperWithBasis). Operates on the normalized-coordinate records
produced by ``data.cocotext.load_cocotext`` (polys in [0,1]), so every
transform is a pure numpy map over (image, polys), with the same random calls
in the same order as the JAX package's, and the augmented record feeds the
same static-shape collate as the un-augmented path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


def resize_shortest_edge(
    img: np.ndarray, min_size: int, max_size: int = 10_000
) -> np.ndarray:
    """Scale so the shorter side hits min_size, capped so the longer side
    stays <= max_size (detectron2 ResizeShortestEdge semantics). Normalized
    polygon coordinates are scale-invariant, so only the image changes."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) == (h, w):
        return img
    return np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    )


def hflip(img: np.ndarray, polys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip; polys [N,P,2] normalized. The reading-order point
    sequence is reversed so control point 0 stays the text start (the
    reference flips bezier control points the same way)."""
    out = polys.copy()
    out[..., 0] = 1.0 - out[..., 0]
    return img[:, ::-1], out[:, ::-1]


def random_crop_with_instances(
    img: np.ndarray,
    polys: np.ndarray,                # [N, P, 2] normalized
    crop_frac: Tuple[float, float],
    rng: np.random.RandomState,
    max_tries: int = 20,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random relative crop that keeps at least one instance fully inside
    (gen_crop_transform_with_instance: the crop is seeded on a randomly
    chosen instance and never splits it). Returns (cropped image, polys
    renormalized to the crop, keep mask of instances fully inside)."""
    h, w = img.shape[:2]
    n = len(polys)
    if n == 0:
        ch = round(h * rng.uniform(*crop_frac))
        cw = round(w * rng.uniform(*crop_frac))
        top = rng.randint(0, h - ch + 1)
        left = rng.randint(0, w - cw + 1)
        return img[top : top + ch, left : left + cw], polys, np.zeros((0,), bool)

    for _ in range(max_tries):
        ch = round(h * rng.uniform(*crop_frac))
        cw = round(w * rng.uniform(*crop_frac))
        # seed the window on one instance (keep it fully inside)
        seed = polys[rng.randint(n)] * [w, h]
        x0, y0 = seed.min(0)
        x1, y1 = seed.max(0)
        if (x1 - x0) > cw or (y1 - y0) > ch:
            continue
        left = rng.randint(
            int(max(0, x1 - cw)), int(min(x0, w - cw)) + 1
        )
        top = rng.randint(int(max(0, y1 - ch)), int(min(y0, h - ch)) + 1)
        px = polys[..., 0] * w
        py = polys[..., 1] * h
        keep = (
            (px >= left).all(-1)
            & (px <= left + cw).all(-1)
            & (py >= top).all(-1)
            & (py <= top + ch).all(-1)
        )
        if not keep.any():
            continue
        out = polys.copy()
        out[..., 0] = (px - left) / cw
        out[..., 1] = (py - top) / ch
        return img[top : top + ch, left : left + cw], out[keep], keep

    return img, polys, np.ones((n,), bool)


@dataclass
class TextAugmentor:
    """Train-time augmentation chain over a loader record (in-place schema:
    the output record has the same keys with instances filtered to the crop).
    Mirrors DatasetMapperWithBasis's train pipeline: crop -> resize ->
    flip, each applied with its own probability."""

    crop_prob: float = 0.5
    crop_frac: Tuple[float, float] = (0.6, 1.0)
    hflip_prob: float = 0.5
    min_size: Optional[int] = None
    max_size: int = 10_000
    seed: int = 0

    def __call__(self, img: np.ndarray, record: Dict, index: int = 0) -> Tuple[np.ndarray, Dict]:
        rng = np.random.RandomState((self.seed * 7_654_321 + index) % (2**31))
        polys = np.asarray(record["poly"], np.float32)
        rec = dict(record)

        if rng.uniform() < self.crop_prob:
            img, polys, keep = random_crop_with_instances(
                img, polys, self.crop_frac, rng
            )
            for k in ("text", "bbox", "text_enc"):
                if k in rec and rec[k] is not None and len(keep):
                    v = rec[k]
                    rec[k] = (
                        [t for t, m in zip(v, keep) if m]
                        if isinstance(v, list)
                        else np.asarray(v)[keep]
                    )

        if rng.uniform() < self.hflip_prob:
            img, polys = hflip(img, polys)
            if rec.get("bbox") is not None and len(rec["bbox"]):
                b = np.asarray(rec["bbox"], np.float32).copy()  # cxcywh norm
                b[:, 0] = 1.0 - b[:, 0]
                rec["bbox"] = b

        if self.min_size is not None:
            img = resize_shortest_edge(img, self.min_size, self.max_size)

        # boxes follow the polygon extent after cropping
        if len(polys):
            x0y0 = polys.min(1)
            x1y1 = polys.max(1)
            rec["bbox"] = np.concatenate(
                [(x0y0 + x1y1) / 2, x1y1 - x0y0], -1
            ).astype(np.float32)
        rec["poly"] = polys
        return np.ascontiguousarray(img), rec
