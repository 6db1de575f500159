"""Two-stage RealESRGAN degradation synthesis of a training batch, on the device.

Counterpart of ``tair_tpu/data/batch_transform.py``: USM-sharpen the HQ image
-> [blur -> random resize -> gaussian or poisson noise -> JPEG] -> [second
blur -> resize toward gt / stage2_scale -> noise -> {JPEG, sinc} in a random
order] -> resize back to the gt size -> round and clamp.

The JAX function compiles once for every drawn size: it snaps the random
intermediate sizes to a static grid and picks the branch with ``lax.switch``.
Eager PyTorch runs the drawn size directly, so this function reaches the same
size by the same arithmetic (``_size_grid``, float32 round-half-even of the
scaled size, the clip to the grid) and then resizes to it.

The draws: the per-batch scalars (scale choices, resize methods, JPEG
qualities, second-blur and order coins, the noise family and its per-image
parameters) are made on the host from a ``numpy.random.Generator``; the noise
fields (normal, poisson) are drawn on the images' device from a
``torch.Generator``. Any of them can come in through ``draws`` instead
(`sample_draws` says which keys), as the train step takes its draws.
Everything runs in float32, outside autocast, with TF32 off.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .degradation import add_gaussian_noise, add_poisson_noise, filter2d, reflect_pad, usm_sharpen
from .diffjpeg import diff_jpeg
from .resize import resize, scale_and_translate


@dataclass(frozen=True)
class DegradationConfig:
    # first stage
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)  # up, down, keep
    resize_range: Tuple[float, float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Tuple[float, float] = (1.0, 30.0)
    poisson_scale_range: Tuple[float, float] = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (30.0, 95.0)
    # second stage
    stage2_scale: float = 4.0
    second_blur_prob: float = 0.8
    resize_prob2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1.0, 25.0)
    poisson_scale_range2: Tuple[float, float] = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Tuple[float, float] = (30.0, 95.0)
    use_sharpener: bool = True


# the three resize methods of the random choice: area (~linear + antialias),
# bilinear, bicubic
_RESIZE_METHODS = (("linear", True), ("linear", False), ("cubic", False))


def _size_grid(lo: float, hi: float, step: int) -> np.ndarray:
    """Grid of candidate content sizes in [lo, hi], multiples of step."""
    sizes = np.arange(max(step, int(np.floor(lo / step) * step)),
                      int(np.ceil(hi / step) * step) + 1, step)
    return sizes[(sizes >= max(8, lo * 0.999))]


def _snap(size: int, scale: np.float32, step: int, grid: np.ndarray) -> int:
    """The JAX function's drawn content size: round-half-even of
    size * scale / step in float32, times step, clipped to the grid."""
    n = int(np.round(np.float32(size) * np.float32(scale) / np.float32(step))) * step
    return int(np.clip(n, int(grid[0]), int(grid[-1])))


def _draw_scale(rng: np.random.Generator, probs, lo: float, hi: float) -> np.float32:
    """up / down / keep, then a uniform scale in float32."""
    choice = rng.choice(3, p=np.asarray(probs, np.float64) / np.sum(probs))
    u = np.float32(rng.uniform())
    if choice == 0:
        return np.float32(1.0) + u * np.float32(hi - 1.0)
    if choice == 1:
        return np.float32(lo) + u * np.float32(1.0 - lo)
    return np.float32(1.0)


def _draw_noise(rng: np.random.Generator, b: int, g_prob, noise_range, poisson_range, gray_prob):
    return dict(
        use_gauss=bool(rng.uniform() < g_prob),
        sigma=rng.uniform(*noise_range, size=b).astype(np.float32),
        scale=rng.uniform(*poisson_range, size=b).astype(np.float32),
        gray=(rng.uniform(size=b) < gray_prob).astype(np.float32),
    )


def sample_draws(rng: np.random.Generator, batch: int, cfg: "DegradationConfig") -> Dict:
    """The host-side draws of one call of `degrade_batch`. The noise stages
    (``noise1``, ``noise2``) may also carry their fields: ``normal`` [B,h,w,3]
    and ``normal_gray`` [B,h,w,1] for gaussian noise, ``poisson`` [B,h,w,3] and
    ``poisson_gray`` [B,h,w] counts for poisson noise."""
    return dict(
        scale1=_draw_scale(rng, cfg.resize_prob, *cfg.resize_range),
        method1=int(rng.integers(0, 3)),
        scale2=_draw_scale(rng, cfg.resize_prob2, *cfg.resize_range2),
        method2=int(rng.integers(0, 3)),
        jpeg_q1=rng.uniform(*cfg.jpeg_range, size=batch).astype(np.float32),
        jpeg_q2=rng.uniform(*cfg.jpeg_range2, size=batch).astype(np.float32),
        do_blur2=bool(rng.uniform() < cfg.second_blur_prob),
        order_first=bool(rng.uniform() < 0.5),
        noise1=_draw_noise(rng, batch, cfg.gaussian_noise_prob, cfg.noise_range,
                           cfg.poisson_scale_range, cfg.gray_noise_prob),
        noise2=_draw_noise(rng, batch, cfg.gaussian_noise_prob2, cfg.noise_range2,
                           cfg.poisson_scale_range2, cfg.gray_noise_prob2),
    )


def _resize_method(x: torch.Tensor, out: int, method_idx: int) -> torch.Tensor:
    method, antialias = _RESIZE_METHODS[method_idx]
    return resize(x, (out, out), method, antialias)


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v) else v,
                           device=device).float()


def _noise_stage(x: torch.Tensor, d: Dict, generator) -> torch.Tensor:
    dev = x.device
    gray = _as_tensor(d["gray"], dev)
    if d["use_gauss"]:
        return add_gaussian_noise(
            x, _as_tensor(d["sigma"], dev), gray,
            normal=d.get("normal"), normal_gray=d.get("normal_gray"), generator=generator,
        )
    return add_poisson_noise(
        x, _as_tensor(d["scale"], dev), gray,
        poisson=d.get("poisson"), poisson_gray=d.get("poisson_gray"), generator=generator,
    )


def degrade_batch(
    hq: torch.Tensor,          # [B, S, S, 3] in [0,1]
    kernel1: torch.Tensor,     # [B, 21, 21]
    kernel2: torch.Tensor,
    sinc_kernel: torch.Tensor,
    cfg: DegradationConfig = DegradationConfig(),
    rng: Optional[np.random.Generator] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict] = None,
):
    """Returns (gt [-1,1], lq [0,1]), both [B, S, S, 3] float32 on hq's device.
    `draws` (as `sample_draws` gives them) is drawn from `rng` when not given;
    the noise fields it lacks come from `generator`."""
    if draws is None:
        if rng is None:
            raise ValueError("degrade_batch needs either draws or a numpy rng to draw them")
        draws = sample_draws(rng, hq.shape[0], cfg)
    with exact_float32(hq.device.type):
        return _degrade(hq.float(), kernel1.float(), kernel2.float(),
                        sinc_kernel.float(), cfg, draws, generator)


@contextlib.contextmanager
def exact_float32(device_type: str):
    """Autocast off and TF32 off for matrix products and convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _degrade(hq, kernel1, kernel2, sinc_kernel, cfg, draws, generator):
    b, s, _, _ = hq.shape
    dev = hq.device
    base = int(round(s / cfg.stage2_scale))  # lq working size (e.g. 128)
    step1 = max(8, s // 16)
    step2 = max(8, base // 16)
    grid1 = _size_grid(s * cfg.resize_range[0], s * cfg.resize_range[1], step1)
    grid2 = _size_grid(base * cfg.resize_range2[0], base * cfg.resize_range2[1], step2)
    n1 = _snap(s, draws["scale1"], step1, grid1)
    m2 = _snap(base, draws["scale2"], step2, grid2)

    gt = usm_sharpen(hq) if cfg.use_sharpener else hq

    # ---------------- stage 1 ----------------
    y = filter2d(gt, kernel1)
    y = _resize_method(y, n1, draws["method1"])
    y = _noise_stage(y, draws["noise1"], generator)
    y = diff_jpeg(y.clamp(0, 1), _as_tensor(draws["jpeg_q1"], dev))
    if draws["do_blur2"]:
        y = filter2d(y, kernel2)
    # content resized to m2, as the JAX function places it on its stage-2
    # canvas; an output column's weights do not depend on the canvas size, so
    # the m2 x m2 corner the second stage crops is computed directly
    pad = 8
    y = reflect_pad(y, pad)
    sc = np.float32(m2) / np.float32(n1)
    y = scale_and_translate(y, (m2, m2), sc, np.float32(-pad) * sc, "linear", antialias=True)

    # ---------------- stage 2 ----------------
    y = _noise_stage(y, draws["noise2"], generator)
    q2 = _as_tensor(draws["jpeg_q2"], dev)
    if draws["order_first"]:  # resize back + sinc, then JPEG
        y = _resize_method(y, base, draws["method2"])
        y = filter2d(y, sinc_kernel)
        y = diff_jpeg(y.clamp(0, 1), q2)
    else:  # JPEG, then resize back + sinc
        y = diff_jpeg(y.clamp(0, 1), q2)
        y = _resize_method(y, base, draws["method2"])
        y = filter2d(y, sinc_kernel)

    # final resize back to the gt size (bicubic)
    lq = resize(y, (s, s), "cubic", antialias=False)
    lq = torch.round(lq.clamp(0, 1) * 255.0).clamp(0, 255) / 255.0
    return gt * 2.0 - 1.0, lq
