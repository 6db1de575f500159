"""Host-side blur-kernel synthesis for RealESRGAN-style degradations.

The port's own copy of ``tair_tpu/data/kernels.py`` (bivariate iso/aniso
Gaussian, generalized Gaussian, plateau kernels, circular lowpass/sinc, and the
per-item sampling policy). Pure numpy with the same ``np.random.RandomState``
calls in the same order, so an item's kernels equal the JAX package's bit for
bit. Runs in the data loader's thread, never on the device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

KERNEL_RANGE = [2 * v + 1 for v in range(3, 11)]  # 7..21 odd
DEFAULT_KERNEL_LISTS = (
    "iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
    "plateau_aniso",
)
DEFAULT_KERNEL_PROBS = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)


def _mesh(kernel_size: int) -> np.ndarray:
    ax = np.arange(kernel_size) - kernel_size // 2
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], -1).astype(np.float64)  # [k, k, 2]


def _sigma_matrix(sigma_x: float, sigma_y: float, theta: float) -> np.ndarray:
    d = np.array([[sigma_x**2, 0], [0, sigma_y**2]])
    u = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    return u @ d @ u.T


def bivariate_gaussian(
    kernel_size: int, sigma_x: float, sigma_y: float, theta: float,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    inv = np.linalg.inv(_sigma_matrix(sigma_x, sigma_y, theta))
    xy = _mesh(kernel_size)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", xy, inv, xy))
    return (k / k.sum()).astype(np.float32)


def bivariate_generalized_gaussian(
    kernel_size: int, sigma_x: float, sigma_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    inv = np.linalg.inv(_sigma_matrix(sigma_x, sigma_y, theta))
    xy = _mesh(kernel_size)
    q = np.einsum("hwi,ij,hwj->hw", xy, inv, xy)
    k = np.exp(-0.5 * np.power(q, beta))
    return (k / k.sum()).astype(np.float32)


def bivariate_plateau(
    kernel_size: int, sigma_x: float, sigma_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    inv = np.linalg.inv(_sigma_matrix(sigma_x, sigma_y, theta))
    xy = _mesh(kernel_size)
    q = np.einsum("hwi,ij,hwj->hw", xy, inv, xy)
    k = 1.0 / (np.power(q, beta) + 1)
    return (k / k.sum()).astype(np.float32)


def circular_lowpass_kernel(
    cutoff: float, kernel_size: int, pad_to: int = 0
) -> np.ndarray:
    """2D sinc filter with the given cutoff frequency."""
    assert kernel_size % 2 == 1
    from scipy import special

    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx**2 + yy**2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel.astype(np.float32)


def random_mixed_kernel(
    rng: np.random.RandomState,
    kernel_size: int,
    kernel_list: Sequence[str] = DEFAULT_KERNEL_LISTS,
    kernel_prob: Sequence[float] = DEFAULT_KERNEL_PROBS,
    sigma_range: Tuple[float, float] = (0.2, 3.0),
    rotation_range: Tuple[float, float] = (-math.pi, math.pi),
    betag_range: Tuple[float, float] = (0.5, 4.0),
    betap_range: Tuple[float, float] = (1.0, 2.0),
) -> np.ndarray:
    kind = rng.choice(kernel_list, p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    sx = rng.uniform(*sigma_range)
    sy = rng.uniform(*sigma_range)
    theta = rng.uniform(*rotation_range)
    if kind == "iso":
        return bivariate_gaussian(kernel_size, sx, sy, theta, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian(kernel_size, sx, sy, theta, isotropic=False)
    if kind == "generalized_iso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, theta, beta, True)
    if kind == "generalized_aniso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, theta, beta, False)
    if kind == "plateau_iso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, sy, theta, beta, True)
    if kind == "plateau_aniso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, sy, theta, beta, False)
    raise ValueError(kind)


def pulse_kernel(size: int = 21) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    k[size // 2, size // 2] = 1.0
    return k


def sample_degradation_kernels(
    rng: np.random.RandomState,
    sinc_prob: float = 0.1,
    sinc_prob2: float = 0.1,
    final_sinc_prob: float = 0.8,
    blur_sigma: Tuple[float, float] = (0.2, 3.0),
    blur_sigma2: Tuple[float, float] = (0.2, 1.5),
    betag_range: Tuple[float, float] = (0.5, 4.0),
    betag_range2: Tuple[float, float] = (0.5, 4.0),
    betap_range: Tuple[float, float] = (1.0, 2.0),
    betap_range2: Tuple[float, float] = (1.0, 2.0),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-item sampling policy (RealESRGAN's) -> three 21x21 kernels
    (kernel1, kernel2, sinc_kernel)."""

    def first_or_second(sinc_p, sigma, betag, betap):
        size = int(rng.choice(KERNEL_RANGE))
        if rng.uniform() < sinc_p:
            lo = np.pi / 3 if size < 13 else np.pi / 5
            k = circular_lowpass_kernel(rng.uniform(lo, np.pi), size)
        else:
            k = random_mixed_kernel(
                rng, size, sigma_range=sigma,
                betag_range=betag, betap_range=betap,
            )
        pad = (21 - size) // 2
        return np.pad(k, ((pad, pad), (pad, pad)))

    kernel1 = first_or_second(sinc_prob, blur_sigma, betag_range, betap_range)
    kernel2 = first_or_second(sinc_prob2, blur_sigma2, betag_range2, betap_range2)

    if rng.uniform() < final_sinc_prob:
        size = int(rng.choice(KERNEL_RANGE))
        sinc = circular_lowpass_kernel(rng.uniform(np.pi / 3, np.pi), size, pad_to=21)
    else:
        sinc = pulse_kernel(21)
    return kernel1.astype(np.float32), kernel2.astype(np.float32), sinc
