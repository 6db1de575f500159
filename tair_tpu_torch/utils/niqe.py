"""NIQE — Natural Image Quality Evaluator (no-reference IQA).

The port's copy of ``tair_tpu/utils/niqe.py`` (numpy + scipy, host side):
the full algorithm of Mittal et al., "Making a 'Completely Blind' Image
Quality Analyzer" (IEEE SPL 2013):

  - MSCN coefficients (gaussian-weighted local mean/variance normalization)
  - asymmetric generalized Gaussian (AGGD) moment-matching fits of the MSCN
    field and its 4 directional pairwise products, at 2 scales (18 features
    per scale)
  - sharpness-based patch selection at the full scale
  - Mahalanobis-style distance to a pristine MVG model

plus ``fit_niqe_params`` to build the pristine model from a clean corpus and
``NIQEParams.save/load`` for parameters fitted elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
from scipy.special import gamma as _gamma

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (_gamma(2.0 / _GAM) ** 2) / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def _gauss_kernel(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float64)


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'same' correlation with symmetric (reflect) padding, separably."""
    from numpy.lib.stride_tricks import sliding_window_view

    p = k.shape[0] // 2
    x = np.pad(img, p, mode="symmetric")
    win = sliding_window_view(x, k.shape)
    return np.einsum("ijkl,kl->ij", win, k, optimize=True)


def mscn(img: np.ndarray, eps: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(MSCN coefficients, local sigma field) of a [H,W] float image."""
    k = _gauss_kernel()
    mu = _filter2(img, k)
    sigma = np.sqrt(np.abs(_filter2(img * img, k) - mu * mu))
    return (img - mu) / (sigma + eps), sigma


def _ggd_fit(x: np.ndarray) -> Tuple[float, float]:
    """Symmetric GGD moment-matching: (alpha, sigma)."""
    sigma_sq = np.mean(x**2)
    e_abs = np.mean(np.abs(x))
    rho = sigma_sq / (e_abs**2 + 1e-12)
    alpha = _GAM[np.argmin(np.abs(_R_GAM - 1.0 / (rho + 1e-12)))]
    return float(alpha), float(np.sqrt(sigma_sq))


def _aggd_fit(x: np.ndarray) -> Tuple[float, float, float, float]:
    """AGGD moment-matching: (alpha, eta, beta_left, beta_right)."""
    left = x[x < 0]
    right = x[x >= 0]
    lstd = np.sqrt(np.mean(left**2)) if left.size else 1e-6
    rstd = np.sqrt(np.mean(right**2)) if right.size else 1e-6
    gammahat = lstd / (rstd + 1e-12)
    rhat = np.mean(np.abs(x)) ** 2 / (np.mean(x**2) + 1e-12)
    rhatnorm = (
        rhat
        * (gammahat**3 + 1.0)
        * (gammahat + 1.0)
        / ((gammahat**2 + 1.0) ** 2)
    )
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    c = np.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    bl = lstd * c
    br = rstd * c
    eta = (br - bl) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha))
    return float(alpha), float(eta), float(bl), float(br)


def _patch_features(m: np.ndarray) -> np.ndarray:
    """18 NIQE features of one MSCN patch."""
    feats = list(_ggd_fit(m))
    for shift in (
        m[:, :-1] * m[:, 1:],            # horizontal
        m[:-1] * m[1:],                  # vertical
        m[:-1, :-1] * m[1:, 1:],         # main diagonal
        m[:-1, 1:] * m[1:, :-1],         # anti diagonal
    ):
        feats.extend(_aggd_fit(shift.ravel()))
    return np.asarray(feats, np.float64)


def niqe_features(
    img: np.ndarray, patch: int = 96, sharpness_frac: float = 0.75
) -> np.ndarray:
    """Per-patch 36-dim features of a grayscale [H,W] image in [0,255].

    Patches are selected by full-scale sharpness (mean local sigma above
    `sharpness_frac` of the peak), then featurized at 2 scales."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    nh, nw = h // patch, w // patch
    if nh == 0 or nw == 0:
        raise ValueError(f"image {img.shape} smaller than patch {patch}")
    img = img[: nh * patch, : nw * patch]

    m1, sig1 = mscn(img)
    # half scale (2x2 mean pool)
    img2 = img.reshape(nh * patch // 2, 2, nw * patch // 2, 2).mean((1, 3))
    m2, _ = mscn(img2)

    sharp = np.zeros((nh, nw))
    for i in range(nh):
        for j in range(nw):
            sharp[i, j] = sig1[
                i * patch : (i + 1) * patch, j * patch : (j + 1) * patch
            ].mean()
    keep = sharp >= sharpness_frac * sharp.max()

    rows = []
    p2 = patch // 2
    for i in range(nh):
        for j in range(nw):
            if not keep[i, j]:
                continue
            f1 = _patch_features(
                m1[i * patch : (i + 1) * patch, j * patch : (j + 1) * patch]
            )
            f2 = _patch_features(
                m2[i * p2 : (i + 1) * p2, j * p2 : (j + 1) * p2]
            )
            rows.append(np.concatenate([f1, f2]))
    return np.stack(rows)


@dataclass
class NIQEParams:
    mu: np.ndarray      # [36]
    cov: np.ndarray     # [36, 36]

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, cov=self.cov)

    @classmethod
    def load(cls, path: str) -> "NIQEParams":
        z = np.load(path)
        return cls(mu=z["mu"], cov=z["cov"])


def _safe_cov(feats: np.ndarray) -> np.ndarray:
    """np.cov collapses to a 0-d array for a single observation; a small
    val panel (e.g. one 128^2 image = one 96px patch) must still produce a
    [36,36] matrix (zero covariance)."""
    if len(feats) < 2:
        return np.zeros((feats.shape[1], feats.shape[1]))
    return np.cov(feats, rowvar=False)


def fit_niqe_params(
    images: Sequence[np.ndarray], patch: int = 96
) -> NIQEParams:
    """Fit the pristine MVG from clean grayscale images ([0,255])."""
    feats = np.concatenate([niqe_features(im, patch) for im in images])
    mu = feats.mean(0)
    return NIQEParams(mu=mu, cov=_safe_cov(feats))


def rgb_to_gray255(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float in [0,1] -> luminance [H,W] in [0,255]."""
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    ) * 255.0


def niqe(
    img: np.ndarray, params: NIQEParams, patch: int = 96
) -> float:
    """NIQE score (lower = more natural). img: [H,W] gray [0,255] or
    [H,W,3] RGB [0,1]."""
    if img.ndim == 3:
        img = rgb_to_gray255(img)
    feats = niqe_features(img, patch)
    mu_d = feats.mean(0)
    cov_d = _safe_cov(feats)
    diff = params.mu - mu_d
    s = (params.cov + cov_d) / 2.0
    inv = np.linalg.pinv(s)
    return float(np.sqrt(max(diff @ inv @ diff, 0.0)))
