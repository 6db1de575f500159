"""Face alignment and paste-back (facexlib-free).

Counterpart of ``tair_tpu/utils/face.py``: 5-point similarity alignment to the
FFHQ template (Umeyama's least squares, float64 numpy), bilinear warps with
the semantics of ``jax.scipy.ndimage.map_coordinates`` (order 1), and the
soft-mask paste-back, behind a pluggable landmark detector
(``utils/retinaface.RetinaFaceDetector.as_landmark_detector()``).

``warp_affine`` samples the source at ``M^-1 @ dst`` like ``cv2.warpAffine``.
Its sample coordinates are float32, computed in JAX's order; each of the four
corners is gathered and, in ``"constant"`` mode, replaced by ``cval`` where it
falls outside the image (JAX's validity mask, corner by corner).
``"reflect"`` is JAX's ``"mirror"`` index rule and ``"nearest"`` a clamp.
``F.grid_sample``'s border and reflection rules differ from these, so it is
not used. Images are ``[H, W, C]`` float32 tensors on the helper's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# the 5-point template (eyes, nose, mouth corners) on a 512 x 512 aligned crop
FACE_TEMPLATE_512 = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.1936],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    np.float32,
)

MODES = ("constant", "reflect", "nearest")


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama similarity (rotation, uniform scale, translation) mapping src
    points to dst points; a 2 x 3 affine matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_s = (sc**2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var_s
    r = u @ diag @ vt
    t = mu_d - scale * r @ mu_s
    m = np.zeros((2, 3), np.float64)
    m[:, :2] = scale * r
    m[:, 2] = t
    return m.astype(np.float32)


def invert_affine(m: np.ndarray) -> np.ndarray:
    a = np.eye(3, dtype=np.float64)
    a[:2] = m
    return np.linalg.inv(a)[:2].astype(np.float32)


def _fix_index(index: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    if mode == "reflect":  # JAX's "mirror": a triangular wave of period 2 (size - 1)
        s = size - 1
        return ((index + s).remainder(2 * s) - s).abs()
    # "nearest" clamps; "constant" gathers in range and masks after
    return index.clamp(0, size - 1)


def warp_affine(img: torch.Tensor, m: np.ndarray, out_hw, mode: str = "constant",
                cval: float = 0.0) -> torch.Tensor:
    """``[H, W, C]`` warped by the forward 2 x 3 matrix `m` (src -> dst) to
    `out_hw`, order-1 ``map_coordinates`` with JAX's rules for `mode`."""
    if mode not in MODES:
        raise ValueError(f"unknown border mode {mode!r}; choose from {MODES}")
    inv = invert_affine(np.asarray(m))
    img = img.float()
    h, w, _ = img.shape
    oh, ow = out_hw
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(oh, device=dev, dtype=torch.float32),
                            torch.arange(ow, device=dev, dtype=torch.float32), indexing="ij")
    f = [[float(v) for v in row] for row in inv]  # float32 values, exact as Python floats
    sx = f[0][0] * xs + f[0][1] * ys + f[0][2]
    sy = f[1][0] * xs + f[1][1] * ys + f[1][2]
    corners = []  # (index, weight) of the lower and upper neighbour, along y then x
    for coord in (sy, sx):
        lower = coord.floor()
        upper_w = coord - lower
        index = lower.to(torch.int64)
        corners.append(((index, 1 - upper_w), (index + 1, upper_w)))
    out = None
    for iy, wy in corners[0]:
        for ix, wx in corners[1]:
            value = img[_fix_index(iy, h, mode), _fix_index(ix, w, mode)]
            if mode == "constant":
                valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                value = torch.where(valid[..., None], value, cval)
            term = (wy * wx)[..., None] * value
            out = term if out is None else out + term
    return out


def _box_blur_same(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """``jnp.convolve(v, ones(k) / k, mode="same")`` along `dim` of a 3-D
    tensor, for odd `k`."""
    moved = x.movedim(dim, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    box = torch.full((1, 1, k), 1.0 / k, dtype=x.dtype, device=x.device)
    out = F.conv1d(flat, box, padding=k // 2).reshape(shape)
    return out.movedim(-1, dim)


@dataclass
class FaceRestoreHelper:
    """Detect (pluggable) -> align to the template -> restore -> paste back.

    detector(img ``[H, W, 3]`` in [0, 1]) -> a list of ``[5, 2]`` landmarks;
    None means landmarks come through `add_landmarks`. Images become float32
    tensors on `device` (``cuda`` unless the caller asks for the CPU)."""

    face_size: int = 512
    upscale_factor: int = 1
    detector: Optional[Callable] = None
    device: object = "cuda"
    landmarks: List[np.ndarray] = field(default_factory=list)
    affine_matrices: List[np.ndarray] = field(default_factory=list)
    cropped_faces: List[torch.Tensor] = field(default_factory=list)
    restored_faces: List[torch.Tensor] = field(default_factory=list)

    def __post_init__(self):
        from .iqa import resolve_device

        self.device = resolve_device(self.device)

    @property
    def template(self) -> np.ndarray:
        return FACE_TEMPLATE_512 * (self.face_size / 512.0)

    def _on_device(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(device=self.device, dtype=torch.float32)

    def clean(self) -> None:
        self.landmarks, self.affine_matrices = [], []
        self.cropped_faces, self.restored_faces = [], []

    def add_landmarks(self, lm5: np.ndarray) -> None:
        self.landmarks.append(np.asarray(lm5, np.float32))

    def detect_faces(self, img) -> int:
        if self.detector is None:
            raise RuntimeError(
                "no landmark detector configured; call add_landmarks() or "
                "pass detector= (external checkpoints required)"
            )
        for lm in self.detector(img):
            self.add_landmarks(lm)
        return len(self.landmarks)

    def align_warp_faces(self, img, border_mode: str = "constant") -> List[torch.Tensor]:
        """img ``[H, W, 3]`` in [0, 1] -> the aligned crops ``[face_size, face_size, 3]``."""
        img = self._on_device(img)
        self.cropped_faces, self.affine_matrices = [], []
        for lm in self.landmarks:
            m = estimate_similarity(lm, self.template)
            self.affine_matrices.append(m)
            self.cropped_faces.append(
                warp_affine(img, m, (self.face_size, self.face_size), border_mode))
        return self.cropped_faces

    def add_restored_face(self, face) -> None:
        self.restored_faces.append(self._on_device(face))

    def _soft_mask(self) -> torch.Tensor:
        """The face's paste-back mask ``[face_size, face_size, 1]``: ones inside
        a border band, box-blurred along each axis."""
        edge = max(2, self.face_size // 20)
        mask = torch.zeros((self.face_size, self.face_size, 1), device=self.device)
        mask[edge:-edge, edge:-edge] = 1.0
        k = max(1, self.face_size // 10) | 1
        for axis in (0, 1):
            mask = _box_blur_same(mask, k, axis)
        return mask

    def paste_faces_to_input_image(self, img) -> torch.Tensor:
        """Soft-mask paste-back of each restored face at `upscale_factor`."""
        from ..data.resize import resize

        img = self._on_device(img)
        h, w = img.shape[:2]
        up_hw = (h * self.upscale_factor, w * self.upscale_factor)
        out = resize(img[None], up_hw, "linear")[0]
        assert len(self.restored_faces) == len(self.affine_matrices)
        mask = self._soft_mask() if self.restored_faces else None
        for face, m in zip(self.restored_faces, self.affine_matrices):
            inv_m = invert_affine(np.asarray(m) * self.upscale_factor)
            inv_face = warp_affine(face, inv_m, up_hw)
            inv_mask = warp_affine(mask, inv_m, up_hw)
            out = inv_mask * inv_face + (1.0 - inv_mask) * out
        return out.clamp(0.0, 1.0)
