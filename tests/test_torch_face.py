"""The port's face alignment and paste-back (``tair_tpu_torch/utils/face.py``)
against the JAX package's on the CPU.

The similarity estimate and the affine inverse are float64 numpy on both
sides, so they are equal bit for bit. ``warp_affine`` in each border mode
warps an image with a rotation and a scale that send part of the output
outside the source, against ``jax.scipy.ndimage.map_coordinates``' rules:
the sample coordinates are float32 in the same order on both sides, so the
outputs are held at 1e-6 (values in [0, 1]). The helper aligns two faces at
``face_size=32`` and pastes them back at upscale 1 and 2 (the upscale is
``jax.image.resize``'s linear rule, the mask's blur ``jnp.convolve``), held at
1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tair_tpu.utils import face as jf
from tair_tpu_torch.utils import face as tf
from test_torch_common import jax_fast_compiles, t2n, torch_single_thread  # noqa: F401

WARP_TOL = 1e-6
HELPER_TOL = 1e-5
FACE = 32
IMG_HW = (40, 48)
# two faces' landmarks in the 40 x 48 image: one upright, one turned and small
LANDMARKS = (
    np.array([[16.5, 18.0], [28.2, 18.4], [22.1, 24.9], [17.3, 29.6], [27.6, 29.8]], np.float32),
    np.array([[36.0, 9.5], [41.0, 13.2], [36.2, 15.1], [32.4, 15.8], [35.1, 19.6]], np.float32),
)


def _img(hw, seed):
    return np.random.default_rng(seed).random((*hw, 3), dtype=np.float32)


def test_similarity_and_inverse_bit_equal():
    tmpl = jf.FACE_TEMPLATE_512 * (FACE / 512.0)
    np.testing.assert_array_equal(tf.FACE_TEMPLATE_512, jf.FACE_TEMPLATE_512)
    for lm in LANDMARKS:
        m = tf.estimate_similarity(lm, tmpl)
        np.testing.assert_array_equal(m, jf.estimate_similarity(lm, tmpl))
        np.testing.assert_array_equal(tf.invert_affine(m), jf.invert_affine(m))
        assert m.dtype == np.float32 and m.shape == (2, 3)


@pytest.mark.parametrize("mode", tf.MODES)
def test_warp_affine_equals_jax(mode):
    img = _img((20, 24), 401)
    c, s = np.cos(0.6), np.sin(0.6)
    m = np.array([[1.3 * c, -1.3 * s, 4.25], [1.3 * s, 1.3 * c, -6.5]], np.float32)
    want = np.asarray(jf.warp_affine(jnp.asarray(img), m, (26, 30), mode))
    got = t2n(tf.warp_affine(torch.from_numpy(img), m, (26, 30), mode))
    inv = tf.invert_affine(m)
    ys, xs = np.mgrid[0:26, 0:30]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    outside = (sx < 0) | (sx > 23) | (sy < 0) | (sy > 19)
    assert 0.1 < outside.mean() < 0.9  # every border rule is exercised
    assert got.shape == (26, 30, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL)
    if mode == "constant":  # every corner of these samples lies outside: cval
        far = (sx < -1) | (sx > 24) | (sy < -1) | (sy > 20)
        assert far.sum() > 100 and np.all(got[far] == 0)


@pytest.mark.parametrize("upscale", [1, 2])
def test_helper_align_and_paste_back_equal_jax(upscale):
    img = _img(IMG_HW, 402)
    jh = jf.FaceRestoreHelper(face_size=FACE, upscale_factor=upscale)
    th = tf.FaceRestoreHelper(face_size=FACE, upscale_factor=upscale, device="cpu")
    for lm in LANDMARKS:
        jh.add_landmarks(lm)
        th.add_landmarks(lm)
    want = jh.align_warp_faces(jnp.asarray(img))
    got = th.align_warp_faces(img)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (FACE, FACE, 3)
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=0, atol=HELPER_TOL)
    for i, (g, w) in enumerate(zip(got, want)):  # a "restoration": a per-face tint
        tint = np.float32(0.8 + 0.1 * i)
        jh.add_restored_face(w * tint)
        th.add_restored_face(g * tint)
    out = th.paste_faces_to_input_image(img)
    assert out.shape == (IMG_HW[0] * upscale, IMG_HW[1] * upscale, 3)
    np.testing.assert_allclose(t2n(out), np.asarray(jh.paste_faces_to_input_image(
        jnp.asarray(img))), rtol=0, atol=HELPER_TOL)


def test_helper_without_a_detector_or_a_card_raises(monkeypatch):
    th = tf.FaceRestoreHelper(face_size=FACE, device="cpu")
    with pytest.raises(RuntimeError, match="detector"):
        th.detect_faces(_img(IMG_HW, 403))
    th.detector = lambda img: list(LANDMARKS)
    assert th.detect_faces(_img(IMG_HW, 403)) == 2 and th.landmarks[1].shape == (5, 2)
    with pytest.raises(ValueError, match="border mode"):
        tf.warp_affine(torch.zeros(4, 4, 3), np.eye(2, 3, dtype=np.float32), (4, 4), "wrap")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FaceRestoreHelper()
