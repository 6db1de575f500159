"""The port's vision ops no path calls yet (``ops/{sampling,deform_conv,
roi_align_rotated,rotated_boxes}.py``), ``utils/structures.py`` and
``make_tiled_fn(window="fade")`` against the JAX package's: the cases of the
JAX package's ``tests/test_vision_ops.py`` and ``tests/test_structures.py``,
the same seeded numpy inputs through both functions, float32. Each JAX
function runs under one ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tair_tpu.ops import deform_conv as jdc
from tair_tpu.ops import roi_align_rotated as jroi
from tair_tpu.ops import rotated_boxes as jrb
from tair_tpu.ops import sampling as jsamp
from tair_tpu.tiling import make_tiled_fn as jax_make_tiled_fn
from tair_tpu.utils import structures as jst
from tair_tpu_torch.ops import deform_conv, roi_align_rotated, rotated_boxes, sampling
from tair_tpu_torch.tiling import make_tiled_fn
from tair_tpu_torch.utils import structures
from test_torch_common import torch_single_thread  # noqa: F401

# float32 on both sides, only the summation order of a contraction differs
TOL = 1e-5

_jit_sample = jax.jit(jsamp.bilinear_sample_nhwc)
_jit_iou_matrix = jax.jit(jrb.rotated_iou_matrix)
_jit_nms = jax.jit(jrb.nms_rotated, static_argnums=2)
_jit_deform = jax.jit(jdc.deform_conv2d, static_argnames=("stride", "padding"))
_jit_roi = jax.jit(jroi.roi_align_rotated,
                   static_argnames=("output_size", "spatial_scale", "sampling_ratio"))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("spread", [1.0, 6.0])
def test_bilinear_sample_matches_jax_and_grid_sample(spread):
    """Coordinates up to `spread` pixels outside the image: corners outside
    weigh 0 and their clamped rows are never read as JAX reads them."""
    rs = np.random.RandomState(0)
    img = rs.rand(2, 7, 9, 3).astype(np.float32)
    x = rs.uniform(-spread, 8 + spread, (2, 5, 4)).astype(np.float32)
    y = rs.uniform(-spread, 6 + spread, (2, 5, 4)).astype(np.float32)
    want = np.asarray(_jit_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    got = sampling.bilinear_sample_nhwc(_t(img), _t(x), _t(y)).numpy()
    assert got.shape == (2, 5, 4, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # and grid_sample(align_corners=False, zeros), as the JAX test holds it
    grid = torch.stack([_t((x + 0.5) / 9 * 2 - 1), _t((y + 0.5) / 7 * 2 - 1)], -1)
    ref = F.grid_sample(_t(img).permute(0, 3, 1, 2), grid, align_corners=False,
                        padding_mode="zeros").permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_deform_conv_zero_offsets_equals_conv():
    """Zero offsets and no mask: the convolution itself (F.conv2d and JAX)."""
    rs = np.random.RandomState(1)
    x = rs.rand(1, 8, 8, 4).astype(np.float32)
    w = rs.rand(3, 3, 4, 6).astype(np.float32)
    offsets = np.zeros((1, 8, 8, 18), np.float32)
    got = deform_conv.deform_conv2d(_t(x), _t(offsets), _t(w), padding=1).numpy()
    want = np.asarray(_jit_deform(*map(jnp.asarray, (x, offsets, w)), padding=1))
    np.testing.assert_allclose(got, want, atol=TOL)
    ref = F.conv2d(_t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), atol=1e-4)


@pytest.mark.parametrize("stride,padding,modulated", [(1, 1, True), (2, 1, True), (1, 0, False)])
def test_deform_conv_matches_jax(stride, padding, modulated):
    rs = np.random.RandomState(2)
    x = rs.rand(2, 9, 8, 3).astype(np.float32)
    w = rs.rand(3, 3, 3, 4).astype(np.float32)
    bias = rs.rand(4).astype(np.float32)
    oh, ow = (9 + 2 * padding - 3) // stride + 1, (8 + 2 * padding - 3) // stride + 1
    offsets = rs.uniform(-1.5, 1.5, (2, oh, ow, 18)).astype(np.float32)
    mask = rs.rand(2, oh, ow, 9).astype(np.float32) if modulated else None
    kw = dict(stride=stride, padding=padding)
    want = np.asarray(_jit_deform(
        jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(w), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), **kw))
    got = deform_conv.deform_conv2d(
        _t(x), _t(offsets), _t(w), _t(bias), None if mask is None else _t(mask), **kw).numpy()
    assert got.shape == (2, oh, ow, 4)
    np.testing.assert_allclose(got, want, atol=TOL)
    if modulated:  # a half mask halves the (linear) response, as the JAX test checks
        half = deform_conv.deform_conv2d(_t(x), _t(offsets), _t(w), None, _t(mask) * 0.5, **kw)
        full = deform_conv.deform_conv2d(_t(x), _t(offsets), _t(w), None, _t(mask), **kw)
        np.testing.assert_allclose(half.numpy(), full.numpy() * 0.5, atol=1e-5)


def test_roi_align_rotated_constant_region_and_ramp():
    img = np.full((1, 16, 16, 3), 5.0, np.float32)
    rois = np.array([[0, 8.0, 8.0, 6.0, 4.0, 30.0]], np.float32)
    out = roi_align_rotated.roi_align_rotated(_t(img), _t(rois), output_size=4).numpy()
    assert out.shape == (1, 4, 4, 3)
    np.testing.assert_allclose(out, 5.0, atol=1e-5)
    ramp = np.tile(np.arange(16, dtype=np.float32)[None, :, None], (16, 1, 1))[None]
    rois = np.array([[0, 7.5, 7.5, 8.0, 8.0, 0.0]], np.float32)
    cols = roi_align_rotated.roi_align_rotated(_t(ramp), _t(rois), 4)[0, :, :, 0].numpy().mean(0)
    diffs = np.diff(cols)
    np.testing.assert_allclose(diffs, diffs[0], atol=1e-4)
    assert diffs[0] > 0


@pytest.mark.parametrize("output_size,spatial_scale,sampling_ratio", [(7, 1.0, 2), (4, 0.5, 3)])
def test_roi_align_rotated_matches_jax(output_size, spatial_scale, sampling_ratio):
    """Random rotated ROIs over two images, some reaching outside; the batch
    index given as a float that is not whole (truncated on both sides)."""
    rs = np.random.RandomState(4)
    feats = rs.standard_normal((2, 12, 14, 5)).astype(np.float32)
    n = 6
    rois = np.stack([
        np.array([0.0, 1.7, 1.0, 0.2, 1.0, 0.0], np.float32),
        rs.uniform(-2, 16, n), rs.uniform(-2, 14, n), rs.uniform(0.5, 9, n),
        rs.uniform(0.5, 7, n), rs.uniform(-180, 180, n),
    ], 1).astype(np.float32)
    args = dict(output_size=output_size, spatial_scale=spatial_scale,
                sampling_ratio=sampling_ratio)
    want = np.asarray(_jit_roi(jnp.asarray(feats), jnp.asarray(rois), **args))
    got = roi_align_rotated.roi_align_rotated(_t(feats), _t(rois), **args).numpy()
    assert got.shape == (n, output_size, output_size, 5)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_box_to_corners_matches_jax():
    rs = np.random.RandomState(5)
    boxes = np.concatenate([rs.uniform(-5, 5, (7, 2)), rs.uniform(0.1, 4, (7, 2)),
                            rs.uniform(-180, 180, (7, 1))], 1).astype(np.float32)
    want = np.asarray(jrb.box_to_corners(jnp.asarray(boxes)))
    np.testing.assert_allclose(rotated_boxes.box_to_corners(_t(boxes)).numpy(), want, atol=1e-6)


def test_rotated_iou_known_values():
    """The JAX test's analytic values: itself, half overlap, the square
    against itself turned 45 degrees (an octagon), disjoint."""
    def iou(a, b):
        return float(rotated_boxes.rotated_iou_pair(torch.tensor(a), torch.tensor(b)))

    a = [0.0, 0.0, 2.0, 2.0, 0.0]
    assert abs(iou(a, a) - 1.0) < 1e-5
    assert abs(iou(a, [1.0, 0.0, 2.0, 2.0, 0.0]) - 1.0 / 3.0) < 1e-5
    expected = (8 * (np.sqrt(2) - 1)) / (8 - 8 * (np.sqrt(2) - 1))
    assert abs(iou(a, [0.0, 0.0, 2.0, 2.0, 45.0]) - expected) < 1e-3
    assert iou(a, [10.0, 10.0, 2.0, 2.0, 0.0]) == 0.0


def _random_boxes(rs, n):
    return np.concatenate([rs.uniform(3, 7, (n, 2)), rs.uniform(1, 4, (n, 2)),
                           rs.uniform(-90, 90, (n, 1))], 1).astype(np.float32)


def test_rotated_iou_matrix_matches_jax():
    """Random pairs (the JAX test's draw against cv2), touching and nested
    boxes and a box against itself: the clip keeps JAX's float32 order; the
    corners' sines and cosines (and XLA's fusions) differ by float32
    rounding, so the IoUs agree to a few ulps."""
    rs = np.random.RandomState(3)
    extra = np.array([
        [0, 0, 2, 2, 0], [2, 0, 2, 2, 0],        # touching along an edge
        [2, 2, 2, 2, 0], [0, 0, 6, 6, 0],        # touching at a corner; holding the first
        [0, 0, 2, 2, 90], [0, 0, 2, 2, 45],
    ], np.float32)
    a = np.concatenate([_random_boxes(rs, 10), extra])
    b = np.concatenate([_random_boxes(rs, 10), extra])
    want = np.asarray(_jit_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = rotated_boxes.rotated_iou_matrix(_t(a), _t(b)).numpy()
    assert got.shape == (16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.diag(got)[10:], 1.0, atol=1e-5)  # the extra boxes


@pytest.mark.parametrize("case", ["jax_test", "ties", "random"])
def test_nms_rotated_keep_mask_equals_jax(case):
    """The keep mask equals JAX's exactly: the JAX test's boxes; equal scores,
    where the stable sort keeps the lower index; and a random crowd."""
    rs = np.random.RandomState(6)
    if case == "jax_test":
        boxes = np.array([[0, 0, 2, 2, 0], [0.1, 0, 2, 2, 0], [10, 10, 2, 2, 30]], np.float32)
        scores = np.array([0.9, 0.8, 0.7], np.float32)
    elif case == "ties":
        boxes = np.array([[0.1, 0, 2, 2, 0], [0, 0, 2, 2, 0], [0.2, 0, 2, 2, 5],
                          [10, 10, 2, 2, 30], [10.1, 10, 2, 2, 30]], np.float32)
        scores = np.array([0.5, 0.5, 0.5, 0.7, 0.7], np.float32)
    else:
        boxes = _random_boxes(rs, 24)
        scores = rs.rand(24).astype(np.float32)
    want = np.asarray(_jit_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3))
    got = rotated_boxes.nms_rotated(_t(boxes), _t(scores), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "jax_test":
        assert got.tolist() == [True, False, True]
    if case == "ties":  # the lower index of each tie survives
        assert got.tolist() == [True, False, False, True, False]


def test_instances_container():
    for mod in (structures, jst):
        inst = mod.Instances((512, 512))
        inst.set("scores", np.array([0.9, 0.5]))
        inst.set("recs", np.zeros((2, 25)))
        assert len(inst) == 2
        top = inst[inst.scores > 0.6]
        assert len(top) == 1 and top.scores[0] == 0.9
        with pytest.raises(AttributeError):
            inst.polygons


@pytest.mark.parametrize("conv", ["xyxy_to_xywh", "xywh_to_xyxy", "xyxy_to_cxcywh",
                                  "cxcywh_to_xyxy"])
def test_box_mode_conversions_equal_jax(conv):
    b = np.random.RandomState(7).uniform(0, 100, (3, 2, 4))
    np.testing.assert_array_equal(getattr(structures, conv)(b), getattr(jst, conv)(b))
    one = np.array([[10.0, 20.0, 30.0, 60.0]])
    np.testing.assert_allclose(structures.xywh_to_xyxy(structures.xyxy_to_xywh(one)), one)
    np.testing.assert_allclose(structures.cxcywh_to_xyxy(structures.xyxy_to_cxcywh(one)), one)


def test_instances_from_spotter_takes_tensors():
    """The port's spotter_inference gives tensors; JAX's numpy arrays: the
    same Instances."""
    rs = np.random.RandomState(8)
    result = {
        "keep": np.array([[True, False, True], [False, True, True]]),
        "scores": rs.rand(2, 3).astype(np.float32),
        "polygons": rs.rand(2, 3, 16, 2).astype(np.float32),
        "recs": rs.randint(0, 97, (2, 3, 25)).astype(np.int32),
        "rec_scores": rs.rand(2, 3, 25, 97).astype(np.float32),
    }
    for batch_index in (0, 1):
        want = jst.instances_from_spotter(result, 512, batch_index)
        got = structures.instances_from_spotter(
            {k: torch.from_numpy(v) for k, v in result.items()}, 512, batch_index)
        assert got.image_size == want.image_size == (512, 512) and len(got) == 2
        for name in ("scores", "polygons", "recs", "rec_scores"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("size,stride", [(8, 6), (8, 0)])
def test_fade_tiled_fn_matches_jax(size, stride):
    """`window="fade"` on a grid whose last tiles snap to a ragged edge (and,
    with stride 0, one tile per axis and the flat window); a function whose
    output depends on the tile, so the blend shows."""
    rs = np.random.RandomState(9)
    x = rs.standard_normal((2, 19, 27, 3)).astype(np.float32)
    e = rs.standard_normal((2, 19, 27, 1)).astype(np.float32)

    def jfn(t, extra):
        return t * extra + t.mean(axis=(1, 2), keepdims=True)

    def tfn(t, extra):
        return t * extra + t.mean(dim=(1, 2), keepdim=True)

    if stride == 0:
        x, e = x[:, :8, :8], e[:, :8, :8]  # one tile: the function on the whole input
    want = np.asarray(jax_make_tiled_fn(jfn, size, stride, window="fade")(
        jnp.asarray(x), jnp.asarray(e)))
    got = make_tiled_fn(tfn, size, stride, window="fade")(_t(x), _t(e)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL)
