"""The port's native host helpers (``tair_tpu_torch/native_ext.py``, built
from its own copies of the C++ sources) against the JAX package's
``tair_tpu.native_ext``: ``lapjv_batch`` bit-equal and at scipy's optimum,
the "hungarian_host" matcher on it, ``coco_ap`` and ``average_precision``
(native and the Python accumulator) bit-equal on seeded polygons; and a build
that fails raises."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tair_tpu import native_ext as jax_native
from tair_tpu.spotter import matcher as jm
from tair_tpu.utils import text_eval as je
from tair_tpu_torch import native_ext
from tair_tpu_torch.spotter import matcher as tm
from tair_tpu_torch.utils import text_eval as te
from test_torch_common import torch_single_thread  # noqa: F401


def _scipy_total(cost, n_valid):
    total = 0.0
    for i in range(cost.shape[0]):
        n = int(n_valid[i])
        if n:
            rows, cols = linear_sum_assignment(cost[i, :, :n])
            total += float(cost[i][rows, cols].sum())
    return total


def _total(cost, out):
    return sum(float(cost[i, out[i, t], t]) for i in range(cost.shape[0])
               for t in range(cost.shape[2]) if out[i, t] >= 0)


@pytest.mark.parametrize("kind", ["float", "tied"])
@pytest.mark.parametrize("q,m", [(12, 5), (8, 8), (100, 32)])
def test_lapjv_batch_equals_jax_native_and_scipy_optimum(q, m, kind):
    rng = np.random.default_rng(q + m)
    b = 4
    cost = (rng.standard_normal((b, q, m)) * 10 if kind == "float"
            else rng.integers(0, 4, (b, q, m))).astype(np.float32)
    n_valid = np.array([0, m, int(rng.integers(1, m + 1)), max(m // 2, 1)], np.int32)
    got = native_ext.lapjv_batch(cost, n_valid)
    want = jax_native.lapjv_batch(cost, n_valid)
    assert want is not None, "the JAX package's native library did not build"
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_total(cost, got), _scipy_total(cost, n_valid), rtol=1e-5)
    # the host matcher is this solve, on the tensors' device
    host = tm._dispatch("hungarian_host", torch.from_numpy(cost), torch.from_numpy(n_valid))
    assert host.dtype == torch.long
    np.testing.assert_array_equal(host.numpy(), jm._lsa_host(cost, n_valid))


def test_lapjv_batch_more_valid_targets_than_queries():
    """The C solver assigns every valid target, so with more of them than
    queries its search would never end: the port solves such an element
    transposed and matches min(Q, n_valid) targets at scipy's optimum."""
    rng = np.random.default_rng(5)
    q, m = 4, 9
    cost = (rng.standard_normal((3, q, m)) * 10).astype(np.float32)
    n_valid = np.array([9, 3, 6], np.int32)
    got = native_ext.lapjv_batch(cost, n_valid)
    for i in range(3):
        matched = got[i][got[i] >= 0]
        assert len(matched) == min(q, n_valid[i]) == len(set(matched.tolist()))
        assert (got[i, n_valid[i]:] == -1).all()
    np.testing.assert_allclose(_total(cost, got), _scipy_total(cost, n_valid), rtol=1e-5)
    # the element that fits is solved as the JAX package solves it
    np.testing.assert_array_equal(got[1], jax_native.lapjv_batch(cost[1:2], n_valid[1:2])[0])


def _ious_scores(rng, n_images):
    ious, scores = [], []
    for k in range(n_images):
        n_pred, n_gt = (0, 3) if k == 0 else (int(rng.integers(1, 7)), int(rng.integers(0, 5)))
        m = rng.random((n_pred, n_gt)).astype(np.float32)
        m[rng.random(m.shape) < 0.3] = 0.5  # IoUs exactly at a threshold
        sc = np.round(rng.random(n_pred), 1).astype(np.float32)  # tied scores
        ious.append(m)
        scores.append(sc)
    return ious, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_ap_equals_jax(seed):
    ious, scores = _ious_scores(np.random.default_rng(seed), 5)
    thresholds = [0.5, 0.55, 0.75, 0.95]
    got = native_ext.coco_ap(ious, scores, thresholds)
    np.testing.assert_array_equal(got, jax_native.coco_ap(ious, scores, thresholds))
    np.testing.assert_array_equal(te._ap_accumulate_py(ious, scores, thresholds),
                                  je._ap_accumulate_py(ious, scores, thresholds))
    np.testing.assert_allclose(got, te._ap_accumulate_py(ious, scores, thresholds), atol=1e-12)
    # no ground truth at all: every AP is 0
    assert (native_ext.coco_ap([np.zeros((2, 0), np.float32)], [np.ones(2, np.float32)],
                               thresholds) == 0).all()


def _quad(x, y, w, h):
    return np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float32)


def _instances(module, rng, n_images):
    """(gts, preds) per image in `module`'s SpottingInstance: ground-truth
    quads and predictions jittered around them plus strays, seeded."""
    all_gts, all_preds = [], []
    for _ in range(n_images):
        boxes = [(rng.uniform(0, 300), rng.uniform(0, 300), rng.uniform(20, 90),
                  rng.uniform(10, 40)) for _ in range(int(rng.integers(1, 4)))]
        gts = [module.SpottingInstance(_quad(*b), "word") for b in boxes]
        preds = []
        for x, y, w, h in boxes:
            jit = rng.normal(0, 4, 4)
            preds.append(module.SpottingInstance(
                _quad(x + jit[0], y + jit[1], w + jit[2], h + jit[3]), "word",
                float(np.round(rng.random(), 1))))
        preds.append(module.SpottingInstance(_quad(400, 400, 30, 12), "stray", 0.5))
        all_gts.append(gts)
        all_preds.append(preds)
    return all_gts, all_preds


@pytest.mark.parametrize("use_native", [True, False])
def test_average_precision_equals_jax(use_native):
    thresholds = (0.5, 0.7, 0.9)
    got = te.average_precision(*_instances(te, np.random.default_rng(11), 3), thresholds,
                               use_native=use_native)
    want = je.average_precision(*_instances(je, np.random.default_rng(11), 3), thresholds,
                                use_native=use_native)
    assert list(got) == ["ap50", "ap70", "ap90", "ap"] == list(want)
    assert got == want
    assert 0.0 < got["ap50"] <= 1.0


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_build_raises(compiler, tmp_path, monkeypatch):
    """A compiler that is missing or fails: the helpers raise, no fallback."""
    monkeypatch.setattr(native_ext, "COMPILER", compiler)
    monkeypatch.setattr(native_ext, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(native_ext, "_LIB", None)
    with pytest.raises(RuntimeError, match="native helpers"):
        native_ext.lapjv_batch(np.zeros((1, 2, 2), np.float32), np.array([2], np.int32))
    with pytest.raises(RuntimeError, match="native helpers"):
        te.average_precision([[]], [[]])
    assert not any(tmp_path.iterdir())  # nothing half-written is left to load
