"""The port's full-reference metrics, LPIPS and DISTS (``tair_tpu_torch/utils/
{lpips,dists}.py``), against the JAX package's on the CPU.

Both packages take the same seeded parameters at the published widths
(AlexNet, VGG16): the JAX tree traced abstractly and filled with numpy noise,
carried into the port by ``from_jax_params``; DISTS' ``alpha`` and ``beta``
are made positive, as trained ones are, so that their joint sum is far from 0.
The images are 64 x 64, two pairs, from numpy's seeded generator. Each JAX
metric is jitted once per module fixture and returns its score and its
feature levels (LPIPS 5, DISTS 6) together.

Tolerances: float32 on both sides, convolutions summed in another order. A
score is held at 1e-5 absolute (scores are of order 0.1 to 1); a feature
level at 1e-5 of its largest magnitude.

The readers: the seeded tree written by the port's exporter in the published
layouts (torchvision ``features.*`` with its ``classifier.*``, LPIPS
``lin{i}.model.1``, DISTS ``alpha``/``beta`` as [1, C, 1, 1]) and read back by
the port's ``from_torch`` and by the JAX package's on the same files: the
trees equal bit for bit, every tensor read, an unknown one refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_fast_compiles, jax_shapes, noise_params, save_checkpoint, t2n,
    torch_single_thread,
)

SIZE = 64
SCORE_ATOL = 1e-5
FEATURE_RTOL = 1e-5  # of the level's largest magnitude


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((2, SIZE, SIZE, 3), dtype=np.float32),
            rng.random((2, SIZE, SIZE, 3), dtype=np.float32))


def _hold_features(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)  # NHWC -> NCHW
        assert g.shape == w.shape
        np.testing.assert_allclose(t2n(g), w, rtol=0, atol=FEATURE_RTOL * np.abs(w).max())


# ---- LPIPS ------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_run():
    from tair_tpu.utils import lpips as jl

    x = jnp.zeros((1, SIZE, SIZE, 3))
    params = noise_params(jax_shapes(jl.LPIPS().init, x, x)["params"], 161)
    a, b = _images(162)

    def run(p, a, b):
        feats = jl.AlexNetFeatures().apply(
            {"params": p["alex"]}, (a * 2.0 - 1.0 - jl._SHIFT) / jl._SCALE)
        return jl.LPIPS().apply({"params": p}, a, b), feats

    want = jax.jit(run)(params, a, b)
    return params, a, b, want


def test_lpips_score_and_levels_equal_jax(lpips_run):
    from tair_tpu_torch.utils.lpips import LPIPSMetric

    params, a, b, (score_j, feats_j) = lpips_run
    metric = LPIPSMetric.from_jax_params(params, device="cpu")
    score = metric(a, b)
    assert score.shape == (2,) and score.device.type == "cpu"
    np.testing.assert_allclose(t2n(score), np.asarray(score_j), rtol=0, atol=SCORE_ATOL)
    with torch.no_grad():
        _hold_features(metric.model.features(torch.from_numpy(a).permute(0, 3, 1, 2)), feats_j)
    # the same image is at distance 0
    np.testing.assert_array_equal(t2n(metric(a, a)), 0.0)


def test_lpips_reader_equals_jax_on_exported_files(lpips_run, tmp_path):
    from tair_tpu.utils.lpips import LPIPSMetric as JaxLPIPS
    from tair_tpu_torch.utils.lpips import LPIPSMetric

    params, a, b, (score_j, _) = lpips_run
    alex_sd, lin_sd = tx.export_lpips(params)
    assert sorted(lin_sd) == [f"lin{i}.model.1.weight" for i in range(5)]
    assert lin_sd["lin0.model.1.weight"].shape == (1, 64, 1, 1)
    # torchvision's file also holds the classifier, which LPIPS never runs
    alex_sd = {**alex_sd, "classifier.1.weight": np.ones((8, 4), np.float32)}
    alex = save_checkpoint(tmp_path / "alexnet.pth", alex_sd)
    lin = save_checkpoint(tmp_path / "alex.pth", lin_sd)

    tree = tc.convert_lpips(tc.load_torch_file(alex), tc.load_torch_file(lin))
    assert_trees_equal(tree, params)
    assert_trees_equal(tree, JaxLPIPS.from_torch(alex, lin).params["params"])
    metric = LPIPSMetric.from_torch(alex, lin, device="cpu")
    np.testing.assert_allclose(t2n(metric(a, b)), np.asarray(score_j), rtol=0, atol=SCORE_ATOL)

    stray = save_checkpoint(tmp_path / "stray.pth", {**lin_sd, "lin5.model.1.weight": np.ones(1)})
    with pytest.raises(ValueError, match="lin5.model.1.weight"):
        LPIPSMetric.from_torch(alex, stray, device="cpu")


def test_lpips_without_weights_raises_as_jax():
    from tair_tpu.utils.lpips import LPIPSMetric as JaxLPIPS
    from tair_tpu_torch.utils.lpips import LPIPSMetric

    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    for metric in (JaxLPIPS(), LPIPSMetric(device="cpu")):
        with pytest.raises(RuntimeError, match="weights not loaded"):
            metric(x, x)


# ---- DISTS ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dists_run():
    from tair_tpu.utils import dists as jd

    x = jnp.zeros((1, SIZE, SIZE, 3))
    params = noise_params(jax_shapes(jd.DISTS().init, x, x)["params"], 163)
    for name in ("alpha", "beta"):
        params[name] = np.abs(params[name]) + np.float32(0.1)
    a, b = _images(164)

    def run(p, a, b):
        feats = jd.VGG16Features().apply({"params": p["vgg"]}, (a - jd._MEAN) / jd._STD)
        return jd.DISTS().apply({"params": p}, a, b), feats

    want = jax.jit(run)(params, a, b)
    return params, a, b, want


def test_dists_score_and_levels_equal_jax(dists_run):
    from tair_tpu_torch.utils.dists import DISTSMetric

    params, a, b, (score_j, feats_j) = dists_run
    metric = DISTSMetric.from_jax_params(params, device="cpu")
    score = metric(a, b)
    assert score.shape == (2,)
    np.testing.assert_allclose(t2n(score), np.asarray(score_j), rtol=0, atol=SCORE_ATOL)
    with torch.no_grad():
        _hold_features(metric.model.features(torch.from_numpy(a).permute(0, 3, 1, 2)), feats_j)
    np.testing.assert_allclose(t2n(metric(a, a)), 0.0, atol=SCORE_ATOL)


def test_dists_l2_pool_equals_jax():
    """The 3-tap Hann window, stride 2, padding 1, on an odd size."""
    from tair_tpu.utils.dists import _l2_pool as jax_pool
    from tair_tpu_torch.utils.dists import _l2_pool

    x = np.random.default_rng(165).standard_normal((2, 9, 7, 5), dtype=np.float32)
    got = _l2_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = np.asarray(jax.jit(jax_pool)(x))
    assert got.shape == want.shape == (2, 5, 4, 5)
    np.testing.assert_allclose(t2n(got), want, rtol=1e-6, atol=1e-6)


def test_dists_reader_equals_jax_on_exported_files(dists_run, tmp_path):
    from tair_tpu.utils.dists import DISTSMetric as JaxDISTS
    from tair_tpu_torch.utils.dists import DISTSMetric

    params, a, b, (score_j, _) = dists_run
    vgg_sd, w_sd = tx.export_dists(params)
    assert sorted(w_sd) == ["alpha", "beta"] and w_sd["alpha"].shape == (1, 1475, 1, 1)
    assert len(vgg_sd) == 26  # 13 convolutions
    vgg = save_checkpoint(tmp_path / "vgg16.pth",
                          {**vgg_sd, "classifier.0.bias": np.zeros(8, np.float32)})
    weights = save_checkpoint(tmp_path / "weights.pt", w_sd)

    tree = tc.convert_dists(tc.load_torch_file(vgg), tc.load_torch_file(weights))
    assert_trees_equal(tree, params)
    assert_trees_equal(tree, JaxDISTS.from_torch(vgg, weights).params["params"])
    metric = DISTSMetric.from_torch(vgg, weights, device="cpu")
    np.testing.assert_allclose(t2n(metric(a, b)), np.asarray(score_j), rtol=0, atol=SCORE_ATOL)

    stray = save_checkpoint(tmp_path / "stray.pth", {**vgg_sd, "features.30.weight": np.ones(1)})
    with pytest.raises(ValueError, match="features.30.weight"):
        DISTSMetric.from_torch(stray, weights, device="cpu")


def test_metrics_want_a_card_unless_told_cpu():
    from tair_tpu_torch.utils.dists import DISTSMetric
    from tair_tpu_torch.utils.lpips import LPIPSMetric

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present: the default device works here")
    for cls in (LPIPSMetric, DISTSMetric):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
