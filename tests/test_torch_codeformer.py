"""The port's CodeFormer degradation (``tair_tpu_torch/data/codeformer.py``)
against the JAX package's on the CPU.

Dataset items from PNGs written here (one at the crop size, one larger, one
smaller that is upscaled before the crop, and a missing file that takes the
retry path) equal the JAX dataset's bit for bit for every crop type: both are
numpy and PIL with the same ``RandomState`` draws. ``codeformer_degrade_batch``
runs against the JAX function under ``jax.jit``, given JAX's own Gaussian noise
field; gt is exact, lq is held at 1e-5 (``test_torch_degradation.py``'s
tolerance for ``diff_jpeg``: float32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tair_tpu.data import codeformer as jc
from tair_tpu_torch.data import codeformer as tcf
from test_torch_common import jax_fast_compiles, t2n, torch_single_thread  # noqa: F401

TOL = 1e-5
SIZE = 32
KEYS = ("hq", "kernel", "scale", "noise_sigma", "jpeg_quality")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("codeformer")
    rng = np.random.RandomState(501)
    recs = {}
    for name, hw in (("exact", (SIZE, SIZE)), ("large", (44, 52)), ("small", (20, 26))):
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(root / f"{name}.png")
        recs[name] = dict(image_path=str(root / f"{name}.png"), img_name=name,
                          prompt=f"a {name} face", text=["x"])
    recs["missing"] = dict(image_path=str(root / "missing.png"), img_name="missing")
    return recs


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray) or np.isscalar(w) and not isinstance(w, str):
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("crop_type,names", [
    ("none", ("exact",)),
    ("center", ("exact", "large", "small", "missing")),
    ("random", ("large", "small", "missing", "exact")),
])
def test_items_bit_equal_jax(records, crop_type, names):
    recs = [records[n] for n in names]
    kw = dict(out_size=SIZE, crop_type=crop_type, blur_kernel_size=11, seed=4)
    ours, theirs = tcf.CodeformerDataset(recs, **kw), jc.CodeformerDataset(recs, **kw)
    for i in range(len(recs)):
        item = ours[i]
        assert item["hq"].shape == (SIZE, SIZE, 3) and item["kernel"].shape == (11, 11)
        _assert_items_equal(item, theirs[i])
    with pytest.raises(ValueError):
        tcf.CodeformerDataset(recs, crop_type="corner")


@pytest.fixture(scope="module")
def batch(records):
    ds = tcf.CodeformerDataset([records[n] for n in ("large", "small", "exact")],
                               out_size=SIZE, blur_kernel_size=11, seed=3)
    items = [ds[i] for i in range(3)]
    out = tcf.collate_codeformer(items)
    want = jc.collate_codeformer(items)
    assert set(out) == set(want) and out["img_name"] == want["img_name"]
    assert out["prompt"] == want["prompt"] == ["a large face", "a small face", "a exact face"]
    for k in KEYS:
        assert out[k].shape[0] == 3
        np.testing.assert_array_equal(out[k], want[k])
    return out


def test_degrade_batch_equals_jax(batch):
    key = jax.random.PRNGKey(7)
    gt_j, lq_j = jax.jit(jc.codeformer_degrade_batch)(key, *(jnp.asarray(batch[k]) for k in KEYS))
    # add_gaussian_noise's field: the first of the two keys split from the first
    k_noise, _ = jax.random.split(jax.random.split(key)[0])
    normal = np.array(jax.random.normal(k_noise, batch["hq"].shape, jnp.float32))
    gt, lq = tcf.codeformer_degrade_batch(
        torch.from_numpy(batch["hq"]), torch.from_numpy(batch["kernel"]), batch["scale"],
        batch["noise_sigma"], batch["jpeg_quality"], normal=torch.from_numpy(normal))
    np.testing.assert_array_equal(t2n(gt), np.asarray(gt_j))
    assert lq.shape == (3, SIZE, SIZE, 3) and float(lq.min()) >= 0 and float(lq.max()) <= 1
    np.testing.assert_allclose(t2n(lq), np.asarray(lq_j), rtol=0, atol=TOL)
    assert np.abs(t2n(lq) - batch["hq"]).mean() > 0.01  # it degrades


def test_degrade_batch_draws_its_noise_from_the_generator(batch):
    args = (torch.from_numpy(batch["hq"]), torch.from_numpy(batch["kernel"]), batch["scale"],
            batch["noise_sigma"], batch["jpeg_quality"])
    a, b, c = (tcf.codeformer_degrade_batch(*args, generator=torch.Generator().manual_seed(s))[1]
               for s in (0, 0, 1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    down, up = tcf.down_up_matrices(np.array([0.5, 2.0], np.float32), 8)
    np.testing.assert_array_equal(down[0], up[0])  # a factor under 1: the identity both ways
    np.testing.assert_allclose(down[0], np.eye(8, dtype=np.float32), atol=0)
    with pytest.raises(ValueError, match="square"):
        tcf.codeformer_degrade_batch(torch.zeros(1, 8, 16, 3), torch.ones(1, 3, 3), [1.0],
                                     [0.0], [90.0])
