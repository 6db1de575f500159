"""The port's MUSIQ (``tair_tpu_torch/utils/musiq.py``) and its key-rename
shim (``weights/musiq_shim.py``) against the JAX package's on the CPU, at the
JAX tests' tiny geometry (``tests/test_musiq.py``: hidden 16, 2 layers, 1 head,
MLP 24, root width 8, a 4 x 4 hash grid, one resize to a longer side of 64, a
budget of 16 patches a scale).

Both packages take the same seeded parameters (the JAX tree traced abstractly
and filled with numpy noise, carried into the port by ``from_jax_params``)
and numpy-seeded images: a square 64 x 64 one, and a 96 x 224 one whose own
scale holds 3 x 7 patches, over the budget, so ``_crop_to_budget`` crops it to
3 x 5, while its resize to 27 x 64 is an antialiased downscale. The JAX model
is jitted once per image shape inside its metric. A score is held at 1e-5
absolute (float32 on both sides, sums in another order; scores of order 1).

The reader: the seeded tree written by the port's exporter in the module's
own layout and in a published-style one (BiT/timm names under ``module.``),
read by both packages' ``from_torch``: the trees equal bit for bit, the
published one only through the shim, and both shims give the same dict. A key
that no rule classifies raises, listing it; so does a scale list of another
length than the checkpoint's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.utils import musiq as jmq
from tair_tpu.weights import musiq_shim as jshim
from tair_tpu_torch.utils import musiq as tmq
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from tair_tpu_torch.weights import musiq_shim as tshim
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_fast_compiles, jax_shapes, noise_params, save_checkpoint, t2n,
    torch_single_thread,
)

ATOL = 1e-5
TINY = dict(hidden=16, layers=2, heads=1, mlp=24, root_width=8, hash_grid=4, scales=(64,),
            max_tokens_per_scale=16)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jmq.MUSIQConfig(**TINY), tmq.MUSIQConfig(**TINY)
    params = noise_params(jax_shapes(jmq.MUSIQ(jcfg).init, jnp.zeros((1, 64, 64, 3)))["params"],
                          191)
    return params, cfg, jmq.MUSIQMetric(params, jcfg), tmq.MUSIQMetric.from_jax_params(
        params, cfg, device="cpu")


@pytest.mark.parametrize("h,w", [(64, 64), (96, 224)], ids=["square", "over_budget"])
def test_score_equals_jax(tiny, h, w):
    _, cfg, jmetric, metric = tiny
    imgs = np.random.default_rng(192 + h).random((2, h, w, 3), dtype=np.float32)
    want = np.asarray(jmetric(jnp.asarray(imgs)))
    got = metric(imgs)
    assert got.shape == (2,)
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=ATOL)


def test_crop_to_budget_and_scales_equal_jax():
    """The token budget's crop of the 96 x 224 image's own scale, and the
    sizes of its resizes."""
    img = np.zeros((1, 96, 224, 3), np.float32)
    assert jmq._crop_to_budget(img, 3, 7, 16)[:2] == (3, 5)
    gh, gw, cropped = tmq._crop_to_budget(torch.from_numpy(img), 3, 7, 16)
    want = jmq._crop_to_budget(img, 3, 7, 16)[2]
    assert (gh, gw) == (3, 5) and tuple(cropped.shape) == want.shape == (1, 96, 160, 3)
    sizes = [tuple(x.shape) for x in tmq._multiscale(torch.from_numpy(img), (384, 224, 64))]
    assert sizes == [tuple(x.shape) for x in jmq._multiscale(jnp.asarray(img), (384, 224, 64))]


@pytest.fixture(scope="module")
def files(tiny, tmp_path_factory):
    params, cfg, _, _ = tiny
    root = tmp_path_factory.mktemp("musiq")
    module = tx.export_musiq(params, cfg)
    published = tx.export_musiq(params, cfg, published=True)
    assert not tshim.looks_like_repo_layout(published)
    assert all(k.startswith("module.") for k in published)
    wrapped = root / "musiq_params.pth"
    torch.save({"params": {k: torch.from_numpy(v) for k, v in module.items()}}, wrapped)
    return (module, published, save_checkpoint(root / "musiq.pth", module),
            save_checkpoint(root / "musiq_koniq_ckpt.pth", published), str(wrapped))


@pytest.mark.parametrize("layout", ["module", "published", "wrapped"])
def test_reader_equals_jax_on_exported_files(tiny, files, layout):
    """Also a file holding the state dict under ``params``, which both
    packages' ``from_torch`` unwrap."""
    params, cfg, _, _ = tiny
    path = {"module": files[2], "published": files[3], "wrapped": files[4]}[layout]
    jmetric = jmq.MUSIQMetric.from_torch(path, scales=(64,), heads=1)
    metric = tmq.MUSIQMetric.from_torch(path, scales=(64,), heads=1, device="cpu")
    assert metric.cfg == tmq.MUSIQConfig(**{**TINY, "max_tokens_per_scale": 512})
    sd = tc.load_torch_file(path)
    renamed = tshim.shim_musiq_state_dict(sd)
    assert sorted(renamed) == sorted(files[0])
    assert sorted(renamed) == sorted(jshim.shim_musiq_state_dict(sd))
    tree = tc.convert_musiq(renamed, cfg)
    assert_trees_equal(tree, params)
    assert_trees_equal(tree, jmetric.params)


def test_unknown_keys_raise_listing_them(files):
    published = files[1]
    stray = {**published, "module.mystery_tower.weight": np.ones(3, np.float32)}
    for shim in (tshim, jshim):
        with pytest.raises(ValueError, match="mystery_tower"):
            shim.shim_musiq_state_dict(stray)
    partial = {k.replace("attn.qkv.", "attn.q."): v for k, v in published.items()
               if "blocks.0.attn.qkv" in k or "blocks.0" not in k}
    with pytest.raises(ValueError, match="partial separate-qkv"):
        tshim.shim_musiq_state_dict(partial)


def test_scale_count_must_match_the_checkpoint(files):
    for cls in (jmq.MUSIQMetric, tmq.MUSIQMetric):
        with pytest.raises(ValueError, match="resize scales"):
            cls.from_state_dict(files[0], scales=(384, 224))
