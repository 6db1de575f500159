"""The port's MANIQA (``tair_tpu_torch/utils/maniqa.py``) against the JAX
package's on the CPU.

Scores at the JAX tests' tiny geometry (``tests/test_maniqa.py``: ViT 32 x 32,
patch 8, width 16, depth 2, blocks 0 and 1 read; Swin window 2 on the 4 x 4
grid, so the odd blocks shift and mask): both packages take the same seeded
parameters (the JAX tree traced abstractly and filled with numpy noise,
carried into the port by ``from_jax_params``) and numpy-seeded images, through
the whole crop protocol: crops drawn twice (a 32 x 34 image has three offsets
for five draws), and an image smaller than the crop (edge-padded). The JAX
network is jitted once per crop count inside its metric. A score is held at
1e-5 absolute (float32 on both sides, sums in another order; scores of order
1), the ViT's tokens at the extract blocks at 1e-5 of their largest magnitude.

The reader at a geometry that the JAX package's ``from_state_dict`` can infer
(it assumes the published extract blocks 6-9 and Swin settings: a ViT of
width 64 and depth 10 here, no forward pass): the seeded tree written in
IIGROUP's layout by the port's exporter, with and without ``module.``, with
the tensors the published file carries beside it, read by both packages'
``from_torch``: the trees equal bit for bit and the same geometry inferred.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.utils import maniqa as jm
from tair_tpu_torch.utils import maniqa as tm
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_shapes, noise_params, save_checkpoint, t2n, torch_single_thread,
)

ATOL = 1e-5
TINY = dict(extract_blocks=(0, 1), embed_dim=16, num_tab=2, depths=(2, 2), num_heads=(2, 2),
            window_size=2, dim_mlp=24, scale=0.8)
TINY_VIT = dict(img_size=32, patch_size=8, dim=16, depth=2, heads=2)
CROPS = 5


def _cfgs(vit: dict, **rest):
    return (jm.MANIQAConfig(vit=jm.ViTConfig(**vit), **rest),
            tm.MANIQAConfig(vit=tm.ViTConfig(**vit), **rest))


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _cfgs(TINY_VIT, **TINY)
    params = noise_params(jax_shapes(jm.MANIQA(jcfg).init, jnp.zeros((1, 32, 32, 3)))["params"],
                          181)
    return (jm.MANIQAMetric(params, jcfg, num_crops=CROPS, seed=7),
            tm.MANIQAMetric.from_jax_params(params, cfg, num_crops=CROPS, seed=7, device="cpu"))


@pytest.mark.parametrize("h,w", [(32, 34), (24, 40)], ids=["repeated_crops", "padded"])
def test_score_equals_jax_through_the_crop_protocol(tiny, h, w):
    jmetric, metric = tiny
    imgs = np.random.default_rng(182 + h).random((2, h, w, 3), dtype=np.float32)
    crops, counts = metric.crops(imgs)
    n_offsets = (max(h, 32) - 31) * (max(w, 32) - 31)
    assert int(counts.sum()) == CROPS and crops.shape[0] == 2 * len(counts)
    if n_offsets < CROPS:
        assert len(counts) < CROPS  # some crop was drawn twice
    assert h >= 32 or crops.shape[2] == 32
    want = np.asarray(jmetric(jnp.asarray(imgs)))
    got = metric(imgs)
    assert got.shape == (2,)
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t2n(metric(imgs)), t2n(got))  # the draws are the seed's


def test_extract_block_tokens_equal_jax(tiny):
    jmetric, metric = tiny
    x = np.random.default_rng(184).standard_normal((2, 32, 32, 3), dtype=np.float32)
    vit = jm.ViTFeatures(jmetric.cfg.vit)
    want = jax.jit(lambda p, x: vit.apply({"params": p}, x))(jmetric.params["vit"], x)
    with torch.no_grad():
        got = metric.net.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(jmetric.cfg.extract_blocks)
    for g, i in zip(got, jmetric.cfg.extract_blocks):
        w = np.asarray(want[i])
        np.testing.assert_allclose(t2n(g), w, rtol=0, atol=ATOL * np.abs(w).max())


def test_swin_shift_mask_and_index_equal_jax():
    from tair_tpu.utils.maniqa import SwinBlock as JaxSwinBlock

    np.testing.assert_array_equal(tm._rel_pos_index(4), jm._rel_pos_index(4))
    np.testing.assert_array_equal(tm._shift_mask(8, 8, 4, 2),
                                  np.asarray(JaxSwinBlock._shift_mask(8, 8, 4, 2)))


@pytest.fixture(scope="module")
def inferable(tmp_path_factory):
    """A tree at a geometry ``from_state_dict`` infers, and its files."""
    jcfg, cfg = _cfgs(dict(img_size=32, patch_size=8, dim=64, depth=10, heads=1), embed_dim=16)
    params = noise_params(jax_shapes(jm.MANIQA(jcfg).init, jnp.zeros((1, 32, 32, 3)))["params"],
                          185)
    root = tmp_path_factory.mktemp("maniqa")
    paths = {}
    for prefix in ("", "module."):
        sd = tx.export_maniqa(params, cfg, prefix)
        # the published file also holds the ViT's norm and head and the Swin buffers
        sd.update({f"{prefix}vit.norm.weight": np.ones(64, np.float32),
                   f"{prefix}vit.head.weight": np.ones((5, 64), np.float32),
                   f"{prefix}swintransformer1.layers.0.blocks.0.attn.relative_position_index":
                   np.zeros((16, 16), np.int64),
                   f"{prefix}swintransformer1.layers.0.blocks.1.attn_mask":
                   np.zeros((1, 16, 16), np.float32)})
        paths[prefix] = save_checkpoint(root / f"maniqa{prefix or '.'}pt", sd)
    return params, cfg, paths


@pytest.mark.parametrize("prefix", ["", "module."], ids=["plain", "dataparallel"])
def test_reader_equals_jax_on_exported_files(inferable, prefix):
    params, cfg, paths = inferable
    jmetric = jm.MANIQAMetric.from_torch(paths[prefix])
    metric = tm.MANIQAMetric.from_torch(paths[prefix], device="cpu")
    assert metric.cfg == cfg
    assert dataclasses.asdict(metric.cfg) == dataclasses.asdict(jmetric.cfg)
    tree = tc.convert_maniqa(tc._strip_module(tc.load_torch_file(paths[prefix])), cfg)
    assert_trees_equal(tree, params)
    assert_trees_equal(tree, jmetric.params)
    assert (metric.num_crops, metric.seed) == (jmetric.num_crops, jmetric.seed) == (20, 0)


def test_reader_refuses_a_tensor_no_table_reads(inferable):
    params, cfg, _ = inferable
    sd = tx.export_maniqa(params, cfg)
    sd["tablock1.2.c_q.weight"] = np.ones((16, 16), np.float32)
    with pytest.raises(ValueError, match="tablock1.2.c_q.weight"):
        tc.convert_maniqa(sd, cfg)
