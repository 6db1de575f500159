"""The port's CLIP-IQA (``tair_tpu_torch/utils/clipiqa.py``) against the JAX
package's on the CPU, at the JAX tests' tiny geometry (``tests/test_clipiqa.py``:
stem width 8, one bottleneck a stage, embedding 16, 64 x 64 grid; a text tower
of width 8 and 2 layers).

One OpenAI-layout CLIP RN50 state dict is written by the port's exporter from
seeded parameters (the JAX trees traced abstractly and filled with numpy
noise; batch-norm variances made positive; ``logit_scale`` ln 5 so that the
scores sit far from 0 and 1) together with what OpenAI's file carries beside
them (its three integers, the batch norms' update counts). Both packages read
that file with ``from_torch``: the image towers' trees equal bit for bit, the
text embeddings and the scores within 1e-5 (float32 on both sides, sums in
another order; scores in (0, 1), embeddings unit vectors). The images are
numpy-seeded: 64 x 64 (the grid of the positional embedding), and 32 x 96,
where ``pos_embedding="interpolate"`` resizes the grid down on one axis
(antialiased, as ``jax.image.resize``) and up on the other; the same image
with ``"none"``. The JAX image tower is jitted once per shape inside its
metric.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.utils.clipiqa import CLIP_MEAN, CLIP_STD
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_fast_compiles, jax_shapes, noise_params, positive_variances,
    save_checkpoint, t2n, torch_single_thread,
)

WIDTH, LAYERS, EMBED, IMG = 8, (1, 1, 1, 1), 16, 64
TEXT_WIDTH, TEXT_LAYERS = 8, 2
ATOL = 1e-5


def _cfgs():
    from tair_tpu.models.clip import CLIPTextConfig as JaxTextConfig
    from tair_tpu.utils.clipiqa import ModifiedResNetConfig as JaxConfig
    from tair_tpu_torch.models.clip import CLIPTextConfig
    from tair_tpu_torch.utils.clipiqa import ModifiedResNetConfig

    # heads: from_state_dict derives one per 64 channels of the pool's width (8 * 32)
    visual = dict(layers=LAYERS, width=WIDTH, embed_dim=EMBED, heads=WIDTH * 32 // 64,
                  image_size=IMG)
    text = dict(width=TEXT_WIDTH, heads=1, layers=TEXT_LAYERS, layer="last", act="quick_gelu")
    return (JaxConfig(**visual), JaxTextConfig(**text),
            ModifiedResNetConfig(**visual), CLIPTextConfig(**text))


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    """(the seeded tree, the JAX configs, the port's, the file's path)."""
    from tair_tpu.models.clip import CLIPTextTower as JaxTextTower
    from tair_tpu.utils.clipiqa import ModifiedResNet as JaxResNet

    jcfg, jtcfg, cfg, tcfg = _cfgs()
    visual = noise_params(jax_shapes(JaxResNet(jcfg).init, jnp.zeros((1, IMG, IMG, 3)))["params"],
                          171)

    positive_variances(visual)
    text = noise_params(jax_shapes(JaxTextTower(jtcfg).init,
                                   jnp.zeros((1, 77), jnp.int32))["params"], 172)
    rng = np.random.default_rng(173)
    tree = {"visual": visual, "text": text,
            "text_projection": rng.standard_normal((TEXT_WIDTH, EMBED), dtype=np.float32),
            "logit_scale": np.asarray(np.log(5.0), np.float32)}
    sd = tx.export_clipiqa(tree, cfg, tcfg)
    sd.update({"input_resolution": np.asarray(IMG), "context_length": np.asarray(77),
               "vocab_size": np.asarray(49408),
               "visual.bn1.num_batches_tracked": np.asarray(0)})
    path = save_checkpoint(tmp_path_factory.mktemp("clip") / "RN50.pt", sd)
    return tree, (jcfg, jtcfg), (cfg, tcfg), path


@pytest.fixture(scope="module")
def metrics(clip_file):
    """(JAX metric, port's metric), both read from the file."""
    from tair_tpu.utils.clipiqa import CLIPIQAMetric as JaxCLIPIQA
    from tair_tpu_torch.utils.clipiqa import CLIPIQAMetric

    path = clip_file[3]
    return JaxCLIPIQA.from_torch(path), CLIPIQAMetric.from_torch(path, device="cpu")


def _images(h, w, seed):
    return np.random.default_rng(seed).random((2, h, w, 3), dtype=np.float32)


def test_reader_gives_the_jax_tree_and_reads_every_tensor(clip_file, metrics):
    tree, _, (cfg, tcfg), path = clip_file
    jm, tm = metrics
    sd = tc.load_torch_file(path)
    got = tc.convert_clipiqa(sd, cfg, tcfg)
    assert_trees_equal(got, tree)
    assert_trees_equal(got["visual"], jm.visual_params)
    assert_trees_equal(tc.convert_clip_rn50_visual(sd, cfg), jm.visual_params)
    assert tm.cfg == cfg  # the geometry read from the shapes
    assert tm.logit_scale == pytest.approx(5.0) and jm.logit_scale == pytest.approx(5.0)
    with pytest.raises(ValueError, match="visual.layer1.0.extra"):
        tc.convert_clipiqa({**sd, "visual.layer1.0.extra": np.ones(1)}, cfg, tcfg)


def test_text_embeddings_equal_jax(metrics):
    jm, tm = metrics
    assert tuple(tm.text_emb.shape) == (2, EMBED)
    np.testing.assert_allclose(t2n(tm.text_emb), np.asarray(jm.text_emb), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,w", [(IMG, IMG), (32, 96)], ids=["grid", "resized_grid"])
def test_score_equals_jax_with_the_interpolated_grid(metrics, h, w):
    jm, tm = metrics
    imgs = _images(h, w, 174 + h)
    want = np.asarray(jm(jnp.asarray(imgs)))
    got = tm(imgs)
    assert got.shape == (2,)
    assert 0.01 < want.min() and want.max() < 0.99  # far from saturation
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=ATOL)
    # the image tower's embedding, before the prompts
    x = (imgs - np.float32(CLIP_MEAN)) / np.float32(CLIP_STD)
    feat_j = np.asarray(jm._apply(jm.visual_params, jnp.asarray(x)))
    with torch.no_grad():
        feat = tm.visual(torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t2n(feat), feat_j, rtol=0, atol=ATOL * np.abs(feat_j).max())


def test_score_equals_jax_without_the_positional_embedding(metrics):
    """``pos_embedding="none"``, from the JAX metric's parameters (``from_jax_params``)."""
    from tair_tpu.utils.clipiqa import CLIPIQAMetric as JaxCLIPIQA
    from tair_tpu_torch.utils.clipiqa import CLIPIQAMetric

    jm, tm = metrics
    jcfg = dataclasses.replace(jm.visual.cfg, pos_embedding="none")
    jnone = JaxCLIPIQA(jm.visual_params, jm.text_emb, jm.logit_scale, jcfg)
    tnone = CLIPIQAMetric.from_jax_params(
        jm.visual_params, np.asarray(jm.text_emb), jm.logit_scale,
        dataclasses.replace(tm.cfg, pos_embedding="none"), device="cpu")
    imgs = _images(32, 96, 175)
    want = np.asarray(jnone(jnp.asarray(imgs)))
    np.testing.assert_allclose(t2n(tnone(imgs)), want, rtol=0, atol=ATOL)
    # the grid embedding did matter on this image
    assert np.abs(t2n(tm(imgs)) - want).max() > 100 * ATOL


def test_grid_resize_is_jax_image_resize():
    """The positional grid's resize, down on one axis and up on the other."""
    from tair_tpu_torch.data.resize import resize

    grid = np.random.default_rng(176).standard_normal((7, 7, 5), dtype=np.float32)
    for hw in ((3, 12), (12, 3), (7, 16)):
        want = np.asarray(jax.image.resize(jnp.asarray(grid), (*hw, 5), "bilinear"))
        got = resize(torch.from_numpy(grid)[None], hw, "linear")[0]
        np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-6)


def test_clipiqa_wants_a_card_unless_told_cpu(clip_file):
    from tair_tpu_torch.utils.clipiqa import CLIPIQAMetric

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPIQAMetric.from_torch(clip_file[3])
