"""The port's RAM++ tagger and captioners (``tair_tpu_torch/models/ram.py``,
``tair_tpu_torch/utils/caption.py``) against the JAX package's on the CPU.

A tiny configuration (``tests/test_caption.py``'s, with two blocks a Swin
stage so that the second block shifts and masks, and two BERT layers): the
parameters are numpy noise drawn from a seed in the JAX layout (shapes from
the port's module, no JAX trace), written in ``ram_plus_swin_large_14m.pth``'s
layout by the port's exporter and read by both packages' readers, which must
give the same tree bit for bit. The logits are held against one ``jax.jit`` of
the JAX network at 1e-5 of their largest magnitude (float32 on both sides);
``preprocess``, JAX's antialiased bicubic resize and normalisation, at 1e-5.
Tags and captions are equal given per-class thresholds at least 1e-3 from
every probability.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tair_tpu.models import ram as jram
from tair_tpu.utils import caption as jcap
from tair_tpu.weights.convert import convert_ram_plus as jax_convert_ram_plus
from tair_tpu_torch.models import ram as tram
from tair_tpu_torch.utils import caption as tcap
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_fast_compiles, noise_params, save_checkpoint, t2n,
    torch_single_thread,
)

TOL = 1e-5
SWIN = dict(img_size=16, patch_size=4, embed_dim=8, depths=(2, 2), num_heads=(2, 2), window=2,
            mlp_ratio=2.0)
RAM = dict(num_class=5, des_per_class=3, embed_width=8, hidden=8, heads=2, intermediate=16,
           layers=2, threshold=0.5)
TAGS = ("cat", "dog", "sign", "text", "car")


def _cfgs():
    return (jram.RAMConfig(swin=jram.SwinConfig(**SWIN), **RAM),
            tram.RAMConfig(swin=tram.SwinConfig(**SWIN), **RAM))


@pytest.fixture(scope="module")
def tiny():
    """(drawn tree, its checkpoint state dict, JAX config, port config, JAX
    tagger, port tagger on the CPU, normalised images, the JAX logits)."""
    jcfg, cfg = _cfgs()
    with torch.device("meta"):
        shapes = tc.module_param_shapes(tram.RAMPlus(cfg))
    tree = noise_params(shapes, 601)
    sd = tx.export_ram_plus(tree, cfg)
    jtagger = jram.RAMTagger(jax_convert_ram_plus(sd, jcfg), jcfg, tag_list=TAGS)
    tagger = tram.RAMTagger(tc.convert_ram_plus(sd, cfg), cfg, tag_list=TAGS, device="cpu")
    x = np.random.default_rng(602).standard_normal((2, 16, 16, 3), dtype=np.float32)
    return tree, sd, jcfg, cfg, jtagger, tagger, x, np.asarray(jtagger.logits(jnp.asarray(x)))


def test_reader_equals_jax_reader_and_inverts_the_exporter(tiny):
    tree, sd, jcfg, cfg, jtagger, _, _, _ = tiny
    assert sd["reweight_scale"].shape == (1,) and sd["fc.W"].shape == (1, 5, 8)
    assert "tagging_head.encoder.layer.1.crossattention.self.key.weight" in sd
    ours = tc.convert_ram_plus(sd, cfg)
    assert_trees_equal(ours, jtagger.params)
    assert_trees_equal(ours, tree)
    wrapped = {f"module.{k}": v for k, v in tx.export_ram_plus(ours, cfg).items()}
    wrapped["module.visual_encoder.layers.0.blocks.1.attn_mask"] = np.zeros((4, 4, 4), np.float32)
    assert_trees_equal(tc.convert_ram_plus(wrapped, cfg), tree)
    with pytest.raises(ValueError, match="tagging_head.embeddings"):
        tc.convert_ram_plus(dict(sd, **{"tagging_head.embeddings.x": np.ones(1)}), cfg)


def test_logits_equal_jax(tiny):
    _, _, _, _, _, tagger, x, want = tiny
    got = t2n(tagger.logits(x))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_preprocess_equals_jax():
    img = np.random.default_rng(603).random((24, 30, 3), dtype=np.float32)
    want = jram.preprocess(img, 16)
    got = t2n(tram.preprocess(img, 16))
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _thresholds_away_from(probs: np.ndarray) -> np.ndarray:
    """Per class, a threshold at least 1e-3 from every image's probability,
    between them where there is room, so that some tags fire and some not."""
    lo, hi = probs.min(0), probs.max(0)
    th = np.where(hi - lo > 2e-3, (lo + hi) / 2, np.where(lo > 0.5, lo - 1e-3, hi + 1e-3))
    assert np.abs(probs - th[None]).min() >= 1e-3 - 1e-7
    return th.astype(np.float32)


def test_tags_and_captions_equal_jax(tiny):
    _, _, jcfg, cfg, jtagger, tagger, x, want = tiny
    th = _thresholds_away_from(1.0 / (1.0 + np.exp(-want.astype(np.float64))))
    jt = jram.RAMTagger(jtagger.params, jcfg, tag_list=TAGS, thresholds=th)
    tagger.thresholds = np.broadcast_to(th, (5,)).copy()
    tags = tagger(x)
    assert tags == jt(jnp.asarray(x)) and len(tags) == 2
    assert 0 < sum(map(len, tags)) < 10
    image = np.random.default_rng(604).random((24, 30, 3), dtype=np.float32) * 1.2 - 0.1
    probs = 1.0 / (1.0 + np.exp(-t2n(tagger.logits(tram.preprocess(image.clip(0, 1), 16)))))
    # the even classes just above their thresholds, the odd ones just below
    th = (probs[0] + np.where(np.arange(5) % 2 == 0, -1e-3, 1e-3)).astype(np.float32)
    jt.thresholds = tagger.thresholds = th
    text = tcap.build_captioner("ram", tagger=tagger)(image)
    assert text == jcap.RAMCaptioner(tagger=jt)(image) == "cat, sign, car"


def test_from_torch_with_tag_list_and_thresholds(tiny, tmp_path):
    tree, sd, jcfg, cfg, _, _, x, want = tiny
    path = save_checkpoint(tmp_path / "ram_plus_swin_large_14m.pth", sd)
    (tmp_path / "tags.txt").write_text("\n".join(TAGS) + "\n\n")
    (tmp_path / "th.txt").write_text("\n".join(str(v) for v in (0.1, 0.9, 0.5, 0.68, 0.3)))
    tagger = tram.RAMTagger.from_torch(path, cfg, str(tmp_path / "tags.txt"),
                                       str(tmp_path / "th.txt"), device="cpu")
    jt = jram.RAMTagger.from_torch(path, jcfg, str(tmp_path / "tags.txt"),
                                   str(tmp_path / "th.txt"))
    assert tagger.tag_list == jt.tag_list == TAGS
    np.testing.assert_array_equal(tagger.thresholds, jt.thresholds)
    assert_trees_equal(jt.params, tree)
    np.testing.assert_allclose(t2n(tagger.logits(x)), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    default = tram.RAMTagger.from_torch(path, cfg, device="cpu")
    assert default.tag_list[4] == "tag_4" and np.all(default.thresholds == np.float32(0.5))


def test_tag_list_length_mismatch_raises(tiny):
    tree, _, _, cfg, _, _, _, _ = tiny
    with pytest.raises(ValueError, match="4 entries"):
        tram.RAMTagger(tree, cfg, tag_list=TAGS[:4], device="cpu")


def test_build_captioner(tiny, monkeypatch):
    tagger = tiny[5]
    for name in ("empty", "none", "", None):
        assert tcap.build_captioner(name)(np.zeros((4, 4, 3), np.float32)) == ""
    assert isinstance(tcap.build_captioner("ram", tagger=tagger), tcap.RAMCaptioner)
    for name in ("ram", "llava"):
        with pytest.raises(ValueError, match="checkpoint"):
            tcap.build_captioner(name)
    with pytest.raises(ValueError, match="not registered"):
        tcap.build_captioner("blip")
    monkeypatch.setattr(tcap, "_REGISTRY", dict(tcap._REGISTRY))
    tcap.register_captioner("const", lambda: type("C", (tcap.Captioner,), {
        "__call__": lambda self, image: "a photo"})())
    assert tcap.build_captioner("const")(None) == "a photo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tram.RAMTagger(tiny[0], tiny[3])
