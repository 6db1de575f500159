"""The port's host-side data pipeline against the JAX package's: blur kernels,
SA-Text items (synthetic and from files) and batches, bit for bit, since both
make the same numpy random calls in the same order."""

import json

import numpy as np
import pytest

from tair_tpu.data import file_backend as jax_fb
from tair_tpu.data import kernels as jax_kernels
from tair_tpu.data import satext as jax_satext
from tair_tpu_torch.data import file_backend as torch_fb
from tair_tpu_torch.data import kernels as torch_kernels
from tair_tpu_torch.data import satext as torch_satext
from test_torch_common import torch_single_thread  # noqa: F401


def _assert_same(ours, theirs, where=""):
    assert type(ours) is type(theirs), where
    if isinstance(ours, dict):
        assert ours.keys() == theirs.keys(), where
        for k in ours:
            _assert_same(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(ours, (list, tuple)):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ours, np.ndarray):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), where
    else:
        assert ours == theirs, where


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_degradation_kernels_bit_equal(seed):
    ours = torch_kernels.sample_degradation_kernels(np.random.RandomState(seed))
    theirs = jax_kernels.sample_degradation_kernels(np.random.RandomState(seed))
    _assert_same(list(ours), list(theirs))


def test_synthetic_items_bit_equal():
    ours = torch_satext.SyntheticSAText(size=64, length=6, seed=3)
    theirs = jax_satext.SyntheticSAText(size=64, length=6, seed=3)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        _assert_same(ours[i], theirs[i], f"item {i}")


def test_first_three_batches_bit_equal():
    def batches(mod):
        ds = mod.SyntheticSAText(size=64, length=7, seed=0)
        it = mod.data_iterator(ds, batch_size=2, seed=5, max_inst=4)
        out = [next(it) for _ in range(3)]
        it.close()
        return out

    _assert_same(batches(torch_satext), batches(jax_satext))


def test_iterator_raises_what_the_dataset_raises():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError("no such record")

    it = torch_satext.data_iterator(Broken(), batch_size=2)
    with pytest.raises(KeyError, match="no such record"):
        next(it)


def _write_satext(root):
    """Four 20x20 PNGs (one unreadable) and restoration_dataset.json with
    instances the filters keep and drop."""
    from PIL import Image

    rng = np.random.default_rng(0)
    images = root / "images"
    images.mkdir()
    data = {}
    for i in range(12):
        name = f"img{i:02d}"
        if i < 11:
            Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
                images / f"{name}.png")
        else:
            (images / f"{name}.png").write_bytes(b"not a png")
        insts = []
        for j, text in enumerate(["OPEN", "café", "x" * 30, "EXIT 2", ""]):
            x, y = 2 + j, 3 + i % 5
            insts.append(dict(
                text=text, bbox=[x, y, x + 10, y + 6],
                polygon=[[x + k * 0.5, y] for k in range(8)] + [[x + 10 - k * 0.5, y + 6]
                                                                for k in range(8)],
            ))
        if i == 4:
            insts = insts[1:3]  # nothing survives the filters: the image is skipped
        data[name] = {"0": {"text_instances": insts}}
    ann = root / "restoration_dataset.json"
    ann.write_text(json.dumps(data))
    return str(images), str(ann)


@pytest.mark.parametrize("mode", ["TRAIN", "VAL"])
def test_satext_files_bit_equal(tmp_path, mode):
    image_root, ann = _write_satext(tmp_path)
    ours = torch_satext.load_satext_file_list(image_root, ann, mode, 20, seed=1)
    theirs = jax_satext.load_satext_file_list(image_root, ann, mode, 20, seed=1)
    _assert_same(ours, theirs)
    assert len(ours) == (9 if mode == "TRAIN" else 2)
    ds_o = torch_satext.SATextDataset(ours, out_size=16, p_empty_prompt=0.5, seed=2)
    ds_t = jax_satext.SATextDataset(theirs, out_size=16, p_empty_prompt=0.5, seed=2)
    for i in range(len(ds_o)):
        _assert_same(ds_o[i], ds_t[i], f"{mode} item {i}")
    _assert_same(torch_satext.collate([ds_o[0], ds_o[-1]], 3),
                 jax_satext.collate([ds_t[0], ds_t[-1]], 3))


def test_unreadable_image_is_replaced_as_in_jax(tmp_path):
    image_root, ann = _write_satext(tmp_path)
    recs = jax_satext.load_satext_file_list(image_root, ann, "TRAIN", 20)
    bad = [r for r in recs if r["img_name"] == "img11"] or recs[:1]
    bad = [dict(bad[0], image_path=str(tmp_path / "images" / "img11.png"))] + recs
    _assert_same(torch_satext.SATextDataset(bad, 16, seed=4)[0],
                 jax_satext.SATextDataset(bad, 16, seed=4)[0])


def test_captions_and_backends():
    texts = ["OPEN", 'say "hi"']
    assert torch_satext.make_caption(texts) == jax_satext.make_caption(texts)
    assert torch_satext.make_tag_prompt(texts) == jax_satext.make_tag_prompt(texts)
    store = torch_fb.get_backend("memory", store={"a": b"xyz"})
    assert store.get("a") == jax_fb.get_backend("memory", store={"a": b"xyz"}).get("a")
    with pytest.raises(ValueError, match="unknown file backend"):
        torch_fb.get_backend("s3")
    with pytest.raises(RuntimeError, match="petrel_client"):
        torch_fb.get_backend("petrel")
