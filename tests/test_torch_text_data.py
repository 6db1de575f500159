"""The port's text-spotting data modules (``tair_tpu_torch/data/augmentation.py``
and ``data/cocotext.py``) against the JAX package's, bit for bit: the resize,
flip and instance-keeping crop, the whole ``TextAugmentor`` chain on seeded
records, bezier sampling, and ``load_cocotext`` on a COCO-text JSON written to
a temporary directory (by path, by registered name and by predefined name)."""

import json

import numpy as np
import pytest

from tair_tpu.data import augmentation as ja
from tair_tpu.data import cocotext as jc
from tair_tpu_torch.data import augmentation as ta
from tair_tpu_torch.data import cocotext as tc


def _equal(got, want):
    """Records (dicts, lists, arrays, scalars) equal value for value and dtype."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _polys(rng, n, p=16):
    lo = rng.uniform(0.05, 0.6, (n, 1, 2))
    return (lo + rng.uniform(0.0, 0.3, (n, p, 2))).astype(np.float32)


@pytest.mark.parametrize("h,w,min_size,max_size", [(40, 64, 32, 10_000), (48, 30, 64, 80),
                                                   (33, 33, 33, 10_000)])
def test_resize_shortest_edge_equals_jax(h, w, min_size, max_size):
    img = _image(np.random.default_rng(h * w), h, w)
    _equal(ta.resize_shortest_edge(img, min_size, max_size),
           ja.resize_shortest_edge(img, min_size, max_size))


@pytest.mark.parametrize("seed", range(4))
def test_hflip_and_crop_equal_jax(seed):
    rng = np.random.default_rng(seed)
    img, polys = _image(rng, 60, 80), _polys(rng, 3 if seed else 0)
    _equal(ta.hflip(img, polys), ja.hflip(img, polys))
    got = ta.random_crop_with_instances(img, polys, (0.5, 1.0), np.random.RandomState(seed))
    want = ja.random_crop_with_instances(img, polys, (0.5, 1.0), np.random.RandomState(seed))
    _equal(got, want)


def test_text_augmentor_equals_jax():
    rng = np.random.default_rng(3)
    for index in range(12):
        n = int(rng.integers(0, 4))
        polys = _polys(rng, n)
        record = dict(
            poly=polys, text=[f"w{k}" for k in range(n)],
            bbox=rng.random((n, 4)).astype(np.float32),
            text_enc=rng.integers(0, 97, (n, 25)).astype(np.int32), prompt="",
        )
        img = _image(rng, 48, 64)
        for kwargs in (dict(seed=5), dict(seed=1, crop_prob=1.0, hflip_prob=1.0, min_size=40)):
            got = ta.TextAugmentor(**kwargs)(img, record, index)
            want = ja.TextAugmentor(**kwargs)(img, record, index)
            _equal(got, want)


def test_bezier_to_polygon_equals_jax():
    bezier = np.random.default_rng(0).uniform(0, 100, 16).astype(np.float32)
    for n_points in (8, 5):
        _equal(tc.bezier_to_polygon(bezier, n_points), jc.bezier_to_polygon(bezier, n_points))


def _coco_json(path):
    rng = np.random.default_rng(1)

    def ann(image_id, k, **fields):
        return dict(id=k, image_id=image_id, bbox=[float(v) for v in rng.uniform(5, 50, 4)],
                    rec=[int(c) for c in rng.integers(0, 97, int(rng.integers(1, 30)))], **fields)

    coco = dict(
        images=[dict(id=1, file_name="a.jpg", width=120, height=80),
                dict(id=2, file_name="b.png", width=64, height=64),
                dict(id=3, file_name="c.jpg", width=50, height=40)],
        annotations=[
            ann(1, 1, polys=[float(v) for v in rng.uniform(0, 80, 32)]),  # 16 points
            ann(1, 2, polys=[float(v) for v in rng.uniform(0, 80, 40)]),  # 20: resampled
            ann(2, 3, bezier_pts=[float(v) for v in rng.uniform(0, 64, 16)]),
            ann(2, 4),                                                     # no geometry
            dict(id=5, image_id=3, bbox=[1, 2, 3, 4], polys=[0.0] * 32),  # no rec
        ],
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(coco))


def test_load_cocotext_equals_jax(tmp_path):
    _coco_json(tmp_path / "totaltext" / "train.json")
    json_file, image_root = str(tmp_path / "totaltext" / "train.json"), str(tmp_path / "imgs")
    got = tc.load_cocotext(str(tmp_path), json_file=json_file, image_root=image_root)
    want = jc.load_cocotext(str(tmp_path), json_file=json_file, image_root=image_root)
    _equal(got, want)
    assert [r["img_name"] for r in got] == ["a", "b"]  # image 3 has no usable annotation
    # by a predefined name, and by a registered one
    _equal(tc.load_cocotext(str(tmp_path), name="totaltext_train"),
           jc.load_cocotext(str(tmp_path), name="totaltext_train"))
    for module in (tc, jc):
        module.register_text_instances("port_test_set", "imgs", "totaltext/train.json")
    _equal(tc.load_cocotext(str(tmp_path), name="port_test_set", num_ctrl_points=8),
           jc.load_cocotext(str(tmp_path), name="port_test_set", num_ctrl_points=8))
    _equal(tc._PREDEFINED, jc._PREDEFINED)
