"""The port's RetinaFace (``tair_tpu_torch/utils/retinaface.py``) and its
reader against the JAX package's on the CPU.

The parameters are numpy noise drawn from a seed in the JAX layout (the
shapes worked out from the port's module, no JAX trace), written as a facexlib
``detection_Resnet50_Final.pth`` state dict by the port's exporter; the JAX
package's ``convert_retinaface`` and the port's reader both read it, and the
two trees must equal each other and the drawn one bit for bit. The full
network runs at 64 x 96 (one ``jax.jit`` of the JAX detector's own forward,
shared by the forward and ``detect`` tests), and a ResNet with one block a
stage at 72 x 100, where the FPN's nearest upsample takes JAX's half-pixel
rule. Outputs are held at 1e-5 of the heads' largest output (the heads'
kernels are drawn at 1/100 of the others', so that their outputs are of order
1 and the decoded boxes, which exponentiate them, stay near the image): float32
on both sides, sums in another order through some 80 convolutions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tair_tpu.utils import retinaface as jr
from tair_tpu.weights.convert import convert_retinaface as jax_convert_retinaface
from tair_tpu_torch.utils import retinaface as tr
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import (  # noqa: F401
    assert_trees_equal, jax_fast_compiles, noise_params, positive_variances, save_checkpoint,
    t2n, torch_single_thread,
)

REL_TOL = 1e-5
# detect's rows: pixel coordinates up to the image's size, decoded from the
# heads' outputs (held at REL_TOL) times prior sizes of 16 to 512 pixels
ROW_TOL_PX = 2.5e-3
HW = (64, 96)


def _seeded_tree(seed: int, layers=(3, 4, 6, 3)):
    with torch.device("meta"):
        shapes = tc.module_param_shapes(tr.RetinaFace(layers=layers))
    tree = noise_params(shapes, seed)
    positive_variances(tree)
    for name, node in tree.items():  # head outputs of order 1: boxes exp() their deltas
        if name.startswith(("class_head", "bbox_head", "ldm_head")):
            node["kernel"] = node["kernel"] * np.float32(0.01)
    return tree


def _assert_outputs_close(got, want):
    want = [np.asarray(w) for w in want]
    scale = max(np.abs(w).max() for w in want[1:])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(t2n(g) - w).max()
        assert err <= REL_TOL * scale, (err, scale)


@pytest.fixture(scope="module")
def full():
    """(drawn tree, its facexlib state dict, the JAX detector, the port's on
    the CPU, an input, the JAX network's outputs on it)."""
    tree = _seeded_tree(301)
    sd = tx.export_retinaface(tree)
    jdet = jr.RetinaFaceDetector(jax_convert_retinaface(sd))
    det = tr.RetinaFaceDetector(tc.convert_retinaface(sd), device="cpu")
    x = np.random.default_rng(302).standard_normal((1, *HW, 3), dtype=np.float32) * 20.0
    want = jdet._apply(jdet.params, jnp.asarray(x))
    return tree, sd, jdet, det, x, want


def test_reader_equals_jax_reader_and_inverts_the_exporter(full):
    tree, sd, jdet, _, _, _ = full
    assert "ssh1.conv7x7_3.0.weight" in sd and "ClassHead.2.conv1x1.bias" in sd
    ours = tc.convert_retinaface(sd)
    assert_trees_equal(ours, jdet.params)
    assert_trees_equal(ours, tree)
    assert_trees_equal(tc.convert_retinaface(tx.export_retinaface(ours)), tree)
    extra = dict(sd, **{"fpn.merge3.0.weight": np.ones((1, 1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="fpn.merge3.0.weight"):
        tc.convert_retinaface(extra)


def test_forward_equals_jax(full):
    _, _, _, det, x, want = full
    with torch.no_grad():
        got = det.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    n = sum(int(np.ceil(HW[0] / s)) * int(np.ceil(HW[1] / s)) * 2 for s in (8, 16, 32))
    assert got[0].shape == (1, n, 2)
    _assert_outputs_close(got, want)


class _SmallBody(jr.ResNet50Backbone):
    layers: tuple = (1, 1, 1, 1)


def test_small_body_off_multiples_of_32_equals_jax(monkeypatch):
    """C3/C4/C5 of 9 x 13, 5 x 7, 3 x 4: the nearest upsamples take
    floor((i + 0.5) * in / out), which torch's "nearest" does not."""
    np.testing.assert_array_equal(tr._nearest_index(3, 5), [0, 0, 1, 2, 2])
    tree = _seeded_tree(303, layers=(1, 1, 1, 1))
    x = np.random.default_rng(304).standard_normal((1, 72, 100, 3), dtype=np.float32) * 20.0
    monkeypatch.setattr(jr, "ResNet50Backbone", _SmallBody)
    net = jr.RetinaFace(jr.RetinaFaceConfig())
    want = jax.jit(lambda p, x: net.apply({"params": p}, x))(tree, jnp.asarray(x))
    with torch.device("meta"):
        ours = tr.RetinaFace(layers=(1, 1, 1, 1))
    ours = ours.to_empty(device="cpu")
    ours.load_state_dict(tc.convert_tree(tree), strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_outputs_close(got, want)


def test_priors_decode_nms_bit_equal():
    cfg, jcfg = tr.RetinaFaceConfig(), jr.RetinaFaceConfig()
    rng = np.random.default_rng(305)
    for h, w in ((64, 96), (70, 90)):
        pri = tr.priors_for(h, w, cfg)
        np.testing.assert_array_equal(pri, jr.priors_for(h, w, jcfg))
        deltas = rng.standard_normal((len(pri), 10), dtype=np.float32)
        np.testing.assert_array_equal(tr.decode_boxes(deltas[:, :4], pri, cfg.variances),
                                      jr.decode_boxes(deltas[:, :4], pri, jcfg.variances))
        np.testing.assert_array_equal(tr.decode_landmarks(deltas, pri, cfg.variances),
                                      jr.decode_landmarks(deltas, pri, jcfg.variances))
    xy = rng.random((200, 2), dtype=np.float32) * 50
    boxes = np.concatenate([xy, xy + 5 + rng.random((200, 2), dtype=np.float32) * 20], axis=1)
    scores = rng.random(200, dtype=np.float32)
    for thresh in (0.2, 0.4):
        keep = tr.nms(boxes, scores, thresh)
        assert keep == jr.nms(boxes, scores, thresh) and 1 < len(keep) < 200


def test_detect_rows_equal_jax(full):
    _, _, jdet, det, _, _ = full
    img = np.random.default_rng(306).random((*HW, 3), dtype=np.float32)
    conf = np.asarray(jdet._apply(jdet.params, jnp.asarray(
        img[..., ::-1] * 255.0 - np.asarray(jr.BGR_MEAN, np.float32))[None])[0])[0, :, 1]
    # a threshold at least 1e-3 from every score, leaving a few dozen candidates
    order = np.sort(conf)[::-1]
    gaps = [(order[i] + order[i + 1]) / 2 for i in range(10, len(order) - 1)
            if order[i] - order[i + 1] >= 2e-3]
    assert gaps
    thresh = float(gaps[0])
    assert np.abs(conf - thresh).min() >= 1e-3
    want = jdet.detect(img, conf_threshold=thresh)
    got = det.detect(img, conf_threshold=thresh)
    assert got.shape == want.shape and got.shape[1] == 15 and len(got) > 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ROW_TOL_PX)
    lms = det.as_landmark_detector(thresh)(img)
    assert len(lms) == len(got) and lms[0].shape == (5, 2)
    assert len(det.detect(img, conf_threshold=1.0)) == 0


def test_from_torch_reads_an_exported_pth(full, tmp_path):
    tree, _, _, _, _, _ = full
    sd = tx.export_retinaface(tree, prefix="module.")
    sd["module.body.bn1.num_batches_tracked"] = np.asarray(7, np.int64)
    path = save_checkpoint(tmp_path / "detection_Resnet50_Final.pth", sd)
    det = tr.RetinaFaceDetector.from_torch(path, device="cpu")
    jdet = jr.RetinaFaceDetector.from_torch(path)
    assert_trees_equal(jdet.params, tree)
    state = det.net.state_dict()
    for name, value in tc.convert_tree(tree).items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0)


def test_detector_for_the_card_raises_without_one(full, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.RetinaFaceDetector(full[0])
