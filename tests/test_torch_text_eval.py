"""ICDAR text evaluation, submission files and NIQE of the port against the
JAX package, and the port's ``spotter_eval`` entry point.

- ``fill_poly`` against ``cv2.fillPoly`` mask for mask, on seeded convex,
  concave, self-intersecting, degenerate (one point, collinear, two points,
  horizontal), tiny and grid-aligned (many exact half-pixel crossings)
  polygons with integer vertices on the 768² canvas: no class needs a
  tolerance.
- ``polygon_iou``, ``polygon_intersection_over_det``, ``evaluate_image`` /
  ``evaluate_dataset`` (counts and scores), ``LexiconMatcher.find_match_word``
  (plain and recognition-weighted) and the dictionary rules equal to JAX's on
  seeded instances.
- ``dump_submission``'s JSON equal and its zips' members equal (the zip bytes
  carry a time stamp).
- NIQE within 1e-6 of JAX on parameters both packages fit from seeded images.
- ``python -m tair_tpu_torch.spotter_eval`` in process on the CPU
  (configs/train_smoke.yaml): the JSON keys of the JAX script
  (``spotter_eval.py:164-183``) and the ``--dump-dir`` bundle.
"""

import json
import zipfile

import numpy as np
import pytest

from test_torch_common import torch_single_thread  # noqa: F401

CANVAS = 768


def _polygon(kind: str, rng: np.random.Generator) -> np.ndarray:
    n = int(rng.integers(3, 17))
    if kind == "convex":
        c, r = rng.uniform(100, 660, 2), rng.uniform(5, 100)
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        p = c + r * np.stack([np.cos(a), np.sin(a)], 1) * rng.uniform(0.5, 1.5, 2)
    elif kind == "concave":
        c, a = rng.uniform(200, 560, 2), np.sort(rng.uniform(0, 2 * np.pi, n))
        p = c + rng.uniform(10, 200, n)[:, None] * np.stack([np.cos(a), np.sin(a)], 1)
    elif kind == "self_intersecting":
        p = rng.uniform(0, CANVAS - 1, (n, 2))
    elif kind == "degenerate":
        which = int(rng.integers(0, 4))
        if which == 0:  # one point repeated
            p = np.repeat(rng.uniform(0, CANVAS - 1, (1, 2)), n, 0)
        elif which == 1:  # collinear points
            a, b = rng.uniform(0, CANVAS - 1, (2, 2))
            p = a + rng.uniform(0, 1, n)[:, None] * (b - a)
        elif which == 2:  # two points
            p = rng.uniform(0, CANVAS - 1, (2, 2))
        else:  # horizontal
            p = np.stack([rng.uniform(0, CANVAS - 1, n), np.full(n, rng.uniform(0, CANVAS - 1))], 1)
    elif kind == "tiny":
        p = rng.uniform(5, CANVAS - 8, 2) + rng.uniform(-4, 4, (n, 2))
    else:  # grid: vertices on multiples of 95 pixels
        p = rng.integers(0, 9, (n, 2)) * 95.0
    return np.clip(np.round(p), 0, CANVAS - 1).astype(np.int32)


KINDS = ["convex", "concave", "self_intersecting", "degenerate", "tiny", "grid"]


@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_equals_cv2_fillpoly(kind):
    import cv2

    from tair_tpu_torch.utils.text_eval import fill_poly

    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(150):
        pts = _polygon(kind, rng)
        want = np.zeros((CANVAS, CANVAS), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = fill_poly(np.zeros((CANVAS, CANVAS), np.uint8), pts)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind}: {pts.tolist()}")


def test_fill_poly_refuses_vertices_off_the_mask():
    from tair_tpu_torch.utils.text_eval import fill_poly

    with pytest.raises(ValueError):
        fill_poly(np.zeros((8, 8), np.uint8), np.array([[0, 0], [8, 3], [2, 5]]))


def _instances(rng, n_images=6, texts=("OPEN", "EXIT", "###", "a", "Café's", "-HELLO-")):
    """Seeded ground truths and predictions: predictions near (IoU around the
    0.5 threshold), far from, and on top of the ground truths, some with the
    right transcription."""
    from tair_tpu_torch.utils.text_eval import SpottingInstance

    all_gts, all_preds = [], []
    for _ in range(n_images):
        gts, preds = [], []
        for _ in range(int(rng.integers(0, 5))):
            c, a = rng.uniform(20, 400, 2), np.sort(rng.uniform(0, 2 * np.pi, 16))
            poly = c + rng.uniform(20, 30, (16, 1)) * np.stack([2 * np.cos(a), np.sin(a)], 1)
            text = str(rng.choice(texts))
            gts.append(SpottingInstance(poly.astype(np.float32), text))
            for _ in range(int(rng.integers(0, 3))):
                shift = rng.uniform(-25, 25, 2) * rng.choice([0.1, 1.0, 3.0])
                guess = text if rng.random() < 0.5 else str(rng.choice(texts))
                preds.append(SpottingInstance(
                    (poly + shift).astype(np.float32), guess.upper(), float(rng.random())))
        for _ in range(int(rng.integers(0, 3))):
            preds.append(SpottingInstance(
                rng.uniform(0, 500, (16, 2)).astype(np.float32), "ZZZ", float(rng.random())))
        all_gts.append(gts)
        all_preds.append(preds)
    return all_gts, all_preds


@pytest.mark.parametrize("word_spotting", [True, False])
def test_evaluate_dataset_equals_jax(word_spotting):
    from tair_tpu.utils import text_eval as jt
    from tair_tpu_torch.utils import text_eval as tt

    all_gts, all_preds = _instances(np.random.default_rng(3 + word_spotting))
    got = tt.evaluate_dataset(all_gts, all_preds, word_spotting=word_spotting)
    want = jt.evaluate_dataset(all_gts, all_preds, word_spotting=word_spotting)
    assert got == want
    assert want["matched_det"] > 0 and want["num_pred"] > want["matched_det"]
    for gts, preds in zip(all_gts, all_preds):
        for g in gts:
            for p in preds:
                assert tt.polygon_iou(g.polygon, p.polygon) == jt.polygon_iou(g.polygon, p.polygon)
                assert tt.polygon_intersection_over_det(g.polygon, p.polygon) == \
                    jt.polygon_intersection_over_det(g.polygon, p.polygon)


def test_dictionary_rules_equal_jax():
    from tair_tpu.utils import text_eval as jt
    from tair_tpu_torch.utils import text_eval as tt

    words = ["OPEN", "it's", "-ab-", "a b", "ok", "×yz", "Ζεύς", "3rd", "(EXIT)", "\"no\"", ""]
    for w in words:
        assert tt.include_in_dictionary(w) == jt.include_in_dictionary(w)
        assert tt.dictionary_transcription(w) == jt.dictionary_transcription(w)
        for d in ("OPEN", "EXIT", "NO", w[1:], w[:-1]):
            for strict in (True, False):
                assert tt.transcription_match(w, d, only_remove_first_last_character_gt=strict) \
                    == jt.transcription_match(w, d, only_remove_first_last_character_gt=strict)


@pytest.mark.parametrize("weighted", [False, True])
def test_lexicon_matcher_equals_jax(weighted):
    from tair_tpu.utils import text_eval as jt
    from tair_tpu_torch.utils import text_eval as tt

    rng = np.random.default_rng(9)
    lexicon = ["OPEN", "EXIT", "HOTEL", "Café", "STOP", "SALE", "street"]
    char_to_col = {c: i for i, c in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyzé")}
    letters = list(char_to_col)
    queries = ["0PEN", "EXT", "HOTTEL", "cafe", "XYZQW", "STREET", "S", "SALES"] + [
        "".join(rng.choice(letters, int(rng.integers(1, 7)))) for _ in range(12)]
    for full, kind in ((False, 2), (True, 2), (False, 1)):
        got_m = tt.LexiconMatcher(lexicon, lexicon_type=kind, full_lexicon=full, weighted_ed=weighted)
        want_m = jt.LexiconMatcher(lexicon, lexicon_type=kind, full_lexicon=full, weighted_ed=weighted)
        for q in queries:
            scores = rng.dirichlet(np.ones(len(char_to_col)), len(q)).astype(np.float32)
            kw = dict(scores=scores, char_to_col=char_to_col) if weighted else {}
            assert got_m.find_match_word(q, **kw) == want_m.find_match_word(q, **kw), q
    assert tt.edit_distance("kitten", "sitting") == jt.edit_distance("kitten", "sitting") == 3


def test_dump_submission_members_equal_jax(tmp_path):
    from tair_tpu.utils.submission import dump_submission as jax_dump
    from tair_tpu_torch.utils.submission import dump_submission

    all_gts, all_preds = _instances(np.random.default_rng(11))
    ids = list(range(1, len(all_gts) + 1))
    got = dump_submission(str(tmp_path / "port"), all_preds, ids, gts_per_image=all_gts,
                          confidence_threshold=0.3)
    want = jax_dump(str(tmp_path / "jax"), all_preds, ids, gts_per_image=all_gts,
                    confidence_threshold=0.3)
    assert set(got) == set(want) == {"coco_json", "det_zip", "gt_zip"}
    with open(got["coco_json"]) as a, open(want["coco_json"]) as b:
        assert json.load(a) == json.load(b)
    for key in ("det_zip", "gt_zip"):
        with zipfile.ZipFile(got[key]) as a, zipfile.ZipFile(want[key]) as b:
            assert a.namelist() == b.namelist() and a.namelist()
            for name in a.namelist():
                assert a.read(name) == b.read(name)


def test_niqe_equals_jax():
    from tair_tpu.utils import niqe as jn
    from tair_tpu_torch.utils import niqe as tn

    rng = np.random.default_rng(13)
    pristine = [rng.random((192, 192)) * 255 for _ in range(3)]
    p_t, p_j = tn.fit_niqe_params(pristine, patch=48), jn.fit_niqe_params(pristine, patch=48)
    np.testing.assert_allclose(p_t.mu, p_j.mu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_t.cov, p_j.cov, rtol=0, atol=1e-6)
    for shape in ((192, 192, 3), (200, 150)):
        img = rng.random(shape).astype(np.float32)
        if len(shape) == 2:
            img = img * 255
        got, want = tn.niqe(img, p_t, patch=48), jn.niqe(img, p_j, patch=48)
        assert np.isfinite(got) and abs(got - want) <= 1e-6


# ---- the entry point ------------------------------------------------------

# the keys spotter_eval.py:164-183 prints, with --lexicon-from-gt
SPOTTER_EVAL_KEYS = {
    "det_precision", "det_recall", "det_hmean", "e2e_precision", "e2e_recall", "e2e_hmean",
    "matched_det", "matched_e2e", "num_gt", "num_pred", "num_gt_det", "num_pred_det",
    "lexicon_words", "e2e_precision_lex", "e2e_recall_lex", "e2e_hmean_lex",
}


@pytest.mark.parametrize("degrade", [True, False], ids=["degraded", "no_degrade"])
def test_spotter_eval_entry_point_prints_the_jax_scripts_keys(tmp_path, capsys, degrade):
    from pathlib import Path

    from tair_tpu_torch.spotter_eval import main

    root = Path(__file__).resolve().parents[1]
    dump = tmp_path / "dump"
    main(["--config", str(root / "configs" / "train_smoke.yaml"), "--device", "cpu",
          "--num-images", "3", "--score-threshold", "0.3", "--lexicon-from-gt",
          "--dump-dir", str(dump), *([] if degrade else ["--no-degrade"])])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert set(out) == SPOTTER_EVAL_KEYS
    for k in SPOTTER_EVAL_KEYS - {"lexicon_words"}:
        assert out[k] >= 0 and (not k.endswith(("precision", "recall", "hmean")) or out[k] <= 1)
    assert out["num_gt_det"] > 0 and out["lexicon_words"] > 0
    assert sorted(p.name for p in dump.iterdir()) == ["det.zip", "gt.zip", "text_results.json"]
    with zipfile.ZipFile(dump / "gt.zip") as z:
        assert z.namelist() == ["0000001.txt", "0000002.txt", "0000003.txt"]
