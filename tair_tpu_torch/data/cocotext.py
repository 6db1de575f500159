"""COCO-style text-spotting datasets (totaltext / ctw1500 / icdar family).

The port's copy of ``tair_tpu/data/cocotext.py`` (numpy only): the
counterpart of the reference's adet data pipeline for standalone-TESTR
training (``adet/data/{builtin.py:19-73, datasets/text.py,
dataset_mapper.py}``): COCO-json annotations with polygon (or bezier) control
points and ``rec`` transcriptions, loaded into per-image records with
normalized coordinates that the static ``[max_inst]`` collate consumes. Bezier
annotations are converted to polygon control points by sampling the two cubic
curves (top / bottom), matching the reference's bezier->polygon mapper. The
charset is the port's own ``spotter/charset.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..spotter.charset import MAX_WORD_LEN, PAD_ID, decode_text

# dataset-name -> (image dir, annotation json), mirroring builtin.py
# the reference's builtin registry (testr/adet/data/builtin.py:21-44),
# same names and relative paths (bezier + _poly variants)
_PREDEFINED = {
    "totaltext_train": ("totaltext/train_images", "totaltext/train.json"),
    "totaltext_val": ("totaltext/test_images", "totaltext/test.json"),
    "ctw1500_word_train": ("CTW1500/ctwtrain_text_image", "CTW1500/annotations/train_ctw1500_maxlen100_v2.json"),
    "ctw1500_word_test": ("CTW1500/ctwtest_text_image", "CTW1500/annotations/test_ctw1500_maxlen100.json"),
    "syntext1_train": ("syntext1/images", "syntext1/annotations/train.json"),
    "syntext2_train": ("syntext2/images", "syntext2/annotations/train.json"),
    "mltbezier_word_train": ("mlt2017/images", "mlt2017/annotations/train.json"),
    "chnsyn_train": ("ChnSyn/syn_130k_images", "ChnSyn/annotations/chn_syntext.json"),
    "totaltext_poly_train": ("totaltext/train_images", "totaltext/train_poly.json"),
    "totaltext_poly_val": ("totaltext/test_images", "totaltext/test_poly.json"),
    "ctw1500_word_poly_train": ("CTW1500/ctwtrain_text_image", "CTW1500/annotations/train_poly.json"),
    "ctw1500_word_poly_test": ("CTW1500/ctwtest_text_image", "CTW1500/annotations/test_poly.json"),
    "syntext1_poly_train": ("syntext1/images", "syntext1/annotations/train_poly.json"),
    "syntext2_poly_train": ("syntext2/images", "syntext2/annotations/train_poly.json"),
    "mltbezier_word_poly_train": ("mlt2017/images", "mlt2017/annotations/train_poly.json"),
    "icdar2015_train": ("icdar2015/train_images", "icdar2015/train_poly.json"),
    "icdar2015_test": ("icdar2015/test_images", "icdar2015/test_poly.json"),
    "icdar2019_train": ("icdar2019/train_images", "icdar2019/train_poly.json"),
}


def bezier_to_polygon(bezier: np.ndarray, n_points: int = 8) -> np.ndarray:
    """[16] bezier control coords (two cubic curves) -> [2*n_points, 2]."""
    pts = bezier.reshape(2, 4, 2)  # two curves, 4 control points each
    t = np.linspace(0, 1, n_points)[:, None]
    out = []
    for curve in pts:
        p0, p1, p2, p3 = curve
        poly = (
            (1 - t) ** 3 * p0
            + 3 * (1 - t) ** 2 * t * p1
            + 3 * (1 - t) * t**2 * p2
            + t**3 * p3
        )
        out.append(poly)
    return np.concatenate(out, 0).astype(np.float32)  # top then bottom


def register_text_instances(name: str, image_root: str, json_file: str) -> None:
    _PREDEFINED[name] = (image_root, json_file)


def load_cocotext(
    root: str,
    name: Optional[str] = None,
    json_file: Optional[str] = None,
    image_root: Optional[str] = None,
    num_ctrl_points: int = 16,
) -> List[Dict]:
    """Load a COCO-text dataset into per-image records (normalized coords)."""
    if name is not None:
        rel_img, rel_json = _PREDEFINED[name]
        image_root = os.path.join(root, rel_img)
        json_file = os.path.join(root, rel_json)

    with open(json_file) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    per_image: Dict[int, List[Dict]] = {}
    for ann in coco["annotations"]:
        per_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img_id, anns in per_image.items():
        im = images[img_id]
        w, h = im["width"], im["height"]
        scale = np.asarray([w, h], np.float32)
        texts, polys, boxes, encs = [], [], [], []
        for ann in anns:
            rec = ann.get("rec")
            if rec is None:
                continue
            text = decode_text(rec)
            if "polys" in ann:
                poly = np.asarray(ann["polys"], np.float32).reshape(-1, 2)
            elif "bezier_pts" in ann:
                poly = bezier_to_polygon(
                    np.asarray(ann["bezier_pts"], np.float32),
                    num_ctrl_points // 2,
                )
            else:
                continue
            if poly.shape[0] != num_ctrl_points:
                # resample to the fixed control-point budget
                idx = np.linspace(0, poly.shape[0] - 1, num_ctrl_points)
                poly = poly[np.round(idx).astype(int)]
            x, y, bw, bh = ann["bbox"]
            boxes.append(
                [(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h]
            )
            polys.append(poly / scale)
            texts.append(text)
            ids = np.full((MAX_WORD_LEN,), PAD_ID, np.int32)
            rec_arr = np.asarray(rec, np.int32)[:MAX_WORD_LEN]
            ids[: len(rec_arr)] = rec_arr
            encs.append(ids)
        if not texts:
            continue
        records.append(
            dict(
                image_path=os.path.join(image_root, im["file_name"]),
                text=texts,
                bbox=np.asarray(boxes, np.float32),
                poly=np.stack(polys),
                text_enc=np.stack(encs),
                img_name=os.path.splitext(im["file_name"])[0],
                prompt="",
            )
        )
    return records
