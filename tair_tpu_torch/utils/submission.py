"""Benchmark-interchange writers: COCO-json predictions and RRC zip submissions.

The port's copy of ``tair_tpu/utils/submission.py``. Spotter predictions go
to a COCO-style ``text_results.json`` (a flat list of {image_id,
category_id, polys, rec, score}) and from there to the RRC (Robust Reading
Competition) submission format: one ``{:07d}.txt`` per image, lines
``x1,y1,...,xN,yN,####transcription`` with integer clockwise-ordered
coordinates, zipped, as the published ICDAR/TotalText evaluation servers
consume it:

    dump_coco_json(preds_per_image, image_ids, path)
    coco_json_to_rrc_zip(path, zip_path)
    write_rrc_gt_zip(gts_per_image, image_ids, path)   # GT side, for scoring
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Sequence

import numpy as np

from .text_eval import SpottingInstance

__all__ = [
    "dump_coco_json",
    "coco_json_to_rrc_zip",
    "write_rrc_gt_zip",
    "dump_submission",
]


def _signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def dump_coco_json(
    preds_per_image: Sequence[Sequence[SpottingInstance]],
    image_ids: Sequence[int],
    path: str,
) -> None:
    """Write the reference's `text_results.json`: a flat list of
    {image_id, category_id, polys, rec, score} dicts
    (text_evaluation.py:258-270 instances_to_coco_json)."""
    results = []
    for img_id, preds in zip(image_ids, preds_per_image):
        for inst in preds:
            results.append(
                {
                    "image_id": int(img_id),
                    "category_id": 1,
                    "polys": np.asarray(inst.polygon, np.float64).reshape(
                        -1, 2
                    ).tolist(),
                    "rec": inst.text,
                    "score": float(inst.score),
                }
            )
    with open(path, "w") as f:
        json.dump(results, f)


def _de_ascii(s: str) -> str:
    # the reference strips non-ASCII from transcriptions before dumping
    # (text_evaluation.py:96-101)
    return "".join(c for c in s if ord(c) < 128)


def coco_json_to_rrc_zip(
    json_path: str,
    zip_path: str,
    confidence_threshold: float = 0.5,
    min_score: float = 0.1,
) -> str:
    """COCO-json -> RRC submission zip, with the reference's exact filtering
    and normalization chain (to_eval_format + sort_detection):

    - drop predictions with score <= 0.1, then score < confidence_threshold
      (text_evaluation.py:105,134-136);
    - integer-truncate coordinates (str(int(.)), :112,176-179);
    - strip non-ASCII from transcriptions (:96-101);
    - drop degenerate polygons (<3 points after int-truncation dedup is NOT
      applied by the reference — only shapely validity; we drop <3-point
      and zero-area rings, the cases its Polygon() constructor rejects);
    - force clockwise point order in image coordinates (LinearRing.is_ccw
      -> reverse, :172-175);
    - one `{:07d}.txt` per image id, zipped flat (:130,186-193).

    Returns zip_path.
    """
    with open(json_path) as f:
        data = json.load(f)

    per_image: Dict[int, List[str]] = {}
    for det in data:
        if det["score"] <= min_score or det["score"] < confidence_threshold:
            continue
        pts = np.asarray(det["polys"], np.float64).reshape(-1, 2)
        pts = pts.astype(np.int64)  # str(int(.)) truncation, as the reference
        if len(pts) < 3 or abs(_signed_area(pts.astype(np.float64))) < 1e-9:
            continue  # the cases Polygon()/is_valid rejects in sort_detection
        # image coords are y-down: mathematical CCW == clockwise on screen;
        # the reference reverses when shapely's is_ccw (signed area > 0)
        if _signed_area(pts.astype(np.float64)) > 0:
            pts = pts[::-1]
        coords = ",".join(f"{int(x)},{int(y)}" for x, y in pts)
        rec = _de_ascii(det["rec"])
        per_image.setdefault(int(det["image_id"]), []).append(
            f"{coords},####{rec}"
        )

    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for img_id in sorted(per_image):
            z.writestr(f"{img_id:07d}.txt", "\n".join(per_image[img_id]) + "\n")
    return zip_path


def write_rrc_gt_zip(
    gts_per_image: Sequence[Sequence[SpottingInstance]],
    image_ids: Sequence[int],
    zip_path: str,
) -> str:
    """Ground-truth side of the RRC format (same line syntax; `###` text
    marks a don't-care region), e.g. the reference's bundled
    `gt_totaltext.zip` consumed at text_eval_script.py evaluate_method."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for img_id, gts in zip(image_ids, gts_per_image):
            lines = []
            for inst in gts:
                pts = np.asarray(inst.polygon, np.float64).reshape(-1, 2)
                if _signed_area(pts) > 0:  # keep clockwise like the dets
                    pts = pts[::-1]
                coords = ",".join(f"{int(x)},{int(y)}" for x, y in pts)
                lines.append(f"{coords},####{inst.text}")
            z.writestr(f"{img_id:07d}.txt", "\n".join(lines) + "\n")
    return zip_path


def dump_submission(
    out_dir: str,
    preds_per_image: Sequence[Sequence[SpottingInstance]],
    image_ids: Sequence[int],
    gts_per_image: Sequence[Sequence[SpottingInstance]] | None = None,
    confidence_threshold: float = 0.5,
) -> Dict[str, str]:
    """Write the full interchange bundle into out_dir:
    text_results.json (COCO), det.zip (RRC submission), and — when GTs are
    provided — gt.zip (RRC ground truth). Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"coco_json": os.path.join(out_dir, "text_results.json")}
    dump_coco_json(preds_per_image, image_ids, paths["coco_json"])
    paths["det_zip"] = coco_json_to_rrc_zip(
        paths["coco_json"], os.path.join(out_dir, "det.zip"),
        confidence_threshold=confidence_threshold,
    )
    if gts_per_image is not None:
        paths["gt_zip"] = write_rrc_gt_zip(
            gts_per_image, image_ids, os.path.join(out_dir, "gt.zip")
        )
    return paths
