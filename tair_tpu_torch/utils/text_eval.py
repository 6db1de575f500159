"""ICDAR/RRC text-spotting evaluation, the reference protocol (host side).

The port's copy of ``tair_tpu/utils/text_eval.py:53-551``: don't-care
ground truths ("###", and in word-spotting mode every GT that fails
``include_in_dictionary``, the kept ones normalised by
``dictionary_transcription``); detections overlapping a don't-care GT by more
than the area-precision threshold excluded; one-to-one matching in index
order with strict IoU > threshold; end-to-end correctness by exact upper-case
match (word spotting) or ``transcription_match``; detection-only counts with
"###"-only don't-cares; the zero-GT edge rule; global aggregation by summed
counts; lexicon-constrained correction (``LexiconMatcher``); and COCO-style
``average_precision`` over polygon IoU, accumulated by the native C++ helper
(``native_ext.coco_ap``) or by its Python oracle ``_ap_accumulate_py``.

Polygon IoU is measured on masks rasterised on a 768² canvas. The JAX module
fills them with ``cv2.fillPoly``; here ``fill_poly`` is a numpy scanline fill
with the same pixel set for integer vertices inside the canvas (checked mask
for mask against OpenCV 5.0's ``fillPoly``): the 8-connected outline of every
edge (``cv2.line``'s Bresenham walk, left to right) joined with the spans
between pairs of edge crossings at each row, where an edge from y0 to y1
crosses rows y0 <= y < y1 at x + 0.5, a span starts at the floor of its left
crossing and ends before the ceiling of its right one, all in exact integer
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# transcription_match leniency set (text_eval_script.py:38,143)
SPECIAL_CHARACTERS = '!?.:,*"()·[]/\''
# include_in_dictionary replacement set (text_eval_script.py:190) — note the
# leading apostrophe and no trailing one; NOT the same set as above.
_DICT_SPECIAL_CHARACTERS = "'!?.:,*\"()·[]/"
_NOT_ALLOWED = "×÷·"
_ALLOWED_RANGES = (
    (ord("a"), ord("z")),
    (ord("A"), ord("Z")),
    (ord("À"), ord("ƿ")),
    (ord("Ǆ"), ord("ɿ")),
    (ord("Ά"), ord("Ͽ")),
    (ord("-"), ord("-")),
)


@dataclass
class SpottingInstance:
    polygon: np.ndarray  # [N, 2] pixel coords
    text: str
    score: float = 1.0


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """(xs, ys) of the 8-connected line from (x0, y0) to (x1, y1) as OpenCV
    walks it: from the left end, one step along the major axis each pixel
    and one along the minor axis where Bresenham's error goes negative."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    if dy > dx:
        i = np.arange(dy + 1, dtype=np.int64)
        return x0 - (dy - 2 * dx * i) // (2 * dy), y0 + sy * i
    i = np.arange(dx + 1, dtype=np.int64)
    minor = -((dx - 2 * dy * i) // (2 * dx)) if dx else np.zeros(1, np.int64)
    return x0 + i, y0 + sy * minor


def fill_poly(mask: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Set to 1 the pixels of `mask` [H, W] that ``cv2.fillPoly(mask, [pts],
    1)`` sets, for integer vertices `pts` [N, 2] (x, y) inside the mask;
    self-intersecting polygons fill by the even-odd rule. Returns `mask`."""
    h, w = mask.shape
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return mask
    if pts.min() < 0 or (pts[:, 0] >= w).any() or (pts[:, 1] >= h).any():
        raise ValueError("fill_poly takes vertices inside the mask")
    line_x, line_y, rows, nums, dens = [], [], [], [], []
    for (x0, y0), (x1, y1) in zip(np.roll(pts, 1, axis=0).tolist(), pts.tolist()):
        lx, ly = _line_pixels(x0, y0, x1, y1)
        line_x.append(lx)
        line_y.append(ly)
        if y0 == y1:
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        r = np.arange(y0, y1, dtype=np.int64)
        # the crossing at row r is num / den: x0 + 0.5 + (r - y0)(x1 - x0)/(y1 - y0)
        rows.append(r)
        nums.append((2 * x0 + 1) * (y1 - y0) + 2 * (r - y0) * (x1 - x0))
        dens.append(np.full_like(r, 2 * (y1 - y0)))
    if rows:
        rows, num, den = np.concatenate(rows), np.concatenate(nums), np.concatenate(dens)
        order = np.lexsort((num / den, rows))  # each row holds an even number of crossings
        rows, num, den = rows[order], num[order], den[order]
        start = num[0::2] // den[0::2]
        stop = -(-num[1::2] // den[1::2])  # one past the span's last pixel
        for row, a, b in zip(rows[0::2].tolist(), start.tolist(), stop.tolist()):
            mask[row, a:b] = 1
    mask[np.concatenate(line_y), np.concatenate(line_x)] = 1
    return mask


def _pair_masks(poly_a: np.ndarray, poly_b: np.ndarray, canvas: int):
    """The masks of two polygons scaled together onto a canvas x canvas grid,
    as the JAX module rasterises them, cut to the bounding box of both
    (translation moves no pixel of the fill). None when the two boxes do not
    meet: the masks then share no pixel."""
    both = np.concatenate([poly_a, poly_b], 0)
    lo = both.min(0)
    scale = max(1e-6, float((both - lo).max()))
    qa, qb = (
        np.round((p - lo) / scale * (canvas - 1)).astype(np.int32).astype(np.int64)
        for p in (poly_a, poly_b)
    )
    if (qa.max(0) < qb.min(0)).any() or (qb.max(0) < qa.min(0)).any():
        return None
    q_lo = np.minimum(qa.min(0), qb.min(0))
    w, h = np.maximum(qa.max(0), qb.max(0)) - q_lo + 1
    return (fill_poly(np.zeros((h, w), np.uint8), qa - q_lo),
            fill_poly(np.zeros((h, w), np.uint8), qb - q_lo))


def polygon_iou(
    poly_a: np.ndarray, poly_b: np.ndarray, canvas: int = 768
) -> float:
    masks = _pair_masks(poly_a, poly_b, canvas)
    if masks is None:
        return 0.0
    ma, mb = masks
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / max(float(union), 1.0)


def polygon_intersection_over_det(
    poly_gt: np.ndarray, poly_det: np.ndarray, canvas: int = 768
) -> float:
    """intersection(gt, det) / area(det) — the don't-care overlap test
    (text_eval_script.py:339-342)."""
    masks = _pair_masks(poly_gt, poly_det, canvas)
    if masks is None:
        return 0.0
    mg, md = masks
    det_area = float(md.sum())
    if det_area == 0:
        return 0.0
    return float(np.logical_and(mg, md).sum()) / det_area


def include_in_dictionary(transcription: str, min_length: int = 3) -> bool:
    """Word-spotting rule: does this GT transcription enter the dictionary?
    Mirrors text_eval_script.py:179-220; GTs failing this become don't-care."""
    if transcription[-2:] in ("'s", "'S"):
        transcription = transcription[:-2]
    transcription = transcription.strip("-")
    for ch in _DICT_SPECIAL_CHARACTERS:
        transcription = transcription.replace(ch, " ")
    transcription = transcription.strip()
    if len(transcription) != len(transcription.replace(" ", "")):
        return False
    if len(transcription) < min_length:
        return False
    for ch in transcription:
        if ch in _NOT_ALLOWED:
            return False
        code = ord(ch)
        if not any(lo <= code <= hi for lo, hi in _ALLOWED_RANGES):
            return False
    return True


def dictionary_transcription(transcription: str) -> str:
    """Normalization applied to kept word-spotting GTs
    (text_eval_script.py:222-239)."""
    if transcription[-2:] in ("'s", "'S"):
        transcription = transcription[:-2]
    transcription = transcription.strip("-")
    for ch in _DICT_SPECIAL_CHARACTERS:
        transcription = transcription.replace(ch, " ")
    return transcription.strip()


def transcription_match(
    trans_gt: str,
    trans_det: str,
    special_characters: str = SPECIAL_CHARACTERS,
    only_remove_first_last_character_gt: bool = True,
) -> bool:
    """Non-word-spotting e2e match with first/last special-character leniency
    on the GT (text_eval_script.py:143-176)."""
    if only_remove_first_last_character_gt:
        if trans_gt == trans_det:
            return True
        if trans_gt and trans_gt[0] in special_characters:
            if trans_gt[1:] == trans_det:
                return True
        if trans_gt and trans_gt[-1] in special_characters:
            if trans_gt[:-1] == trans_det:
                return True
        if (
            len(trans_gt) >= 2
            and trans_gt[0] in special_characters
            and trans_gt[-1] in special_characters
            and trans_gt[1:-1] == trans_det
        ):
            return True
        return False
    while trans_gt and trans_gt[0] in special_characters:
        trans_gt = trans_gt[1:]
    while trans_det and trans_det[0] in special_characters:
        trans_det = trans_det[1:]
    while trans_gt and trans_gt[-1] in special_characters:
        trans_gt = trans_gt[:-1]
    while trans_det and trans_det[-1] in special_characters:
        trans_det = trans_det[:-1]
    return trans_gt == trans_det


def evaluate_image(
    gts: Sequence[SpottingInstance],
    preds: Sequence[SpottingInstance],
    iou_threshold: float = 0.5,
    area_precision_threshold: float = 0.5,
    word_spotting: bool = True,
    min_length_care_word: int = 3,
) -> Dict[str, int]:
    """One image's match counts under the full reference protocol.

    Returns e2e counters (word-spotting / transcription-match don't-cares)
    and det-only counters ("###"-only don't-cares), matching
    text_eval_script.py:259-434 exactly.
    """
    # --- GT don't-care classification ---
    gt_texts: List[str] = []
    gt_dontcare: List[bool] = []  # e2e (word-spotting filtered)
    gt_dontcare_det: List[bool] = []  # det-only ("###" only)
    for gt in gts:
        text = gt.text
        dc_det = dc = text == "###"
        if word_spotting and not dc:
            if not include_in_dictionary(text, min_length_care_word):
                dc = True
            else:
                text = dictionary_transcription(text)
        gt_texts.append(text)
        gt_dontcare.append(dc)
        gt_dontcare_det.append(dc_det)

    # --- detections overlapping a don't-care GT are excluded ---
    # rasterize each (don't-care GT, det) intersection ONCE: gt_dontcare_det
    # implies gt_dontcare, so one precomputed ratio serves both the e2e and
    # det-only exclusion rules (each rasterization builds two 768^2 masks)
    inter_over_det: Dict[Tuple[int, int], float] = {}
    for g in range(len(gts)):
        if not gt_dontcare[g]:
            continue
        for d, pr in enumerate(preds):
            inter_over_det[(g, d)] = polygon_intersection_over_det(
                gts[g].polygon, pr.polygon
            )
    det_dontcare: List[bool] = []
    det_dontcare_det: List[bool] = []
    for d in range(len(preds)):
        det_dontcare.append(any(
            gt_dontcare[g]
            and inter_over_det[(g, d)] > area_precision_threshold
            for g in range(len(gts))
        ))
        det_dontcare_det.append(any(
            gt_dontcare_det[g]
            and inter_over_det[(g, d)] > area_precision_threshold
            for g in range(len(gts))
        ))

    iou = np.zeros((len(gts), len(preds)), np.float64)
    for g in range(len(gts)):
        for d in range(len(preds)):
            iou[g, d] = polygon_iou(gts[g].polygon, preds[d].polygon)

    # --- e2e matching: index order, strict >, one-to-one ---
    det_correct = 0
    gt_used = [False] * len(gts)
    det_used = [False] * len(preds)
    for g in range(len(gts)):
        for d in range(len(preds)):
            if (
                not gt_used[g]
                and not det_used[d]
                and not gt_dontcare[g]
                and not det_dontcare[d]
                and iou[g, d] > iou_threshold
            ):
                gt_used[g] = True
                det_used[d] = True
                if word_spotting:
                    correct = gt_texts[g].upper() == preds[d].text.upper()
                else:
                    try:
                        correct = transcription_match(
                            gt_texts[g].upper(), preds[d].text.upper()
                        )
                    except IndexError:
                        correct = False
                det_correct += int(correct)

    # --- det-only matching ---
    det_only_correct = 0
    gt_used = [False] * len(gts)
    det_used = [False] * len(preds)
    for g in range(len(gts)):
        for d in range(len(preds)):
            if (
                not gt_used[g]
                and not det_used[d]
                and not gt_dontcare_det[g]
                and not det_dontcare_det[d]
                and iou[g, d] > iou_threshold
            ):
                gt_used[g] = True
                det_used[d] = True
                det_only_correct += 1

    return {
        "matched_e2e": det_correct,
        "matched_det": det_only_correct,
        "num_gt": len(gts) - sum(gt_dontcare),
        "num_pred": len(preds) - sum(det_dontcare),
        "num_gt_det": len(gts) - sum(gt_dontcare_det),
        "num_pred_det": len(preds) - sum(det_dontcare_det),
    }


def _prf(matched: int, num_gt: int, num_pred: int) -> Dict[str, float]:
    p = matched / num_pred if num_pred else 0.0
    r = matched / num_gt if num_gt else 0.0
    h = 2 * p * r / (p + r) if p + r else 0.0
    return {"precision": p, "recall": r, "hmean": h}


def sample_metrics(counts: Dict[str, int]) -> Dict[str, float]:
    """Per-sample P/R/H with the reference's zero-GT edge rule
    (text_eval_script.py:411-427)."""
    out = {}
    for tag, (m, g, p) in {
        "e2e": ("matched_e2e", "num_gt", "num_pred"),
        "det": ("matched_det", "num_gt_det", "num_pred_det"),
    }.items():
        if counts[g] == 0:
            recall = 1.0
            precision = 0.0 if counts[p] > 0 else 1.0
        else:
            recall = counts[m] / counts[g]
            precision = counts[m] / counts[p] if counts[p] else 0.0
        h = (
            2 * precision * recall / (precision + recall)
            if precision + recall
            else 0.0
        )
        out[f"{tag}_precision"] = precision
        out[f"{tag}_recall"] = recall
        out[f"{tag}_hmean"] = h
    return out


def evaluate_dataset(
    all_gts: Sequence[Sequence[SpottingInstance]],
    all_preds: Sequence[Sequence[SpottingInstance]],
    iou_threshold: float = 0.5,
    area_precision_threshold: float = 0.5,
    word_spotting: bool = True,
    min_length_care_word: int = 3,
) -> Dict[str, float]:
    """Dataset detection + end-to-end P/R/F, global counts summed as in
    text_eval_script.py:429-457."""
    tot = {
        "matched_det": 0, "matched_e2e": 0,
        "num_gt": 0, "num_pred": 0, "num_gt_det": 0, "num_pred_det": 0,
    }
    for gts, preds in zip(all_gts, all_preds):
        res = evaluate_image(
            gts, preds, iou_threshold, area_precision_threshold,
            word_spotting, min_length_care_word,
        )
        for k in tot:
            tot[k] += res[k]
    det = _prf(tot["matched_det"], tot["num_gt_det"], tot["num_pred_det"])
    e2e = _prf(tot["matched_e2e"], tot["num_gt"], tot["num_pred"])
    return {
        **{f"det_{k}": v for k, v in det.items()},
        **{f"e2e_{k}": v for k, v in e2e.items()},
        **tot,
    }



def _pairwise_ious(
    all_gts: Sequence[Sequence[SpottingInstance]],
    all_preds: Sequence[Sequence[SpottingInstance]],
):
    """Per-image [n_pred, n_gt] polygon-IoU matrices and pred scores."""
    ious, scores = [], []
    for gts, preds in zip(all_gts, all_preds):
        m = np.zeros((len(preds), len(gts)), np.float32)
        for i, pr in enumerate(preds):
            for j, gt in enumerate(gts):
                m[i, j] = polygon_iou(pr.polygon, gt.polygon)
        ious.append(m)
        scores.append(np.asarray([p.score for p in preds], np.float32))
    return ious, scores


def _ap_accumulate_py(ious, scores, thresholds):
    """Pure-Python AP accumulation, the oracle of native/cocoeval.cpp: per
    image, preds in stable score-descending order each take the still-free gt
    of highest IoU >= threshold (ties to the last index); 101-point
    interpolated precision over the global stable score-descending ranking."""
    total_gt = sum(m.shape[1] for m in ious)
    aps = []
    for thr in thresholds:
        if total_gt == 0:
            aps.append(0.0)
            continue
        scored = []  # (score, is_tp)
        for m, sc in zip(ious, scores):
            order = np.argsort(-sc, kind="stable")
            taken = [False] * m.shape[1]
            for i in order:
                best, best_iou = -1, thr
                for j in range(m.shape[1]):
                    if taken[j]:
                        continue
                    if m[i, j] >= best_iou:
                        best, best_iou = j, m[i, j]
                if best >= 0:
                    taken[best] = True
                    scored.append((float(sc[i]), 1))
                else:
                    scored.append((float(sc[i]), 0))
        scored.sort(key=lambda x: -x[0])
        tp = np.cumsum([s[1] for s in scored]) if scored else np.zeros(0)
        fp = np.cumsum([1 - s[1] for s in scored]) if scored else np.zeros(0)
        recall = tp / total_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        # 101-point interpolation
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r].max() if (recall >= r).any() else 0.0
            ap += p / 101
        aps.append(float(ap))
    return np.asarray(aps, np.float64)


def average_precision(
    all_gts: Sequence[Sequence[SpottingInstance]],
    all_preds: Sequence[Sequence[SpottingInstance]],
    iou_thresholds: Sequence[float] = (0.5,),
    use_native: bool = True,
) -> Dict[str, float]:
    """COCO-style average precision over polygon IoU: ``ap<thr*100>`` for
    each threshold and ``ap``, their mean. Polygon IoUs are computed once in
    Python (as detectron2's COCOeval does); the per-threshold score-ranked
    greedy matching and the accumulation run in the native C++ helper
    (``native_ext.coco_ap``, which raises when it cannot be built), or with
    ``use_native=False`` in ``_ap_accumulate_py``, of identical semantics."""
    ious, scores = _pairwise_ious(all_gts, all_preds)
    if use_native:
        from ..native_ext import coco_ap

        aps = coco_ap(ious, scores, list(iou_thresholds))
    else:
        aps = _ap_accumulate_py(ious, scores, iou_thresholds)
    results = {
        f"ap{int(thr * 100)}": float(a) for thr, a in zip(iou_thresholds, aps)
    }
    results["ap"] = float(np.mean(aps)) if len(aps) else 0.0
    return results

def weighted_edit_distance(
    word1: str, word2: str, scores: np.ndarray, char_to_col: Dict[str, int]
) -> float:
    """Recognition-probability-weighted edit distance — exact port of the
    reference cost model (lexicon_procesor.py:8-50):

    - delete word1[j]:   P_j(word1[j])
    - insert word2[i]:   mean of P at the adjacent word1 positions,
                         (P_j(word1[j]) + P_{j+1}(word1[j+1])) / 2
                         (or just P_j at the last position)
    - replace word1[j] by word2[i]:  max(1 - 5 * P_j(word2[i]) / P_j(word1[j]), 0)
      (0 when the characters already agree)

    where P_j(c) = max(scores[j][col(upper(c))], scores[j][col(lower(c))]),
    case-insensitive via the max over both case columns (:46-50). `scores`
    is the recognizer softmax, one row per word1 character.
    """

    def p(j: int, ch: str) -> float:
        cu = char_to_col.get(ch.upper())
        cl = char_to_col.get(ch.lower())
        vals = [float(scores[j][c]) for c in (cu, cl) if c is not None]
        return max(vals) if vals else 0.0

    m, n = len(word1), len(word2)
    dp = np.zeros((n + 1, m + 1), np.float32)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):  # word2
        for j in range(1, m + 1):  # word1
            delete_cost = p(j - 1, word1[j - 1])
            if j - 1 < m - 1:
                insert_cost = (p(j - 1, word1[j - 1]) + p(j, word1[j])) / 2
            else:
                insert_cost = p(j - 1, word1[j - 1])
            if word1[j - 1] != word2[i - 1]:
                denom = p(j - 1, word1[j - 1])
                ratio = p(j - 1, word2[i - 1]) / denom if denom > 0 else 0.0
                replace_cost = max(1.0 - 5.0 * ratio, 0.0)
            else:
                replace_cost = 0.0
            dp[i][j] = min(
                dp[i - 1][j] + insert_cost,
                dp[i][j - 1] + delete_cost,
                dp[i - 1][j - 1] + replace_cost,
            )
    return float(dp[n][m])


def edit_distance(a: str, b: str) -> int:
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev, dp[0] = dp[0], i
        for j in range(1, n + 1):
            cur = min(
                dp[j] + 1,
                dp[j - 1] + 1,
                prev + (a[i - 1] != b[j - 1]),
            )
            prev, dp[j] = dp[j], cur
    return dp[n]


class LexiconMatcher:
    """Lexicon-constrained transcription correction — semantics of
    lexicon_procesor.py:52-98.

    lexicon: candidate words; pairs: candidate (upper) -> ground-truth
    output string (defaults to identity). full_lexicon=True always returns
    the best match (totaltext/ctw1500); otherwise matches with distance
    >= 2.5 are rejected unless lexicon_type == 1 (generic, :93-98).
    weighted_ed=True uses the recognizer-probability-weighted distance and
    requires `scores` + `char_to_col` at query time.
    """

    def __init__(
        self,
        lexicon: List[str],
        pairs: Optional[Dict[str, str]] = None,
        lexicon_type: int = 2,
        full_lexicon: bool = False,
        weighted_ed: bool = False,
    ):
        self.lexicon = lexicon
        self.pairs = pairs or {w.upper(): w for w in lexicon}
        self.lexicon_type = lexicon_type
        self.full_lexicon = full_lexicon
        self.weighted_ed = weighted_ed

    def find_match_word(
        self, rec_str: str, scores=None, char_to_col=None
    ) -> Optional[str]:
        assert not self.weighted_ed or scores is not None
        rec_up = rec_str.upper()
        dist_min = 100.0
        match_word: Optional[str] = ""
        match_dist = 100.0
        for word in self.lexicon:
            word_up = word.upper()
            if self.weighted_ed:
                ed = weighted_edit_distance(
                    rec_up, word_up, scores, char_to_col or {}
                )
            else:
                ed = edit_distance(rec_up, word_up)
            if ed < dist_min:
                dist_min = ed
                match_word = self.pairs.get(word_up, word)
                match_dist = ed
        if self.full_lexicon:
            return match_word
        return (
            match_word
            if match_dist < 2.5 or self.lexicon_type == 1
            else None
        )
