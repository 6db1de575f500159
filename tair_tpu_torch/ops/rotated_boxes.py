"""Rotated-box geometry: exact IoU and NMS.

Counterpart of ``tair_tpu/ops/rotated_boxes.py`` (detectron2's
``box_iou_rotated`` and ``nms_rotated``). Rotated rectangles are convex, so
the exact intersection is a Sutherland-Hodgman clip with a fixed budget of
vertices (at most 8 for two rectangles): the JAX function's fixed-length loop
with masked pushes, in its float32 order of operations, here run for every
pair of boxes at once. NMS is the greedy suppression over the boxes sorted by
score, ties in index order. Boxes are (cx, cy, w, h, angle in degrees), the
angle counter-clockwise. Plain PyTorch; no path of the package calls it yet.
"""

from __future__ import annotations

import torch

MAX_VERTS = 8


def box_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] -> [..., 4, 2] corner points (counter-clockwise)."""
    cx, cy, w, h, ang = boxes.split(1, dim=-1)
    theta = torch.deg2rad(ang)
    c, s = torch.cos(theta), torch.sin(theta)
    dx = torch.cat([-w, w, w, -w], -1) / 2
    dy = torch.cat([-h, -h, h, h], -1) / 2
    x = cx + dx * c - dy * s
    y = cy + dx * s + dy * c
    return torch.stack([x, y], -1)


def _polygon_area(pts: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Shoelace over the first n_valid of the MAX_VERTS points of each
    polygon (the rest ignored): pts [P, M, 2], n_valid [P] -> [P]."""
    m = pts.shape[-2]
    idx = torch.arange(m, device=pts.device)[None]
    valid = idx < n_valid[:, None]
    nxt = torch.where(idx + 1 < n_valid[:, None], idx + 1, 0)
    x, y = pts[..., 0], pts[..., 1]
    xn = x.gather(1, nxt)
    yn = y.gather(1, nxt)
    cross = (x * yn - xn * y) * valid
    return torch.abs(cross.sum(-1)) / 2.0


def _clip_polygon(pts: torch.Tensor, n: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Each polygon pts[p, :n[p]] clipped by the half-plane left of its edge
    a[p] -> b[p]; (points [P, M, 2], counts [P]). A point is pushed at slot
    `cnt` only where its condition holds, as the JAX loop's masked push; a
    neighbour index past the last slot reads the last slot, as JAX's gather
    clamps."""
    m = MAX_VERTS
    edge = b - a
    slots = torch.arange(m, device=pts.device)[None]

    def side(p):
        return edge[:, 0] * (p[:, 1] - a[:, 1]) - edge[:, 1] * (p[:, 0] - a[:, 0])

    def push(out, cnt, p, cond):
        at = (slots == cnt[:, None]) & cond[:, None]
        return torch.where(at[..., None], p[:, None], out), cnt + cond.to(cnt.dtype)

    out = torch.zeros_like(pts)
    cnt = torch.zeros_like(n)
    for i in range(m):
        cur = pts[:, i]
        nxt_i = torch.where(i + 1 < n, i + 1, 0).clamp(max=m - 1)
        nxt = pts.gather(1, nxt_i[:, None, None].expand(-1, 1, 2))[:, 0]
        s_cur = side(cur)
        s_nxt = side(nxt)
        denom = s_cur - s_nxt
        big = torch.abs(denom) > 1e-12
        t = torch.where(big, s_cur / torch.where(big, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
        inter = cur + t[:, None] * (nxt - cur)
        inside_cur = s_cur >= 0
        inside_nxt = s_nxt >= 0
        active = i < n
        out, cnt = push(out, cnt, cur, active & inside_cur)
        out, cnt = push(out, cnt, inter, active & (inside_cur != inside_nxt))
    return out, cnt


def _rotated_iou_pairs(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Exact IoU of the pairs of rotated boxes [P, 5] x [P, 5] -> [P]."""
    pa = box_to_corners(box_a)  # [P, 4, 2]
    pb = box_to_corners(box_b)
    pts = torch.zeros((box_a.shape[0], MAX_VERTS, 2), dtype=box_a.dtype, device=box_a.device)
    pts[:, :4] = pa
    n = torch.full((box_a.shape[0],), 4, dtype=torch.int32, device=box_a.device)
    for i in range(4):
        pts, n = _clip_polygon(pts, n, pb[:, i], pb[:, (i + 1) % 4])
    inter = _polygon_area(pts, n)
    area_a = box_a[:, 2] * box_a[:, 3]
    area_b = box_b[:, 2] * box_b[:, 3]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def rotated_iou_pair(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Exact IoU of two rotated boxes [5] each -> scalar."""
    return _rotated_iou_pairs(box_a[None], box_b[None])[0]


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 5] x [M, 5] -> [N, M] exact IoU."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    a = boxes_a[:, None].expand(n, m, 5).reshape(n * m, 5)
    b = boxes_b[None].expand(n, m, 5).reshape(n * m, 5)
    return _rotated_iou_pairs(a, b).reshape(n, m)


def nms_rotated(
    boxes: torch.Tensor,   # [N, 5]
    scores: torch.Tensor,  # [N]
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """Greedy NMS; a boolean keep mask [N]. The order is ``jnp.argsort(-scores)``'s:
    a stable sort, so among equal scores the lower index ranks first."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = rotated_iou_matrix(boxes[order], boxes[order])
    earlier = torch.arange(n, device=boxes.device)
    keep_sorted = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        # suppressed if any higher-ranked kept box overlaps too much
        overlap = (iou[i] > iou_threshold) & (earlier < i) & keep_sorted
        keep_sorted[i] = ~overlap.any()
    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep
