"""Hungarian matchers of the TESTR criterion.

Counterpart of ``tair_tpu/spotter/matcher.py``: the control-point matcher
(focal class cost + control-point L1) for the decoder outputs and the box
matcher (focal class + box L1 + GIoU) for the encoder proposals, over static
padded targets ``[B, M, ...]`` with ``inst_mask``. The assignment comes back as
a dense ``[B, M]`` query index per target, -1 for a padded or unmatched target.

The cost matrices are formed on the tensors' device without gradients. The
exact solve ("hungarian", "jv", "hungarian_host": one and the same here) runs on
the host, one device-to-host copy per matching, through scipy's
``linear_sum_assignment`` (a Jonker-Volgenant shortest-augmenting-path solver,
the algorithm the JAX package runs on the device), and gives the same optimum.
"greedy" is the approximation that stays on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _focal_class_cost(prob: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0):
    """prob [..., 1] sigmoid; returns pos_cost - neg_cost for class 0."""
    neg = (1 - alpha) * (prob**gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    return (pos - neg)[..., 0]


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(dim=-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def generalized_box_iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., Q, 4], b [..., M, 4] xyxy -> GIoU [..., Q, M]."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp(min=1e-9)
    # smallest enclosing box
    lt_c = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb_c = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh_c = (rb_c - lt_c).clamp(min=0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp(min=1e-9)


def _lsa_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Batched rectangular assignment on the host. cost [B, Q, M]; returns
    [B, M] query index per target, -1 for padded targets and, when a batch
    element has more valid targets than queries, for the targets left over."""
    from scipy.optimize import linear_sum_assignment

    b, _, m = cost.shape
    out = np.full((b, m), -1, np.int64)
    for i in range(b):
        n = int(n_valid[i])
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :n])
        out[i, cols] = rows
    return out


def hungarian_assignment(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Exact assignment: [B, Q, M] cost + [B] counts -> [B, M] matched query
    per target (-1 = padding or unmatched), on cost's device. Both
    orientations: with more valid targets than queries, min(Q, n_valid)
    targets are matched, as scipy's rectangular solve does."""
    host = _lsa_host(
        cost.detach().float().cpu().numpy(), n_valid.detach().cpu().numpy()
    )
    return torch.from_numpy(host).to(cost.device)


def greedy_assignment(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Greedy matching on the device: repeatedly take the globally cheapest
    unassigned (query, target) pair. cost [B, Q, M] -> [B, M]."""
    b, q, m = cost.shape
    dev = cost.device
    big = 1e9
    ar_m = torch.arange(m, device=dev)
    ar_q = torch.arange(q, device=dev)
    tgt_mask = ar_m[None] < n_valid[:, None]  # [B, M]
    c = torch.where(tgt_mask[:, None, :], cost.detach().float(), big)
    out = torch.full((b, m), -1, dtype=torch.long, device=dev)
    for _ in range(m):
        flat = c.reshape(b, q * m)
        best, idx = flat.min(dim=1)
        qi, mi = idx // m, idx % m
        valid = best < big / 2
        out = torch.where(valid[:, None] & (ar_m[None] == mi[:, None]), qi[:, None], out)
        # block the assigned row and column
        c = torch.where(
            (ar_q[None, :, None] == qi[:, None, None])
            | (ar_m[None, None, :] == mi[:, None, None]),
            big, c,
        )
    return out


@torch.no_grad()
def ctrl_point_match(
    outputs: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    class_weight: float = 2.0,
    coord_weight: float = 5.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
    impl: str = "hungarian",
) -> torch.Tensor:
    """Decoder matching. outputs: pred_logits [B,Q,Np,1], pred_ctrl_points
    [B,Q,Np,2]; targets: ctrl_points [B,M,Np,2], inst_mask [B,M].
    Returns [B, M] matched query index (-1 = padding)."""
    return _dispatch(impl, *ctrl_point_cost(
        outputs, targets, class_weight, coord_weight, alpha, gamma
    ))


@torch.no_grad()
def ctrl_point_cost(outputs, targets, class_weight=2.0, coord_weight=5.0,
                    alpha=0.25, gamma=2.0):
    """(cost [B, Q, M], n_valid [B]) of the decoder matching."""
    prob = torch.sigmoid(outputs["pred_logits"].float())
    cost_class = _focal_class_cost(prob, alpha, gamma).mean(-1)[..., None]  # [B,Q,1]

    out_pts = outputs["pred_ctrl_points"].float()
    b, q = out_pts.shape[:2]
    m = targets["ctrl_points"].shape[1]
    out_flat = out_pts.reshape(b, q, -1)
    tgt_flat = targets["ctrl_points"].float().reshape(b, m, -1)
    cost_kpts = (out_flat[:, :, None, :] - tgt_flat[:, None, :, :]).abs().sum(-1)

    cost = class_weight * cost_class + coord_weight * cost_kpts
    return cost, targets["inst_mask"].sum(-1).long()


@torch.no_grad()
def box_match(
    outputs: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    class_weight: float = 2.0,
    coord_weight: float = 5.0,
    giou_weight: float = 2.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
    impl: str = "hungarian",
) -> torch.Tensor:
    """Encoder-proposal matching. outputs: pred_logits [B,S,1], pred_boxes
    [B,S,4] cxcywh; targets: boxes [B,M,4], inst_mask [B,M]."""
    return _dispatch(impl, *box_cost(
        outputs, targets, class_weight, coord_weight, giou_weight, alpha, gamma
    ))


@torch.no_grad()
def box_cost(outputs, targets, class_weight=2.0, coord_weight=5.0, giou_weight=2.0,
             alpha=0.25, gamma=2.0):
    """(cost [B, S, M], n_valid [B]) of the encoder-proposal matching."""
    prob = torch.sigmoid(outputs["pred_logits"].float())
    cost_class = _focal_class_cost(prob, alpha, gamma)[..., None]  # [B,S,1]

    out_box = outputs["pred_boxes"].float()
    tgt_box = targets["boxes"].float()
    cost_bbox = (out_box[:, :, None, :] - tgt_box[:, None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou_pairwise(
        box_cxcywh_to_xyxy(out_box), box_cxcywh_to_xyxy(tgt_box)
    )
    cost = class_weight * cost_class + coord_weight * cost_bbox + giou_weight * cost_giou
    return cost, targets["inst_mask"].sum(-1).long()


def _dispatch(impl: str, cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """"hungarian"/"jv"/"hungarian_host": the exact solve, on the host.
    "greedy": the approximation on the device."""
    if impl in ("hungarian", "jv", "hungarian_host"):
        return hungarian_assignment(cost, n_valid)
    if impl == "greedy":
        return greedy_assignment(cost, n_valid)
    raise ValueError(f"unknown matcher impl {impl!r}")
