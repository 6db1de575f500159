"""Hungarian matchers of the TESTR criterion.

Counterpart of ``tair_tpu/spotter/matcher.py``: the control-point matcher
(focal class cost + control-point L1) for the decoder outputs and the box
matcher (focal class + box L1 + GIoU) for the encoder proposals, over static
padded targets ``[B, M, ...]`` with ``inst_mask``. The assignment comes back as
a dense ``[B, M]`` query index per target, -1 for a padded or unmatched target.

The cost matrices are formed on the tensors' device without gradients. The
exact solve has two routes, as in the JAX package:

- "hungarian" / "jv" (the default): the Jonker-Volgenant shortest augmenting
  path of ``tair_tpu/spotter/matcher.py::_jv_single`` / ``jv_assignment``
  (``:86-211``). On a CUDA tensor it is kernel J1 (``ops/csrc/jv_assign.cu``),
  one thread block per matrix, one launch per matching, nothing read back to
  the host; on a CPU tensor its plain version ``jv_assignment_reference``, a
  line-for-line transcription in float32 with JAX's operation order, so the
  assignment equals JAX's bit for bit, ties included.
- "hungarian_host": the same optimum on the host through the native C++
  solver (``native_ext.lapjv_batch``), one device-to-host copy per matching.
  Where optima tie it may pick another one than the default.

"greedy" is the approximation that stays on the device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

# float32 "infinity" of the shortest-path costs, and the cost of a padded target
# column when more target slots than queries are solved query-major (large so
# that the optimum takes real targets first): JAX's constants
JV_INF = 1e30
JV_PAD = 1e6

# kernel launches made by the wrapper (never raised by the plain version)
launches = {"assign": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


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


def hungarian_assignment(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Exact assignment on the host by the native C++ solver: [B, Q, M] cost +
    [B] counts -> [B, M] matched query per target (-1 = padding or unmatched),
    on cost's device. Both orientations: with more valid targets than
    queries, min(Q, n_valid) targets are matched."""
    from ..native_ext import lapjv_batch

    host = lapjv_batch(cost.detach().float().cpu().numpy(), n_valid.detach().cpu().numpy())
    return torch.from_numpy(host.astype(np.int64)).to(cost.device)


def _jv_single_reference(a: torch.Tensor, n_valid: int,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Exact assignment of ONE cost matrix: ``_jv_single`` of the JAX package,
    line for line. a [m, q] is target-major (rows = targets, columns =
    queries, m <= q); rows >= n_valid are set to 0, which leaves the valid
    rows' optimum as it is. Returns [m] assigned query index, -1 for padded
    targets. Every float32 operation is JAX's, in JAX's order, and the argmin
    takes the first index of the minimum, so the result is JAX's bit for bit.
    Each row's search ends within q steps (a new column joins the tree at
    every step), and the augmenting walk within m: both loops are bounded as
    kernel J1's are. `stats`, when given, counts the search steps, the relaxed
    columns and the dual updates (the operations this run's data needs)."""
    m, q = a.shape
    assert m <= q, f"_jv_single_reference needs rows<=cols, got {m}x{q}"
    dev = a.device
    rows = torch.arange(m, device=dev)
    a = torch.where((rows < n_valid)[:, None], a.float(), 0.0)
    inf = torch.tensor(JV_INF, dtype=torch.float32, device=dev)
    u = torch.zeros((m,), dtype=torch.float32, device=dev)
    v = torch.zeros((q,), dtype=torch.float32, device=dev)
    row4col = torch.full((q,), -1, dtype=torch.long, device=dev)
    col4row = torch.full((m,), -1, dtype=torch.long, device=dev)

    for cur_row in range(m):
        # --- Dijkstra from cur_row until a free column is reached ---
        i, sink = cur_row, -1
        min_val = torch.zeros((), dtype=torch.float32, device=dev)
        sr = torch.zeros((m,), dtype=torch.bool, device=dev)
        sc = torch.zeros((q,), dtype=torch.bool, device=dev)
        spc = torch.full((q,), JV_INF, dtype=torch.float32, device=dev)
        path = torch.full((q,), -1, dtype=torch.long, device=dev)
        for _ in range(q):
            sr[i] = True
            remaining = ~sc
            r = min_val + a[i] - u[i] - v
            better = remaining & (r < spc)
            spc = torch.where(better, r, spc)
            path = torch.where(better, i, path)
            masked = torch.where(remaining, spc, inf)
            j = int(torch.argmin(masked))
            min_val = masked[j]
            sc[j] = True
            if stats is not None:
                stats["relaxed"] = stats.get("relaxed", 0) + int(remaining.sum())
                stats["steps"] = stats.get("steps", 0) + 1
            if int(row4col[j]) < 0:
                sink = j
                break
            i = int(row4col[j])

        # --- dual update (scipy _lsap convention) ---
        if stats is not None:
            stats["dual"] = stats.get("dual", 0) + int(sr.sum()) + int(sc.sum())
        u[cur_row] += min_val
        other = sr & (rows != cur_row)
        delta = min_val - spc[col4row.clamp(min=0)]
        u = torch.where(other, u + delta, u)
        v = torch.where(sc, v - (min_val - spc), v)

        # --- augment along the alternating path back to cur_row ---
        j = sink
        for _ in range(m if sink >= 0 else 0):
            i = int(path[j])
            row4col[j] = i
            j_next = int(col4row[i])
            col4row[i] = j
            if i == cur_row:
                break
            j = j_next
    return torch.where(rows < n_valid, col4row, -1)


def jv_assignment_reference(cost: torch.Tensor, n_valid: torch.Tensor,
                            stats: Optional[dict] = None) -> torch.Tensor:
    """Plain version of kernel J1: ``jv_assignment`` of the JAX package, line
    for line. [B, Q, M] cost + [B] counts -> [B, M] matched query per target
    (-1 = padding or unmatched). With M <= Q the matrix is solved target-major
    (constant-0 padded rows); with M > Q query-major, padded target columns
    at ``JV_PAD``, so min(Q, n_valid) real targets are matched, and the
    assignment is inverted back to target-major."""
    cost = cost.detach().float()
    b, q, m = cost.shape
    dev = cost.device
    n_valid = n_valid.to(device=dev, dtype=torch.long)
    counts = n_valid.tolist()
    if m <= q:
        a = cost.transpose(1, 2)
        return torch.stack(
            [_jv_single_reference(a[k], counts[k], stats) for k in range(b)]
        ) if b else torch.empty((0, m), dtype=torch.long, device=dev)

    pad_cols = torch.arange(m, device=dev)[None, None, :] >= n_valid[:, None, None]
    a = torch.where(pad_cols, JV_PAD, cost)  # [B, Q(rows), M(cols)], Q < M
    col4row = torch.stack(
        [_jv_single_reference(a[k], q, stats) for k in range(b)]
    ) if b else torch.empty((0, q), dtype=torch.long, device=dev)
    # invert: target -> query, -1 where unmatched or padded
    out = torch.full((b, m), -1, dtype=torch.long, device=dev)
    out.scatter_(1, col4row, torch.arange(q, device=dev).expand(b, q))
    return torch.where(torch.arange(m, device=dev)[None] < n_valid[:, None], out, -1)


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_JV = {}  # J1's C entries, bound at the first call
_WORKSPACE_BYTES = {}  # (device, B, Q, M) -> device memory J1 needs beside shared memory


def _jv_entries() -> dict:
    if not _JV:
        from ..ops import _build

        lib = _build.library("jv_assign")
        lib.jv_assign.argtypes = [_PTR] * 4 + [_I64] + [_INT] * 3 + [_PTR]
        lib.jv_assign.restype = _INT
        lib.jv_assign_workspace_bytes.argtypes = [_INT] * 3
        lib.jv_assign_workspace_bytes.restype = _I64
        _JV.update(assign=lib.jv_assign, workspace_bytes=lib.jv_assign_workspace_bytes)
    return _JV


def _launch_jv(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Kernel J1 on the cost's CUDA device: one thread block per matrix, the
    orientation, padding, inversion and -1 masking of
    ``jv_assignment_reference`` done inside the one launch. A matrix whose
    vectors do not fit a block's shared memory (over about 13,600 columns)
    gets a workspace in device memory. Raises for any other device, and when
    the launch fails."""
    if cost.device.type != "cuda":
        raise ValueError(f"kernel J1 runs on CUDA tensors, got a {cost.device.type} tensor")
    if cost.dim() != 3 or n_valid.shape != cost.shape[:1]:
        raise ValueError(f"J1 takes cost [B, Q, M] and n_valid [B], got "
                         f"{tuple(cost.shape)} and {tuple(n_valid.shape)}")
    b, q, m = cost.shape
    cost = cost.detach().float().contiguous()
    n_valid = n_valid.to(device=cost.device, dtype=torch.long).contiguous()
    out = torch.empty((b, m), dtype=torch.long, device=cost.device)
    if b == 0 or m == 0:
        return out
    entries = _jv_entries()
    with torch.cuda.device(cost.device):
        key = (cost.device.index, b, q, m)
        nbytes = _WORKSPACE_BYTES.get(key)
        if nbytes is None:
            nbytes = entries["workspace_bytes"](b, q, m)
            if nbytes < 0:
                raise RuntimeError(f"jv_assign could not read the device (error {-nbytes})")
            _WORKSPACE_BYTES[key] = nbytes
        workspace = torch.empty((nbytes,), dtype=torch.uint8, device=cost.device) if nbytes else None
        err = entries["assign"](
            cost.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            workspace.data_ptr() if nbytes else None, nbytes, b, q, m,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"jv_assign launch failed with error {err} at B={b}, Q={q}, M={m}")
    launches["assign"] += 1
    return out


def jv_assignment(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Exact assignment, the default matcher: [B, Q, M] cost + [B] counts ->
    [B, M] matched query per target (-1 = padding or unmatched), on cost's
    device. Kernel J1 on a CUDA tensor; the plain version only for a tensor on
    the CPU."""
    if cost.device.type == "cpu":
        return jv_assignment_reference(cost, n_valid)
    return _launch_jv(cost, n_valid)


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
    """"hungarian"/"jv": the exact solve on the tensors' device (kernel J1 on
    CUDA). "hungarian_host": the exact solve on the host. "greedy": the
    approximation on the device."""
    if impl in ("hungarian", "jv"):
        return jv_assignment(cost, n_valid)
    if impl == "hungarian_host":
        return hungarian_assignment(cost, n_valid)
    if impl == "greedy":
        return greedy_assignment(cost, n_valid)
    raise ValueError(f"unknown matcher impl {impl!r}")
