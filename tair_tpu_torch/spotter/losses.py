"""Set criterion of TESTR over static padded targets.

Counterpart of ``tair_tpu/spotter/losses.py``: Hungarian-matched focal
classification, control-point L1 and text cross-entropy for the decoder (and
every auxiliary layer), focal + box L1 + GIoU for the encoder proposals,
normalised by the number of target instances. Targets are padded to
``[B, M, ...]`` with ``inst_mask``; the matcher returns a dense ``[B, M]`` query
index, so every loss is a masked gather. Under data parallelism (a process
group) the instance count and the text cells are those of the global batch,
as the JAX trainer's global-view step computes them (``_global_counts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .matcher import (
    assign_many,
    box_cost,
    box_cxcywh_to_xyxy,
    ctrl_point_cost,
    generalized_box_iou_pairwise,
)


@dataclass(frozen=True)
class CriterionConfig:
    point_class_weight: float = 2.0
    point_coord_weight: float = 5.0
    point_text_weight: float = 2.0
    box_class_weight: float = 2.0
    box_coord_weight: float = 5.0
    box_giou_weight: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    aux_loss: bool = True
    # "hungarian" / "jv": the exact solve on the device (kernel J1 on CUDA);
    # "hungarian_host": the exact solve on the host; "greedy": the
    # approximation that stays on the device
    matcher: str = "hungarian"


def sigmoid_focal_loss(logits, targets_onehot, num_inst, alpha=0.25, gamma=2.0):
    """Mean over the (query, point) dims, sum over batch and class, / num_inst."""
    logits = logits.float()
    targets_onehot = targets_onehot.float().expand(logits.shape)
    prob = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets_onehot, reduction="none")
    p_t = prob * targets_onehot + (1 - prob) * (1 - targets_onehot)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)) * loss
    if loss.dim() == 4:
        return loss.mean(dim=(1, 2)).sum() / num_inst
    if loss.dim() == 3:
        return loss.mean(dim=1).sum() / num_inst
    raise ValueError(f"focal loss takes 3-D or 4-D logits, got {loss.dim()}-D")


def _gather_by_src(pred: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """pred [B, Q, ...], src_idx [B, M] -> [B, M, ...] (-1 clipped to 0; the
    caller masks)."""
    idx = src_idx.clamp(min=0)
    idx = idx.reshape(*idx.shape, *([1] * (pred.dim() - 2)))
    return torch.gather(pred, 1, idx.expand(-1, -1, *pred.shape[2:]))


def _matched_mask(targets, src_idx) -> torch.Tensor:
    """[B, M] float: valid AND matched. With more valid targets than queries
    the surplus targets carry -1 and must add nothing: clipping them to query
    0 would stack several one-hot targets on it."""
    return targets["inst_mask"].float() * (src_idx >= 0).float()


def _positive_queries(src_idx, mask, q: int) -> torch.Tensor:
    """[B, Q] in {0, 1}: the queries some target was assigned to."""
    onehot = F.one_hot(src_idx.clamp(min=0), q).float() * mask[..., None]  # [B,M,Q]
    return onehot.sum(dim=1)


def dec_losses(outputs, targets, src_idx, num_inst, cfg: CriterionConfig,
               n_cells: Optional[torch.Tensor] = None):
    """Decoder losses for one layer's outputs; `n_cells` (the matched
    (instance, character) cells that divide the text loss) is counted on
    `targets` when not given."""
    mask = _matched_mask(targets, src_idx)  # [B, M]
    q = outputs["pred_logits"].shape[1]

    pos_mask = _positive_queries(src_idx, mask, q)
    loss_ce = (
        sigmoid_focal_loss(
            outputs["pred_logits"], pos_mask[:, :, None, None], num_inst,
            cfg.focal_alpha, cfg.focal_gamma,
        )
        * q
    )

    # control points: L1 over matched pairs
    src_pts = _gather_by_src(outputs["pred_ctrl_points"], src_idx)  # [B,M,Np,2]
    l1 = (src_pts.float() - targets["ctrl_points"].float()).abs()
    loss_ctrl = (l1 * mask[:, :, None, None]).sum() / num_inst

    # texts: cross-entropy averaged over matched (instance, char) cells
    src_txt = _gather_by_src(outputs["pred_texts"], src_idx)  # [B,M,Nw,V+1]
    logp = torch.log_softmax(src_txt.float(), dim=-1)
    tgt = targets["texts"].long()  # [B,M,Nw]
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    if n_cells is None:
        n_cells = (mask.sum() * tgt.shape[-1]).clamp(min=1.0)
    loss_texts = (nll * mask[:, :, None]).sum() / n_cells

    return {
        "loss_ce": loss_ce * cfg.point_class_weight,
        "loss_ctrl_points": loss_ctrl * cfg.point_coord_weight,
        "loss_texts": loss_texts * cfg.point_text_weight,
    }


def enc_losses(enc_outputs, targets, src_idx, num_inst, cfg: CriterionConfig):
    mask = _matched_mask(targets, src_idx)
    b, s = enc_outputs["pred_logits"].shape[:2]

    pos_mask = _positive_queries(src_idx, mask, s)
    loss_ce = (
        sigmoid_focal_loss(
            enc_outputs["pred_logits"], pos_mask[:, :, None], num_inst,
            cfg.focal_alpha, cfg.focal_gamma,
        )
        * s
    )

    src_boxes = _gather_by_src(enc_outputs["pred_boxes"], src_idx).float()  # [B,M,4]
    tgt_boxes = targets["boxes"].float()
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = (l1 * mask).sum() / num_inst

    giou = generalized_box_iou_pairwise(
        box_cxcywh_to_xyxy(src_boxes).reshape(-1, 1, 4),
        box_cxcywh_to_xyxy(tgt_boxes).reshape(-1, 1, 4),
    ).reshape(b, -1)
    loss_giou = ((1.0 - giou) * mask).sum() / num_inst

    return {
        "loss_ce_enc": loss_ce * cfg.box_class_weight,
        "loss_bbox_enc": loss_bbox * cfg.box_coord_weight,
        "loss_giou_enc": loss_giou * cfg.box_giou_weight,
    }


def _global_counts(counts: Sequence[torch.Tensor], group) -> torch.Tensor:
    """The loss denominators of a data-parallel step, each ``max(global
    count, 1) / n`` over the n processes of `group` (one all-reduce): a
    process's loss is then its rows' numerator over the global count times n,
    so the mean over processes, which the gradient reduction takes, is the
    global batch's loss. This follows the JAX trainer's global-view step
    (``set_criterion`` with ``axis_name=None`` on the sharded global batch),
    not the JAX function's ``axis_name`` branch: that one takes ``max(., 1)``
    after the mean over replicas and leaves the text cells per replica."""
    counts = torch.stack([c.detach().float() for c in counts])
    n = dist.get_world_size(group)
    dist.all_reduce(counts, group=group)
    return counts.clamp(min=1.0) / n


def set_criterion(
    outputs: Dict[str, Any],
    targets: Dict[str, torch.Tensor],
    cfg: CriterionConfig = CriterionConfig(),
    group: Optional[dist.ProcessGroup] = None,
) -> Dict[str, torch.Tensor]:
    """Full weighted TESTR loss dict; 'loss_total' is the training scalar.
    Every matching's cost (the last decoder layer, the auxiliary layers, the
    encoder proposals) is formed first, and the matcher solves them in one
    call: one launch of kernel J1 on the card. `group`: the data-parallel
    process group whose global batch normalises the losses (`_global_counts`);
    None, a single process."""

    point_outputs = [outputs]
    if cfg.aux_loss and "aux_outputs" in outputs:
        point_outputs += list(outputs["aux_outputs"])
    problems = [
        ctrl_point_cost(out, targets, cfg.point_class_weight, cfg.point_coord_weight,
                        cfg.focal_alpha, cfg.focal_gamma)
        for out in point_outputs
    ]
    if "enc_outputs" in outputs:
        problems.append(box_cost(
            outputs["enc_outputs"], targets,
            cfg.box_class_weight, cfg.box_coord_weight, cfg.box_giou_weight,
            cfg.focal_alpha, cfg.focal_gamma,
        ))
    matched = assign_many(cfg.matcher, problems)

    n_chars = targets["texts"].shape[-1]
    counts = [targets["inst_mask"].float().sum()] + [
        _matched_mask(targets, idx).sum() * n_chars for idx in matched[: len(point_outputs)]
    ]
    if group is not None and dist.get_world_size(group) > 1:
        num_inst, *n_cells = _global_counts(counts, group).unbind()
    else:
        num_inst, *n_cells = (c.clamp(min=1.0) for c in counts)

    losses: Dict[str, torch.Tensor] = {}
    losses.update(dec_losses(outputs, targets, matched[0], num_inst, cfg, n_cells[0]))
    for i, aux in enumerate(point_outputs[1:]):
        for k, v in dec_losses(aux, targets, matched[1 + i], num_inst, cfg, n_cells[1 + i]).items():
            losses[f"{k}_{i}"] = v

    if "enc_outputs" in outputs:
        losses.update(
            enc_losses(outputs["enc_outputs"], targets, matched[-1], num_inst, cfg)
        )

    losses["loss_total"] = sum(losses.values())
    return losses
