"""Set criterion of TESTR over static padded targets.

Counterpart of ``tair_tpu/spotter/losses.py``: Hungarian-matched focal
classification, control-point L1 and text cross-entropy for the decoder (and
every auxiliary layer), focal + box L1 + GIoU for the encoder proposals,
normalised by the number of target instances. Targets are padded to
``[B, M, ...]`` with ``inst_mask``; the matcher returns a dense ``[B, M]`` query
index, so every loss is a masked gather. The cross-replica mean of the
instance count (the JAX function's ``axis_name``) belongs to the parallel
slice and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .matcher import (
    box_cxcywh_to_xyxy,
    box_match,
    ctrl_point_match,
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


def dec_losses(outputs, targets, src_idx, num_inst, cfg: CriterionConfig):
    """Decoder losses for one layer's outputs."""
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


def set_criterion(
    outputs: Dict[str, Any],
    targets: Dict[str, torch.Tensor],
    cfg: CriterionConfig = CriterionConfig(),
) -> Dict[str, torch.Tensor]:
    """Full weighted TESTR loss dict; 'loss_total' is the training scalar."""
    num_inst = targets["inst_mask"].float().sum().clamp(min=1.0)

    def match_points(out):
        return ctrl_point_match(
            out, targets, cfg.point_class_weight, cfg.point_coord_weight,
            cfg.focal_alpha, cfg.focal_gamma, cfg.matcher,
        )

    losses: Dict[str, torch.Tensor] = {}
    losses.update(dec_losses(outputs, targets, match_points(outputs), num_inst, cfg))

    if cfg.aux_loss and "aux_outputs" in outputs:
        for i, aux in enumerate(outputs["aux_outputs"]):
            for k, v in dec_losses(aux, targets, match_points(aux), num_inst, cfg).items():
                losses[f"{k}_{i}"] = v

    if "enc_outputs" in outputs:
        enc_idx = box_match(
            outputs["enc_outputs"], targets,
            cfg.box_class_weight, cfg.box_coord_weight, cfg.box_giou_weight,
            cfg.focal_alpha, cfg.focal_gamma, cfg.matcher,
        )
        losses.update(
            enc_losses(outputs["enc_outputs"], targets, enc_idx, num_inst, cfg)
        )

    losses["loss_total"] = sum(losses.values())
    return losses
