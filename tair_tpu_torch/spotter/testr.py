"""TESTR text spotter consuming the diffusion UNet's decoder features.

Counterpart of ``tair_tpu/spotter/testr.py``: per-level projection from UNet
channels to d_model, 2D sine positional encodings, the two-stage deformable
transformer, heads shared across decoder layers, and the fixed-shape
score-threshold decode. ``TESTR.forward`` takes NHWC feature maps.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import to_nchw, to_nhwc
from .transformer import (
    DeformableTransformer,
    MLPHead,
    inverse_sigmoid,
    sine_pos_embed_1d,
    sine_pos_embed_2d,
)


@dataclass(frozen=True)
class TESTRConfig:
    d_model: int = 256
    n_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    num_proposals: int = 100          # number of instance queries
    num_ctrl_points: int = 16         # polygon control points
    num_chars: int = 25               # max text length
    voc_size: int = 96                # char vocabulary (plus 1 for EOS/blank)
    in_channels: Tuple[int, ...] = (1280, 1280, 640, 320)
    test_score_threshold: float = 0.5
    # encoder msda query block; 16384 leaves inference shapes unchunked, lower
    # it for large-batch training to bound what autograd saves
    enc_msda_q_chunk: int = 16384


class DiffFeatProj(nn.Module):
    """Per-level projection from UNet feature channels to d_model (NHWC in/out)."""

    def __init__(self, in_ch: int, d_model: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, d_model, 1)
        self.gn1 = nn.GroupNorm(32, d_model, eps=1e-6)
        self.conv2 = nn.Conv2d(d_model, d_model, 3, padding=1)
        self.gn2 = nn.GroupNorm(32, d_model, eps=1e-6)

    @staticmethod
    def _gn(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(
            x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(), norm.eps
        )
        return y.to(x.dtype)

    def forward(self, x):
        dtype = self.conv1.weight.dtype
        x = self.conv1(to_nchw(x).to(dtype))
        x = F.gelu(self._gn(self.gn1, x))
        x = self.conv2(x)
        return to_nhwc(F.gelu(self._gn(self.gn2, x)))


@functools.lru_cache(maxsize=32)
def _pos_2d(h: int, w: int, feats: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sine_pos_embed_2d(h, w, feats)).to(device)


class TESTR(nn.Module):
    def __init__(self, cfg: TESTRConfig = TESTRConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.d_model
        for i, ch in enumerate(cfg.in_channels):
            setattr(self, f"diff_feat_proj_{i}", DiffFeatProj(ch, c))
        self.ctrl_point_embed = nn.Parameter(torch.zeros(cfg.num_ctrl_points, c))
        self.text_embed = nn.Parameter(torch.zeros(cfg.num_chars, c))
        self.register_buffer(
            "text_pos_embed",
            torch.from_numpy(sine_pos_embed_1d(cfg.num_chars, c)),
            persistent=False,
        )
        self.transformer = DeformableTransformer(
            d_model=c,
            n_heads=cfg.n_heads,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            d_ffn=cfg.dim_feedforward,
            n_levels=cfg.num_feature_levels,
            enc_n_points=cfg.enc_n_points,
            dec_n_points=cfg.dec_n_points,
            num_proposals=cfg.num_proposals,
            enc_msda_q_chunk=cfg.enc_msda_q_chunk,
        )
        # heads shared across decoder layers
        self.ctrl_point_class = nn.Linear(c, 1)
        self.ctrl_point_coord = MLPHead(c, c, 2, 3)
        self.text_class = nn.Linear(c, cfg.voc_size + 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """feats: NHWC UNet decoder features (channels cfg.in_channels).

        Returns dict:
          pred_logits      [B, K, Np, 1]
          pred_ctrl_points [B, K, Np, 2]
          pred_texts       [B, K, Nw, voc+1]
          aux_outputs      list of the same for decoder layers 0..L-2
          enc_outputs      {pred_logits [B,S,1], pred_boxes [B,S,4]}
        """
        cfg = self.cfg
        c = cfg.d_model
        srcs = [
            getattr(self, f"diff_feat_proj_{i}")(f) for i, f in enumerate(feats)
        ]
        pos = [_pos_2d(s.shape[1], s.shape[2], c // 2, s.device) for s in srcs]

        hs, hs_text, init_reference, enc_class, enc_coord_unact = self.transformer(
            srcs, pos, self.ctrl_point_embed, self.text_embed, self.text_pos_embed
        )

        ref_logit = inverse_sigmoid(init_reference.float())  # [B, K, 4]
        # heads applied once over the stacked [L, B, K, N, C] decoder states
        logits_all = self.ctrl_point_class(hs)                        # [L,B,K,Np,1]
        coords_all = torch.sigmoid(
            self.ctrl_point_coord(hs).float() + ref_logit[:, :, None, :2]
        )                                                             # [L,B,K,Np,2]
        texts_all = self.text_class(hs_text)                          # [L,B,K,Nw,V+1]
        layer_outs = [
            {
                "pred_logits": logits_all[lvl],
                "pred_ctrl_points": coords_all[lvl],
                "pred_texts": texts_all[lvl],
            }
            for lvl in range(cfg.num_decoder_layers)
        ]

        out = dict(layer_outs[-1])
        out["aux_outputs"] = layer_outs[:-1]
        out["enc_outputs"] = {
            "pred_logits": enc_class,
            "pred_boxes": torch.sigmoid(enc_coord_unact),
        }
        return out


def spotter_inference(
    output: Dict[str, Any], score_threshold: float = 0.5, image_size: int = 512
) -> Dict[str, torch.Tensor]:
    """Dense, fixed-shape decode of the spotter output:
      scores  [B, K]       sigmoid of mean point logit
      keep    [B, K] bool  scores >= threshold
      polygons[B, K, Np, 2] pixel coords
      recs    [B, K, Nw]   argmax char ids
      rec_scores [B, K, Nw, voc+1] softmax char distribution
    """
    logits = output["pred_logits"]           # [B, K, Np, 1]
    coords = output["pred_ctrl_points"]      # [B, K, Np, 2]
    texts = output["pred_texts"]             # [B, K, Nw, V+1]

    prob = torch.sigmoid(logits.float().mean(dim=-2))  # [B, K, 1]
    scores = prob.max(dim=-1).values
    keep = scores >= score_threshold
    polygons = coords.float() * image_size
    rec_scores = torch.softmax(texts.float(), dim=-1)
    recs = rec_scores.argmax(dim=-1)
    return {
        "scores": scores,
        "keep": keep,
        "polygons": polygons,
        "recs": recs,
        "rec_scores": rec_scores,
    }
