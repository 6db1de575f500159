"""Deformable transformer of the TESTR text spotter.

Counterpart of ``tair_tpu/spotter/transformer.py``: a 6-layer encoder of
MSDeformAttn self-attention over the flattened multi-scale tokens, two-stage
proposal generation with top-K selection, and a 6-layer composite decoder
(location branch and factorized text branch). Feature maps are never padded,
so valid-ratio bookkeeping is omitted; dropout is omitted. The sparse encoder
update (``enc_topk``) is the JAX module's, and so are ``use_checkpoint``,
which recomputes each encoder and decoder layer in the backward, and the
sequence-parallel encoder (``enc_sp_axis``: each process of a mesh axis updates
its slice of the query tokens, over the value table of all of them, and the
slices are gathered after each layer). Tokens are ``[B, S, C]`` throughout.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import LayerNorm32, MultiHeadAttention, checkpoint_block
from ..parallel.collectives import copy_to_model, gather_tokens
from .ms_deform_attn import MSDeformAttn


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def encoder_reference_points(spatial_shapes) -> np.ndarray:
    """Static [S, L, 2] normalized reference grid (valid ratios == 1)."""
    pts = []
    for (h, w) in spatial_shapes:
        ref_y, ref_x = np.meshgrid(
            (np.arange(h, dtype=np.float32) + 0.5) / h,
            (np.arange(w, dtype=np.float32) + 0.5) / w,
            indexing="ij",
        )
        pts.append(np.stack([ref_x.reshape(-1), ref_y.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)  # [S, 2]
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


def proposal_grid(spatial_shapes) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-token proposal boxes (cxcywh, logit space) and their
    validity mask; wh = 0.05 * 2^level."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(
            (np.arange(h, dtype=np.float32) + 0.5) / h,
            (np.arange(w, dtype=np.float32) + 0.5) / w,
            indexing="ij",
        )
        grid = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        wh = np.full_like(grid, 0.05 * (2.0**lvl))
        props.append(np.concatenate([grid, wh], -1))
    props = np.concatenate(props, 0)  # [S, 4]
    valid = ((props > 0.01) & (props < 0.99)).all(-1)
    logit = np.log(props / (1 - props))
    logit[~valid] = np.inf
    return logit.astype(np.float32), valid


@functools.lru_cache(maxsize=16)
def _grid_tensors(spatial_shapes, device: torch.device):
    """(proposal logits, proposal validity, encoder reference points) on
    `device`, made once per geometry: a copy from the host in every pass
    would wait for the card."""
    prop_logit, prop_valid = proposal_grid(spatial_shapes)
    ref = encoder_reference_points(spatial_shapes)
    return tuple(torch.from_numpy(a).to(device) for a in (prop_logit, prop_valid, ref))


def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int = 128) -> np.ndarray:
    """Static 2D sine embedding [h, w, 2*num_pos_feats] (normalize=True,
    scale=2pi)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = (np.arange(1, h + 1, dtype=np.float32) - 0.5) / (h + eps) * scale
    x = (np.arange(1, w + 1, dtype=np.float32) - 0.5) / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[None, :, None] / dim_t  # [1, w, F]
    pos_y = y[:, None, None] / dim_t  # [h, 1, F]
    pos_x = np.broadcast_to(pos_x, (h, w, num_pos_feats))
    pos_y = np.broadcast_to(pos_y, (h, w, num_pos_feats))

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], -1).reshape(
            h, w, -1
        )

    return np.concatenate([interleave(pos_y), interleave(pos_x)], -1)


def sine_pos_embed_1d(length: int, channels: int) -> np.ndarray:
    """Static 1D sine embedding [length, channels] (normalize=True, scale=2pi)."""
    scale = 2 * math.pi
    eps = 1e-6
    pos = np.arange(1, length + 1, dtype=np.float32)
    pos = pos / (pos[-1] + eps) * scale
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, channels, 2, np.float32) / channels))
    sin_inp = pos[:, None] * inv_freq[None]
    return np.concatenate([np.sin(sin_inp), np.cos(sin_inp)], -1).astype(np.float32)


def proposal_pos_embed(boxes: torch.Tensor, d_model: int = 256) -> torch.Tensor:
    """[B, K, 4] unactivated boxes -> [B, K, 256] sine embedding."""
    num_pos_feats = 64
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=boxes.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    proposals = torch.sigmoid(boxes) * scale
    pos = proposals[..., None] / dim_t  # [B, K, 4, 64]
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
    return pos.reshape(*boxes.shape[:-1], 4 * num_pos_feats)


def proposal_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[B, k] indices of the k highest scores of each row, highest first,
    the lower index first among equal scores (invalid proposals at -inf
    included): ``jax.lax.top_k``'s order. A stable descending sort, not
    ``torch.topk``, whose order of ties CUDA leaves open; the order is that of
    the decoder's queries, so it is not re-sorted."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def _token_rows(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """Process `rank`'s contiguous slice of the token axis (axis 1) of `x`
    cut into `n` slices of ceil(S / n) tokens; the last slices are padded
    with zeros where S does not divide (as GSPMD pads)."""
    per = -(-x.shape[1] // n)
    if per * n != x.shape[1]:
        pad = x.new_zeros((x.shape[0], per * n - x.shape[1]) + tuple(x.shape[2:]))
        x = torch.cat([x, pad], dim=1)
    return x[:, rank * per : (rank + 1) * per]


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, msda_q_chunk: int = 16384,
                 msda_core: str = "flatlanes", sp_axis: Optional[str] = None):
        super().__init__()
        # sequence parallelism: the mesh axis over which the query tokens are
        # sliced; `parallel.tp.bind_sequence_parallel` gives its process group
        self.sp_axis = sp_axis
        self.sp_group = None
        # 16384 queries a block leaves the encoder's Q = S unchunked at
        # inference shapes; training at a large batch can lower it
        self.self_attn = MSDeformAttn(
            d_model, n_levels, n_heads, n_points, core=msda_core, q_chunk=msda_q_chunk
        )
        self.norm1 = LayerNorm32(d_model)
        self.norm2 = LayerNorm32(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)

    def forward(self, src, pos, reference_points, spatial_shapes, sel_idx=None):
        """`sel_idx` None: every token is updated. `sel_idx` [B, N] (ascending
        token indices): the sparse update, in which only the selected tokens
        are msda queries and go through the norms and the FFN; every token
        stays a sampling source (the value is the layer's input `src`), and
        every other token passes through unchanged.

        With ``sp_axis`` each process of the axis' group updates its slice of
        the query tokens (of all S, or of the N selected) and the slices are
        gathered: the same result on every process. In the backward each
        process keeps its slice's rows of the gathered gradient, and the
        gradients of the layer's inputs sum over the axis (its parameters'
        are partial sums: ``parallel.tp.partial_grad_params``)."""
        group = n_sp = rank = None
        if self.sp_axis:
            if self.sp_group is None:
                raise RuntimeError(
                    f"sp_axis {self.sp_axis!r} has no process group: bind one with "
                    "parallel.tp.bind_sequence_parallel (or shard_params_tp)"
                )
            group = self.sp_group
            n_sp, rank = dist.get_world_size(group), dist.get_rank(group)
        if sel_idx is None and group is None:
            return self._update(src, pos, reference_points, src, spatial_shapes)
        # what this process's update reads: all of it is a partial use
        inp, pos, ref = ((src, pos, reference_points) if group is None else
                         (copy_to_model(t, group) for t in (src, pos, reference_points)))
        if sel_idx is None:
            q_src, q_pos, q_ref = (
                _token_rows(t, n_sp, rank) for t in (inp, pos.expand(src.shape), ref)
            )
            upd = self._update(q_src, q_pos, q_ref, inp, spatial_shapes)
            return gather_tokens(upd, src.shape[1], group, n_sp, rank)

        b, n = sel_idx.shape
        local_idx = sel_idx if group is None else _token_rows(sel_idx, n_sp, rank)
        rows = local_idx[..., None].expand(b, local_idx.shape[1], src.shape[-1])
        src_sel = inp.gather(1, rows)
        pos_sel = pos.expand(src.shape).gather(1, rows)
        ref_sel = ref.gather(
            1, local_idx[:, :, None, None].expand(rows.shape[:2] + ref.shape[2:])
        )
        upd = self._update(src_sel, pos_sel, ref_sel, inp, spatial_shapes)
        if group is not None:
            upd = gather_tokens(upd, n, group, n_sp, rank)
            rows = sel_idx[..., None].expand(b, n, src.shape[-1])
        # a new tensor (`src` is left as it was); the tokens passed through
        # take their gradient whole on every process, not summed
        return src.scatter(1, rows, upd)

    def _update(self, q_src, q_pos, ref, value, spatial_shapes):
        """The layer on its query tokens `q_src` (at `q_pos`, `ref`), with
        every token of `value` a sampling source."""
        src2 = self.self_attn(q_src + q_pos, ref, value, spatial_shapes)
        x = self.norm1(q_src + src2).to(q_src.dtype)
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + h).to(q_src.dtype)


class CompositeDecoderLayer(nn.Module):
    """Location branch + factorized text branch (one decoder layer)."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, msda_q_chunk: int = 16384,
                 msda_core: str = "flatlanes"):
        super().__init__()
        self.n_levels = n_levels
        for suffix in ("", "_text"):
            setattr(self, f"attn_intra{suffix}", MultiHeadAttention(d_model, n_heads))
            setattr(self, f"norm_intra{suffix}", LayerNorm32(d_model))
            setattr(self, f"attn_inter{suffix}", MultiHeadAttention(d_model, n_heads))
            setattr(self, f"norm_inter{suffix}", LayerNorm32(d_model))
            setattr(self, f"attn_cross{suffix}",
                    MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                 core=msda_core, q_chunk=msda_q_chunk))
            setattr(self, f"norm_cross{suffix}", LayerNorm32(d_model))
            setattr(self, f"linear1{suffix}", nn.Linear(d_model, d_ffn))
            setattr(self, f"linear2{suffix}", nn.Linear(d_ffn, d_model))
            setattr(self, f"norm3{suffix}", LayerNorm32(d_model))

    def _branch(self, suffix, tgt, qpos, reference_points, src, spatial_shapes):
        b, k, n, c = tgt.shape
        dtype = tgt.dtype

        def fold(x):  # [B, K, N, C] -> [B*K, N, C]
            return x.reshape(b * k, n, c)

        q = tgt + qpos
        a = getattr(self, f"attn_intra{suffix}")(fold(q), fold(q), fold(tgt))
        tgt = getattr(self, f"norm_intra{suffix}")(tgt + a.reshape(tgt.shape)).to(dtype)

        q = tgt.permute(0, 2, 1, 3).reshape(b * n, k, c)  # [B*N, K, C]
        a = getattr(self, f"attn_inter{suffix}")(q, q, q)
        a = a.reshape(b, n, k, c).permute(0, 2, 1, 3)
        tgt = getattr(self, f"norm_inter{suffix}")(tgt + a).to(dtype)

        ref = reference_points[:, :, None].expand(-1, -1, n, -1, -1)
        a = getattr(self, f"attn_cross{suffix}")(
            (tgt + qpos).reshape(b, k * n, c),
            ref.reshape(b, k * n, self.n_levels, reference_points.shape[-1]),
            src,
            spatial_shapes,
        )
        tgt = getattr(self, f"norm_cross{suffix}")(tgt + a.reshape(tgt.shape)).to(dtype)

        h = F.relu(getattr(self, f"linear1{suffix}")(tgt))
        h = getattr(self, f"linear2{suffix}")(h)
        return getattr(self, f"norm3{suffix}")(tgt + h).to(dtype)

    def forward(
        self,
        tgt,        # [B, K, Np, C] ctrl-point queries
        query_pos,  # [B, K, Np, C]
        tgt_text,   # [B, K, Nw, C] text queries
        query_pos_text,  # [K, Nw, C] or [Nw, C] or [B, K, Nw, C]
        reference_points,  # [B, K, L, 4]
        src,        # [B, S, C]
        spatial_shapes,
    ):
        tgt = self._branch("", tgt, query_pos, reference_points, src, spatial_shapes)
        qp_text = query_pos_text.to(tgt_text.dtype).expand(tgt_text.shape)
        tgt_text = self._branch(
            "_text", tgt_text, qp_text, reference_points, src, spatial_shapes
        )
        return tgt, tgt_text


class MLPHead(nn.Module):
    """num_layers-deep ReLU MLP with layers ``fc0`` .. ``fc<n-1>``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.num_layers - 1}")(x)


class DeformableTransformer(nn.Module):
    """Full two-stage pipeline: encoder -> proposals -> composite decoder.

    forward(srcs, pos_embeds, ctrl_point_embed, text_embed, text_pos_embed)
    with srcs a list of NHWC ``[B, h, w, C]`` maps and pos_embeds their static
    ``[h, w, C]`` embeddings; returns (hs [Ld,B,K,Np,C], hs_text [Ld,B,K,Nw,C],
    init_reference [B,K,4], enc_class [B,S,1], enc_coord_unact [B,S,4]).
    """

    def __init__(
        self,
        d_model: int = 256,
        n_heads: int = 8,
        num_encoder_layers: int = 6,
        num_decoder_layers: int = 6,
        d_ffn: int = 1024,
        n_levels: int = 4,
        enc_n_points: int = 4,
        dec_n_points: int = 4,
        num_proposals: int = 100,
        enc_msda_q_chunk: int = 16384,
        enc_topk: int = 0,
        use_checkpoint: bool = False,
        enc_sp_axis: Optional[str] = None,
    ):
        super().__init__()
        if enc_topk < 0:
            raise ValueError(f"enc_topk must be 0 (off) or positive, got {enc_topk}")
        self.d_model = d_model
        # the sparse encoder update (a serving knob; 0 = every token, the exact
        # path): when 0 < enc_topk < S, each encoder layer updates only the
        # enc_topk tokens that the two-stage objectness head scores highest on
        # the encoder's input, so the msda gather's rows fall by S / enc_topk
        self.enc_topk = enc_topk
        # the layers are ``nn.remat``'s units: with it, the backward recomputes
        # them (the sparse update's `sel_idx` is an input, so the recomputation
        # updates the same tokens)
        self.use_checkpoint = use_checkpoint
        self.n_levels = n_levels
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.num_proposals = num_proposals
        self.level_embed = nn.Parameter(torch.zeros(n_levels, d_model))
        self.enc_output = nn.Linear(d_model, d_model)
        self.enc_output_norm = LayerNorm32(d_model)
        self.bbox_class_embed = nn.Linear(d_model, 1)
        self.bbox_embed = MLPHead(d_model, d_model, 4, 3)
        self.pos_trans = nn.Linear(256, d_model)  # proposal_pos_embed is 4 x 64 wide
        self.pos_trans_norm = LayerNorm32(d_model)
        for i in range(num_encoder_layers):
            setattr(self, f"enc_{i}",
                    EncoderLayer(d_model, d_ffn, n_levels, n_heads, enc_n_points,
                                 msda_q_chunk=enc_msda_q_chunk, sp_axis=enc_sp_axis))
        for i in range(num_decoder_layers):
            setattr(self, f"dec_{i}",
                    CompositeDecoderLayer(d_model, d_ffn, n_levels, n_heads, dec_n_points))

    def _layer(self, layer: nn.Module, *args):
        return checkpoint_block(layer, *args) if self.use_checkpoint else layer(*args)

    def select_tokens(self, src_flat: torch.Tensor, prop_valid: torch.Tensor) -> torch.Tensor:
        """[B, enc_topk] ascending indices of the tokens with the highest
        salience: the two-stage head (the same modules that score the final
        memory) on the encoder's input, invalid proposals at -inf. Among equal
        saliences the lower index wins, as in ``jax.lax.top_k``: a stable
        descending sort, not ``torch.topk``, whose order of ties CUDA leaves
        open. On the device, with no copy to the host."""
        sal = self.bbox_class_embed(
            self.enc_output_norm(self.enc_output(src_flat)).to(src_flat.dtype)
        )[..., 0]
        sal = sal.masked_fill(~prop_valid[None], -torch.inf)
        order = torch.sort(sal, dim=1, descending=True, stable=True).indices
        return order[:, : self.enc_topk].sort(dim=1).values

    def forward(self, srcs, pos_embeds, ctrl_point_embed, text_embed, text_pos_embed):
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        b = srcs[0].shape[0]
        c = self.d_model
        dev = srcs[0].device
        dtype = srcs[0].dtype

        src_flat = torch.cat([s.reshape(b, -1, c) for s in srcs], dim=1)  # [B, S, C]
        pos_flat = torch.cat(
            [
                (p.reshape(-1, c)[None] + self.level_embed[lvl].float()[None, None]).to(dtype)
                for lvl, p in enumerate(pos_embeds)
            ],
            dim=1,
        ).expand(src_flat.shape)

        prop_logit, prop_valid, ref = _grid_tensors(spatial_shapes, dev)
        ref = ref[None].expand(b, -1, -1, -1)
        sel_idx = (
            self.select_tokens(src_flat, prop_valid)
            if 0 < self.enc_topk < src_flat.shape[1] else None
        )
        memory = src_flat
        for i in range(self.num_encoder_layers):
            memory = self._layer(getattr(self, f"enc_{i}"), memory, pos_flat, ref, spatial_shapes,
                                 sel_idx)

        # two-stage proposals
        output_memory = torch.where(
            prop_valid[None, :, None], memory, torch.zeros((), dtype=dtype, device=dev)
        )
        output_memory = self.enc_output_norm(self.enc_output(output_memory)).to(dtype)
        enc_class = self.bbox_class_embed(output_memory)  # [B, S, 1]
        enc_coord_unact = self.bbox_embed(output_memory) + prop_logit[None]  # [B, S, 4]

        k = self.num_proposals
        scores = enc_class[..., 0].float().masked_fill(~prop_valid[None], -torch.inf)
        topk_idx = proposal_indices(scores, k)  # [B, K]
        topk_coords_unact = torch.gather(
            enc_coord_unact, 1, topk_idx[..., None].expand(-1, -1, 4)
        ).detach()
        reference_points = torch.sigmoid(topk_coords_unact)  # [B, K, 4]

        query_pos = self.pos_trans_norm(
            self.pos_trans(proposal_pos_embed(topk_coords_unact.float(), c).to(dtype))
        ).to(dtype)

        n_pts = ctrl_point_embed.shape[0]
        n_words = text_embed.shape[0]
        tgt = ctrl_point_embed[None, None].expand(b, k, n_pts, c).to(dtype)
        qp = query_pos[:, :, None].expand(b, k, n_pts, c)
        tgt_text = text_embed[None, None].expand(b, k, n_words, c).to(dtype)
        ref_input = reference_points[:, :, None, :].expand(b, k, self.n_levels, 4)

        hs, hs_text = [], []
        for i in range(self.num_decoder_layers):
            tgt, tgt_text = self._layer(
                getattr(self, f"dec_{i}"),
                tgt, qp, tgt_text, text_pos_embed, ref_input, memory, spatial_shapes,
            )
            hs.append(tgt)
            hs_text.append(tgt_text)

        return (
            torch.stack(hs),
            torch.stack(hs_text),
            reference_points,
            enc_class,
            enc_coord_unact,
        )
