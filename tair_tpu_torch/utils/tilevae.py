"""Tiled VAE encode and decode for large images.

Counterpart of ``tair_tpu/utils/tilevae.py``: the tiles of one image run as one
batched call, their overlaps are blended by ``tiling.merge_with_overlap``'s
linear fade, and with ``cross_tile_gn`` every GroupNorm pools its statistics
over the tiles (``models.layers.gn_stats_over_batch``), so each tile is
normalised with the whole image's statistics. The NaN check reads one boolean
per image on the host: one synchronisation per image, as in the JAX module.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..models.layers import gn_stats_over_batch
from ..tiling import merge_with_overlap, split_with_overlap


class NansException(Exception):
    pass


def tiled_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,    # [B, H, W, C]
    tile: int,
    overlap: int,
    out_scale_num: int,     # output size = input * num / den (1/8 to encode)
    out_scale_den: int,
    check_nans: bool = True,
    cross_tile_gn: bool = False,
) -> torch.Tensor:
    """Apply an image -> image function tile-wise with a blend-merge; float32.

    fn maps [N, tile, tile, C] -> [N, tile*num/den, tile*num/den, C'].
    cross_tile_gn: pool GroupNorm statistics across the tiles of each image."""
    outs = []
    ctx = gn_stats_over_batch if cross_tile_gn else contextlib.nullcontext
    out_tile = tile * out_scale_num // out_scale_den
    out_overlap = max(1, overlap * out_scale_num // out_scale_den)
    for i in range(image.shape[0]):
        tiles = split_with_overlap(image[i], tile, overlap)
        with ctx():
            out_tiles = fn(tiles)
        if check_nans and bool(torch.isnan(out_tiles).any()):
            raise NansException("NaNs produced in tiled_apply")
        outs.append(merge_with_overlap(
            out_tiles, (image.shape[1], image.shape[2]), in_patch=tile, in_overlap=overlap,
            out_patch=out_tile, out_overlap=out_overlap,
        ))
    return torch.stack(outs)


def tiled_vae_encode(
    cldm, image: torch.Tensor, tile_size: int = 256, overlap: int = 32,
    cross_tile_gn: bool = True,
) -> torch.Tensor:
    """image [-1, 1] NHWC -> scaled latent (the mode), tile-wise."""
    return tiled_apply(
        lambda tiles: cldm.vae_encode(tiles, sample=False), image, tile_size, overlap, 1, 8,
        cross_tile_gn=cross_tile_gn,
    )


def tiled_vae_decode(
    cldm, z: torch.Tensor, tile_size: int = 32, overlap: int = 8, cross_tile_gn: bool = True,
) -> torch.Tensor:
    """Scaled latent NHWC -> image [-1, 1], tile-wise (`tile_size` in latent pixels)."""
    return tiled_apply(cldm.vae_decode, z, tile_size, overlap, 8, 1, cross_tile_gn=cross_tile_gn)
