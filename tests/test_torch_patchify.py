"""The port's packed-table constructions against the JAX package's: the plain
version behind ``patchify_value_kernel`` against the Pallas kernel in interpret
mode and the concat packing, its backward against ``jax.grad`` of the Pallas
function, and the ``roll`` and ``conv`` tables against ``patchify_value``. The
CUDA kernel's band design is pinned without a card: its tile schedule covers
every output row once within the shared-memory budget, and a numpy emulation
of its block program over that schedule gives the same bits."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.patchify import patchify_value_pallas
from tair_tpu.spotter import ms_deform_attn as jmsda
from tair_tpu_torch.ops import patchify as tp
from tair_tpu_torch.spotter.ms_deform_attn import patchify_value_conv, patchify_value_roll
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

# a 1-pixel-wide level among ordinary ones; the Pallas kernel cannot shift a
# level that is one pixel HIGH, so those are held against the concat packing
SHAPES = ((3, 5), (2, 2), (4, 1))
FLAT_SHAPES = ((1, 1), (1, 4), (3, 2))
B, H, D = 2, 3, 4


def _value(shapes, seed):
    s = sum(h * w for h, w in shapes)
    return np.random.default_rng(seed).standard_normal((B, s, H, D), dtype=np.float32)


def _reachable(shapes):
    """Rows a core can gather (the patch start is clamped to wl-2 / hl-2) and
    on which the roll table keeps its promise. A level one pixel wide and more
    than one high is left out: its single column is reachable, yet its (0,1)
    lanes hold the next row's value in the roll table, here as in the JAX
    package."""
    keep = []
    for hl, wl in shapes:
        y, x = np.meshgrid(np.arange(hl), np.arange(wl), indexing="ij")
        ok = (x <= max(wl - 2, 0)) & (y <= max(hl - 2, 0)) & (wl > 1 or hl == 1)
        keep.append(ok.reshape(-1))
    return np.tile(np.concatenate(keep), B * H)


@pytest.fixture(scope="module")
def pallas_table():
    """The Pallas kernel in interpret mode on `_value(SHAPES, 0)`: the file's
    one interpret-mode call, shared by the tests that hold a table against it."""
    return np.asarray(patchify_value_pallas(jnp.asarray(_value(SHAPES, 0)), SHAPES, True))


def test_kernel_wrapper_on_cpu_equals_pallas_interpret_and_concat(pallas_table):
    value = _value(SHAPES, 0)
    got = tp.patchify_value_kernel(torch.from_numpy(value), SHAPES).numpy()
    # values are moved, never rounded: equal, atol=0
    np.testing.assert_array_equal(got, pallas_table)
    np.testing.assert_array_equal(
        got, np.asarray(jmsda.patchify_value(jnp.asarray(value), SHAPES))
    )
    assert tp.launches["fwd"] == 0  # the plain version never counts as a launch


@pytest.mark.parametrize("shapes", [SHAPES, FLAT_SHAPES])
def test_tables_match_jax_constructions(shapes):
    value = _value(shapes, 1)
    tv, jv = torch.from_numpy(value), jnp.asarray(value)
    want = np.asarray(jmsda.patchify_value(jv, shapes))
    np.testing.assert_array_equal(tp.patchify_value(tv, shapes).numpy(), want)
    np.testing.assert_array_equal(tp.patchify_value_kernel(tv, shapes).numpy(), want)

    roll = patchify_value_roll(tv, shapes).numpy()
    np.testing.assert_array_equal(roll, np.asarray(jmsda.patchify_value_roll(jv, shapes)))
    keep = _reachable(shapes)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(roll[keep], want[keep])
    assert not np.array_equal(roll[~keep], want[~keep])  # wrapped neighbours there

    conv = patchify_value_conv(tv, shapes).numpy()
    np.testing.assert_array_equal(conv, np.asarray(jmsda.patchify_value_conv(jv, shapes)))
    # channel-major lane c*4 + corner holds what corner-major lane corner*D + c holds
    perm = np.arange(4 * D).reshape(4, D).T.reshape(-1)
    np.testing.assert_array_equal(conv, want[:, perm])


def test_backward_matches_jax_grad_of_the_pallas_function():
    value = _value(SHAPES, 2)
    s = value.shape[1]
    cot = np.random.default_rng(3).standard_normal((B * H * s, 4 * D), dtype=np.float32)
    want = jax.grad(
        lambda x: jnp.vdot(patchify_value_pallas(x, SHAPES, True), jnp.asarray(cot))
    )(jnp.asarray(value))
    leaf = torch.from_numpy(value).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tp.patchify_value_kernel(leaf, SHAPES), leaf, torch.from_numpy(cot)
    )
    # at most four float32 addends an element, in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("shapes", [SHAPES, FLAT_SHAPES])
def test_backward_equals_autograd_through_the_plain_version(shapes):
    value = _value(shapes, 4)
    s = value.shape[1]
    cot = torch.from_numpy(
        np.random.default_rng(5).standard_normal((B * H * s, 4 * D), dtype=np.float32)
    )
    leaf = torch.from_numpy(value).requires_grad_(True)
    (want,) = torch.autograd.grad(tp.patchify_value(leaf, shapes), leaf, cot)
    got = tp.patchify_value_bwd_plain(cot, tuple(value.shape), shapes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    # the cotangent's type comes back, summed in float32 and rounded once
    half = tp.patchify_value_bwd_plain(cot.bfloat16(), tuple(value.shape), shapes)
    assert half.dtype == torch.bfloat16
    exact = tp.patchify_value_bwd_plain(cot.bfloat16().float(), tuple(value.shape), shapes)
    np.testing.assert_array_equal(half.float().numpy(), exact.bfloat16().float().numpy())


def test_bfloat16_table_moves_values_unrounded():
    value = torch.from_numpy(_value(SHAPES, 6)).bfloat16()
    got = tp.patchify_value_kernel(value, SHAPES)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), tp.patchify_value(value.float(), SHAPES).numpy()
    )


def test_wrapper_refuses_shapes_that_do_not_add_up():
    value = torch.zeros((1, 7, 2, 4))
    with pytest.raises(ValueError, match="add up"):
        tp.patchify_value_kernel(value, ((2, 2), (1, 2)))
    with pytest.raises(ValueError, match="at least one"):
        tp.patchify_value_kernel(value, ((7, 1), (0, 3)))


# --- the band kernel (csrc/patchify.cu) without a card -----------------------

SPOTTER_LEVELS = ((16, 16), (32, 32), (64, 64), (64, 64))
# (heads per tile, band tokens, slab bytes): the wrapper's default; one head
# and 16-token bands; a slab of 12 tokens, which cuts every level wider than
# five columns into runs of columns
TILES = {
    "default": (tp.HEAD_GROUP, tp.BAND_TOKENS, tp.SLAB_BYTES),
    "one_head_16": (1, 16, tp.SLAB_BYTES),
    "column_runs": (tp.HEAD_GROUP, tp.BAND_TOKENS, 12 * 16),
}
PIECE = np.dtype((np.void, 16))


def _schedule(monkeypatch, levels, b, h, d, elem_bytes, tile):
    head_group, band_tokens, slab_bytes = TILES[tile]
    monkeypatch.setattr(tp, "SLAB_BYTES", slab_bytes)
    return tp.band_schedule(levels, b, h, d, elem_bytes, head_group, band_tokens)


def test_python_constants_match_the_cuda_source():
    src = (Path(tp.__file__).parent / "csrc" / "patchify.cu").read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == tp.THREADS
    assert int(re.search(r"kSlabBytes = (\d+) \* 1024;", src).group(1)) * 1024 == tp.SLAB_BYTES
    assert int(re.search(r"kTileInts = (\d+);", src).group(1)) == len(tp.TILE_FIELDS)


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("levels", [SHAPES, FLAT_SHAPES, SPOTTER_LEVELS],
                         ids=["shapes", "flat", "spotter"])
def test_band_schedule_covers_every_row_once_within_the_slab(monkeypatch, levels, elem_bytes,
                                                             tile):
    b, h, d = 2, 4, 32 // elem_bytes
    tiles, g, slab = _schedule(monkeypatch, levels, b, h, d, elem_bytes, tile)
    assert h % g == 0 and 1 <= g <= TILES[tile][0]
    assert g * d * elem_bytes <= 16 * tp.THREADS
    s = sum(hl * wl for hl, wl in levels)
    starts = np.cumsum([0] + [hl * wl for hl, wl in levels])[:-1]
    seen = np.zeros((b, h, s), np.int64)
    staged_max = 0
    for bb, h0, start, hl, wl, y0, rows, x0, cols in tiles.tolist():
        assert (start, hl, wl) in {(int(st), lh, lw) for st, (lh, lw) in zip(starts, levels)}
        assert h0 % g == 0 and rows >= 1 and cols >= 1
        assert y0 + rows <= hl and x0 + cols <= wl
        tok = start + (y0 + np.arange(rows))[:, None] * wl + x0 + np.arange(cols)[None]
        seen[bb, h0 : h0 + g, tok.reshape(-1)] += 1
        staged = (rows + (y0 + rows < hl)) * (cols + (x0 + cols < wl)) * g * d * elem_bytes
        assert staged <= tp.SLAB_BYTES
        staged_max = max(staged_max, staged)
    assert (seen == 1).all()  # every (batch, head, level, row, column) exactly once
    assert slab == staged_max
    # a level is cut into runs of columns exactly when two of its rows do not fit,
    # which only the 12-token slab makes happen here
    cut = any(c < w for *_, w, _, _, _, c in tiles.tolist())
    assert cut == any(2 * w * g * d * elem_bytes > tp.SLAB_BYTES for _, w in levels)
    assert cut == (tile == "column_runs")


def emulate_band_kernel(full, h, levels, tiles, g):
    """The block program of patchify_band_kernel in numpy, thread by thread
    (vectorised over the block's threads), in 16-byte pieces and with the
    kernel's own index arithmetic. `full` [B, S, Hf, D] holds value as
    full[:, :, :h], read through its strides. Returns the table [B*h*S, 4D]
    and how often each of its pieces was stored."""
    b, s, hf, d = full.shape
    vpd = d * full.itemsize // 16
    pieces = np.ascontiguousarray(full).reshape(-1).view(PIECE)
    stride_b, stride_s, stride_h = s * hf * vpd, hf * vpd, vpd
    ppr, gv = 4 * vpd, g * vpd
    out = np.zeros(b * h * s * ppr, PIECE)
    stores = np.zeros(out.size, np.int64)
    tid = np.arange(tp.THREADS)
    for bb, h0, start, hl, wl, y0, rows, x0, cols in tiles.tolist():
        srows, scols = rows + (y0 + rows < hl), cols + (x0 + cols < wl)
        slab = np.zeros(srows * scols * gv, PIECE)
        filled = np.zeros(slab.size, bool)
        # 1. stage the band, the row below and the column right, with cp.async
        tpr, k, xs = tp.THREADS // gv, tid % gv, tid // gv
        hh = k // vpd
        src0 = bb * stride_b + (h0 + hh) * stride_h + (k - hh * vpd) + (
            start + y0 * wl + x0) * stride_s
        for r in range(srows):
            for step in range(-(-scols // tpr)):
                x = xs + step * tpr
                m = (xs < tpr) & (x < scols)
                dst = r * scols * gv + x * gv + k
                slab[dst[m]] = pieces[(src0 + r * wl * stride_s + x * stride_s)[m]]
                filled[dst[m]] = True
        assert filled.all() and slab.size * 16 <= tp.SLAB_BYTES
        # 2. write each head's band of output rows, zeros past the border
        rpp, q, xo = tp.THREADS // ppr, tid % ppr, tid // ppr
        corner = q // vpd
        p = q - corner * vpd
        dy, dx = corner >> 1, corner & 1
        xend = np.where((dx == 1) & (x0 + cols == wl), cols - 1, cols)
        for hg in range(g):
            o = ((bb * h + h0 + hg) * s + start + y0 * wl + x0) * ppr + q
            sl = (dy * scols + dx) * gv + hg * vpd + p
            for r in range(rows):
                row_ok = y0 + r + dy < hl
                for step in range(-(-cols // rpp)):
                    x = xo + step * rpp
                    m = (xo < rpp) & (x < cols)
                    take = m & row_ok & (x < xend)
                    v = np.zeros(tp.THREADS, PIECE)
                    v[take] = slab[(sl + x * gv)[take]]
                    at = (o + x * ppr)[m]
                    out[at] = v[m]
                    stores[at] += 1
                o = o + wl * ppr
                sl = sl + scols * gv
    return out.view(full.dtype).reshape(b * h * s, 4 * d), stores


# (levels, numpy type, D, heads cut off the value's wider buffer); the first is
# `_value(SHAPES, 0)` itself, the Pallas table's input
EMULATED = {
    "shapes_f32": (SHAPES, np.float32, D, 0),
    "shapes_f16": (SHAPES, np.float16, 8, 1),
    "flat_f32": (FLAT_SHAPES, np.float32, D, 1),
    "flat_f16": (FLAT_SHAPES, np.float16, 8, 1),
    "spotter_f32": (SPOTTER_LEVELS, np.float32, D, 1),
    "spotter_f16": (SPOTTER_LEVELS, np.float16, 8, 1),
}


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_band_kernel_emulation_equals_plain_and_pallas(monkeypatch, pallas_table, case, tile):
    levels, dtype, d, extra = EMULATED[case]
    s = sum(hl * wl for hl, wl in levels)
    if case == "shapes_f32":
        full = _value(SHAPES, 0)
    else:
        full = np.random.default_rng(7).standard_normal((B, s, H + extra, d)).astype(dtype)
    tiles, g, _ = _schedule(monkeypatch, levels, B, H, d, full.itemsize, tile)
    got, stores = emulate_band_kernel(full, H, levels, tiles, g)
    assert (stores == 1).all()  # every output sector stored once
    want = tp.patchify_value(torch.from_numpy(full)[:, :, :H], levels).numpy()
    # values are moved, never rounded: the same bits, atol=0
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    if case == "shapes_f32":  # the Pallas kernel traces these levels
        np.testing.assert_array_equal(got, pallas_table)
