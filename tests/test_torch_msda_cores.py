"""Every msda core of the port against the same core of the JAX package: each
core x reduce x packed-table construction, unchunked and in query blocks that
do not divide Q, forward and gradients to value, locations and weights, with
sample points pushed outside the maps and a 1-pixel-wide level.

The JAX side runs eagerly (no jit: every case shares the primitives' compiled
forms, the shapes being equal across cases) and once per variant; the chunked
case of a variant is held against the same unchunked JAX result, which is the
same function, and one case per core also runs the JAX core's own ``lax.map``.
JAX's Pallas pieces run as its own tests run them: the patchify kernel in
interpret mode handed in as ``value_patched``, the reduce as
``"pallas_interpret"``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.patchify import patchify_value_pallas
from tair_tpu.spotter import ms_deform_attn as J
from tair_tpu_torch.spotter import ms_deform_attn as T
from test_torch_common import torch_single_thread  # noqa: F401

FWD_TOL = 1e-5   # float32 on both sides; gathers are exact, sums differ in order
GRAD_TOL = 1e-4  # scatter-adds of up to Q*P rows, in another order
SHAPES = ((5, 4), (3, 1), (2, 3))   # (3, 1): one pixel wide
# the JAX patch core gathers 2x2 slices and cannot be traced with a 1-pixel level
PATCH_SHAPES = ((5, 4), (3, 2), (2, 3))
B, Q, H, D, L, P = 2, 11, 2, 4, len(SHAPES), 2
Q_CHUNK = 4                          # smaller than Q, does not divide it

VARIANTS = (
    [("patch", None, None), ("flat", None, None)]
    + [("flatpatch", r, p) for r in T.FLATPATCH_REDUCES for p in ("concat", "roll", "conv", "kernel")]
    + [("flatlanes", r, p) for r in T.FLATLANES_REDUCES for p in ("concat", "roll", "kernel")]
)
CASES = [(c, r, p, ch) for (c, r, p) in VARIANTS for ch in (False, True) if not (c == "patch" and ch)]


def _inputs(shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, s, H, D), dtype=np.float32)
    loc = rng.uniform(-0.3, 1.3, (B, Q, H, len(shapes), P, 2)).astype(np.float32)
    attn = rng.random((B, Q, H, len(shapes), P), dtype=np.float32)
    cot = rng.standard_normal((B, Q, H * D), dtype=np.float32)
    assert ((loc < 0) | (loc > 1)).mean() > 0.25
    return value, loc, attn, cot


def _lane_pack(loc, attn):
    b, q = loc.shape[:2]
    return loc[..., 0].reshape(b, q, -1), loc[..., 1].reshape(b, q, -1), attn.reshape(b, q, -1)


def _jax_fn(core, reduce, patchify, q_chunk=None):
    chunk = {} if q_chunk is None else {"q_chunk": q_chunk}
    if core == "patch":
        return lambda v, l, a: J.ms_deform_attn_core_patch(v, PATCH_SHAPES, l, a)
    if core == "flat":
        return lambda v, l, a: J.ms_deform_attn_core_flat(v, SHAPES, l, a, **chunk)

    def table(v):  # JAX's cores reach the Pallas kernel only through value_patched
        if patchify == "kernel":
            return {"value_patched": patchify_value_pallas(v, SHAPES, True)}
        return {"patchify": patchify}

    if core == "flatpatch":
        return lambda v, l, a: J.ms_deform_attn_core_flatpatch(
            v, SHAPES, l, a, reduce=reduce, **table(v), **chunk
        )
    jreduce = {"kernel": "pallas_interpret"}.get(reduce, reduce)
    return lambda v, lx, ly, a: J.ms_deform_attn_core_flatlanes(
        v, SHAPES, lx, ly, a, reduce=jreduce, **table(v), **chunk
    )


def _args(core, value, loc, attn):
    return (value, *_lane_pack(loc, attn)) if core == "flatlanes" else (value, loc, attn)


@functools.lru_cache(maxsize=None)
def _jax_reference(core, reduce, patchify):
    value, loc, attn, cot = _inputs(PATCH_SHAPES if core == "patch" else SHAPES)
    args = tuple(jnp.asarray(a) for a in _args(core, value, loc, attn))
    out, vjp = jax.vjp(_jax_fn(core, reduce, patchify), *args)
    return np.asarray(out), tuple(np.asarray(g) for g in vjp(jnp.asarray(cot)))


def _torch_call(core, reduce, patchify, args, q_chunk=None):
    chunk = {} if q_chunk is None else {"q_chunk": q_chunk}
    if core == "patch":
        return T.ms_deform_attn_core_patch(args[0], PATCH_SHAPES, *args[1:])
    if core == "flat":
        return T.ms_deform_attn_core_flat(args[0], SHAPES, *args[1:], **chunk)
    fn = T.ms_deform_attn_core_flatpatch if core == "flatpatch" else T.ms_deform_attn_core_flatlanes
    return fn(args[0], SHAPES, *args[1:], reduce=reduce, patchify=patchify, **chunk)


@pytest.mark.parametrize(
    "core,reduce,patchify,chunked", CASES,
    ids=[f"{c}-{r}-{p}-{'chunked' if ch else 'whole'}" for c, r, p, ch in CASES],
)
def test_core_matches_the_same_jax_core(core, reduce, patchify, chunked):
    want_out, want_grads = _jax_reference(core, reduce, patchify)
    value, loc, attn, cot = _inputs(PATCH_SHAPES if core == "patch" else SHAPES)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in _args(core, value, loc, attn)]
    out = _torch_call(core, reduce, patchify, leaves, Q_CHUNK if chunked else None)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=FWD_TOL)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for got, want in zip(grads, want_grads):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL)


@pytest.mark.parametrize("core", ["flat", "flatpatch", "flatlanes"])
def test_chunked_core_matches_the_jax_core_under_lax_map(core):
    reduce = {"flat": None, "flatpatch": "mxu", "flatlanes": "mxu"}[core]
    value, loc, attn, _ = _inputs()
    args = _args(core, value, loc, attn)
    want = _jax_fn(core, reduce, "concat", Q_CHUNK)(*(jnp.asarray(a) for a in args))
    got = _torch_call(core, reduce, "concat", [torch.from_numpy(a) for a in args], Q_CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)


@pytest.mark.parametrize(
    "core,reduce,patchify",
    [v for v in VARIANTS if v[2] != "roll"],
    ids=lambda v: str(v),
)
def test_one_pixel_levels_against_the_reference_core(core, reduce, patchify):
    """Levels one pixel high or wide are where a clamped patch start slips:
    max(size - 2, 0) is 0 and the patch's second row or column does not exist.
    torch raises on the out-of-range index that JAX would clamp. (The roll
    table is wrong by construction for a level one pixel wide, here and in the
    JAX package, and is left out.)"""
    shapes = ((1, 1), (1, 4), (3, 1))
    value, loc, attn, _ = _inputs(shapes, seed=1)
    want = J.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    args = [torch.from_numpy(a) for a in _args(core, value, loc, attn)]
    if core == "patch":
        got = T.ms_deform_attn_core_patch(args[0], shapes, *args[1:])
    elif core == "flat":
        got = T.ms_deform_attn_core_flat(args[0], shapes, *args[1:], q_chunk=Q_CHUNK)
    else:
        fn = T.ms_deform_attn_core_flatpatch if core == "flatpatch" else T.ms_deform_attn_core_flatlanes
        got = fn(args[0], shapes, *args[1:], reduce=reduce, patchify=patchify, q_chunk=Q_CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)


def test_unknown_choices_raise():
    value, loc, attn, _ = _inputs()
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, attn))
    packed = [torch.from_numpy(a) for a in _lane_pack(loc, attn)]
    with pytest.raises(ValueError, match="patchify"):
        T.ms_deform_attn_core_flatpatch(tv, SHAPES, tl, ta, patchify="pallas")
    with pytest.raises(ValueError, match="patchify"):
        T.ms_deform_attn_core_flatlanes(tv, SHAPES, *packed, patchify="pallas")
    with pytest.raises(ValueError, match="patchify"):  # channel-major lanes
        T.ms_deform_attn_core_flatlanes(tv, SHAPES, *packed, patchify="conv")
    with pytest.raises(ValueError, match="reduce"):
        T.ms_deform_attn_core_flatpatch(tv, SHAPES, tl, ta, reduce="kernel")
    with pytest.raises(ValueError, match="reduce"):
        T.ms_deform_attn_core_flatlanes(tv, SHAPES, *packed, reduce="einsum")
    with pytest.raises(ValueError, match="q_chunk"):
        T.ms_deform_attn_core_flat(tv, SHAPES, tl, ta, q_chunk=0)


def test_value_patched_takes_the_place_of_the_construction():
    value, loc, attn, _ = _inputs()
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, attn))
    want = T.ms_deform_attn_core_flatpatch(tv, SHAPES, tl, ta)
    table = T.patchify_value_kernel(tv, SHAPES)
    got = T.ms_deform_attn_core_flatpatch(tv, SHAPES, tl, ta, value_patched=table)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    packed = [torch.from_numpy(a) for a in _lane_pack(loc, attn)]
    got = T.ms_deform_attn_core_flatlanes(tv, SHAPES, *packed, value_patched=table)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL)
