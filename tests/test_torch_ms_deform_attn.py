"""Port's MSDeformAttn (flatlanes core + corner reduce) against the JAX module
with the Pallas reduce in interpret mode, and against the four-gather oracle,
with sampling points pushed outside [0, 1] so the zero-padding border logic
and the clamped patch start are exercised; the module on its ``flat`` and
``flatpatch`` cores against the JAX module with the same field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.spotter.ms_deform_attn import MSDeformAttn as JaxMSDA
from tair_tpu.spotter.ms_deform_attn import ms_deform_attn_core as jax_core
from tair_tpu_torch.spotter.ms_deform_attn import (
    MSDeformAttn,
    ms_deform_attn_core,
    ms_deform_attn_core_flatlanes,
    patchify_value,
)
from test_torch_common import jax_shapes, load_module, noise_params, torch_single_thread  # noqa: F401

TOL = 1e-4  # float32; gathers are exact, sums differ in order
SHAPES = ((6, 5), (3, 4), (2, 2), (1, 3))
S = sum(h * w for h, w in SHAPES)
D_MODEL, HEADS, POINTS = 32, 4, 2


def _pair(seed=0, core="flatlanes", **torch_fields):
    jm = JaxMSDA(
        d_model=D_MODEL, n_levels=len(SHAPES), n_heads=HEADS, n_points=POINTS,
        core=core, reduce_mode="pallas_interpret",
        **({"q_chunk": torch_fields["q_chunk"]} if "q_chunk" in torch_fields else {}),
    )
    shapes = jax_shapes(
        lambda key, *args: jm.init(key, *args, SHAPES),
        jnp.zeros((1, 3, D_MODEL)), jnp.zeros((1, 3, len(SHAPES), 2)),
        jnp.zeros((1, S, D_MODEL)),
    )["params"]
    params = noise_params(shapes, seed)
    # large offsets: many sample points land outside the maps
    params["sampling_offsets"]["bias"] = (
        3.0 * np.random.default_rng(seed + 1).standard_normal(
            params["sampling_offsets"]["bias"].shape
        ).astype(np.float32)
    )
    tm = load_module(
        MSDeformAttn(D_MODEL, len(SHAPES), HEADS, POINTS, core=core, **torch_fields), params
    )
    return jm, params, tm


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_module_matches_jax_flatlanes_pallas_interpret(ref_dim):
    jm, params, tm = _pair()
    rng = np.random.default_rng(3)
    b, q = 2, 23
    query = rng.standard_normal((b, q, D_MODEL), dtype=np.float32)
    value = rng.standard_normal((b, S, D_MODEL), dtype=np.float32)
    ref = rng.uniform(-0.2, 1.2, (b, q, len(SHAPES), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] = rng.uniform(0.1, 1.5, ref[..., 2:].shape)
    want = jm.apply(
        {"params": params}, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value), SHAPES
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(value), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("ref_dim", [2, 4])
@pytest.mark.parametrize("core", ["flat", "flatpatch"])
def test_module_matches_jax_on_the_unpacked_cores(core, ref_dim):
    """The non-packed location path. The JAX module hands neither `patchify`
    nor `reduce` to these cores; the port's builds the packed table through
    the patchify kernel's plain version here, which is the same function. The
    4-wide case also runs in query blocks that do not divide Q on both sides."""
    fields = {"q_chunk": 8} if ref_dim == 4 else {}
    if core == "flatpatch":
        fields["patchify"] = "kernel"
    jm, params, tm = _pair(seed=12, core=core, **fields)
    rng = np.random.default_rng(13)
    b, q = 2, 23
    query = rng.standard_normal((b, q, D_MODEL), dtype=np.float32)
    value = rng.standard_normal((b, S, D_MODEL), dtype=np.float32)
    ref = rng.uniform(-0.2, 1.2, (b, q, len(SHAPES), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] = rng.uniform(0.1, 1.5, ref[..., 2:].shape)
    want = jm.apply(
        {"params": params}, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value), SHAPES
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(value), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_every_core_loads_the_same_converted_tree_strictly():
    """The cores are layouts of one function: the parameters, and so the
    weight converter's leaves, are the same for each."""
    from tair_tpu_torch.weights.convert import convert_tree

    _, params, tm = _pair(seed=14)
    state = convert_tree(params)
    for core in ("flat", "flatpatch", "flatlanes"):
        mod = MSDeformAttn(D_MODEL, len(SHAPES), HEADS, POINTS, core=core, patchify="kernel")
        result = mod.load_state_dict(state, strict=True)
        assert not result.missing_keys and not result.unexpected_keys
        assert set(mod.state_dict()) == set(tm.state_dict())
    with pytest.raises(ValueError, match="core"):
        bad = MSDeformAttn(D_MODEL, len(SHAPES), HEADS, POINTS, core="patch")
        bad(torch.zeros(1, 2, D_MODEL), torch.zeros(1, 2, len(SHAPES), 2),
            torch.zeros(1, S, D_MODEL), SHAPES)


def _lane_pack(loc, attn):
    # [B,Q,H,L,P,2] / [B,Q,H,L,P] -> lane-packed [B,Q,H*L*P]
    b, q = loc.shape[:2]
    return loc[..., 0].reshape(b, q, -1), loc[..., 1].reshape(b, q, -1), attn.reshape(b, q, -1)


def test_flatlanes_core_matches_oracles_outside_the_maps():
    rng = np.random.default_rng(5)
    b, q, h, d, L, p = 2, 17, HEADS, 8, len(SHAPES), POINTS
    value = rng.standard_normal((b, S, h, d), dtype=np.float32)
    loc = rng.uniform(-0.5, 1.5, (b, q, h, L, p, 2)).astype(np.float32)
    attn = rng.random((b, q, h, L, p), dtype=np.float32)
    assert ((loc < 0) | (loc > 1)).mean() > 0.3
    want = jax_core(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn))
    tv, tl, ta = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn)
    oracle = ms_deform_attn_core(tv, SHAPES, tl, ta)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), atol=TOL)
    got = ms_deform_attn_core_flatlanes(tv, SHAPES, *_lane_pack(tl, ta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_patchify_value_matches_jax():
    from tair_tpu.spotter.ms_deform_attn import patchify_value as jax_patchify

    value = np.random.default_rng(6).standard_normal((2, S, 3, 4), dtype=np.float32)
    want = jax_patchify(jnp.asarray(value), SHAPES)
    got = patchify_value(torch.from_numpy(value), SHAPES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_pixel_levels():
    # 1-wide / 1-high levels: patch start clamps to 0, second column is padding
    shapes = ((1, 1), (1, 4), (3, 1))
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(7)
    value = rng.standard_normal((1, s, 2, 4), dtype=np.float32)
    loc = rng.uniform(-0.3, 1.3, (1, 9, 2, 3, 2, 2)).astype(np.float32)
    attn = rng.random((1, 9, 2, 3, 2), dtype=np.float32)
    want = jax_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = ms_deform_attn_core_flatlanes(
        torch.from_numpy(value), shapes,
        *_lane_pack(torch.from_numpy(loc), torch.from_numpy(attn)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_module_gradients_match_jax_flatlanes_pallas_interpret():
    """Gradients with respect to value_flatten, query and every parameter of
    the module, through the packed core and the reduce's backward, with
    sample points outside the maps."""
    import jax

    jm, params, tm = _pair(seed=8)
    rng = np.random.default_rng(9)
    b, q = 2, 19
    query = rng.standard_normal((b, q, D_MODEL), dtype=np.float32)
    value = rng.standard_normal((b, S, D_MODEL), dtype=np.float32)
    ref = rng.uniform(-0.2, 1.2, (b, q, len(SHAPES), 2)).astype(np.float32)
    cot = rng.standard_normal((b, q, D_MODEL), dtype=np.float32)

    def loss(p, qr, vl):
        return jnp.sum(jm.apply({"params": p}, qr, jnp.asarray(ref), vl, SHAPES) * cot)

    gp, gq, gv = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(query), jnp.asarray(value)
    )
    tm.train()
    tq = torch.from_numpy(query).requires_grad_(True)
    tv = torch.from_numpy(value).requires_grad_(True)
    out = tm(tq, torch.from_numpy(ref), tv, SHAPES)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(out, [tq, tv, *tm.parameters()], torch.from_numpy(cot))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gq), atol=TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(gv), atol=TOL)
    from tair_tpu_torch.weights.convert import to_jax_tree

    got = to_jax_tree(dict(zip(names, grads[2:])), params)
    for mod in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        for leaf in ("kernel", "bias"):
            want = np.asarray(gp[mod][leaf])
            assert np.abs(want).max() > 0
            # float32; the absolute part scales with the leaf's largest gradient
            np.testing.assert_allclose(
                got[mod][leaf], want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                err_msg=f"{mod}/{leaf}",
            )


def test_core_gradient_reaches_value_locations_and_weights_not_rows():
    rng = np.random.default_rng(10)
    b, q, h, d, L, p = 1, 7, HEADS, 8, len(SHAPES), POINTS
    value = torch.from_numpy(rng.standard_normal((b, S, h, d), dtype=np.float32))
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (b, q, h, L, p, 2)).astype(np.float32))
    attn = torch.from_numpy(rng.random((b, q, h, L, p), dtype=np.float32))
    leaves = [t.requires_grad_(True) for t in (value, *_lane_pack(loc, attn))]
    cot = torch.from_numpy(rng.standard_normal((b, q, h * d), dtype=np.float32))
    got = torch.autograd.grad(
        ms_deform_attn_core_flatlanes(leaves[0], SHAPES, *leaves[1:]), leaves, cot
    )
    # the four-gather oracle under plain autograd gives the same gradients
    lx, ly, la = (t.detach().clone().requires_grad_(True) for t in leaves[1:])
    v2 = value.detach().clone().requires_grad_(True)
    loc2 = torch.stack([lx, ly], dim=-1).reshape(b, q, h, L, p, 2)
    want = torch.autograd.grad(
        ms_deform_attn_core(v2, SHAPES, loc2, la.reshape(b, q, h, L, p)), [v2, lx, ly, la], cot
    )
    for name, a, w in zip(("value", "locx", "locy", "attn"), got, want):
        assert a.abs().max() > 0, name
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL, err_msg=name)


def test_gather_rows_sums_its_gradient_in_float32():
    from tair_tpu_torch.spotter.ms_deform_attn import gather_rows

    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((5, 8), dtype=np.float32)).bfloat16()
    rows = torch.from_numpy(rng.integers(0, 5, 4000))
    dg = torch.from_numpy(rng.standard_normal((4000, 8), dtype=np.float32)).bfloat16()
    leaf = table.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gather_rows(leaf, rows), leaf, dg)
    assert got.dtype == torch.bfloat16
    want = torch.zeros((5, 8)).index_add_(0, rows, dg.float())
    # 800 bfloat16 addends a row: summed in float32 and rounded once
    np.testing.assert_array_equal(got.float().numpy(), want.bfloat16().float().numpy())
