"""The port's packed-table constructions against the JAX package's: the plain
version behind ``patchify_value_kernel`` against the Pallas kernel in interpret
mode and the concat packing, its backward against ``jax.grad`` of the Pallas
function, and the ``roll`` and ``conv`` tables against ``patchify_value``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.patchify import patchify_value_pallas
from tair_tpu.spotter import ms_deform_attn as jmsda
from tair_tpu_torch.ops import patchify as tp
from tair_tpu_torch.spotter.ms_deform_attn import patchify_value_conv, patchify_value_roll
from test_torch_common import torch_single_thread  # noqa: F401

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


def test_kernel_wrapper_on_cpu_equals_pallas_interpret_and_concat():
    value = _value(SHAPES, 0)
    got = tp.patchify_value_kernel(torch.from_numpy(value), SHAPES).numpy()
    # values are moved, never rounded: equal, atol=0
    np.testing.assert_array_equal(
        got, np.asarray(patchify_value_pallas(jnp.asarray(value), SHAPES, True))
    )
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
