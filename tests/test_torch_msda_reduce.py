"""Port's msda corner reduce (plain version, the one the CPU runs) against the
JAX package's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.msda_reduce import msda_corner_reduce as jax_reduce
from tair_tpu_torch.ops import msda_reduce as mr
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

TOL = 1e-5  # float32 on both sides; summation order only


def _inputs(nq, lanes, d, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((nq * lanes, 4 * d), dtype=np.float32)
    ws = [rng.random((nq, lanes), dtype=np.float32) for _ in range(4)]
    return g, ws


@pytest.mark.parametrize(
    "nq,lanes,d,k",
    [
        (64, 128, 32, 16),   # spotter geometry, whole blocks
        (37, 128, 32, 16),   # ragged NQ (the TPU wrapper pads to 32)
        (5, 8, 16, 4),       # small groups
        (3, 64, 8, 16),      # the tiny model's geometry
    ],
)
def test_plain_matches_pallas_interpret(nq, lanes, d, k):
    g, ws = _inputs(nq, lanes, d)
    ref = jax_reduce(jnp.asarray(g), *(jnp.asarray(w) for w in ws), k, 32, True)
    out = mr.msda_corner_reduce(torch.from_numpy(g), *(torch.from_numpy(w) for w in ws), k)
    assert out.dtype == torch.float32 and tuple(out.shape) == (nq * (lanes // k), d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_bf16_g_accumulates_in_float32():
    g, ws = _inputs(9, 128, 32, seed=1)
    gb = torch.from_numpy(g).bfloat16()
    out = mr.msda_corner_reduce(gb, *(torch.from_numpy(w) for w in ws), 16)
    ref = jax_reduce(
        jnp.asarray(gb.float().numpy()), *(jnp.asarray(w) for w in ws), 16, 32, True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_cpu_call_does_not_count_as_launch():
    before = dict(mr.launches)
    g, ws = _inputs(2, 8, 16)
    mr.msda_corner_reduce(torch.from_numpy(g), *(torch.from_numpy(w) for w in ws), 4)
    assert mr.launches == before


def test_requires_grad_raises():
    """A tensor that requires grad is taken now (the backward has its kernel);
    what still raises, with or without a gradient asked for, is a type of `g`
    that no kernel takes."""
    g, ws = _inputs(2, 8, 16)
    tw = [torch.from_numpy(w) for w in ws]
    out = mr.msda_corner_reduce(torch.from_numpy(g).requires_grad_(True), *tw, 4)
    assert out.requires_grad
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mr.msda_corner_reduce(torch.from_numpy(g).double().requires_grad_(True), *tw, 4)


def test_bad_shapes_raise():
    g, ws = _inputs(2, 8, 16)
    tw = [torch.from_numpy(w) for w in ws]
    with pytest.raises(ValueError):
        mr.msda_corner_reduce(torch.from_numpy(g)[:-1], *tw, 4)   # rows != NQ*lanes
    with pytest.raises(ValueError):
        mr.msda_corner_reduce(torch.from_numpy(g), *tw, 3)        # lanes % k
    with pytest.raises(TypeError):
        mr.msda_corner_reduce(torch.from_numpy(g), tw[0].double(), *tw[1:], 4)
