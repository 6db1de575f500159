"""Port's msda corner reduce backward against the JAX package's: ``jax.vjp``
of the Pallas kernels in interpret mode against ``torch.autograd.grad``
through the port's ``Function`` (whose backward is the plain version on the
CPU) and against ``msda_corner_reduce_bwd_plain`` called directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.msda_reduce import msda_corner_reduce as jax_reduce
from tair_tpu_torch.ops import msda_reduce as mr
from test_torch_common import torch_single_thread  # noqa: F401

TOL = 1e-5  # float32 on both sides; summation order only


def _inputs(nq, lanes, d, k, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((nq * lanes, 4 * d), dtype=np.float32)
    ws = [rng.random((nq, lanes), dtype=np.float32) for _ in range(4)]
    dout = rng.standard_normal((nq * (lanes // k), d), dtype=np.float32)
    return g, ws, dout


def _jax_vjp(g, ws, dout, k):
    _, vjp = jax.vjp(
        lambda g_, *ws_: jax_reduce(g_, *ws_, k, 32, True),
        jnp.asarray(g), *(jnp.asarray(w) for w in ws),
    )
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize(
    "nq,lanes,d,k",
    [
        (64, 128, 32, 16),   # spotter geometry, whole blocks
        (37, 128, 32, 16),   # ragged NQ (the TPU wrapper pads to 32)
        (5, 8, 16, 4),       # small groups
        (3, 64, 8, 16),      # the tiny model's geometry
    ],
)
def test_function_gradients_match_pallas_interpret(nq, lanes, d, k):
    g, ws, dout = _inputs(nq, lanes, d, k)
    want = _jax_vjp(g, ws, dout, k)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (g, *ws)]
    out = mr.msda_corner_reduce(*leaves, k)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    direct = mr.msda_corner_reduce_bwd_plain(
        *(t.detach() for t in leaves), torch.from_numpy(dout), k
    )
    for name, a, b_, w in zip(("dg", "dw0", "dw1", "dw2", "dw3"), got, direct, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL, err_msg=name)
        np.testing.assert_array_equal(a.numpy(), b_.numpy())


def test_bf16_g_gives_bf16_dg_and_float32_dw():
    g, ws, dout = _inputs(9, 128, 32, 16, seed=1)
    gb = torch.from_numpy(g).bfloat16()
    want = _jax_vjp(jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16), ws, dout, 16)
    assert want[0].dtype == jnp.bfloat16
    leaves = [gb.requires_grad_(True), *(torch.from_numpy(w).requires_grad_(True) for w in ws)]
    got = torch.autograd.grad(mr.msda_corner_reduce(*leaves, 16), leaves, torch.from_numpy(dout))
    assert got[0].dtype == torch.bfloat16
    # dg = w * dO rounded once to bfloat16 on both sides: the same values up
    # to one ulp where the two round a tie differently
    np.testing.assert_allclose(
        got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=2.0 ** -7
    )
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL)


def test_cpu_backward_does_not_count_as_launch():
    before = dict(mr.launches)
    g, ws, dout = _inputs(2, 8, 16, 4)
    out = mr.msda_corner_reduce(
        torch.from_numpy(g).requires_grad_(True), *(torch.from_numpy(w) for w in ws), 4
    )
    out.backward(torch.from_numpy(dout))
    assert mr.launches == before and set(before) == {"fwd", "bwd"}
