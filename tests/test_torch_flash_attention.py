"""Port's flash attention (plain version, the one the CPU runs) against the
JAX package's Pallas kernel in interpret mode and against einsum_sdpa."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.attention import einsum_sdpa as jax_einsum_sdpa
from tair_tpu.ops.flash_attention import _flash_attention_fwd
from tair_tpu_torch.ops import flash_attention as fa
from tair_tpu_torch.ops.attention import einsum_sdpa, sdpa
from test_torch_common import torch_single_thread  # noqa: F401

# float32 on both sides; only the summation order differs
TOL = 1e-5

CASES = [
    (1, 64, 64, 2, 32, None),     # self-attention, several blocks
    (2, 100, 77, 4, 64, None),    # cross-attention, ragged q, 77 keys
    (1, 40, 77, 1, 16, 0.5),      # custom scale
    (1, 33, 130, 3, 128, None),   # ragged both ways, wide head
]


def _inputs(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, tq, h, d), dtype=np.float32),
        rng.standard_normal((b, tk, h, d), dtype=np.float32),
        rng.standard_normal((b, tk, h, d), dtype=np.float32),
    )


@pytest.mark.parametrize("b,tq,tk,h,d,scale", CASES)
def test_plain_matches_pallas_interpret_o_and_lse(b, tq, tk, h, d, scale):
    q, k, v = _inputs(b, tq, tk, h, d)
    s = scale if scale is not None else 1.0 / np.sqrt(d)
    out_j, res = _flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s, 32, 32, True
    )
    lse_j = np.asarray(res[4])[:, :tq, 0].reshape(b, h, tq)
    out_t, lse_t = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=TOL)


@pytest.mark.parametrize("b,tq,tk,h,d,scale", CASES)
def test_sdpa_matches_jax_einsum_sdpa(b, tq, tk, h, d, scale):
    q, k, v = _inputs(b, tq, tk, h, d, seed=1)
    ref = jax_einsum_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(sdpa(tq_, tk_, tv_, scale).numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(
        einsum_sdpa(tq_, tk_, tv_, scale).numpy(), np.asarray(ref), atol=TOL
    )


def test_bf16_inputs_keep_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 64, 64, 2, 32))
    out, lse = fa.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = fa.flash_attention_plain(q.float(), k.float(), v.float())
    # one bfloat16 ulp of the value compared, against the float32 result
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2.0 ** -7, atol=1e-4)


def test_cpu_call_does_not_count_as_launch():
    before = dict(fa.launches)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def test_requires_grad_raises():
    """A tensor that requires grad is taken now (the backward has its
    kernels); what still raises is a backward launch at a head width that has
    no backward kernel, naming the width."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 16))
    out, lse = fa.flash_attention(q.requires_grad_(True), k, v)
    assert out.requires_grad and not lse.requires_grad
    wide = torch.zeros((1, 8, 1, 512))
    stats = torch.zeros((1, 1, 8))
    with pytest.raises(NotImplementedError, match="512"):
        fa._launch_backward_kernel("dq", wide, wide, wide, wide, stats, stats, 1.0)


@pytest.mark.parametrize(
    "shapes",
    [
        ((1, 8, 2, 16), (1, 8, 2, 32), (1, 8, 2, 32)),   # head width differs
        ((1, 8, 2, 16), (1, 8, 3, 16), (1, 8, 3, 16)),   # heads differ
        ((1, 8, 2, 16), (1, 9, 2, 16), (1, 8, 2, 16)),   # k and v differ
    ],
)
def test_shape_mismatch_raises(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
