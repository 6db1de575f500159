"""Port's flash attention backward against the JAX package's: ``jax.grad``
through the Pallas kernels in interpret mode (forward, dQ, dK/dV) against
``torch.autograd.grad`` through the port's ``Function`` (whose backward is the
plain version on the CPU) and against ``flash_attention_bwd_plain`` called
directly; the query split of the tensor-core dK/dV kernel and its plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.flash_attention import flash_attention as jax_flash
from tair_tpu_torch.ops import flash_attention as fa
from test_torch_common import torch_single_thread  # noqa: F401

# float32 on both sides; only the summation order differs
TOL = 2e-5

CASES = [
    # b, tq, tk, h, d, scale, strided
    (1, 64, 64, 2, 16, None, False),    # self-attention, several blocks, narrow head
    (2, 100, 77, 3, 64, None, False),   # cross-attention: ragged q, 77 keys
    (1, 40, 77, 2, 16, 0.5, False),     # custom scale
    (2, 45, 45, 2, 64, None, True),     # q, k, v cut out of one wider projection
]


def _inputs(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((b, t, h, d), dtype=np.float32) for t in (tq, tk, tk, tq)
    ]


def _jax_grads(q, k, v, do, scale):
    def f(q_, k_, v_):
        out = jax_flash(q_, k_, v_, scale=scale, block_q=32, block_k=32, interpret=True)
        return jnp.sum(out * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _torch_leaves(q, k, v, strided):
    if not strided:
        return None, [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    # one [B, T, 3, H, D] buffer, as a fused projection would leave it: the
    # three views have a token stride of 3*H*D
    fused = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_(True)
    return fused, [fused[:, :, i] for i in range(3)]


@pytest.mark.parametrize("b,tq,tk,h,d,scale,strided", CASES)
def test_function_gradients_match_pallas_interpret(b, tq, tk, h, d, scale, strided):
    if strided:
        assert tq == tk
    q, k, v, do = _inputs(b, tq, tk, h, d)
    want = _jax_grads(q, k, v, do, scale)
    fused, (tq_, tk_, tv_) = _torch_leaves(q, k, v, strided)
    assert strided == (not tq_.is_contiguous())
    out, lse = fa.flash_attention(tq_, tk_, tv_, scale)
    assert not lse.requires_grad
    if strided:
        (g,) = torch.autograd.grad(out, fused, torch.from_numpy(do))
        got = [g[:, :, i] for i in range(3)]
    else:
        got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("b,tq,tk,h,d,scale,strided", CASES[:3])
def test_bwd_plain_matches_pallas_interpret(b, tq, tk, h, d, scale, strided):
    q, k, v, do = _inputs(b, tq, tk, h, d, seed=1)
    want = _jax_grads(q, k, v, do, scale)
    tq_, tk_, tv_, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq_, tk_, tv_, scale)
    got = fa.flash_attention_bwd_plain(tq_, tk_, tv_, out, lse, tdo, scale)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, err_msg=f"d{name}")


def test_plain_forward_stays_differentiable_and_agrees_with_the_function():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 33, 50, 2, 32, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(fa.flash_attention_plain(*leaves)[0], leaves, do)
    func = torch.autograd.grad(fa.flash_attention(*leaves)[0], leaves, do)
    for a, b_ in zip(func, plain):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=TOL)


def test_bf16_gradients_keep_dtype_and_hold_to_float32():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 48, 77, 2, 64, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, _ = fa.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float())
    want = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.detach().float(), ref_lse, do.float()
    )
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        # one bfloat16 ulp of the value compared for the store, and a tenth of
        # a percent of a typical value for elements that cancel to near zero
        np.testing.assert_allclose(
            a.float().numpy(), w.numpy(), rtol=2.0 ** -7, atol=1e-3 * w.abs().mean().item()
        )


def test_cpu_backward_does_not_count_as_launch():
    before = dict(fa.launches)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 16))
    out, _ = fa.flash_attention(q.requires_grad_(True), k, v)
    out.backward(do)
    assert fa.launches == before
    assert set(before) == {"fwd", "fwd_tc", "fwd_tc_wide", "dq", "dq_tc", "dkv", "dkv_tc"}


@pytest.mark.parametrize(
    "b,h,tq,tk",
    [
        (1, 5, 4096, 4096), (1, 5, 4096, 77), (1, 10, 1024, 1024), (1, 10, 1024, 77),
        (1, 20, 256, 256), (1, 20, 256, 77), (1, 20, 64, 64), (1, 20, 64, 77),
        (2, 3, 1000, 333), (2, 4, 301, 77), (1, 1, 1, 1), (4, 8, 200, 77),
    ],
)
def test_dkv_query_split(b, h, tq, tk):
    splits = fa.dkv_query_split(b, h, tq, tk)
    chunk = fa.dkv_chunk_queries(tq, splits)
    starts = list(range(0, tq, chunk))
    assert splits >= 1 and chunk % 64 == 0
    # the chunks cover Tq exactly, and none is empty
    assert len(starts) == splits and starts[-1] < tq <= splits * chunk
    blocks = -(-tk // 64) * b * h * splits
    if (b, h, tq, tk) == (1, 5, 4096, 4096):
        assert splits == 1  # 64 key tiles x 5 heads already fill 132 SMs
    if (b, h, tq, tk) == (1, 5, 4096, 77):
        assert splits > 1 and blocks >= 132
    if splits > 1:  # never more chunks than two blocks per SM ask for
        assert -(-tk // 64) * b * h * (splits - 1) < 2 * fa.SMS


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_dkv_split_plain_matches_bwd_plain(splits):
    """Partials per chunk of queries, added in chunk order, give the unsplit dK
    and dV to float32 rounding (the same sums, grouped)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 200, 77, 3, 32, seed=4))
    out, lse = fa.flash_attention_plain(q, k, v)
    _, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    assert len(range(0, 200, fa.dkv_chunk_queries(200, splits))) == splits
    got_k, got_v = fa.flash_attention_dkv_split_plain(q, k, v, out, lse, do, splits)
    np.testing.assert_allclose(got_k.numpy(), dk.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), dv.numpy(), atol=1e-6)


def test_dkv_split_plain_matches_pallas_interpret():
    """The split's plain version against the Pallas dK/dV kernel in interpret
    mode, through jax.vjp; float32 on both sides, so only the summation order
    differs (TOL)."""
    b, tq, tk, h, d, scale = 1, 130, 77, 2, 16, None
    q, k, v, do = _inputs(b, tq, tk, h, d, seed=5)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(
            q_, k_, v_, scale=scale, block_q=32, block_k=32, interpret=True
        ),
        *map(jnp.asarray, (q, k, v)),
    )
    _, dk_j, dv_j = vjp(jnp.asarray(do))
    tq_, tk_, tv_, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq_, tk_, tv_, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=TOL)
    splits = 3  # chunks of 64, 64 and 2 queries
    assert fa.dkv_chunk_queries(tq, splits) == 64
    dk, dv = fa.flash_attention_dkv_split_plain(tq_, tk_, tv_, out, lse, tdo, splits, scale)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), atol=TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), atol=TOL)
