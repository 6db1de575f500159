"""Port's flash attention (plain version, the one the CPU runs) against the
JAX package's Pallas kernel in interpret mode and against einsum_sdpa, at the
UNet's head widths and the autoencoder's D = 512; the choice between the
tensor-core and the FMA kernels; and why the tensor-core kernels carry P and
dS as two bfloat16 terms."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.ops.attention import einsum_sdpa as jax_einsum_sdpa
from tair_tpu.ops.flash_attention import _flash_attention_fwd
from tair_tpu_torch.ops import flash_attention as fa
from tair_tpu_torch.ops.attention import einsum_sdpa, sdpa
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

# float32 on both sides; only the summation order differs
TOL = 1e-5

CASES = [
    (1, 64, 64, 2, 32, None),     # self-attention, several blocks
    (2, 100, 77, 4, 64, None),    # cross-attention, ragged q, 77 keys
    (1, 40, 77, 1, 16, 0.5),      # custom scale
    (1, 33, 130, 3, 128, None),   # ragged both ways, wide head
    (1, 48, 80, 1, 512, None),    # the autoencoder's single 512-wide head
    (1, 48, 80, 1, 1024, None),   # a head above 512: the column-split kernels' width
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
    out_j, res = jax.jit(_flash_attention_fwd, static_argnums=(3, 4, 5, 6))(
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
    kernels at every width of the forward, the autoencoder's D = 512
    included); what still raises is a backward launch at a head width that
    has no kernel, naming the width."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 16))
    out, lse = fa.flash_attention(q.requires_grad_(True), k, v)
    assert out.requires_grad and not lse.requires_grad
    assert 512 in fa.HEAD_DIMS
    odd = torch.zeros((1, 8, 1, 96))
    stats = torch.zeros((1, 1, 8))
    with pytest.raises(NotImplementedError, match="96"):
        fa._launch_backward_kernel("dq", odd, odd, odd, odd, stats, stats, 1.0)


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


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("d", [*fa.HEAD_DIMS, 640, 768, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_choice(dtype, d, kind):
    """bfloat16 takes the tensor-core kernels: the forward, dQ and dK/dV at
    every head width (kernels of their own at the autoencoder's D = 512, and
    the column-split ones above 512); float32 (held to 1e-4, never through
    TF32) takes the FMA kernels (column-split ones above 512)."""
    tc = dtype == torch.bfloat16
    assert fa.kernel_width(d)
    assert fa.tensor_core_kernels(dtype, d, kind) == tc
    if d > 512:
        want = f"{kind}_tc_colsplit" if tc else f"{kind}_colsplit"
    else:
        want = f"{kind}_tc_wide" if tc and d == 512 else f"{kind}_tc" if tc else kind
    assert fa.kernel_name(dtype, d, kind) == want
    assert want in fa.launches


@pytest.mark.parametrize("d,want", [
    (640, [(0, 384), (384, 256)]),
    (768, [(0, 384), (384, 384)]),
    (1024, [(0, 512), (512, 512)]),
    (1152, [(0, 384), (384, 384), (768, 384)]),
    (2176, [(0, 512), (512, 512), (1024, 384), (1408, 384), (1792, 384)]),
])
def test_column_slices_cover_the_head_once(d, want):
    """The column-split kernels' output slices (one grid plane each): as few
    as keep every slice within 512 columns, sharing the 128-column units as
    evenly as they go, covering [0, D) once in order."""
    slices = fa.column_slices(d)
    assert slices == want
    assert [s for s, _ in slices] == [sum(w for _, w in slices[:i]) for i in range(len(slices))]
    assert sum(w for _, w in slices) == d
    assert all(w % fa.COLUMN_GRANULE == 0 and 256 <= w <= fa.SLICE_MAX for _, w in slices)
    assert len(slices) == -(-d // fa.SLICE_MAX)


@pytest.mark.parametrize(
    "which,dtype,d",
    [
        ("fwd_tc_wide", torch.bfloat16, 64),   # the wide kernel has D = 512 only
        ("fwd_tc", torch.bfloat16, 512),       # and the narrow one D <= 128
        ("fwd_tc", torch.float32, 64),         # tensor cores take bfloat16 only
        ("dq_tc", torch.float32, 64),
        ("dkv_tc", torch.float32, 32),
        ("dq_tc", torch.bfloat16, 512),        # D = 512 has a backward kernel of its own
        ("dq_tc_wide", torch.bfloat16, 64),
        ("dkv_tc_wide", torch.float32, 512),
        ("fwd", torch.float32, 640),           # above 512 the FMA kernel is the column split's
        ("fwd_colsplit", torch.bfloat16, 1024),  # which takes float32 only
        ("fwd_tc_colsplit", torch.float32, 640),
        ("dq_tc_wide", torch.bfloat16, 1024),
        ("dkv_tc_colsplit", torch.bfloat16, 512),
    ],
)
def test_tensor_core_kernel_refuses_other_calls(which, dtype, d):
    """Asking for a tensor-core kernel outside its types and widths raises
    before anything is launched."""
    q = torch.zeros((1, 8, 1, d), dtype=dtype)
    with pytest.raises(ValueError, match=which):
        if which.startswith("fwd"):
            fa._launch(q, q, q, 1.0, which)
        else:
            stats = torch.zeros((1, 1, 8))
            fa._launch_backward_kernel(which, q, q, q, q, stats, stats, 1.0)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _two_terms(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


@pytest.mark.parametrize("product", ["pv", "dv", "dk", "dq", "pv512", "dv512", "dk512", "dq512",
                                     "pv1024", "dv1024", "dk1024", "dq1024"])
def test_bf16_probabilities_need_two_terms(product):
    """The tensor-core kernels' arithmetic, emulated, also at the
    autoencoder's D = 512 and at D = 1024 (the column-split kernels, whose
    logits sum D in another order): P (forward P V; dV = P^T dO) and dS (dK = dS^T q, dQ = dS k)
    enter a bf16 product after float32 softmax. Rounded to one bf16 term they
    miss the elementwise tolerances that chip_smoke.py holds the kernels to (O:
    2^-7 |O| + 1e-4; gradients: 2^-7 |g| + 1e-3 mean|g|) several times over;
    as hi + lo they keep under half of them. The result is rounded to bf16
    once, as the kernels store it."""
    tq, tk, h, d = ((128, 256, 1, int(product[2:])) if product[2:].isdigit()
                    else (256, 77, 2, 64))
    rng = np.random.default_rng(0)
    q, k, v, do = (
        _bf16(torch.from_numpy(rng.standard_normal((h, t, d), dtype=np.float32)))
        for t in (tq, tk, tk, tq)
    )
    s = q @ k.transpose(1, 2) / math.sqrt(d)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = p @ v
    ds = p * (do @ v.transpose(1, 2) - (do * o).sum(-1, keepdim=True)) / math.sqrt(d)
    operand, other, ref = {
        "pv": (p, v, o),
        "dv": (p.transpose(1, 2), do, p.transpose(1, 2) @ do),
        "dk": (ds.transpose(1, 2), q, ds.transpose(1, 2) @ q),
        "dq": (ds, k, ds @ k),
    }[product[:2]]
    atol = 1e-4 if product.startswith("pv") else 1e-3 * ref.abs().mean().item()

    def share(rounded):
        got = _bf16(rounded @ other)
        return ((got - ref).abs() / (2.0 ** -7 * ref.abs() + atol)).max().item()

    assert share(_bf16(operand)) > 4.0
    assert share(_two_terms(operand)) < 0.5


@pytest.mark.parametrize("b,h,limit", [(1, 1, 65535), (7, 3, 65535), (10, 3, 4), (4, 2, 3),
                                       (2, 5, 3), (3, 7, 7), (21846, 3, 65535),
                                       (2, 70000, 65535)])
def test_bh_slices_cover_every_pair_once_in_order(b, h, limit):
    """The launches of a call cover its (batch, head) pairs once each, in
    order, none over the limit: whole batch rows where H fits, else slices
    of one row's heads; a call within the limit is one launch."""
    cuts = fa.bh_slices(b, h, limit)
    pairs = [(bi, hi) for bs, hs in cuts
             for bi in range(bs.start, bs.stop) for hi in range(hs.start, hs.stop)]
    assert pairs == [(bi, hi) for bi in range(b) for hi in range(h)]
    assert all(0 < (bs.stop - bs.start) * (hs.stop - hs.start) <= limit for bs, hs in cuts)
    if h <= limit:
        assert all(hs == slice(0, h) for _, hs in cuts)
    assert (len(cuts) == 1) == (b * h <= limit)


def test_split_launches_assemble_the_whole_call(monkeypatch):
    """`_launch_split` and `_launch_bwd_split` with each launch replaced by
    the plain version and a limit of 3 pairs (over batch rows, and over one
    row's heads) give the plain version of the whole call."""
    import functools

    monkeypatch.setattr(fa, "_launch", fa.flash_attention_plain)
    monkeypatch.setattr(fa, "_launch_bwd", fa.flash_attention_bwd_plain)
    monkeypatch.setattr(fa, "bh_slices", functools.partial(fa.bh_slices, limit=3))
    for b, h in ((4, 2), (2, 5)):
        do = np.random.default_rng(5).standard_normal((b, 9, h, 16), np.float32)
        q, k, v, do = (torch.from_numpy(a) for a in (*_inputs(b, 9, 7, h, 16), do))
        assert len(fa.bh_slices(b, h)) > 1
        out, lse = fa._launch_split(q, k, v, 0.3)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, 0.3)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
        got = fa._launch_bwd_split(q, k, v, out, lse, do, 0.3)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, 0.3)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=1e-6)
