"""Flash attention, forward and backward: the CUDA kernels' wrapper and their
plain versions.

Counterpart of ``tair_tpu/ops/flash_attention.py``. Tensors are laid out
``[B, T, H, D]`` as there. ``flash_attention`` returns the attention output in
the input type and the per-row logsumexp ``[B, H, Tq]`` in float32, and is
differentiable with respect to q, k and v through a ``torch.autograd.Function``
that saves ``q, k, v, O, lse``. On CUDA tensors each of its three kernels
(forward, dQ, dK/dV) is taken from one of two families, as
``tensor_core_kernels(dtype, D, kind)`` decides: bfloat16 takes the tensor-core
kernels at every head width: the forward in ``csrc/flash_attention_tc.cu`` at
D <= 128 and ``csrc/flash_attention_wide_tc.cu`` at the autoencoder's D = 512,
dQ and dK/dV in ``csrc/flash_attention_dq_tc.cu`` and
``csrc/flash_attention_dkv_tc.cu`` at D <= 128 and both in
``csrc/flash_attention_wide_bwd_tc.cu`` at D = 512, and all three in
``csrc/flash_attention_colsplit_tc.cu`` above 512; float32 takes the FMA
kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``, and
``csrc/flash_attention_colsplit.cu`` above 512).
``delta = rowsum(dO * O)`` is formed here in float32, outside the kernels, as
the JAX package does. The plain versions are taken only for tensors that lie
on the CPU. The kernels' head widths are ``HEAD_DIMS`` and, above 512, every
multiple of ``COLUMN_GRANULE``: above 512 the column-split kernels stream D
through shared memory and give each block a slice of at most 512 output
columns (`column_slices`), so they take any width, as the JAX kernel does
(which holds a head's whole K and V in VMEM and is bounded there by VMEM
only). `flash_attention` takes every other width by padding q, k and v with
zeros along D to the kernels' next width (`padded_head_dim`: the next of
``HEAD_DIMS`` up to 512, the next multiple of 128 above) and slicing the
output (autograd slices dQ, dK and dV back): the scale is the caller's, so the
zeros change no logit. A grid holds at
most `MAX_BH_PAIRS` (batch, head) pairs, so a call with more is cut into
launches over batch slices, or over heads where H alone passes it
(`bh_slices`), forward and backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# the head widths of every kernel: forward, dQ and dK/dV, FMA and tensor cores
HEAD_DIMS = (16, 32, 64, 128, 512)
# the tensor-core kernels of their own at this width: the forward in
# csrc/flash_attention_wide_tc.cu, dQ and dK/dV in csrc/flash_attention_wide_bwd_tc.cu
WIDE_HEAD_DIM = 512
# above WIDE_HEAD_DIM the column-split kernels take every multiple of this
# (their chunk of D), and give a block at most SLICE_MAX output columns
COLUMN_GRANULE = 128
SLICE_MAX = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DKV_QUERY_TILE = 64  # a chunk of the dK/dV query split is a multiple of this
MAX_BH_PAIRS = 65535  # (batch, head) pairs of one launch: the grid's y extent
SMS = 132            # streaming multiprocessors of an H100 SXM

# kernel launches made by the wrapper, one count per kernel (never raised by a
# plain version): forward, dQ and dK/dV, each on the FMA kernel, the
# tensor-core kernel at D <= 128, the tensor-core kernel at D = 512, and the
# column-split FMA and tensor-core kernels above 512
launches = {"fwd": 0, "fwd_tc": 0, "fwd_tc_wide": 0, "dq": 0, "dq_tc": 0, "dq_tc_wide": 0,
            "dkv": 0, "dkv_tc": 0, "dkv_tc_wide": 0, "fwd_colsplit": 0, "fwd_tc_colsplit": 0,
            "dq_colsplit": 0, "dq_tc_colsplit": 0, "dkv_colsplit": 0, "dkv_tc_colsplit": 0}

# the C entry points: (library, symbol, argument types); pointers, then
# B, H, Tq, Tk, D, the strides, the scale, and what each kernel takes after it
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SHAPE = [_INT] * 5 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float]
_ENTRY = {
    "fwd": ("flash_attention", "flash_attention_fwd", [_PTR] * 5 + _SHAPE + [_INT, _PTR]),
    "fwd_tc": ("flash_attention_tc", "flash_attention_fwd_tc", [_PTR] * 5 + _SHAPE + [_PTR]),
    "fwd_tc_wide": ("flash_attention_wide_tc", "flash_attention_fwd_wide_tc",
                    [_PTR] * 5 + _SHAPE + [_PTR]),
    "dq": ("flash_attention_bwd", "flash_attention_dq", [_PTR] * 7 + _SHAPE + [_INT, _PTR]),
    "dq_tc": ("flash_attention_dq_tc", "flash_attention_dq_tc", [_PTR] * 7 + _SHAPE + [_PTR]),
    "dq_tc_wide": ("flash_attention_wide_bwd_tc", "flash_attention_dq_wide_tc",
                   [_PTR] * 7 + _SHAPE + [_PTR]),
    "dkv": ("flash_attention_bwd", "flash_attention_dkv", [_PTR] * 8 + _SHAPE + [_INT, _PTR]),
    "dkv_tc_wide": ("flash_attention_wide_bwd_tc", "flash_attention_dkv_wide_tc",
                    [_PTR] * 8 + _SHAPE + [_PTR]),
    **{f"{kind}{route}_colsplit": (f"flash_attention_colsplit{route}",
                                   f"flash_attention_{kind}_colsplit{route}",
                                   [_PTR] * n + _SHAPE + [_PTR])
       for kind, n in (("fwd", 5), ("dq", 7), ("dkv", 8)) for route in ("", "_tc")},
    # + the workspace pointer, and splits, chunk after the scale
    "dkv_tc": ("flash_attention_dkv_tc", "flash_attention_dkv_tc",
               [_PTR] * 9 + _SHAPE + [_INT, _INT, _PTR]),
}
_FNS = {}


def _entry(which: str):
    """The C entry point of one kernel, built and typed at its first call."""
    fn = _FNS.get(which)
    if fn is None:
        library, symbol, argtypes = _ENTRY[which]
        fn = getattr(_build.library(library), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[which] = fn
    return fn


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def kernel_width(d: int) -> bool:
    """Whether the kernels run at head width `d` as it is: one of `HEAD_DIMS`,
    or above 512 a multiple of `COLUMN_GRANULE` (the column-split kernels)."""
    return d in HEAD_DIMS or (d > WIDE_HEAD_DIM and d % COLUMN_GRANULE == 0)


def tensor_core_kernels(dtype: torch.dtype, d: int, kind: str) -> bool:
    """Whether a call of this type and head width takes the tensor-core kernel
    of `kind` ("fwd", "dq" or "dkv") rather than the FMA one: bfloat16 at every
    head width of the kernels (`kernel_width`), whatever the kind. float32 is
    held to 1e-4 and never goes through TF32, so it stays on the FMA kernels."""
    if kind not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kind must be fwd, dq or dkv, got {kind!r}")
    return dtype == torch.bfloat16 and kernel_width(d)


def kernel_name(dtype: torch.dtype, d: int, kind: str) -> str:
    """The `launches` key of the kernel of `kind` that a call of this type and
    head width takes: `kind` itself for the FMA kernel, else its tensor-core
    kernel (``<kind>_tc_wide`` at D = 512); above 512 the column-split ones,
    ``<kind>_colsplit`` (float32) and ``<kind>_tc_colsplit`` (bfloat16)."""
    tc = tensor_core_kernels(dtype, d, kind)
    if d > WIDE_HEAD_DIM:
        return f"{kind}_tc_colsplit" if tc else f"{kind}_colsplit"
    if not tc:
        return kind
    return f"{kind}_tc_wide" if d == WIDE_HEAD_DIM else f"{kind}_tc"


def column_slices(d: int) -> list:
    """The output slices [(first column, width)] that the column-split kernels
    cut a head width `d` (above 512, a multiple of 128) into, one grid plane
    each: ceil(d / 512) slices sharing the d / 128 units of 128 columns as
    evenly as they go, the first ones a unit wider (each kernel's
    ``slice_of``)."""
    units = d // COLUMN_GRANULE
    n = -(-units // (SLICE_MAX // COLUMN_GRANULE))
    base, rem = divmod(units, n)
    return [(COLUMN_GRANULE * (s * base + min(s, rem)), COLUMN_GRANULE * (base + (s < rem)))
            for s in range(n)]


def dkv_query_split(b: int, h: int, tq: int, tk: int) -> int:
    """How many chunks the tensor-core dK/dV kernel cuts the queries into: as
    many as give its grid (64-key tiles x heads x chunks) about two blocks per
    SM, each chunk a multiple of 64 queries and none empty. 1 when the key
    tiles alone fill the card."""
    tiles = -(-tq // DKV_QUERY_TILE)
    blocks = -(-tk // 64) * b * h
    want = min(max(-(-2 * SMS // blocks), 1), tiles)
    per_chunk = -(-tiles // want)
    return -(-tiles // per_chunk)


def dkv_chunk_queries(tq: int, splits: int) -> int:
    """Queries per chunk of a split into `splits` chunks: a multiple of 64."""
    tiles = -(-tq // DKV_QUERY_TILE)
    return DKV_QUERY_TILE * -(-tiles // splits)


def padded_head_dim(d: int) -> int:
    """The kernels' head width that a call of width `d` runs at: `d` itself
    when the kernels have it, else the next wider (zero padding): the next of
    `HEAD_DIMS` up to 512, the next multiple of `COLUMN_GRANULE` above."""
    if d > WIDE_HEAD_DIM:
        return -(-d // COLUMN_GRANULE) * COLUMN_GRANULE
    return next(width for width in HEAD_DIMS if width >= d)


def bh_slices(b: int, h: int, limit: int = MAX_BH_PAIRS):
    """The launches of a call of `b` x `h` (batch, head) pairs, each at most
    `limit` pairs, in order: [(batch slice, head slice)]. Slices of whole
    batch rows where `h` <= `limit`; else each row's heads cut into slices
    of `limit`. One launch of everything when the pairs fit."""
    if h <= limit:
        rows = limit // h
        return [(slice(b0, min(b, b0 + rows)), slice(0, h)) for b0 in range(0, b, rows)]
    return [(slice(bi, bi + 1), slice(h0, min(h, h0 + limit)))
            for bi in range(b) for h0 in range(0, h, limit)]


def flash_attention_plain(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit attention with float32 logits and softmax; (O, lse)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)  # [B, H, Tq]
    weights = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(
    q: torch.Tensor,    # [B, Tq, H, D]
    k: torch.Tensor,    # [B, Tk, H, D]
    v: torch.Tensor,
    o: torch.Tensor,    # [B, Tq, H, D] forward output
    lse: torch.Tensor,  # [B, H, Tq] float32
    do: torch.Tensor,   # [B, Tq, H, D] cotangent of o
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the kernels' arithmetic, in float32 throughout: P is
    rebuilt from lse, dS = P * (dP - delta) * scale with delta = rowsum(dO * O)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = (dof * o.float()).sum(dim=-1).permute(0, 2, 1)  # [B, H, Tq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dkv_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, splits: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) as the tensor-core kernel forms them under a query split: float32
    partials over each chunk of `dkv_chunk_queries(Tq, splits)` queries, added
    in chunk order, rounded once to k's type."""
    chunk = dkv_chunk_queries(q.shape[1], splits)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for start in range(0, q.shape[1], chunk):
        rows = slice(start, start + chunk)
        _, dk_c, dv_c = flash_attention_bwd_plain(
            q[:, rows].float(), k.float(), v.float(), o[:, rows].float(),
            lse[:, :, rows], do[:, rows].float(), scale,
        )
        dk, dv = dk + dk_c, dv + dv_c
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, T, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride along D and every row starting on a 16-byte boundary."""
    vec = 16 // t.element_size()
    return (
        t.stride(3) == 1
        and not any(s % vec for s in t.stride()[:3])
        and t.data_ptr() % 16 == 0
    )


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    which: Optional[str] = None,  # kernel_name's (the default), or "fwd" at HEAD_DIMS
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if not kernel_width(d):
        raise ValueError(f"flash_attention kernel has head widths {HEAD_DIMS} and the "
                         f"multiples of {COLUMN_GRANULE} above {WIDE_HEAD_DIM}, got {d}")
    chosen = kernel_name(q.dtype, d, "fwd")
    if which is None:
        which = chosen
    if which != chosen and not (which == "fwd" and d in HEAD_DIMS):
        raise ValueError(f"flash_attention_{which} does not take {q.dtype} at D = {d}")
    if b * h > MAX_BH_PAIRS:
        raise ValueError(f"one flash_attention launch takes at most {MAX_BH_PAIRS} (batch, "
                         "head) pairs: cut the call with bh_slices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_aligned(t):
            raise ValueError(
                f"{name} must have unit stride along D and rows aligned to 16 bytes"
            )
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)

    fn = _entry(which)
    strides = (ctypes.c_int64 * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]
    )
    dtype_code = () if which != "fwd" else (_DTYPE_CODES[q.dtype],)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, strides, float(scale), *dtype_code, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_{which} launch failed with CUDA error {err}")
    launches[which] += 1
    return out, lse


def _launch_backward_kernel(
    which: str,  # kernel_name's for "dq" or "dkv", or "dq", "dkv" at HEAD_DIMS
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
):
    """One backward kernel on the tensors the forward launch saw: dq for "dq"
    and its other kernels, (dk, dv) for "dkv" and its other kernels. do must
    pass `_rows_aligned`; lse and delta are float32
    [B, H, Tq], contiguous. "dkv_tc" cuts the queries
    as `dkv_query_split` says and sums the chunks' float32 partials in a
    workspace allocated here."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if not kernel_width(d):
        raise NotImplementedError(
            f"flash_attention backward kernels have head widths {HEAD_DIMS} and the "
            f"multiples of {COLUMN_GRANULE} above {WIDE_HEAD_DIM}, got {d}"
        )
    kind = which.split("_")[0]
    if which != kernel_name(q.dtype, d, kind) and not (which == kind and d in HEAD_DIMS):
        raise ValueError(f"flash_attention_{which} does not take {q.dtype} at D = {d}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's device")
    if do.dtype != q.dtype or do.shape != q.shape or not _rows_aligned(do):
        raise ValueError("do must have q's type and shape, unit stride along D and aligned rows")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, tq) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [B, H, Tq]")
    is_dq = kind == "dq"
    if is_dq:
        outs = (torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device),)
    else:
        outs = tuple(
            torch.empty((b, tk, h, d), dtype=k.dtype, device=q.device) for _ in range(2)
        )

    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3]
    )
    if which == "dkv_tc":
        splits = dkv_query_split(b, h, tq, tk)
        ws = (
            torch.empty((2, splits, b, tk, h, d), dtype=torch.float32, device=q.device)
            if splits > 1 else None
        )
        tail = (
            None if ws is None else ws.data_ptr(), b, h, tq, tk, d, strides,
            float(scale), splits, dkv_chunk_queries(tq, splits),
        )
    elif which == kind:  # the FMA kernels of HEAD_DIMS take the type's code
        tail = (b, h, tq, tk, d, strides, float(scale), _DTYPE_CODES[q.dtype])
    else:
        tail = (b, h, tq, tk, d, strides, float(scale))
    fn = _entry(which)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), *tail, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_{which} launch failed with CUDA error {err}")
    launches[which] += 1
    return outs[0] if is_dq else outs


def _launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """delta in float32 here, then the dQ and the dK/dV kernel. dO comes in
    whatever layout autograd hands over: it is used as it is when its rows are
    contiguous along D and 16-byte aligned, and copied once otherwise."""
    do = do.to(q.dtype)
    if not _rows_aligned(do):
        do = do.contiguous()
    # rowsum(dO * O): [B, Tq, H] -> [B, H, Tq]
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
    d = q.shape[-1]
    dq = _launch_backward_kernel(kernel_name(q.dtype, d, "dq"), q, k, v, do, lse, delta, scale)
    dk, dv = _launch_backward_kernel(
        kernel_name(q.dtype, d, "dkv"), q, k, v, do, lse, delta, scale
    )
    return dq, dk, dv


def _launch_split(q, k, v, scale):
    """`_launch` over the call's `bh_slices`, into one output."""
    b, tq, h, d = q.shape
    cuts = bh_slices(b, h)
    if len(cuts) == 1:
        return _launch(q, k, v, scale)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    for bs, hs in cuts:
        out[bs, :, hs], lse[bs, hs] = _launch(q[bs, :, hs], k[bs, :, hs], v[bs, :, hs], scale)
    return out, lse


def _launch_bwd_split(q, k, v, out, lse, do, scale):
    """`_launch_bwd` over the call's `bh_slices`, into whole gradients."""
    b, _, h, _ = q.shape
    cuts = bh_slices(b, h)
    if len(cuts) == 1:
        return _launch_bwd(q, k, v, out, lse, do, scale)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    for bs, hs in cuts:
        parts = _launch_bwd(q[bs, :, hs], k[bs, :, hs], v[bs, :, hs], out[bs, :, hs],
                            lse[bs, hs].contiguous(), do[bs, :, hs], scale)
        for g, part in zip(grads, parts):
            g[bs, :, hs] = part
    return grads


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the two backward kernels behind it; on CPU
    tensors, the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cuda":
            out, lse = _launch_split(q, k, v, scale)
        else:
            out, lse = flash_attention_plain(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = _launch_bwd_split(q, k, v, out, lse, do, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v -> (O [B, Tq, H, D], lse [B, H, Tq] float32).
    A head width the kernels lack runs zero-padded to `padded_head_dim`."""
    _check(q, k, v)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    width = padded_head_dim(d)
    if width == d:
        return _FlashAttention.apply(q, k, v, scale)
    pad = (0, width - d)
    out, lse = _FlashAttention.apply(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), scale)
    return out[..., :d], lse
