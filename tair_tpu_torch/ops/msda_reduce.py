"""Corner-weight and (level, point) reduce of multi-scale deformable
attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tair_tpu/ops/msda_reduce.py``. The lane-packed msda core ends
in

    out[n*G + h, :] = sum_{j<k} sum_{c<4} w_c[n, h*k + j] * g[n*lanes + h*k + j, c*D:(c+1)*D]

where ``g`` is the row-gather output ``[NQ*lanes, 4D]`` and ``G = lanes // k``.
``msda_corner_reduce`` is differentiable with respect to ``g`` and the four
weights through a ``torch.autograd.Function`` that saves them: for the
cotangent ``dO`` of ``out``,

    dg[n*lanes + h*k + j, c*D:(c+1)*D] = w_c[n, h*k + j] * dO[n*G + h, :]    (g's type)
    dw_c[n, h*k + j] = sum_d g[n*lanes + h*k + j, c*D + d] * dO[n*G + h, d]  (float32)

On CUDA tensors the forward and the backward each launch their kernel of
``csrc/msda_reduce.cu``; the plain versions are taken only for tensors that
lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by the wrapper, one count per kernel (never raised by a
# plain version): forward, backward
launches = {"fwd": 0, "bwd": 0}
# the forward's launches again, by query count NQ: which row counts a path ran
fwd_launches_by_rows: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    fwd_launches_by_rows.clear()


def msda_corner_reduce_plain(
    g: torch.Tensor,   # [NQ*lanes, 4D]
    w0: torch.Tensor,  # [NQ, lanes] float32
    w1: torch.Tensor,
    w2: torch.Tensor,
    w3: torch.Tensor,
    k: int,
) -> torch.Tensor:     # [NQ*(lanes//k), D] float32
    nq, lanes = w0.shape
    d = g.shape[-1] // 4
    g4 = g.float().reshape(nq, lanes, 4, d)
    w = torch.stack([w0, w1, w2, w3], dim=-1).float()  # [NQ, lanes, 4]
    t = (g4 * w[..., None]).sum(dim=2)                 # [NQ, lanes, D]
    return t.reshape(nq * (lanes // k), k, d).sum(dim=1)


def msda_corner_reduce_bwd_plain(
    g: torch.Tensor,     # [NQ*lanes, 4D]
    w0: torch.Tensor,    # [NQ, lanes] float32
    w1: torch.Tensor,
    w2: torch.Tensor,
    w3: torch.Tensor,
    dout: torch.Tensor,  # [NQ*(lanes//k), D] cotangent of the output
    k: int,
):
    """(dg in g's type, dw0, dw1, dw2, dw3 in float32)."""
    nq, lanes = w0.shape
    d = g.shape[-1] // 4
    # the group's cotangent, repeated over its k rows: [NQ, lanes, 1, D]
    do = dout.float().reshape(nq, lanes // k, 1, d).expand(-1, -1, k, -1)
    do = do.reshape(nq, lanes, 1, d)
    w = torch.stack([w0, w1, w2, w3], dim=-1).float()        # [NQ, lanes, 4]
    dg = (w[..., None] * do).reshape(nq * lanes, 4 * d).to(g.dtype)
    dw = (g.float().reshape(nq, lanes, 4, d) * do).sum(dim=-1)  # [NQ, lanes, 4]
    return (dg, *dw.unbind(dim=-1))


def _check(g, ws, k: int) -> None:
    w0 = ws[0]
    if g.dim() != 2 or g.shape[-1] % 4:
        raise ValueError("g must be [NQ*lanes, 4D]")
    if w0.dim() != 2 or any(w.shape != w0.shape for w in ws):
        raise ValueError("w0..w3 must share one [NQ, lanes] shape")
    nq, lanes = w0.shape
    if g.shape[0] != nq * lanes:
        raise ValueError(f"g has {g.shape[0]} rows, the weights ask for {nq * lanes}")
    if k <= 0 or lanes % k:
        raise ValueError(f"lanes ({lanes}) must be a multiple of k ({k})")
    if any(w.dtype != torch.float32 for w in ws):
        raise TypeError("w0..w3 must be float32")
    if any(w.device != g.device for w in ws):
        raise ValueError("g and the weights must lie on one device")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"msda_corner_reduce takes g in float32 or bfloat16, got {g.dtype}")


def _check_layout(g, ws) -> None:
    for name, t in (("g", g), *((f"w{i}", w) for i, w in enumerate(ws))):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and aligned to 16 bytes")


def _raise_for(err: int, which: str, g, lanes: int, k: int) -> None:
    if err == -1:
        raise ValueError(
            f"msda_corner_reduce kernel does not take D={g.shape[-1] // 4}, "
            f"lanes={lanes}, k={k} in {g.dtype}"
        )
    if err != 0:
        raise RuntimeError(f"msda_corner_reduce_{which} launch failed with CUDA error {err}")


def _launch(g, ws, k: int) -> torch.Tensor:
    nq, lanes = ws[0].shape
    d = g.shape[-1] // 4
    _check_layout(g, ws)
    out = torch.empty((nq * (lanes // k), d), dtype=torch.float32, device=g.device)

    lib = _build.library("msda_reduce")
    fn = lib.msda_corner_reduce_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int64]
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            g.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
            nq, lanes, k, d, _DTYPE_CODES[g.dtype], stream,
        )
    _raise_for(err, "fwd", g, lanes, k)
    launches["fwd"] += 1
    fwd_launches_by_rows[nq] = fwd_launches_by_rows.get(nq, 0) + 1
    return out


def _launch_bwd(g, ws, dout: torch.Tensor, k: int):
    nq, lanes = ws[0].shape
    d = g.shape[-1] // 4
    _check_layout(g, ws)
    dout = dout.float().contiguous()
    dg = torch.empty_like(g)
    dws = [torch.empty_like(w) for w in ws]

    lib = _build.library("msda_reduce")
    fn = lib.msda_corner_reduce_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int64]
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            g.data_ptr(), *(w.data_ptr() for w in ws), dout.data_ptr(),
            dg.data_ptr(), *(dw.data_ptr() for dw in dws),
            nq, lanes, k, d, _DTYPE_CODES[g.dtype], stream,
        )
    _raise_for(err, "bwd", g, lanes, k)
    launches["bwd"] += 1
    return (dg, *dws)


class _MsdaCornerReduce(torch.autograd.Function):
    """The forward kernel with the backward kernel behind it; on CPU tensors,
    the plain versions of both."""

    @staticmethod
    def forward(ctx, g, w0, w1, w2, w3, k):
        ws = (w0, w1, w2, w3)
        if g.device.type == "cuda":
            out = _launch(g, ws, k)
        else:
            out = msda_corner_reduce_plain(g, *ws, k)
        ctx.save_for_backward(g, *ws)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, dout):
        g, *ws = ctx.saved_tensors
        if g.device.type == "cuda":
            grads = _launch_bwd(g, ws, dout, ctx.k)
        else:
            grads = msda_corner_reduce_bwd_plain(g, *ws, dout, ctx.k)
        return (*grads, None)


def msda_corner_reduce(
    g: torch.Tensor,   # [NQ*lanes, 4D] gathered bilinear patches
    w0: torch.Tensor,  # [NQ, lanes] corner (0,0) weights, float32 (incl. attention)
    w1: torch.Tensor,  # corner (0,1)
    w2: torch.Tensor,  # corner (1,0)
    w3: torch.Tensor,  # corner (1,1)
    k: int = 16,       # rows per output group (= L*P)
) -> torch.Tensor:     # [NQ*(lanes//k), D] float32
    ws = (w0, w1, w2, w3)
    _check(g, ws, k)
    if g.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"msda_corner_reduce has no kernel for device {g.device}")
    return _MsdaCornerReduce.apply(g, *ws, k)
