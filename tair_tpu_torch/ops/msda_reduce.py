"""Corner-weight and (level, point) reduce of multi-scale deformable
attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tair_tpu/ops/msda_reduce.py``. The lane-packed msda core ends
in

    out[n*G + h, :] = sum_{j<k} sum_{c<4} w_c[n, h*k + j] * g[n*lanes + h*k + j, c*D:(c+1)*D]

where ``g`` is the row-gather output ``[NQ*lanes, 4D]`` and ``G = lanes // k``.
On a CUDA tensor ``msda_corner_reduce`` launches ``csrc/msda_reduce.cu``; the
plain version is taken only for a tensor that lies on the CPU. Forward only:
the backward kernel comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# number of kernel launches made by msda_corner_reduce (never by the plain version)
launches = 0


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
    if g.requires_grad or any(w.requires_grad for w in ws):
        raise NotImplementedError(
            "msda_corner_reduce is forward only: its backward kernel belongs "
            "to the training slice of the port"
        )


def _launch(g, ws, k: int) -> torch.Tensor:
    global launches
    nq, lanes = ws[0].shape
    d = g.shape[-1] // 4
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"msda_corner_reduce kernel takes float32 or bfloat16, got {g.dtype}")
    for name, t in (("g", g), *((f"w{i}", w) for i, w in enumerate(ws))):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and aligned to 16 bytes")
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
    if err == -1:
        raise ValueError(
            f"msda_corner_reduce kernel does not take D={d}, lanes={lanes}, "
            f"k={k} in {g.dtype}"
        )
    if err != 0:
        raise RuntimeError(f"msda_corner_reduce_fwd launch failed with CUDA error {err}")
    launches += 1
    return out


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
    if g.device.type == "cpu":
        return msda_corner_reduce_plain(g, *ws, k)
    if g.device.type != "cuda":
        raise RuntimeError(f"msda_corner_reduce has no kernel for device {g.device}")
    return _launch(g, ws, k)
