"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tair_tpu/ops/flash_attention.py``. Tensors are laid out
``[B, T, H, D]`` as there. ``flash_attention`` returns the attention output in
the input type and the per-row logsumexp ``[B, H, Tq]`` in float32. On a CUDA
tensor it launches ``csrc/flash_attention.cu``; the plain version is taken
only for a tensor that lies on the CPU. Forward only: the backward kernels
come with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# number of kernel launches made by flash_attention (never by the plain version)
launches = 0


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
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward only: its backward kernels belong to "
            "the training slice of the port"
        )


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has head widths {HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError("flash_attention kernel takes at most 65535 (batch, head) pairs")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along D")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be aligned to 16 bytes in every row")
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)

    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    strides = (ctypes.c_int64 * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, strides, float(scale),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {err}")
    launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v -> (O [B, Tq, H, D], lse [B, H, Tq] float32)."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    return _launch(q, k, v, scale)
