"""Probe: a gather along the last axis inside a kernel, from L2 and from shared
memory.

Counterpart of ``scripts/dyngather_probe.py``. The function is

    out[g, c, r, j] = x[g, r, idx[g, c, r, j]]

with ``x [G, R, S]``, ``idx [G, C, R, J]`` int32 and ``out [G, C, R, J]``: the
access pattern of a deformable-attention kernel that samples its corners from a
value table it keeps on chip. ``gather(..., where="global")`` reads the table
straight from global memory (it stays in L2), ``where="shared"`` first copies a
slab of as many rows of ``x[g]`` as one block's shared memory holds
(``slab_rows``) and gathers from that. Both are kernels of
``ops/csrc/probe_gather.cu``; on a CPU tensor the wrapper takes
``gather_plain``. ``run`` checks each kernel against the plain version (itself
held against ``torch.take_along_dim``) in float32, bfloat16 and int32 at
``[32, 1024]`` and reports elements per second
at the msda shape (8 heads, 64 index planes, a ``[32, 9472]`` table per head),
beside ``torch.take_along_dim``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..ops import _build
from . import _common

CHECK_SHAPE = (32, 1024)                 # x and idx of the check
RATE_SHAPE = dict(G=8, C=64, R=32, S=9472)
C_SPLITS = (4, 8, 16)                    # shares of the index planes per slab

# kernel launches made by the wrapper, one count per kernel
launches = {"global": 0, "shared": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def gather_plain(
    x: torch.Tensor,      # [G, R, S]
    idx: torch.Tensor,    # [G, C, R, J] integer
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:        # [G, C, R, J]
    """Flat indexing of x's values; an index outside [0, S) is clamped."""
    g, r, s = x.shape
    dev = x.device
    row = torch.arange(g, device=dev)[:, None, None, None] * r + torch.arange(r, device=dev)[:, None]
    flat = row * s + idx.clamp(0, s - 1).long()
    return x.reshape(-1)[flat].to(out_dtype or x.dtype)


def _check(x, idx, out_dtype) -> torch.dtype:
    if x.dim() != 3 or idx.dim() != 4:
        raise ValueError("x must be [G, R, S] and idx [G, C, R, J]")
    if idx.shape[0] != x.shape[0] or idx.shape[2] != x.shape[1]:
        raise ValueError("idx's G and R must be x's")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"x must be float32, bfloat16 or int32, got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype != x.dtype and (x.dtype, out_dtype) != (torch.bfloat16, torch.float32):
        raise TypeError(f"no gather from {x.dtype} into {out_dtype}")
    if idx.device != x.device:
        raise ValueError("x and idx must lie on one device")
    return out_dtype


def slab_rows(r: int, s: int, dtype: torch.dtype) -> int:
    """Rows of one x[g] that a block's shared-memory slab holds."""
    lib = _build.library("probe_gather")
    lib.probe_gather_slab_rows.restype = ctypes.c_int
    lib.probe_gather_slab_rows.argtypes = [ctypes.c_int] * 3
    return lib.probe_gather_slab_rows(r, s, torch.empty((), dtype=dtype).element_size())


def gather(
    x: torch.Tensor,      # [G, R, S]
    idx: torch.Tensor,    # [G, C, R, J] int32
    where: str = "global",
    out_dtype: Optional[torch.dtype] = None,
    c_split: int = 8,
) -> torch.Tensor:        # [G, C, R, J]
    out_dtype = _check(x, idx, out_dtype)
    if where not in launches:
        raise ValueError(f"where must be one of {tuple(launches)}, got {where!r}")
    if x.device.type == "cpu":
        return gather_plain(x, idx, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"the gather probe has no kernel for device {x.device}")
    g, c, r, j = idx.shape
    s = x.shape[2]
    if j % 4:
        raise ValueError(f"the gather kernels take J a multiple of 4, got {j}")
    for name, t in (("x", x), ("idx", idx)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and aligned to 16 bytes")
    out = torch.empty(idx.shape, dtype=out_dtype, device=x.device)

    lib = _build.library("probe_gather")
    fn = lib.probe_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), g, c, r, s, j,
            1 if x.dtype == torch.bfloat16 else 0, int(out_dtype != x.dtype),
            int(where == "shared"), c_split, stream,
        )
    if err == -1:
        raise ValueError(f"the gather probe does not take x {tuple(x.shape)} {x.dtype}, idx {tuple(idx.shape)}")
    if err != 0:
        raise RuntimeError(f"probe_gather ({where}) launch failed with CUDA error {err}")
    launches[where] += 1
    return out


def _check_inputs(rng: np.random.Generator, dtype: torch.dtype, dev: torch.device, shape):
    r, s = shape
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (1, r, s)).astype(np.int32))
    else:
        x = torch.from_numpy(rng.standard_normal((1, r, s), dtype=np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, s, (1, 1, r, s)).astype(np.int32))
    return x.to(dev), idx.to(dev)


def check(device: str = "cuda", seed: int = 0, shape=CHECK_SHAPE) -> list:
    """Each kernel against the plain version, which is held against numpy and
    torch.take_along_dim: values are moved, so every comparison is for equality."""
    dev = _common.resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x, idx = _check_inputs(rng, dtype, dev, shape)
        want = gather_plain(x, idx)
        ref = np.take_along_axis(
            x.cpu().view(torch.int16 if dtype == torch.bfloat16 else dtype).numpy()[:, None],
            idx.cpu().numpy().astype(np.int64), axis=3,
        )
        got_bits = want.cpu().view(torch.int16 if dtype == torch.bfloat16 else dtype).numpy()
        if not np.array_equal(got_bits, ref):
            raise AssertionError(f"gather_plain {dtype} disagrees with numpy.take_along_axis")
        if not torch.equal(want, torch.take_along_dim(x[:, None], idx.long(), dim=3)):
            raise AssertionError(f"gather_plain {dtype} disagrees with torch.take_along_dim")
        row = dict(dtype=str(dtype).split(".")[-1], shape=list(shape), plain_equals_numpy=True,
                   plain_equals_take_along_dim=True)
        if dev.type == "cuda":
            for where in launches:
                got = gather(x, idx, where)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"gather {where} {dtype} disagrees with its plain version")
                row[f"{where}_equals_plain"] = True
        rows.append(row)
    return rows


def rate(device: str = "cuda", reps: int = 5, seed: int = 0) -> list:
    """Elements per second at the msda shape, float32 and bfloat16 tables into a
    float32 output, for the two kernels (the shared one at several splits of
    the index planes), the plain version and torch.take_along_dim."""
    dev = _common.resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("rates are measured on a CUDA device only")
    G, C, R, S = (RATE_SHAPE[k] for k in "GCRS")
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, S, (G, C, R, S), device=dev, dtype=torch.int32, generator=gen)
    idx64 = idx.long()
    elems = idx.numel()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((G, R, S), device=dev, generator=gen).to(dtype)
        want = gather_plain(x, idx, torch.float32)
        x_planes = x[:, None].expand(-1, C, -1, -1)
        timed = {"global": lambda: gather(x, idx, "global", torch.float32)}
        for split in C_SPLITS:
            timed[f"shared c_split={split}"] = (
                lambda split=split: gather(x, idx, "shared", torch.float32, split)
            )
        for name, fn in timed.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather {name} {dtype} disagrees with its plain version")
            del got
        timed["plain"] = lambda: gather_plain(x, idx, torch.float32)
        timed["torch.take_along_dim"] = lambda: torch.take_along_dim(x_planes, idx64, dim=3)
        for name, fn in timed.items():
            ms = _common.time_ms(fn, warmup=1, reps=reps, inner=1)
            rows.append(dict(
                table=str(dtype).split(".")[-1], what=name, ms=ms,
                g_elements_per_s=elems / ms / 1e6,
                slab_rows=slab_rows(R, S, dtype) if name.startswith("shared") else None,
            ))
        del want
    return rows


def run(device: str = "cuda", reps: int = 5) -> dict:
    dev = _common.resolve_device(device)
    if dev.type == "cpu":
        # the plain version only, at a small size
        return dict(probe="dyngather", device="cpu", check=check("cpu", shape=(8, 64)))
    return dict(
        probe="dyngather", device=torch.cuda.get_device_name(dev), check=check(device),
        rate_shape=RATE_SHAPE, rate=rate(device, reps),
    )


if __name__ == "__main__":
    _common.main(run, __doc__)
