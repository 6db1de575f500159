"""Probe: how much of the card's memory rate a kernel reaches when it streams a
large bfloat16 matrix once.

Counterpart of ``scripts/stream_probe.py``. The matrix is the msda gather
output ``g [9472*128, 128]`` in bfloat16 (310 MB), the work its 128 column sums
in float32. ``column_sums(g, "strided", ...)`` is a grid-stride loop of 16-byte
loads at a chosen block size, unroll and grid; ``column_sums(g, "pipeline",
...)`` is a ring of shared-memory buffers filled by ``cp.async`` at a chosen
depth and chunk size; ``column_sums(g, "bulk", ...)`` is the same ring filled by
the copy engine (``cp.async.bulk`` reporting to an mbarrier). All are kernels of
``ops/csrc/probe_stream.cu``; on a CPU tensor the wrapper takes
``column_sums_plain``. ``run`` reports
milliseconds and GB/s of every setting beside ``g.float().sum()``,
``g.sum(0, dtype=torch.float32)``, a device-to-device copy and the card's
published 3.35 TB/s, and holds every result against the column sums in float64.

Tolerance: float32 sums of 1.2 M bfloat16 values depend on the order of
addition. Each result is held to ``SUM_RTOL`` times the column's sum of
absolute values, which is what float32 rounding allows a blocked summation
(about 0.1 on sums of about 1e3 here).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import _build
from . import _common

ROWS, COLS = 9472 * 128, 128
SUM_RTOL = 1e-7
# (threads, unroll, blocks per SM)
STRIDED_SETTINGS = (
    (128, 8, 8), (256, 1, 8), (256, 4, 8), (256, 8, 2), (256, 8, 4), (256, 8, 8),
    (256, 4, 16), (512, 4, 4), (512, 8, 2), (512, 8, 4),
)
# (stages, chunk rows): 16 rows are 4 KB
PIPELINE_SETTINGS = tuple((st, rows) for st in (2, 4, 8) for rows in (16, 32, 64))
# (stages, chunk rows) of the copy engine's ring: larger chunks, one request each
BULK_SETTINGS = ((2, 64), (4, 64), (8, 64), (2, 128), (4, 128), (2, 256))
PIPELINE_THREADS = 256
SHARED_PER_SM = 227 * 1024

# kernel launches made by the wrapper, one count per kernel
launches = {"strided": 0, "pipeline": 0, "bulk": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def column_sums_plain(g: torch.Tensor) -> torch.Tensor:  # [R, C] -> [C] float32
    """Blocks of rows summed first, then the blocks: the kernels' association."""
    rows, cols = g.shape
    block = 1024
    head = rows - rows % block
    out = g[:head].float().reshape(-1, block, cols).sum(dim=1).sum(dim=0)
    return out + g[head:].float().sum(dim=0)


def column_sums(
    g: torch.Tensor,                 # [R, 128] bfloat16
    kernel: str = "strided",
    threads: int = 256,
    unroll: int = 4,                 # strided: loads in flight per thread
    stages: int = 4,                 # pipeline, bulk: buffers in the ring
    chunk_rows: int = 32,            # pipeline, bulk: rows in one buffer
    blocks_per_sm: Optional[int] = None,
) -> torch.Tensor:                   # [128] float32
    if g.dim() != 2:
        raise ValueError("g must be [R, C]")
    if kernel not in launches:
        raise ValueError(f"kernel must be one of {tuple(launches)}, got {kernel!r}")
    if g.device.type == "cpu":
        return column_sums_plain(g)
    if g.device.type != "cuda":
        raise RuntimeError(f"the stream probe has no kernel for device {g.device}")
    if g.dtype != torch.bfloat16 or g.shape[1] != COLS:
        raise TypeError(f"the stream kernels take [R, {COLS}] bfloat16, got {tuple(g.shape)} {g.dtype}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous and aligned to 16 bytes")
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    if blocks_per_sm is None:
        if kernel == "strided":
            blocks_per_sm = max(1, 2048 // threads)
        else:  # as many rings as an SM's shared memory holds, beside 16 KB each
            ring = stages * chunk_rows * COLS * 2 + 16 * 1024
            blocks_per_sm = max(1, min(2048 // threads, SHARED_PER_SM // ring))
    blocks = sms * blocks_per_sm
    partials = torch.empty((blocks, COLS), dtype=torch.float32, device=g.device)
    out = torch.empty((COLS,), dtype=torch.float32, device=g.device)

    lib = _build.library("probe_stream")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "strided":
            fn = lib.probe_stream_strided
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            err = fn(g.data_ptr(), partials.data_ptr(), out.data_ptr(), g.shape[0],
                     threads, unroll, blocks, stream)
        else:
            fn = lib.probe_stream_pipeline if kernel == "pipeline" else lib.probe_stream_bulk
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            err = fn(g.data_ptr(), partials.data_ptr(), out.data_ptr(), g.shape[0],
                     threads, stages, chunk_rows, blocks, stream)
    if err == -1:
        raise ValueError(
            f"the {kernel} stream kernel does not take rows={g.shape[0]}, threads={threads}, "
            f"unroll={unroll}, stages={stages}, chunk_rows={chunk_rows}"
        )
    if err != 0:
        raise RuntimeError(f"probe_stream_{kernel} launch failed with CUDA error {err}")
    launches[kernel] += 1
    return out


def make_g(device, rows: int = ROWS, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows, COLS), device=device, generator=gen).to(torch.bfloat16)


def reference(g: torch.Tensor):
    """(column sums in float64, the tolerance SUM_RTOL * sum_r |g[r, c]|)."""
    return g.double().sum(dim=0), SUM_RTOL * g.double().abs().sum(dim=0)


def held(out: torch.Tensor, exact: torch.Tensor, tol: torch.Tensor, enforce: bool = True) -> dict:
    """Largest |out - exact| and the largest share any column takes of its
    tolerance; raises beyond it when `enforce` is set."""
    err = (out.double() - exact).abs()
    share = (err / tol).max().item()
    if enforce and not share <= 1.0:
        raise AssertionError(
            f"column sums off by {err.max().item()}, {share} of the tolerance "
            f"{SUM_RTOL} * sum|g| = {tol.max().item()}"
        )
    return dict(max_abs_err=err.max().item(), max_share_of_tol=share, tol=tol.max().item())


def run(device: str = "cuda", reps: int = 5, g: Optional[torch.Tensor] = None) -> dict:
    dev = _common.resolve_device(device)
    if dev.type == "cpu":
        # the plain version only, at a small size
        g = make_g(dev, rows=5000) if g is None else g
        return dict(probe="stream", device="cpu", rows=g.shape[0],
                    plain=held(column_sums_plain(g), *reference(g)))
    g = make_g(dev) if g is None else g
    nbytes = g.numel() * g.element_size()
    exact, tol = reference(g)

    def measured(name, fn, check=True, enforce=True, nbytes=nbytes):
        row = dict(what=name)
        if check:
            out = fn()
            torch.cuda.synchronize()
            row.update(held(out, exact, tol, enforce))
        ms = _common.time_ms(fn, warmup=1, reps=reps, inner=2)
        row.update(ms=ms, gb_per_s=nbytes / ms / 1e6,
                   share_of_peak=nbytes / ms / 1e-3 / _common.PEAK_BYTES_PER_S)
        return row

    copy = torch.empty_like(g)
    rows = [
        # a yardstick of the card's memory system: a device-to-device copy reads
        # and writes, so twice the bytes
        measured("copy_ (reads + writes)", lambda: copy.copy_(g), check=False, nbytes=2 * nbytes),
        measured("g.float().sum()", lambda: g.float().sum(), check=False),
        # the library's sums are reported beside the kernels', not enforced
        measured("g.sum(0, dtype=torch.float32)", lambda: g.sum(0, dtype=torch.float32),
                 enforce=False),
        measured("plain", lambda: column_sums_plain(g)),
    ]
    del copy
    for threads, unroll, bps in STRIDED_SETTINGS:
        rows.append(measured(
            f"strided threads={threads} unroll={unroll} blocks/SM={bps}",
            lambda: column_sums(g, "strided", threads=threads, unroll=unroll, blocks_per_sm=bps),
        ))
    for stages, chunk_rows in PIPELINE_SETTINGS:
        rows.append(measured(
            f"pipeline stages={stages} chunk={chunk_rows * COLS * 2 // 1024}KB",
            lambda: column_sums(g, "pipeline", threads=PIPELINE_THREADS, stages=stages,
                                chunk_rows=chunk_rows),
        ))
    for stages, chunk_rows in BULK_SETTINGS:
        rows.append(measured(
            f"bulk stages={stages} chunk={chunk_rows * COLS * 2 // 1024}KB",
            lambda: column_sums(g, "bulk", threads=PIPELINE_THREADS, stages=stages,
                                chunk_rows=chunk_rows),
        ))
    return dict(
        probe="stream", device=torch.cuda.get_device_name(dev), rows=g.shape[0],
        bytes=nbytes, peak_gb_per_s=_common.PEAK_BYTES_PER_S / 1e9, sum_rtol=SUM_RTOL,
        settings=rows,
    )


if __name__ == "__main__":
    _common.main(run, __doc__)
