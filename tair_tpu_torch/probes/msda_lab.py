"""Probe: the msda corner reduce cut into stages, to see where its time goes.

Counterpart of ``scripts/msda_kernel_lab.py``, at the encoder's geometry (NQ =
9472 queries, 128 lanes, K = 16 rows per output group, D = 32; ``g`` is 310 MB
in bfloat16). The variants of ``ops/csrc/probe_msda_lab.cu`` keep the shipped
kernel's mapping and do less or other work:

``copy``  reads all of ``g`` and stores each group's first D values;
``seg``   sums corners and the K rows without weights;
``w32``   the full reduce with the product in float32;
``w16``   the full reduce with the weight rounded to bfloat16 and the product
          in bfloat16, summed in float32;
``prod``  the shipped kernel, ``ops.msda_reduce.msda_corner_reduce``, timed in
          the same harness.

``lab(variant, ...)`` launches the kernel on a CUDA tensor and takes
``lab_plain`` only for a CPU tensor. ``check`` holds each variant against
``lab_plain``; ``copy`` moves values and must be equal, ``seg`` and ``w32`` sum
in float32 in another order (``SUM_TOL``), ``w16`` rounds each weight and each
product to bfloat16, two roundings of 2^-9 relative each, so it is held to
``W16_RTOL`` = 2^-7 of the sum of the terms' absolute values.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import Optional, Sequence

import torch

from ..ops import _build
from ..ops import msda_reduce
from . import _common

NQ, LANES, D, K = 9472, 128, 32, 16
VARIANTS = ("copy", "seg", "w32", "w16")
SUM_TOL = 1e-4        # float32 sums of 64 terms of order 1, in another order
W16_RTOL = 2.0 ** -7

# kernel launches made by the wrapper, one count per variant
launches = {v: 0 for v in VARIANTS}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def lab_plain(
    variant: str,
    g: torch.Tensor,                  # [NQ*lanes, 4D]
    ws: Sequence[torch.Tensor],       # four [NQ, lanes] float32
    k: int,
) -> torch.Tensor:                    # [NQ*(lanes//k), D] float32
    nq, lanes = ws[0].shape
    d = g.shape[-1] // 4
    if variant == "copy":
        return g.reshape(nq * (lanes // k), k, 4 * d)[:, 0, :d].float()
    g4 = g.float().reshape(nq, lanes, 4, d)
    if variant == "seg":
        t = g4.sum(dim=2)
    else:
        w = torch.stack(list(ws), dim=2).float()  # [NQ, lanes, 4]
        if variant == "w16":
            t = (g.reshape(nq, lanes, 4, d) * w.to(g.dtype)[..., None]).float().sum(dim=2)
        elif variant in ("w32", "prod"):
            t = (g4 * w[..., None]).sum(dim=2)
        else:
            raise ValueError(f"unknown variant {variant!r}")
    return t.reshape(nq, lanes // k, k, d).sum(dim=2).reshape(nq * (lanes // k), d)


def lab(variant: str, g: torch.Tensor, ws: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    if variant not in launches:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    nq, lanes = ws[0].shape
    if g.dim() != 2 or g.shape[-1] % 4 or g.shape[0] != nq * lanes or lanes % k:
        raise ValueError("g must be [NQ*lanes, 4D] for weights [NQ, lanes], lanes a multiple of k")
    if g.device.type == "cpu":
        return lab_plain(variant, g, ws, k)
    if g.device.type != "cuda":
        raise RuntimeError(f"the msda lab has no kernel for device {g.device}")
    if g.dtype != torch.bfloat16 or any(w.dtype != torch.float32 for w in ws):
        raise TypeError("the lab kernels take g in bfloat16 and float32 weights")
    for name, t in (("g", g), *((f"w{i}", w) for i, w in enumerate(ws))):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != g.device:
            raise ValueError(f"{name} must be contiguous, aligned to 16 bytes and on g's device")
    d = g.shape[-1] // 4
    out = torch.empty((nq * (lanes // k), d), dtype=torch.float32, device=g.device)

    lib = _build.library("probe_msda_lab")
    fn = lib.probe_msda_lab
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), nq, lanes,
                 k, d, VARIANTS.index(variant), stream)
    if err == -1:
        raise ValueError(f"the msda lab does not take D={d}, lanes={lanes}, k={k}")
    if err != 0:
        raise RuntimeError(f"probe_msda_lab ({variant}) launch failed with CUDA error {err}")
    launches[variant] += 1
    return out


def make_inputs(device, nq: int = NQ, seed: int = 0, g: Optional[torch.Tensor] = None):
    """(g, four weights); `g` may be handed in (any [nq*LANES, 4*D] bfloat16)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if g is None:
        g = torch.randn((nq * LANES, 4 * D), device=device, generator=gen).to(torch.bfloat16)
    ws = [torch.rand((nq, LANES), device=device, generator=gen) for _ in range(4)]
    return g, ws


def held(variant: str, out: torch.Tensor, g: torch.Tensor, ws, k: int) -> dict:
    """|out - plain| against the variant's tolerance; raises beyond it."""
    ref = lab_plain("w32" if variant == "w16" else variant, g, ws, k)
    err = (out - ref).abs()
    if variant == "copy":
        tol, share = 0.0, (0.0 if err.max().item() == 0.0 else float("inf"))
    elif variant == "w16":
        bound = W16_RTOL * lab_plain("w32", g.abs(), ws, k) + 1e-6
        tol, share = bound.max().item(), (err / bound).max().item()
    else:
        tol, share = SUM_TOL, err.max().item() / SUM_TOL
    if not share <= 1.0:
        raise AssertionError(
            f"msda lab {variant}: |d| {err.max().item()}, {share} of its tolerance {tol}"
        )
    return dict(max_abs_err=err.max().item(), tol=tol, max_share_of_tol=share)


def check(g: torch.Tensor, ws: Sequence[torch.Tensor]) -> list:
    """Every variant through its wrapper, held against its plain version."""
    rows = []
    for variant in VARIANTS:
        out = lab(variant, g, ws, K)
        if g.device.type == "cuda":
            torch.cuda.synchronize()
        rows.append(dict(variant=variant, **held(variant, out, g, ws, K)))
    return rows


def run(device: str = "cuda", reps: int = 5, g: Optional[torch.Tensor] = None) -> dict:
    dev = _common.resolve_device(device)
    if dev.type == "cpu":
        # the plain versions only, at a small size
        return dict(probe="msda_lab", device="cpu", check=check(*make_inputs(dev, nq=37)))
    g, ws = make_inputs(dev, g=g)
    nq = ws[0].shape[0]
    rows = check(g, ws)
    nbytes = g.numel() * g.element_size()
    timed = {v: (lambda v=v: lab(v, g, ws, K)) for v in VARIANTS}
    timed["prod"] = lambda: msda_reduce.msda_corner_reduce(g, *ws, K)
    # in turns, so that a drift of the card's clocks falls on every variant alike
    samples = {name: [] for name in timed}
    for _ in range(max(reps, 1)):
        for name, fn in timed.items():
            samples[name].append(_common.time_ms(fn, warmup=1, reps=1, inner=5))
    times = [
        dict(variant=name, ms=statistics.median(ms), ms_all=ms,
             gb_per_s_of_g=nbytes / statistics.median(ms) / 1e6)
        for name, ms in samples.items()
    ]
    return dict(
        probe="msda_lab", device=torch.cuda.get_device_name(dev),
        geometry=dict(nq=nq, lanes=LANES, d=D, k=K), g_bytes=nbytes,
        check=rows, times=times,
    )


if __name__ == "__main__":
    _common.main(run, __doc__)
