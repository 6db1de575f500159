#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each of the
five (flash attention forward, dQ, dK/dV; msda corner reduce forward, backward)
against its plain PyTorch version at every shape the main paths give it, in
bfloat16 and float32, with its time beside its bound. Then it drives the two
main paths of the port and checks that each went through its kernels:

  serving   ``TeReDiff.restore_fused_feedback``, full width, bfloat16, random
            weights from a seed (phases reference, restore, layers);
  training  stage 3 (``all_modules``) through ``train.step.make_train_step``:
            one step of the tiny model on the card against the CPU (phase
            train_reference), then full-width steps with float32 master
            weights and bfloat16 compute on one 512 x 512 image (phase train).

One JSON line per phase; the last line is the verdict. Any failed check raises,
so the exit code is non-zero and no verdict is printed. ``--phases`` runs a
subset for development and never prints a verdict.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (B, Tq, Tk, H, D, calls per denoising step, calls per restore outside the steps)
# of every flash-attention call of one restore at 512 x 512: UNet + ControlNet
# self- and cross-attention at the three attention levels (5 + 2 transformer
# blocks each) and the two middle blocks, the VAE middle block of the encoder
# and of the decoder. The last two shapes the restore never gives: ragged
# lengths at batch 2, and a narrow head; both are cut out of wider buffers, so
# their token strides are not H*D.
K1_SHAPES = [
    ("unet_self_64", 1, 4096, 4096, 5, 64, 7, 0),
    ("unet_self_32", 1, 1024, 1024, 10, 64, 7, 0),
    ("unet_self_16", 1, 256, 256, 20, 64, 7, 0),
    ("unet_self_mid", 1, 64, 64, 20, 64, 2, 0),
    ("unet_cross_64", 1, 4096, 77, 5, 64, 7, 0),
    ("unet_cross_32", 1, 1024, 77, 10, 64, 7, 0),
    ("unet_cross_16", 1, 256, 77, 20, 64, 7, 0),
    ("unet_cross_mid", 1, 64, 77, 20, 64, 2, 0),
    ("vae_mid", 1, 4096, 4096, 1, 512, 0, 2),
    ("ragged_strided", 2, 1000, 333, 3, 128, 0, 0),
    ("narrow_strided", 2, 301, 77, 4, 32, 0, 0),
]
# O is held elementwise against the plain version run in float32 on the same
# values: |kernel - plain| <= rtol * |plain| + atol. bfloat16: one ulp of the
# value compared (2^-7 of it; storing O rounds by half of that); float32: the
# order of summation over up to 4096 keys. atol covers elements near zero. The
# outputs at 4096 keys are about 0.03 in size, so a bound that does not scale
# with the value would pass a product that is wrong by all of it.
K1_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}  # (rtol, atol)
K1_LSE_TOL = 1e-4
# (NQ, calls per spotter pass) of the msda reduce: the 6 encoder layers, the 6
# decoder layers' control-point and text branches, and one ragged shape
K3_SHAPES = [("encoder", 9472, 6), ("dec_ctrl", 1600, 6), ("dec_text", 2500, 6), ("ragged", 37, 0)]
K3_TOL = 1e-4  # float32 accumulation on both sides, summation order only
# the training phases: configs/train_stage3.yaml's learning rate and OCR weight
TRAIN_LR = 1e-4
TRAIN_OCR_WEIGHT = 0.01
# Gradients are held elementwise against the plain backward run in float32 on
# the same values: |kernel - plain| <= rtol * |plain| + afrac * mean|plain|.
# The absolute part scales with the gradient's own size, because a gradient at
# 4096 keys is about 1e-3 in size and a fixed bound would pass one that is wrong
# by all of it. bfloat16: one ulp of the value compared for the store, and a
# tenth of a percent of a typical value for elements that cancel to near zero;
# float32: the order of summation over up to 4096 rows.
GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-3)}  # (rtol, afrac)


PHASES = ("kernels", "reference", "restore", "layers", "train_reference", "train")


LOG_PATH = None  # --log: every phase line is appended there as well


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    if LOG_PATH is not None:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


def time_ms(fn, warmup: int = 2, reps: int = 7, inner: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around `inner` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def held_error(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """Largest |out - ref|, and the largest share any element takes of its own
    tolerance rtol * |ref| + atol (over 1.0 means the check failed)."""
    err = (out.float() - ref.float()).abs()
    share = err / (rtol * ref.float().abs() + atol)
    return err.max().item(), share.max().item()


def held_grad_error(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype):
    """`held_error` with the absolute part of the tolerance scaled to the
    reference's mean size; returns (max |d|, share of tolerance, mean |ref|)."""
    rtol, afrac = GRAD_TOL[dtype]
    mean = ref.float().abs().mean().item()
    err, share = held_error(out, ref, rtol, afrac * mean)
    return err, share, mean


def bound_of(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def per_step_sums(rows, key: str) -> dict:
    """Milliseconds of one training step spent in a kernel: each bfloat16
    shape's time times its calls in a step."""
    return {
        f"{key}_per_train_step": sum(
            r[key] * r["calls_per_train_step"] for r in rows if r["dtype"] == "bfloat16"
        )
    }


def per_restore_sums(rows) -> dict:
    """Milliseconds of one restore spent in a kernel, its plain version, its
    bound and the library call: each bfloat16 shape's time times its calls."""
    sums = {}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [
            r[key] * r["calls_per_restore"] for r in rows
            if r["dtype"] == "bfloat16" and r[key] is not None
        ]
        sums[f"{key}_per_restore"] = sum(vals) if vals else None
    return sums


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    emit(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )
    return smi


def phase_build() -> None:
    from tair_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={p.name: _build.resource_usage(p) for p in paths})


def check_flash(rng: np.random.Generator, smi: str, steps: int) -> dict:
    import torch.nn.functional as F

    from tair_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, b, tq, tk, h, d, per_step, per_restore in K1_SHAPES:
        extra = 1 if name.endswith("_strided") else 0  # heads cut off again below
        qn = rng.standard_normal((b, tq, h + extra, d), dtype=np.float32)
        kn = rng.standard_normal((b, tk, h + extra, d), dtype=np.float32)
        vn = rng.standard_normal((b, tk, h + extra, d), dtype=np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (
                torch.from_numpy(a).cuda().to(dtype)[:, :, :h] for a in (qn, kn, vn)
            )
            out, lse = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            rtol, atol = K1_TOL[dtype]
            ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float())
            err, share = held_error(out, ref, rtol, atol)
            lse_err = (lse - ref_lse).abs().max().item()
            if not (share <= 1.0 and lse_err <= K1_LSE_TOL):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: |dO| {err}, {share} of its "
                    f"tolerance {rtol} * |O| + {atol}; |dlse| {lse_err} (tol {K1_LSE_TOL})"
                )
            ref_abs_mean = ref.abs().mean().item()
            del ref, ref_lse
            flops = 4.0 * tq * tk * d * h * b
            nbytes = b * ((2 * tq * d * h + 2 * tk * d * h) * q.element_size() + 4 * tq * h)
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
            ms = time_ms(lambda: fa.flash_attention(q, k, v))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            rows.append(dict(
                shape=name, batch=b, tq=tq, tk=tk, heads=h, d=d,
                dtype=str(dtype).split(".")[-1],
                calls_per_restore=per_step * steps + per_restore,
                calls_per_train_step=per_step + per_restore, max_abs_err=err,
                rtol=rtol, atol=atol, max_share_of_tol=share,
                mean_abs_plain=ref_abs_mean, lse_abs_err=lse_err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            ))
    head = next(r for r in rows if r["shape"] == "unet_self_64" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="flash_attention_fwd", card=smi, shapes=rows,
         **per_restore_sums(rows), **per_step_sums(rows, "ms"))
    return dict(
        name="flash_attention_fwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="tair_tpu/ops/flash_attention.py:168",
        shape="Tq=Tk=4096 H=5 D=64 bfloat16", max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        **per_step_sums(rows, "ms"),
    )


def check_msda(rng: np.random.Generator, smi: str, steps: int) -> dict:
    from tair_tpu_torch.ops import msda_reduce as mr

    lanes, k, d = 128, 16, 32
    rows = []
    for name, nq, per_pass in K3_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.from_numpy(
                rng.standard_normal((nq * lanes, 4 * d), dtype=np.float32)
            ).cuda().to(dtype)
            ws = [
                torch.from_numpy(rng.random((nq, lanes), dtype=np.float32)).cuda()
                for _ in range(4)
            ]
            out = mr.msda_corner_reduce(g, *ws, k)
            torch.cuda.synchronize()
            ref = mr.msda_corner_reduce_plain(g, *ws, k)
            err = (out - ref).abs().max().item()
            if not err <= K3_TOL:
                raise AssertionError(f"msda_corner_reduce {name} {dtype}: |d| {err} (tol {K3_TOL})")
            nbytes = g.numel() * g.element_size() + 4 * 4 * nq * lanes + 4 * out.numel()
            flops = 2.0 * g.numel()
            t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
            rows.append(dict(
                shape=name, nq=nq, dtype=str(dtype).split(".")[-1],
                calls_per_restore=per_pass * steps, calls_per_train_step=per_pass,
                max_abs_err=err,
                tol=K3_TOL, ms=time_ms(lambda: mr.msda_corner_reduce(g, *ws, k)),
                plain_ms=time_ms(lambda: mr.msda_corner_reduce_plain(g, *ws, k)),
                library_ms=None, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            ))
            del g, ws, out, ref
    head = next(r for r in rows if r["shape"] == "encoder" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="msda_corner_reduce_fwd", card=smi, shapes=rows,
         **per_restore_sums(rows), **per_step_sums(rows, "ms"))
    return dict(
        name="msda_corner_reduce_fwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/msda_reduce.cu",
        replaces="tair_tpu/ops/msda_reduce.py:150",
        shape="NQ=9472 lanes=128 K=16 D=32 bfloat16", max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, **per_step_sums(rows, "ms"),
    )


def check_flash_bwd(rng: np.random.Generator, smi: str) -> list:
    """dQ and dK/dV kernels at the forward's shapes (all but the autoencoder's
    D=512, which is never differentiated), against the plain backward, and the
    time of each beside its bound, the plain backward and autograd through
    PyTorch's fused attention (one call gives all three gradients, so that
    time stands beside the two kernels' sum)."""
    import torch.nn.functional as F

    from tair_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, b, tq, tk, h, d, per_step, _ in K1_SHAPES:
        if d not in fa.BWD_HEAD_DIMS:
            continue
        extra = 1 if name.endswith("_strided") else 0
        arrays = [
            rng.standard_normal((b, t, h + extra, d), dtype=np.float32)
            for t in (tq, tk, tk, tq)
        ]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (
                torch.from_numpy(a).cuda().to(dtype)[:, :, :h] for a in arrays
            )
            scale = 1.0 / d ** 0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
            dq = fa._launch_backward_kernel("dq", q, k, v, do, lse, delta, scale)
            dk, dv = fa._launch_backward_kernel("dkv", q, k, v, do, lse, delta, scale)
            torch.cuda.synchronize()
            refs = fa.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), out.float(), lse, do.float(), scale
            )
            held = {}
            for gname, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                err, share, mean = held_grad_error(got, ref, dtype)
                held[gname] = dict(max_abs_err=err, max_share_of_tol=share, mean_abs_plain=mean)
                if not share <= 1.0:
                    rtol, afrac = GRAD_TOL[dtype]
                    raise AssertionError(
                        f"flash_attention backward {name} {dtype} {gname}: |d| {err}, "
                        f"{share} of its tolerance {rtol} * |g| + {afrac} * mean|g| "
                        f"(mean|g| {mean})"
                    )
            del refs
            # the same gradients through autograd and the Function, with dO
            # handed over in another layout (heads outermost): the same kernels
            # on the same values, so equal bit for bit
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            do_hm = do.transpose(1, 2).contiguous().transpose(1, 2)
            via_fn = torch.autograd.grad(fa.flash_attention(*leaves, scale)[0], leaves, do_hm)
            if not all(torch.equal(a, b_) for a, b_ in zip(via_fn, (dq, dk, dv))):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: autograd through the Function "
                    "disagrees with the backward kernels called directly"
                )
            del leaves, via_fn, do_hm
            qkv_bytes = (2 * tq + 2 * tk) * d * h * b * q.element_size()  # q, dO, k, v
            stats_bytes = 2 * 4 * tq * h * b                              # lse, delta
            prod = 2.0 * tq * tk * d * h * b                              # one product
            ms_dq = time_ms(lambda: fa._launch_backward_kernel("dq", q, k, v, do, lse, delta, scale))
            ms_dkv = time_ms(lambda: fa._launch_backward_kernel("dkv", q, k, v, do, lse, delta, scale))
            plain_ms = time_ms(
                lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale), reps=3
            )
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2)
            library_ms = time_ms(
                lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
            )
            del lib_out, qt, kt, vt
            common = dict(
                shape=name, batch=b, tq=tq, tk=tk, heads=h, d=d,
                dtype=str(dtype).split(".")[-1], calls_per_train_step=per_step,
                plain_ms_dq_and_dkv=plain_ms, library_ms_dq_and_dkv=library_ms,
            )
            rows.append(dict(
                kernel="dq", **common, ms=ms_dq, held=dict(dq=held["dq"]),
                **bound_of(3 * prod, qkv_bytes + stats_bytes + tq * d * h * b * q.element_size(), dtype),
            ))
            rows.append(dict(
                kernel="dkv", **common, ms=ms_dkv, held=dict(dk=held["dk"], dv=held["dv"]),
                **bound_of(4 * prod, qkv_bytes + stats_bytes + 2 * tk * d * h * b * q.element_size(), dtype),
            ))
    entries = []
    for which, site in (("dq", 229), ("dkv", 245)):
        mine = [r for r in rows if r["kernel"] == which]
        head = next(r for r in mine if r["shape"] == "unet_self_64" and r["dtype"] == "bfloat16")
        emit("kernels", kernel=f"flash_attention_{which}", card=smi, shapes=mine,
             **per_step_sums(mine, "ms"), **per_step_sums(mine, "bound_ms"),
             **per_step_sums(mine, "plain_ms_dq_and_dkv"),
             **per_step_sums(mine, "library_ms_dq_and_dkv"))
        entries.append(dict(
            name=f"flash_attention_{which}", route="cuda",
            source="tair_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            replaces=f"tair_tpu/ops/flash_attention.py:{site}",
            shape="Tq=Tk=4096 H=5 D=64 bfloat16",
            max_abs_err=max(g["max_abs_err"] for g in head["held"].values()),
            ms=head["ms"], plain_ms=head["plain_ms_dq_and_dkv"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms_dq_and_dkv"],
            plain_and_library_cover="dq + dkv (one call gives all three gradients)",
            **per_step_sums(mine, "ms"),
        ))
    return entries


def check_msda_bwd(rng: np.random.Generator, smi: str) -> dict:
    from tair_tpu_torch.ops import msda_reduce as mr

    lanes, k, d = 128, 16, 32
    rows = []
    for name, nq, per_pass in K3_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.from_numpy(
                rng.standard_normal((nq * lanes, 4 * d), dtype=np.float32)
            ).cuda().to(dtype)
            ws = [
                torch.from_numpy(rng.random((nq, lanes), dtype=np.float32)).cuda()
                for _ in range(4)
            ]
            dout = torch.from_numpy(
                rng.standard_normal((nq * (lanes // k), d), dtype=np.float32)
            ).cuda()
            grads = mr._launch_bwd(g, ws, dout, k)
            torch.cuda.synchronize()
            refs = mr.msda_corner_reduce_bwd_plain(g.float(), *ws, dout, k)
            held = {}
            for gname, got, ref in zip(("dg", "dw0", "dw1", "dw2", "dw3"), grads, refs):
                # dg is stored in g's type; the dw are float32 sums over D
                err, share, mean = held_grad_error(
                    got, ref, dtype if gname == "dg" else torch.float32
                )
                held[gname] = dict(max_abs_err=err, max_share_of_tol=share, mean_abs_plain=mean)
                if not share <= 1.0:
                    raise AssertionError(
                        f"msda_corner_reduce backward {name} {dtype} {gname}: |d| {err}, "
                        f"{share} of its tolerance (mean|g| {mean})"
                    )
            if grads[0].dtype != g.dtype:
                raise AssertionError("dg does not have g's type")
            leaves = [t.detach().requires_grad_(True) for t in (g, *ws)]
            via_fn = torch.autograd.grad(mr.msda_corner_reduce(*leaves, k), leaves, dout)
            if not all(torch.equal(a, b_) for a, b_ in zip(via_fn, grads)):
                raise AssertionError(
                    f"msda_corner_reduce {name} {dtype}: autograd through the Function "
                    "disagrees with the backward kernel called directly"
                )
            del refs, leaves, via_fn
            nbytes = (
                2 * g.numel() * g.element_size() + 2 * 4 * 4 * nq * lanes + 4 * dout.numel()
            )
            rows.append(dict(
                shape=name, nq=nq, dtype=str(dtype).split(".")[-1],
                calls_per_train_step=per_pass, held=held,
                ms=time_ms(lambda: mr._launch_bwd(g, ws, dout, k)),
                plain_ms=time_ms(lambda: mr.msda_corner_reduce_bwd_plain(g, *ws, dout, k)),
                library_ms=None, **bound_of(4.0 * g.numel(), nbytes, torch.float32),
            ))
            del g, ws, dout, grads
    head = next(r for r in rows if r["shape"] == "encoder" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="msda_corner_reduce_bwd", card=smi, shapes=rows,
         **per_step_sums(rows, "ms"), **per_step_sums(rows, "bound_ms"),
         **per_step_sums(rows, "plain_ms"))
    return dict(
        name="msda_corner_reduce_bwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/msda_reduce.cu",
        replaces="tair_tpu/ops/msda_reduce.py:204",
        shape="NQ=9472 lanes=128 K=16 D=32 bfloat16",
        max_abs_err=max(g["max_abs_err"] for g in head["held"].values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, **per_step_sums(rows, "ms"),
    )


def phase_reference(seed: int) -> None:
    """The whole loop on a small input against a reference: the tiny model in
    float32 on the card (attention and msda through the kernels) and the same
    weights, input and noise on the CPU (plain versions)."""
    from tair_tpu_torch.pipeline import build_tiny_model

    steps, tol = 3, 1e-3  # float32 on both sides through 3 full steps
    ref = build_tiny_model(dtype=torch.float32, device="cpu")
    ref.init_parameters(torch.Generator().manual_seed(seed))
    dut = build_tiny_model(dtype=torch.float32, device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(seed)
    lq = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
    x_T = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
    noises = [
        torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
        for _ in range(steps)
    ]
    reset_launch_counts()
    img_d, tok_d = dut.restore_fused_feedback(
        lq.cuda(), steps=steps, score_threshold=0.0, x_T=x_T.cuda(),
        step_noises=[n.cuda() for n in noises],
    )
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = (counts["flash_attention_fwd"], counts["msda_corner_reduce_fwd"])
    backward = [k for k, n in counts.items() if n and not k.endswith("_fwd")]
    if backward:
        raise AssertionError(f"the restore loop launched backward kernels: {backward}")
    img_r, tok_r = ref.restore_fused_feedback(
        lq, steps=steps, score_threshold=0.0, x_T=x_T, step_noises=noises
    )
    err = (img_d.cpu() - img_r).abs().max().item()
    if not err <= tol or not torch.equal(tok_d.cpu(), tok_r) or min(launches) == 0:
        raise AssertionError(
            f"tiny model on the card against the CPU: |d image| {err} (tol {tol}), "
            f"tokens equal {torch.equal(tok_d.cpu(), tok_r)}, launches {launches}"
        )
    emit(
        "reference", model="build_tiny_model float32", steps=steps, max_abs_err=err,
        tol=tol, tokens_equal=True, prompt_tokens=int((tok_r != 0).sum().item()),
        flash_launches=launches[0], msda_launches=launches[1],
    )


def reset_launch_counts() -> None:
    from tair_tpu_torch.ops import flash_attention as fa
    from tair_tpu_torch.ops import msda_reduce as mr

    fa.reset_launches()
    mr.reset_launches()


def launch_counts() -> dict:
    """The wrappers' counts under the names of the `kernels` line."""
    from tair_tpu_torch.ops import flash_attention as fa
    from tair_tpu_torch.ops import msda_reduce as mr

    return {
        "flash_attention_fwd": fa.launches["fwd"],
        "flash_attention_dq": fa.launches["dq"],
        "flash_attention_dkv": fa.launches["dkv"],
        "msda_corner_reduce_fwd": mr.launches["fwd"],
        "msda_corner_reduce_bwd": mr.launches["bwd"],
    }


def predicted_train_launches(model) -> dict:
    """Kernel launches of one stage-3 training step, from the model's
    structure: every attention of the UNet and the ControlNet runs forward, dQ
    and dK/dV once; the frozen autoencoder's middle attention runs forward in
    each of the two encodes; every deformable attention of the spotter runs the
    reduce forward and backward once."""
    from tair_tpu_torch.models.attention import CrossAttention
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    attn = sum(
        isinstance(m, CrossAttention)
        for net in (model.cldm.unet, model.cldm.controlnet) for m in net.modules()
    )
    msda = sum(isinstance(m, MSDeformAttn) for m in model.testr.modules())
    return {
        "flash_attention_fwd": attn + 2, "flash_attention_dq": attn,
        "flash_attention_dkv": attn, "msda_corner_reduce_fwd": msda,
        "msda_corner_reduce_bwd": msda,
    }


def train_batch(rng: np.random.Generator, batch: int, size: int, max_inst: int, n_inst: int):
    """A seeded training batch as numpy arrays: images, prompt tokens and
    `max_inst` padded text instances of which the first `n_inst` are real."""
    cxcy = rng.uniform(0.2, 0.8, (batch, max_inst, 2))
    wh = rng.uniform(0.05, 0.3, (batch, max_inst, 2))
    tokens = rng.integers(1, 40000, (batch, 77))
    tokens[:, 0] = 49406  # start token
    return dict(
        gt=rng.random((batch, size, size, 3), dtype=np.float32) * 2 - 1,
        lq=rng.random((batch, size, size, 3), dtype=np.float32),
        tokens=tokens,
        inst_mask=np.broadcast_to(np.arange(max_inst) < n_inst, (batch, max_inst)).copy(),
        boxes=np.concatenate([cxcy, wh], -1).astype(np.float32),
        ctrl_points=rng.uniform(0.1, 0.9, (batch, max_inst, 16, 2)).astype(np.float32),
        texts=rng.integers(0, 97, (batch, max_inst, 25)),
    )


def make_trainer(model, compute_dtype, marks=None):
    """(state, step) of stage 3. `marks`, a `StageMarks`, is told when the
    criterion has returned."""
    from tair_tpu_torch.diffusion.diffusion import Diffusion
    from tair_tpu_torch.train.step import create_train_state, make_train_step

    spotter_loss = model.spotter_loss_fn()

    def marked_loss(feats, batch):
        out = spotter_loss(feats, batch)
        if marks is not None:
            marks.mark("criterion_and_matcher")
        return out

    state = create_train_state(model, "stage3", TRAIN_LR)
    step = make_train_step(
        model, Diffusion(model.schedule), spotter_loss_fn=marked_loss,
        ocr_loss_weight=TRAIN_OCR_WEIGHT, compute_dtype=compute_dtype,
    )
    return state, step


class StageMarks:
    """Splits one training step into its layers by the host clock: while
    `on`, every mark synchronises the device and books the time since the
    last mark under its name. The marks are module and optimizer hooks around
    the step the trainer really runs, so nothing of it is repeated here."""

    def __init__(self):
        self.on = False
        self.seconds = {}
        self._last = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self.on, self.seconds, self._last = True, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if not self.on:
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._last
        self._last = now

    def install(self, model, optimizer) -> None:
        cldm = model.cldm
        # the frozen prologue (SwinIR, two VAE encodes, CLIP) ends where the
        # ControlNet begins; the timestep draw and q_sample fall to it
        cldm.controlnet.register_forward_pre_hook(lambda *_: self.mark("frozen_prologue"))
        cldm.unet.register_forward_hook(lambda *_: self.mark("controlnet_unet_forward"))
        model.testr.register_forward_pre_hook(lambda *_: self.mark("diffusion_loss"))
        model.testr.register_forward_hook(lambda *_: self.mark("spotter_forward"))
        optimizer.register_step_pre_hook(lambda *_: self.mark("backward"))
        optimizer.register_step_post_hook(lambda *_: self.mark("optimizer"))


def watch_gradients(state, model, marks=None) -> dict:
    """Before every optimizer update, record the trained gradients (norm, and
    whether each exists and is finite) and whether a frozen parameter has one.
    `marks` books the time this takes under its own name."""
    seen = {}

    def hook(*_):
        trained = [p for p in model.parameters() if p.requires_grad]
        frozen = [p for p in model.parameters() if not p.requires_grad]
        grads = [p.grad for p in trained if p.grad is not None]
        seen["trained_without_grad"] = len(trained) - len(grads)
        seen["frozen_with_grad"] = sum(p.grad is not None for p in frozen)
        norms = torch.stack(torch._foreach_norm(grads)).float()  # a few launches, not one per tensor
        seen["grad_norm"] = norms.norm().item()
        seen["grads_finite"] = bool(torch.isfinite(norms).all().item())
        if marks is not None:
            marks.mark("gradient_watch")

    state.optimizer.register_step_pre_hook(hook)
    return seen


def phase_train_reference(seed: int) -> None:
    """One stage-3 step of the tiny model in float32 on the card, through the
    five kernels, against the same weights, batch and draws on the CPU through
    the plain versions."""
    from tair_tpu_torch.pipeline import build_tiny_model

    ref = build_tiny_model(dtype=torch.float32, device="cpu", training=True)
    ref.init_parameters(torch.Generator().manual_seed(seed))
    dut = build_tiny_model(dtype=torch.float32, device="cuda", training=True)
    dut.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(seed)
    batch = train_batch(rng, batch=2, size=64, max_inst=3, n_inst=2)
    draws = dict(
        vae_noise=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        t=rng.integers(0, 1000, (2,)),
        noise=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
    )
    results = {}
    for name, model in (("card", dut), ("cpu", ref)):
        dev = next(model.parameters()).device
        state, step = make_trainer(model, torch.float32)
        seen = watch_gradients(state, model)
        grads = {}
        state.optimizer.register_step_pre_hook(lambda *_, m=model, g=grads: g.update(
            {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters() if p.grad is not None}
        ))
        reset_launch_counts()
        _, aux = step(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            draws={k: torch.from_numpy(v).to(dev) for k, v in draws.items()},
        )
        if dev.type == "cuda":
            torch.cuda.synchronize()
        results[name] = dict(
            aux={k: v.item() for k, v in aux.items()}, seen=dict(seen), grads=grads,
            launches=launch_counts(),
            params={n: p.detach().cpu() for n, p in model.named_parameters()},
        )
    card, cpu = results["card"], results["cpu"]
    # float32 on both sides; the card sums in another order and its float32
    # convolutions are cuDNN's
    aux_tol, norm_tol = 2e-3, 2e-3
    for key, want in cpu["aux"].items():
        if not abs(card["aux"][key] - want) <= aux_tol * abs(want):
            raise AssertionError(f"train_reference {key}: card {card['aux'][key]}, CPU {want}")
    if not abs(card["seen"]["grad_norm"] - cpu["seen"]["grad_norm"]) <= norm_tol * cpu["seen"]["grad_norm"]:
        raise AssertionError(f"train_reference gradient norm: {card['seen']} against {cpu['seen']}")
    # Adam's first update is lr * g / (|g| + eps), lr in size whatever the
    # gradient's: a tenth of lr where the CPU's gradient stands clear of float32
    # noise, and no more than two updates apart anywhere
    worst_solid = worst_any = 0.0
    for name, want in cpu["params"].items():
        err = (card["params"][name] - want).abs()
        worst_any = max(worst_any, err.max().item())
        if name in cpu["grads"]:
            solid = cpu["grads"][name].abs() >= 1e-5
            if solid.any():
                worst_solid = max(worst_solid, err[solid].max().item())
        elif err.max().item() != 0.0:
            raise AssertionError(f"train_reference: frozen {name} differs after the step")
    if not (worst_solid <= 0.1 * TRAIN_LR and worst_any <= 2.1 * TRAIN_LR):
        raise AssertionError(
            f"train_reference parameters after the step: {worst_solid} where the gradient "
            f"is solid (tol {0.1 * TRAIN_LR}), {worst_any} anywhere (tol {2.1 * TRAIN_LR})"
        )
    want_launches = predicted_train_launches(dut)
    if card["launches"] != want_launches or any(cpu["launches"].values()):
        raise AssertionError(
            f"train_reference launches: card {card['launches']}, structure says "
            f"{want_launches}; CPU {cpu['launches']} (must be none)"
        )
    emit(
        "train_reference", model="build_tiny_model float32, stage 3, batch 2, 64x64",
        aux_card=card["aux"], aux_cpu=cpu["aux"], aux_rtol=aux_tol,
        grad_norm_card=card["seen"]["grad_norm"], grad_norm_cpu=cpu["seen"]["grad_norm"],
        grad_norm_rtol=norm_tol, max_param_err_where_gradient_solid=worst_solid,
        max_param_err_anywhere=worst_any, learning_rate=TRAIN_LR, launches=card["launches"],
    )


def phase_train(seed: int, steps: int, kernels: list, profile: bool) -> dict:
    """Stage 3 at full width: float32 master weights, bfloat16 compute, one
    512 x 512 image with 8 padded target instances; one warm-up step, then
    `steps` timed ones."""
    from tair_tpu_torch.pipeline import build_default_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_default_model(dtype=torch.float32, device=dev, training=True)
    model.init_parameters(torch.Generator(device=dev).manual_seed(seed))
    marks = StageMarks()
    state, step = make_trainer(model, torch.bfloat16, marks)
    marks.install(model, state.optimizer)
    seen = watch_gradients(state, model, marks)
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    n_trained = sum(p.numel() for p in model.parameters() if p.requires_grad)

    def checksums():
        return {
            n: (p.detach().double().sum().item(), p.detach().double().square().sum().item())
            for n, p in model.named_parameters()
        }

    rng = np.random.default_rng(seed)
    batch = {
        k: torch.from_numpy(v).to(dev)
        for k, v in train_batch(rng, batch=1, size=512, max_inst=8, n_inst=5).items()
    }
    gen = torch.Generator(device=dev).manual_seed(seed)
    want = predicted_train_launches(model)
    before = checksums()

    def one_step():
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, aux = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        got = launch_counts()
        aux = {k: v.item() for k, v in aux.items()}
        if got != want:
            raise AssertionError(f"train launches {got}, structure says {want}")
        if not all(np.isfinite(v) for v in aux.values()):
            raise AssertionError(f"train: a loss is not finite: {aux}")
        total = aux["loss_diffusion"] + TRAIN_OCR_WEIGHT * aux["loss_ocr"]
        if not abs(aux["loss_total"] - total) <= 1e-5 * abs(total):
            raise AssertionError(f"train: loss_total {aux['loss_total']} is not {total}")
        if seen["trained_without_grad"] or seen["frozen_with_grad"] or not seen["grads_finite"]:
            raise AssertionError(f"train: gradients {seen}")
        return seconds, aux, got

    warm_seconds, warm_aux, _ = one_step()
    torch.cuda.reset_peak_memory_stats()
    timed = [one_step() for _ in range(steps)]
    peak = torch.cuda.max_memory_allocated()
    after = checksums()
    unmoved = [n for n in trained if after[n] == before[n]]
    moved_frozen = [n for n in after if n not in trained and after[n] != before[n]]
    if unmoved or moved_frozen:
        raise AssertionError(
            f"train: {len(unmoved)} trained parameters did not move ({unmoved[:3]}), "
            f"{len(moved_frozen)} frozen ones did ({moved_frozen[:3]})"
        )
    seconds = [t for t, _, _ in timed]
    step_s = statistics.median(seconds)
    emit(
        "train", stage="all_modules", geometry="build_default_model, batch 1, 512x512, "
        "8 padded target instances (5 real)", master_dtype="float32", compute_dtype="bfloat16",
        learning_rate=TRAIN_LR, ocr_loss_weight=TRAIN_OCR_WEIGHT,
        model_build_seconds=build_seconds, trained_parameters=n_trained,
        trained_tensors=len(trained), warmup_step_seconds=warm_seconds,
        step_seconds=seconds, median_step_seconds=step_s, peak_memory_bytes=peak,
        losses=[warm_aux] + [a for _, a, _ in timed], grad_norm_last_step=seen["grad_norm"],
        launches_per_step=want,
        kernel_share_of_step={
            e["name"]: e["ms_per_train_step"] * 1e-3 / step_s for e in kernels
        } or None,
    )
    marks.start()
    layered_seconds = one_step()[0]
    marks.on = False
    emit("train_layers", step_seconds_with_marks=layered_seconds, seconds=marks.seconds,
         note="one more step, synchronised at every mark; gradient_watch is this "
              "script's own check of the gradients before the update")
    if profile:
        phase_profile("train_profile", lambda: one_step()[0])
    return timed[-1][2]


def build_model(seed: int):
    from tair_tpu_torch.pipeline import build_default_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_default_model(dtype=torch.bfloat16, device=dev)
    model.init_parameters(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    emit(
        "model", seconds=time.perf_counter() - t0,
        parameters=sum(p.numel() for p in model.parameters()),
        dtype="bfloat16", geometry="build_default_model (SD-2.1 UNet/ControlNet/VAE, "
        "OpenCLIP-H text tower, SwinIR, TESTR), random weights from the seed",
    )
    lq = torch.from_numpy(
        np.random.default_rng(seed).random((1, 512, 512, 3), dtype=np.float32)
    ).to(dev)
    return model, lq


def phase_restore(model, lq, seed: int, steps: int) -> dict:
    from tair_tpu_torch.models.attention import CrossAttention
    from tair_tpu_torch.models.prompt_splice import SOT_TOKEN
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    dev = lq.device
    check_steps = 10  # of the two requests that check same seed, same image
    attn_sites = sum(
        isinstance(m, CrossAttention)
        for net in (model.cldm.unet, model.cldm.controlnet) for m in net.modules()
    )
    msda_sites = sum(isinstance(m, MSDeformAttn) for m in model.testr.modules())

    def request(req_seed: int, n_steps: int):
        # score_threshold=0.0 keeps every proposal of the randomly initialised
        # spotter, so the spliced prompt carries words and the re-encode matters
        gen = torch.Generator(device=dev).manual_seed(req_seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        image, tokens = model.restore_fused_feedback(
            lq, generator=gen, steps=n_steps, spotter_every=1, score_threshold=0.0
        )
        torch.cuda.synchronize()
        return image, tokens, time.perf_counter() - t

    def check(image, tokens):
        if tuple(image.shape) != (1, 512, 512, 3) or not torch.isfinite(image).all():
            raise AssertionError(f"restored image is not finite [1,512,512,3]: {tuple(image.shape)}")
        if image.min().item() < 0.0 or image.max().item() > 1.0:
            raise AssertionError("restored image leaves [0, 1]")
        if tuple(tokens.shape) != (1, 77) or tokens[0, 0].item() != SOT_TOKEN:
            raise AssertionError("tokens are not [1,77] starting with the start token")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    image, tokens, seconds = request(seed, steps)
    counts = launch_counts()
    k1_launches, k3_launches = counts["flash_attention_fwd"], counts["msda_corner_reduce_fwd"]
    check(image, tokens)
    want_k1 = attn_sites * steps + 2
    want_k3 = msda_sites * steps
    if k1_launches != want_k1 or k3_launches != want_k3 or min(k1_launches, k3_launches) == 0:
        raise AssertionError(
            f"launches: flash {k1_launches} (structure says {want_k1}), "
            f"msda {k3_launches} (structure says {want_k3})"
        )
    peak = torch.cuda.max_memory_allocated()

    image_b, tokens_b, seconds_b = request(seed + 1, steps)
    check(image_b, tokens_b)
    if torch.equal(image, image_b):
        raise AssertionError("two seeds gave the same image")
    image_c, tokens_c, seconds_c = request(seed + 2, check_steps)
    image_d, tokens_d, seconds_d = request(seed + 2, check_steps)
    check(image_c, tokens_c)
    if not (torch.equal(image_c, image_d) and torch.equal(tokens_c, tokens_d)):
        raise AssertionError("the same seed gave two different images")

    emit(
        "restore", steps=steps, seconds_first_request=seconds,
        seconds_second_request=seconds_b, same_seed_check_steps=check_steps,
        same_seed_check_seconds=[seconds_c, seconds_d],
        attention_sites=attn_sites, msda_sites=msda_sites,
        flash_launches=k1_launches, msda_launches=k3_launches,
        peak_memory_bytes=peak, image_mean=image.mean().item(),
        tokens_head=tokens[0, :12].tolist(),
        prompt_tokens=int((tokens != 0).sum().item()),
    )
    return {"flash_attention_fwd": k1_launches, "msda_corner_reduce_fwd": k3_launches}


def phase_layers(model, lq, steps: int) -> None:
    """Seconds of each stage of one request, by the host clock around work that
    ends in a synchronise (median of 5 after one warm-up), and what 50 steps of
    the loop's stages add up to."""
    from tair_tpu_torch.models.prompt_splice import empty_tokens, splice_tag_prompt
    from tair_tpu_torch.spotter.testr import spotter_inference

    def timed(fn, reps: int = 5):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times), out

    dev = lq.device
    with torch.no_grad():
        t_clean, clean = timed(lambda: model.clean(lq))
        t_enc, c_img = timed(lambda: model.cldm.vae_encode(clean * 2.0 - 1.0, sample=False))
        tokens = torch.from_numpy(empty_tokens(1)).to(dev).long()
        t_clip, c_txt = timed(lambda: model.cldm.clip_encode_tokens(tokens))
        x = torch.randn((1, 64, 64, 4), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        t_model = torch.full((1,), 500, dtype=torch.int32, device=dev)
        cond = dict(c_txt=c_txt, c_img=c_img)
        t_step, (_, feats) = timed(lambda: model.cldm.apply(x, t_model, cond))
        t_spot, out = timed(lambda: model.spotter_apply(feats))

        def splice():
            res = spotter_inference(out, 0.0, image_size=512)
            return splice_tag_prompt(res["recs"], res["scores"], res["keep"], 4)

        t_splice, _ = timed(splice)
        t_dec, _ = timed(lambda: model.cldm.vae_decode(x))
    per_step = t_step + t_spot + t_splice + t_clip
    emit(
        "layers", clean_s=t_clean, vae_encode_s=t_enc, clip_encode_s=t_clip,
        controlnet_unet_step_s=t_step, spotter_pass_s=t_spot,
        decode_and_splice_s=t_splice, vae_decode_s=t_dec, steps=steps,
        sum_of_stages_s=t_clean + t_enc + t_clip + steps * per_step + t_dec,
    )


def phase_profile(phase: str, run) -> None:
    """Device time by kernel over one call of `run` (which returns its wall
    seconds), from torch.profiler, and the device's idle share against the
    same call's time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    wall = run()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        wall_profiled = run()
    rows = [
        (e.key, e.device_time_total / 1e6, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
        # a range such as "Optimizer.step#AdamW.step" repeats its kernels' time
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.")
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    emit(
        phase, wall_seconds=wall, wall_seconds_under_profiler=wall_profiled,
        device_busy_seconds=busy if rows else None,
        device_idle_share=(1.0 - busy / wall) if rows else None,
        kernel_launches=sum(r[2] for r in rows),
        top_kernels=[dict(name=n[:90], seconds=s, calls=c) for n, s, c in rows[:30]],
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20, help="steps of the two full requests")
    ap.add_argument("--train-steps", type=int, default=3, help="timed training steps")
    ap.add_argument("--profile-train", action="store_true",
                    help="also trace one training step with torch.profiler")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases (a subset prints no verdict)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="also trace a request of this many steps with torch.profiler")
    ap.add_argument("--log", default=None,
                    help="also append every phase's JSON line to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    import tair_tpu_torch.pipeline  # noqa: F401  (a missing package fails before any output)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.log:
        global LOG_PATH
        LOG_PATH = Path(args.log)
        LOG_PATH.parent.mkdir(parents=True, exist_ok=True)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from {PHASES}")

    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    kernels, restore_launches, train_launches = [], {}, {}
    if "kernels" in phases:
        kernels = [
            check_flash(rng, smi, args.steps),
            *check_flash_bwd(rng, smi),
            check_msda(rng, smi, args.steps),
            check_msda_bwd(rng, smi),
        ]
    if "reference" in phases:
        phase_reference(args.seed)
    if phases & {"restore", "layers"} or args.profile_steps:
        model, lq = build_model(args.seed)
        if "restore" in phases:
            restore_launches = phase_restore(model, lq, args.seed, args.steps)
        if "layers" in phases:
            phase_layers(model, lq, args.steps)
        if args.profile_steps:
            def request() -> float:
                gen = torch.Generator(device=lq.device).manual_seed(args.seed)
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.restore_fused_feedback(
                    lq, generator=gen, steps=args.profile_steps, score_threshold=0.0
                )
                torch.cuda.synchronize()
                return time.perf_counter() - t

            phase_profile("profile", request)
        del model, lq
        torch.cuda.empty_cache()
    if "train_reference" in phases:
        phase_train_reference(args.seed)
    if "train" in phases:
        train_launches = phase_train(args.seed, args.train_steps, kernels, args.profile_train)
    if phases != set(PHASES):
        # a partial run is for development: it prints what it measured and no verdict
        print(json.dumps({"kernels": kernels, "restore_launches": restore_launches,
                          "train_step_launches": train_launches}), flush=True)
        raise SystemExit(f"partial run of phases {sorted(phases)}: no verdict")
    for entry in kernels:
        # each main path was driven with the counts set to 0 just before it:
        # one restore request, and the last training step
        entry["launches_restore"] = restore_launches.get(entry["name"], 0)
        entry["launches_train_step"] = train_launches[entry["name"]]
        entry["launches"] = entry["launches_restore"] + entry["launches_train_step"]
        if entry["launches_train_step"] < 1 or (
            entry["name"] in restore_launches and entry["launches_restore"] < 1
        ):
            raise AssertionError(f"{entry['name']} was not launched on a main path that runs it")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
