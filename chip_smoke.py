#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each of the
ten model kernels (flash attention forward, dQ and dK/dV on the tensor cores for
bfloat16, the forward at D <= 128 and at the autoencoder's D = 512, and on FMA
for float32; msda corner reduce forward, backward; the msda patchify kernel)
against its plain PyTorch version at every shape the main paths give it, with
its time beside its bound (each tensor-core kernel timed in turns with the FMA
kernel it replaces, the patchify kernel's band design with its first design,
by CUDA-graph replay), and
each probe kernel (gather, stream, msda lab) against its plain version at the
probe's shape. Then it drives the paths of the port and checks that each went
through its kernels:

  probes    the three probes of the card, each through its own ``run`` (phase
            probes);
  serving   ``TeReDiff.restore_fused_feedback``, full width, bfloat16, random
            weights from a seed (phases restore, layers; the tiny model in
            float32 against the CPU in phase reference), and the
            same request with every deformable attention of the spotter on the
            ``flatpatch`` core and the patchify kernel (phase
            restore_flatpatch, which also times ``flatlanes`` with the patchify
            kernel beside the default), and the same request with the sparse
            spotter encoder, ``enc_topk`` = 2048 of the 9472 tokens, beside
            the dense one and ``enc_topk`` = 9472 (phase enc_topk, which also
            holds K3 at the sparse encoder's 2048 rows and checks its
            launches by row count), and the same request served w8a8
            (``ControlLDM.quantized``: dynamic, static from
            ``calibrate_quant`` on its first step, and selective) in turns
            with bfloat16, after the two w8a8 kernels (Q2, the activation
            quantize, and Q1, the int8 convolution) are held bit for bit
            against their plain versions at every quantized site shape of a
            step (phase quant); phase restore also times one spotter pass
            with the proposals picked by the stable sort and by torch.topk;
  weights   the released checkpoints' path: the seeded full-width model
            exported under the reference's names (SD-2.1 bundle, ControlNet,
            SwinIR, TESTR), ``python -m tair_tpu_torch.convert_weights``, the
            npz loaded by ``val.load_model``; every tensor and a request's
            image equal to the seeded model's (phase ckpt);
  diffbir   ``DiffBIRPipeline.run``, full width, bfloat16, 4 steps: an untiled
            request with classifier-free guidance, strength, noise_aug, MSE
            guidance and the colour fix; a tiled 1024 x 1024 request (9 latent
            tiles a model pass, the tiled autoencoder with pooled GroupNorm);
            every sampler family; SCUNet as the cleaner and BSRNet alone; and
            the tiny model's tiled request in float32 against the CPU (phases
            diffbir, diffbir_reference);
  matcher   the exact matcher, kernel J1 (``jv_assign``, the
            Jonker-Volgenant solve of ``spotter/matcher.py``), held element
            for element against its plain version on seeded float and tied
            costs in both orientations and on the costs of a real spotter
            pass, timed by CUDA-graph replay beside the host path (a copy to
            the host, the native ``lapjv_batch``, a copy back) and scipy's
            solve (phase matcher);
  training  stage 3 (``all_modules``) through ``train.step.make_train_step``:
            one step of the tiny model on the card against the CPU (phase
            train_reference), then full-width steps with float32 master
            weights and bfloat16 compute on one 512 x 512 image, and its host
            synchronisations and seconds a step with J1 and with the host
            matcher (phase train);
            then the port's trainer as a user starts it, ``python -m
            tair_tpu_torch.train`` on configs/train_chip_demo.yaml (its own
            data, degradation on the card, checkpoint, resume, validation with
            NIQE and the five learned IQA metrics, and weight export; phase
            train_entry);
  metrics   the learned IQA metrics (LPIPS, DISTS, CLIP-IQA, MANIQA, MUSIQ) at
            full width from seeded checkpoints in their published layouts,
            read by ``from_torch``, on a 512 x 512 image: milliseconds per
            image, peak memory, two calls bit-equal, the card against the CPU
            (phase iqa; plain PyTorch, no kernel of the port);
  entry     the port's serving and evaluation entry points as a user starts
            them: ``python -m tair_tpu_torch.val`` on two 512 x 512 images in
            both loops (host-fed CAPTION prompts, and ``--fused``; each image
            scored by the five learned metrics; phase val, which also counts
            the host synchronisations of a step of each),
            ``python -m tair_tpu_torch.val_patches`` on a 240 x 240 image, its
            4 patches restored as one batch of 4 at 512 x 512 and again in
            chunks of 3 (phase val_patches), and ``python -m
            tair_tpu_torch.spotter_eval`` on configs/train_chip_demo.yaml
            (phase spotter_eval).

One JSON line per phase; the last line is the verdict. Any failed check raises,
so the exit code is non-zero and no verdict is printed. ``--phases`` runs a
subset for development and never prints a verdict.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tair_tpu_torch.ops.launches import launch_counts, reset_launch_counts

# published peaks of one H100 SXM (NVIDIA data sheet, dense): 989 TFLOP/s bf16 and
# 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

# (B, Tq, Tk, H, D, calls per denoising step, calls per restore outside the steps)
# of every flash-attention call of one restore at 512 x 512: UNet + ControlNet
# self- and cross-attention at the three attention levels (5 + 2 transformer
# blocks each) and the two middle blocks, the VAE middle block of the encoder
# and of the decoder. Then the shapes that only the trainer's 256 x 256 images
# give (phase train_entry; its third level, 64 tokens at 20 heads, is
# unet_*_mid), with no calls at 512 x 512. Then the batches of the serving entry
# points: four 512 x 512 patches at once (phase val_patches) and pairs of 256 x 256
# images (phase spotter_eval), the largest shapes of each; the 9 latent tiles of 64 x 64
# of a tiled 1024 x 1024 DiffBIR request in one batch, and its autoencoder's 9 image
# tiles of 512 x 512 (phase diffbir). The last three shapes no path gives:
# ragged lengths at batch 2 at a wide head and at the autoencoder's width, and
# a narrow head; all are cut out of wider buffers, so their token strides are
# not H*D.
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
    ("at256_unet_self_32", 1, 1024, 1024, 5, 64, 0, 0),
    ("at256_unet_self_16", 1, 256, 256, 10, 64, 0, 0),
    ("at256_unet_self_mid", 1, 16, 16, 20, 64, 0, 0),
    ("at256_unet_cross_32", 1, 1024, 77, 5, 64, 0, 0),
    ("at256_unet_cross_16", 1, 256, 77, 10, 64, 0, 0),
    ("at256_unet_cross_mid", 1, 16, 77, 20, 64, 0, 0),
    ("at256_vae_mid", 1, 1024, 1024, 1, 512, 0, 0),
    ("b4_unet_self_64", 4, 4096, 4096, 5, 64, 0, 0),
    ("b4_unet_cross_64", 4, 4096, 77, 5, 64, 0, 0),
    ("b4_vae_mid", 4, 4096, 4096, 1, 512, 0, 0),
    ("b2_at256_unet_self_32", 2, 1024, 1024, 5, 64, 0, 0),
    ("b2_at256_unet_cross_32", 2, 1024, 77, 5, 64, 0, 0),
    ("b2_at256_vae_mid", 2, 1024, 1024, 1, 512, 0, 0),
    ("b9_unet_self_64", 9, 4096, 4096, 5, 64, 0, 0),
    ("b9_vae_mid", 9, 4096, 4096, 1, 512, 0, 0),
    ("ragged_strided", 2, 1000, 333, 3, 128, 0, 0),
    ("vae_ragged_strided", 2, 1000, 333, 1, 512, 0, 0),
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
# (NQ, calls per spotter pass at 512 x 512) of the msda reduce: the 6 encoder
# layers, the 6 decoder layers' control-point and text branches (the same at
# every image size), the encoder at the trainer's 256 x 256, the batches of four
# 512 x 512 patches (val_patches) and of two 256 x 256 images (spotter_eval), and
# one ragged shape
K3_SHAPES = [("encoder", 9472, 6), ("dec_ctrl", 1600, 6), ("dec_text", 2500, 6),
             ("at256_encoder", 2368, 0), ("b4_encoder", 4 * 9472, 0),
             ("b4_dec_ctrl", 4 * 1600, 0), ("b4_dec_text", 4 * 2500, 0),
             ("b2_at256_encoder", 2 * 2368, 0), ("ragged", 37, 0)]
# the sparse encoder update (phase enc_topk): each encoder layer's msda queries
# are the ENC_TOPK selected tokens of the 9472, so K3 runs at NQ = ENC_TOPK
ENC_TOPK = 2048
K3_ENC_TOPK_SHAPE = ("enc_topk_encoder", ENC_TOPK, 0)
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


# (levels, B, H, D, calls per spotter pass) of the patchify kernel: the spotter's
# table at 512 x 512 (encoder layers and decoder cross-attentions pack the same
# [1, 9472, 8, 32] memory), the same at batch 2 cut out of a wider projection
# (rows 16-byte aligned, not contiguous), a ragged shape with 1-pixel levels,
# and a level taller than one band beside one whose two rows do not fit the
# band kernel's slab (so a band boundary falls inside the first and the second
# is cut into runs of columns)
SPOTTER_LEVELS = ((16, 16), (32, 32), (64, 64), (64, 64))
K4_SHAPES = [
    ("spotter", SPOTTER_LEVELS, 1, 8, 32, 18),
    ("spotter_b2_strided", SPOTTER_LEVELS, 2, 8, 32, 0),
    ("ragged_one_pixel", ((1, 1), (1, 5), (7, 1), (3, 4)), 2, 3, 8, 0),
    ("bands_and_column_runs", ((40, 24), (5, 200)), 2, 2, 64, 0),
]

# flash launches of one pass of the full-width bfloat16 paths (the forwards;
# dQ and dK/dV in training): every one on a tensor-core kernel
BF16_FLASH_PER_STEP = {"flash_attention_fwd_tc": 46, "flash_attention_fwd_tc_wide": 2,
                       "flash_attention_dq_tc": 46, "flash_attention_dkv_tc": 46}

FLATPATCH_STEPS = 10  # of every request of phase restore_flatpatch
PROBE_REPS = 2        # timed repetitions per setting of the probes' own runs

# denoising steps of every request of the serving entry points' phases
SERVE_STEPS = 4

PHASES = ("kernels", "probes", "reference", "restore", "restore_flatpatch", "layers",
          "enc_topk", "quant", "matcher", "diffbir", "ckpt", "train_reference", "train", "iqa", "train_entry",
          "val", "val_patches", "spotter_eval")
# the paths on which the serving entry points run K1 and K3
ENTRY_PHASES = ("val", "val_patches", "spotter_eval")


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


def device_sums(rows) -> dict:
    """`per_restore_sums` and `per_step_sums` of the kernels' device time."""
    return {
        "device_ms_per_restore": sum(
            r["device_ms"] * r["calls_per_restore"] for r in rows if r["dtype"] == "bfloat16"
        ),
        **per_step_sums(rows, "device_ms"),
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


def in_turns(first, second, timer=time_ms) -> tuple:
    """Times of two functions timed in turns in one call (first, second,
    second, first): (median ms of first, median ms of second, all four)."""
    t = [timer(first), timer(second), timer(second), timer(first)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def captured(fn, n: int):
    """A CUDA graph that holds n back-to-back calls of fn."""
    fn()  # builds, binds and caches what the call needs, outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device milliseconds of one call: CUDA events around the replay of a
    CUDA graph that holds n back-to-back calls of fn, over n (median of reps
    replays). Only the kernels run, with no host work between them; inputs
    stay where the last call left them (warm in L2 if they fit)."""
    graph = captured(fn, n)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def per_launch_ms(run, calls: dict, n: int) -> tuple:
    """torch.profiler over one call of `run` (which returns its wall seconds)
    that makes n calls of each function of `calls` (name -> (fn, parts of its
    kernels' names), each call launching its first part's kernel once):
    (device milliseconds of each function's kernels per launch the profiler
    recorded, without the host's time to launch them; for each function, the
    launches of its first part recorded against the n made, and `partial`
    when the profiler dropped some)."""
    watched = profiled(run, watch=tuple(p for _, parts in calls.values() for p in parts))["watched"]
    ms = {
        name: 1e3 * sum(watched[p]["seconds"] / max(watched[p]["calls"], 1) for p in parts)
        for name, (_, parts) in calls.items()
    }
    sample = {
        name: dict(recorded=watched[parts[0]]["calls"], expected=n,
                   partial=watched[parts[0]]["calls"] != n)
        for name, (_, parts) in calls.items()
    }
    return ms, sample


def device_ms(calls: dict, n: int = 10) -> tuple:
    """`per_launch_ms` of n eager calls of each function of `calls`."""
    def run() -> float:
        t = time.perf_counter()
        for fn, _ in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    return per_launch_ms(run, calls, n)


def graph_device_ms(calls: dict, n: int = 20) -> tuple:
    """`per_launch_ms` of the launches that `graph_ms` times: one replay of a
    CUDA graph of n back-to-back calls of each function of `calls`."""
    graphs = [captured(fn, n) for fn, _ in calls.values()]

    def run() -> float:
        t = time.perf_counter()
        for graph in graphs:
            graph.replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    return per_launch_ms(run, calls, n)


def host_ms(fn, n: int = 1000) -> float:
    """Host milliseconds of one call: time.perf_counter over n calls with no
    synchronise between them, over n (the device runs behind the host)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * t / n


# the profiler's kernel names (a part of each) of the flash wrappers' kernels
FLASH_KERNEL_NAMES = {
    "fwd": ("flash_fwd_kernel",), "fwd_tc": ("flash_fwd_tc_kernel",),
    "fwd_tc_wide": ("flash_fwd_wide_tc_kernel",), "dq": ("flash_dq_kernel",),
    "dq_tc": ("flash_dq_tc_kernel",), "dkv": ("flash_dkv_kernel",),
    "dkv_tc": ("flash_dkv_tc_kernel", "sum_partials_kernel"),
}


def check_flash(rng: np.random.Generator, smi: str, steps: int) -> list:
    """The tensor-core forwards (bfloat16: D <= 128, and D = 512) and the FMA
    forward (float32, and beside each tensor-core kernel at every bfloat16
    shape, timed in turns with it) against the plain version, with times,
    bounds, plain and library times. Returns the three kernels' entries."""
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
            scale = 1.0 / d ** 0.5
            mine = fa.kernel_name(dtype, d, "fwd")
            tc = mine != "fwd"
            rtol, atol = K1_TOL[dtype]
            ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float())
            held = {}
            # the wrapper's own choice first; at a tensor-core shape, the FMA
            # kernel on the same values as well
            for which, fn in (
                (mine, lambda: fa.flash_attention(q, k, v)),
                *((("fwd", lambda: fa._launch(q, k, v, scale, "fwd")),) if tc else ()),
            ):
                out, lse = fn()
                torch.cuda.synchronize()
                err, share = held_error(out, ref, rtol, atol)
                lse_err = (lse - ref_lse).abs().max().item()
                if not (share <= 1.0 and lse_err <= K1_LSE_TOL):
                    raise AssertionError(
                        f"flash_attention {which} {name} {dtype}: |dO| {err}, {share} of its "
                        f"tolerance {rtol} * |O| + {atol}; |dlse| {lse_err} (tol {K1_LSE_TOL})"
                    )
                held[which] = dict(max_abs_err=err, max_share_of_tol=share, lse_abs_err=lse_err)
            ref_abs_mean = ref.abs().mean().item()
            del ref, ref_lse, out, lse
            flops = 4.0 * tq * tk * d * h * b
            nbytes = b * ((2 * tq * d * h + 2 * tk * d * h) * q.element_size() + 4 * tq * h)
            kernels = {
                which: (lambda which=which: fa._launch(q, k, v, scale, which),
                        FLASH_KERNEL_NAMES[which])
                for which in dict.fromkeys((mine, "fwd"))
            }
            if tc:
                ms, fma_ms, turns = in_turns(kernels[mine][0], kernels["fwd"][0])
            else:
                ms, fma_ms, turns = time_ms(kernels["fwd"][0]), None, None
            dev, sampled = device_ms(kernels)
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            rows.append(dict(
                kernel=mine, shape=name, batch=b, tq=tq, tk=tk,
                heads=h, d=d, dtype=str(dtype).split(".")[-1],
                calls_per_restore=per_step * steps + per_restore,
                calls_per_train_step=per_step + per_restore, **held[mine], held=held,
                rtol=rtol, atol=atol, mean_abs_plain=ref_abs_mean, ms=ms,
                fma_ms=fma_ms, turns_ms=turns,
                device_ms=dev[mine], fma_device_ms=dev["fwd"] if tc else None,
                device_ms_launches=sampled[mine],
                fma_device_ms_launches=sampled["fwd"] if tc else None,
                plain_ms=plain_ms, library_ms=library_ms,
                **bound_of(flops, nbytes, dtype),
            ))
    entries = []
    for which, file, head_shape, paths in (
        ("fwd_tc", "flash_attention_tc.cu", ("unet_self_64", "Tq=Tk=4096 H=5 D=64 bfloat16"),
         ("restore", "restore_flatpatch", "diffbir", "train")),
        ("fwd_tc_wide", "flash_attention_wide_tc.cu",
         ("vae_mid", "T=4096 H=1 D=512 bfloat16"),
         ("restore", "restore_flatpatch", "diffbir", "train")),
        ("fwd", "flash_attention.cu", ("unet_self_64", "Tq=Tk=4096 H=5 D=64 float32"),
         ("reference", "diffbir_reference", "train_reference")),
    ):
        mine = [r for r in rows if r["kernel"] == which]
        head = next(r for r in mine if r["shape"] == head_shape[0])
        tc = which != "fwd"  # the FMA forward serves float32 only: no bf16 path
        sums = {**per_restore_sums(mine), **per_step_sums(mine, "ms"),
                **device_sums(mine)} if tc else {}
        emit("kernels", kernel=f"flash_attention_{which}", card=smi, shapes=mine, **sums)
        entries.append(dict(
            name=f"flash_attention_{which}", route="cuda",
            source=f"tair_tpu_torch/ops/csrc/{file}",
            replaces="tair_tpu/ops/flash_attention.py:168", shape=head_shape[1],
            max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], paths=paths, device_ms=head["device_ms"],
            device_ms_launches=head["device_ms_launches"],
            **({"ms_per_train_step": sums["ms_per_train_step"], "fma_ms": head["fma_ms"],
                "fma_device_ms": head["fma_device_ms"]} if tc else {}),
        ))
    return entries


def check_msda(rng: np.random.Generator, smi: str, steps: int) -> list:
    """K3 at every shape of K3_SHAPES and at the sparse encoder's NQ; two
    entries of the kernels line: the dense paths' (NQ = 9472) and the sparse
    encoder's (NQ = ENC_TOPK), whose ms is device time by CUDA-graph replay."""
    from tair_tpu_torch.ops import msda_reduce as mr

    lanes, k, d = 128, 16, 32
    rows = []
    for name, nq, per_pass in [*K3_SHAPES, K3_ENC_TOPK_SHAPE]:
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
            if name == K3_ENC_TOPK_SHAPE[0] and dtype == torch.bfloat16:
                def call():
                    return mr.msda_corner_reduce(g, *ws, k)

                device, sample = device_ms({"k3": (call, ("msda_corner_reduce_kernel",))})
                sparse = dict(graph_ms=graph_ms(call), device_ms=device["k3"],
                              device_ms_launches=sample["k3"], input_bytes=nbytes)
                rows[-1].update(sparse)
            del g, ws, out, ref
    head = next(r for r in rows if r["shape"] == "encoder" and r["dtype"] == "bfloat16")
    topk = next(r for r in rows if r["shape"] == K3_ENC_TOPK_SHAPE[0] and r["dtype"] == "bfloat16")
    emit("kernels", kernel="msda_corner_reduce_fwd", card=smi, shapes=rows,
         **per_restore_sums(rows), **per_step_sums(rows, "ms"),
         note=f"{K3_ENC_TOPK_SHAPE[0]} (NQ={ENC_TOPK}) is the sparse encoder's shape: "
              "graph_ms by CUDA events around the replay of a CUDA graph of 20 launches, "
              "device_ms by torch.profiler over 10 eager calls; on no dense path")
    common = dict(route="cuda", source="tair_tpu_torch/ops/csrc/msda_reduce.cu",
                  replaces="tair_tpu/ops/msda_reduce.py:150", library_ms=None)
    return [
        dict(name="msda_corner_reduce_fwd", **common,
             shape="NQ=9472 lanes=128 K=16 D=32 bfloat16", max_abs_err=head["max_abs_err"],
             ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
             bound_by=head["bound_by"], paths=("restore", "train"),
             **per_step_sums(rows, "ms")),
        # the same kernel at the sparse encoder's row count; its launches are
        # those at ENC_TOPK rows in phase enc_topk's request (the wrapper counts
        # them by row count), the kernel's other launches there are the entry above's
        dict(name=f"msda_corner_reduce_fwd_nq{ENC_TOPK}", **common, shape=f"NQ={ENC_TOPK} lanes=128 K=16 D=32 bfloat16",
             max_abs_err=topk["max_abs_err"], ms=topk["graph_ms"], plain_ms=topk["plain_ms"],
             bound_ms=topk["bound_ms"], bound_by=topk["bound_by"],
             wrapper_ms=topk["ms"], device_ms=topk["device_ms"],
             share_of_bound=topk["bound_ms"] / topk["graph_ms"], paths=("enc_topk",)),
    ]


def check_flash_bwd(rng: np.random.Generator, smi: str) -> list:
    """dQ and dK/dV kernels at the forward's shapes (all but the autoencoder's
    D=512, which is never differentiated), against the plain backward: the
    tensor-core dQ and dK/dV in bfloat16 with the FMA kernels beside them
    (checked too, timed in turns with them), the FMA kernels in float32. Each
    time stands beside its bound, the plain backward and autograd through
    PyTorch's fused attention (one call gives all three gradients, so that time
    stands beside the kernels' sum)."""
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
            mine = {kind: fa.kernel_name(dtype, d, kind) for kind in ("dq", "dkv")}
            out, lse = fa.flash_attention(q, k, v, scale)
            delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
            got = {
                which: fa._launch_backward_kernel(which, q, k, v, do, lse, delta, scale)
                for which in dict.fromkeys((*mine.values(), "dq", "dkv"))
            }
            torch.cuda.synchronize()
            refs = fa.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), out.float(), lse, do.float(), scale
            )
            held = {}
            for which, grads in got.items():
                if which.startswith("dq"):
                    names, grads, wants = ("dq",), (grads,), refs[:1]
                else:
                    names, wants = ("dk", "dv"), refs[1:]
                for gname, g, ref in zip(names, grads, wants):
                    err, share, mean = held_grad_error(g, ref, dtype)
                    held.setdefault(which, {})[gname] = dict(
                        max_abs_err=err, max_share_of_tol=share, mean_abs_plain=mean
                    )
                    if not share <= 1.0:
                        rtol, afrac = GRAD_TOL[dtype]
                        raise AssertionError(
                            f"flash_attention {which} {name} {dtype} {gname}: |d| {err}, "
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
            direct = (got[mine["dq"]], *got[mine["dkv"]])
            if not all(torch.equal(a, b_) for a, b_ in zip(via_fn, direct)):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: autograd through the Function "
                    "disagrees with the backward kernels called directly"
                )
            del leaves, via_fn, do_hm, got, direct
            qkv_bytes = (2 * tq + 2 * tk) * d * h * b * q.element_size()  # q, dO, k, v
            stats_bytes = 2 * 4 * tq * h * b                              # lse, delta
            prod = 2.0 * tq * tk * d * h * b                              # one product
            kernels = {
                which: (lambda which=which: fa._launch_backward_kernel(
                    which, q, k, v, do, lse, delta, scale), FLASH_KERNEL_NAMES[which])
                for which in dict.fromkeys((*mine.values(), "dq", "dkv"))
            }
            times = {}
            for kind, which in mine.items():
                if which != kind:  # a tensor-core kernel, in turns with the FMA one
                    times[kind] = in_turns(kernels[which][0], kernels[kind][0])
                else:
                    times[kind] = (time_ms(kernels[kind][0]), None, None)
            dev, sampled = device_ms(kernels)
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
            out_bytes = {"dq": tq * d * h * b, "dkv": 2 * tk * d * h * b}
            for kind, which in mine.items():
                ms, fma_ms, turns = times[kind]
                rows.append(dict(
                    kernel=which, **common, ms=ms, device_ms=dev[which],
                    device_ms_launches=sampled[which], held=held[which],
                    **({"fma_ms": fma_ms, "turns_ms": turns, "fma_device_ms": dev[kind],
                        "fma_device_ms_launches": sampled[kind],
                        "fma_held": held[kind]} if which != kind else {}),
                    **({"query_split": fa.dkv_query_split(b, h, tq, tk)}
                       if which == "dkv_tc" else {}),
                    **bound_of((3 if kind == "dq" else 4) * prod,
                               qkv_bytes + stats_bytes + out_bytes[kind] * q.element_size(),
                               dtype),
                ))
    entries = []
    for which, site, file, head_dtype, paths in (
        ("dq_tc", 229, "flash_attention_dq_tc.cu", "bfloat16", ("train",)),
        ("dkv_tc", 245, "flash_attention_dkv_tc.cu", "bfloat16", ("train",)),
        ("dq", 229, "flash_attention_bwd.cu", "float32", ("train_reference",)),
        ("dkv", 245, "flash_attention_bwd.cu", "float32", ("train_reference",)),
    ):
        mine = [r for r in rows if r["kernel"] == which]
        head = next(r for r in mine if r["shape"] == "unet_self_64" and r["dtype"] == head_dtype)
        tc = which.endswith("_tc")  # the FMA kernels run only in float32
        sums = {}
        if tc:
            for key in ("ms", "device_ms", "bound_ms", "plain_ms_dq_and_dkv",
                        "library_ms_dq_and_dkv"):
                sums.update(per_step_sums(mine, key))
        emit("kernels", kernel=f"flash_attention_{which}", card=smi, shapes=mine, **sums)
        entries.append(dict(
            name=f"flash_attention_{which}", route="cuda",
            source=f"tair_tpu_torch/ops/csrc/{file}",
            replaces=f"tair_tpu/ops/flash_attention.py:{site}",
            shape=f"Tq=Tk=4096 H=5 D=64 {head_dtype}",
            max_abs_err=max(g["max_abs_err"] for g in head["held"].values()),
            ms=head["ms"], plain_ms=head["plain_ms_dq_and_dkv"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms_dq_and_dkv"],
            plain_and_library_cover="dq + dkv (one call gives all three gradients)",
            paths=paths, device_ms=head["device_ms"],
            device_ms_launches=head["device_ms_launches"],
            **({"ms_per_train_step": sums["ms_per_train_step"], "fma_ms": head["fma_ms"],
                "fma_device_ms": head["fma_device_ms"]} if tc else {}),
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
        bound_by=head["bound_by"], library_ms=None, paths=("train",),
        **per_step_sums(rows, "ms"),
    )


# the profiler's kernel names of the two designs
K4_KERNEL_NAMES = {"band": ("patchify_band_kernel",), "per_piece": ("patchify_per_piece_kernel",)}


def patchify_host_parts(tp, value: torch.Tensor, levels) -> dict:
    """Host ms of each part of one call of the band kernel's wrapper, each
    timed alone by `host_ms`: the level tuple, the checks of value and the
    plan's lookup, the output's allocation, the device and stream lookups,
    and the ctypes call that launches the kernel (into one output, uncounted)."""
    b, s, h, d = value.shape
    tiles, n, g, slab = tp._plan(levels, value.shape, value.element_size(), value.device)
    out = tp._launch(value, levels)
    dev = value.device.index
    args = (value.data_ptr(), out.data_ptr(), tiles.data_ptr(), n, s, h, d, g,
            value.element_size(), *value.stride()[:3], slab,
            torch._C._cuda_getCurrentRawStream(dev))
    return dict(
        levels_tuple=host_ms(lambda: tuple((int(y), int(x)) for y, x in levels)),
        input_check_and_plan=host_ms(lambda: tp._plan(
            levels, tp._kernel_input(value).shape, value.element_size(), value.device)),
        output_empty=host_ms(lambda: torch.empty_like(out)),
        current_device=host_ms(torch.cuda.current_device),
        raw_stream=host_ms(lambda: torch._C._cuda_getCurrentRawStream(dev)),
        stream_object=host_ms(lambda: torch.cuda.current_stream().cuda_stream),
        ctypes_launch=host_ms(lambda: tp._FWD["fwd"](*args)),
    )


def check_patchify(rng: np.random.Generator, smi: str, steps: int) -> dict:
    """The patchify kernel (band design) and its first design (one thread per
    piece) against `patchify_value`, bit for bit (they move values), and the
    backward against autograd through `patchify_value`. Device time of one
    launch of each design by CUDA-graph replay, timed in turns, and by
    torch.profiler; the host's time to make one call."""
    from tair_tpu_torch.ops import patchify as tp

    rows = []
    for name, levels, b, h, d, per_pass in K4_SHAPES:
        s = sum(hl * wl for hl, wl in levels)
        extra = 2 if name.endswith("_strided") else 0  # heads cut off again below
        vn = rng.standard_normal((b, s, h + extra, d), dtype=np.float32)
        cn = rng.standard_normal((b * h * s, 4 * d), dtype=np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            value = torch.from_numpy(vn).cuda().to(dtype)[:, :, :h]
            cot = torch.from_numpy(cn).cuda().to(dtype)
            want = tp.patchify_value(value, levels)
            for design, table in (("band", tp.patchify_value_kernel(value, levels)),
                                  ("per_piece", tp._launch_per_piece(value, levels))):
                torch.cuda.synchronize()
                if table.dtype != dtype or not torch.equal(table, want):
                    raise AssertionError(
                        f"patchify {design} {name} {dtype}: the kernel's table is not equal to "
                        f"the plain version's, max |d| "
                        f"{(table.float() - want.float()).abs().max().item()}"
                    )
            # backward: the wrapper sums in float32 and rounds once; autograd through
            # the plain version run in float32 on the same values is the reference
            leaf = value.detach().requires_grad_(True)
            (got,) = torch.autograd.grad(tp.patchify_value_kernel(leaf, levels), leaf, cot)
            leaf32 = value.detach().float().requires_grad_(True)
            (ref,) = torch.autograd.grad(tp.patchify_value(leaf32, levels), leaf32, cot.float())
            # at most four addends an element: float32 order, or one bfloat16 ulp
            rtol, atol = (2.0 ** -7, 1e-6) if dtype == torch.bfloat16 else (1e-6, 1e-6)
            bwd_err, bwd_share = held_error(got, ref, rtol, atol)
            if got.dtype != dtype or not bwd_share <= 1.0:
                raise AssertionError(
                    f"patchify backward {name} {dtype}: |d| {bwd_err}, {bwd_share} of its "
                    f"tolerance {rtol} * |g| + {atol}"
                )
            del leaf, leaf32, got, ref, cot
            nbytes = (value.numel() + want.numel()) * value.element_size()
            designs = {
                "band": (lambda: tp._launch(value, levels), K4_KERNEL_NAMES["band"]),
                "per_piece": (lambda: tp._launch_per_piece(value, levels),
                              K4_KERNEL_NAMES["per_piece"]),
            }
            ms, per_piece_ms, turns = in_turns(designs["band"][0], designs["per_piece"][0],
                                               timer=graph_ms)
            dev, dev_sample = graph_device_ms(designs)
            eager, eager_sample = device_ms(designs)
            bound = bound_of(0.0, nbytes, dtype)
            _, tiles, heads_per_tile, slab = tp._plan(
                levels, value.shape, value.element_size(), value.device)
            rows.append(dict(
                shape=name, levels=[list(l) for l in levels], batch=b, heads=h, d=d,
                dtype=str(dtype).split(".")[-1], calls_per_restore=per_pass * steps,
                max_abs_err=0.0, equal_to_plain=True, per_piece_equal_to_plain=True,
                backward_max_abs_err=bwd_err, backward_rtol=rtol,
                backward_max_share_of_tol=bwd_share,
                value_contiguous=value.is_contiguous(), bytes=nbytes, tiles=tiles,
                heads_per_tile=heads_per_tile, slab_bytes=slab,
                ms=ms, per_piece_ms=per_piece_ms, turns_ms=turns,
                device_ms=dev["band"], per_piece_device_ms=dev["per_piece"],
                device_ms_launches=dev_sample,
                eager_device_ms=eager["band"], per_piece_eager_device_ms=eager["per_piece"],
                eager_device_ms_launches=eager_sample,
                share_of_bound=bound["bound_ms"] / ms,
                per_piece_share_of_bound=bound["bound_ms"] / per_piece_ms,
                wrapper_ms=time_ms(lambda: tp.patchify_value_kernel(value, levels)),
                plain_ms=time_ms(lambda: tp.patchify_value(value, levels)),
                library_ms=None, **bound,
            ))
            if name == "spotter" and dtype == torch.bfloat16:
                class FirstDesign(torch.autograd.Function):
                    # the wrapper's autograd.Function as it was with the first design
                    @staticmethod
                    def forward(ctx, v, lv):
                        ctx.value_shape, ctx.spatial_shapes = tuple(v.shape), lv
                        return tp._launch_per_piece(v, lv)

                def first_call():
                    # the user's call as it was with the first design: checks,
                    # level tuple, autograd.Function, then the entry typed, the
                    # level array made and the device entered on every call
                    tp._check(value.shape, levels)
                    return FirstDesign.apply(value, tuple((int(y), int(x)) for y, x in levels))

                before, after, host_turns = in_turns(
                    first_call, lambda: tp.patchify_value_kernel(value, levels), timer=host_ms)
                host = dict(before=before, after=after, turns=host_turns,
                            band_launch=host_ms(lambda: tp._launch(value, levels)))
                host_parts = patchify_host_parts(tp, value, levels)
            del value, want
    head = next(r for r in rows if r["shape"] == "spotter" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="patchify_value_fwd", card=smi, shapes=rows, **per_restore_sums(rows),
         host_ms_per_call=host, host_ms_of_parts=host_parts,
         note="ms and per_piece_ms: device time of one launch by CUDA events around the "
              "replay of a CUDA graph of 20 back-to-back launches, value warm in L2, band and "
              "first design in turns; device_ms: torch.profiler over one replay of the same "
              "graph; eager_device_ms: torch.profiler over 10 eager calls, each alone on the "
              "card between the host's launches (both per launch the profiler recorded, "
              "with the launches recorded against those made); "
              "wrapper_ms: CUDA events around eager calls "
              "(the host's time); host_ms_per_call: time.perf_counter over 1000 calls "
              "without a synchronise, the first design's user call and the band's in turns")
    return dict(
        name="patchify_value_fwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/patchify.cu",
        replaces="tair_tpu/ops/patchify.py:66",
        shape="B=1 S=9472 H=8 D=32 bfloat16", max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, paths=("restore_flatpatch",),
        device_ms=head["device_ms"], eager_device_ms=head["eager_device_ms"],
        device_ms_launches=head["device_ms_launches"]["band"],
        eager_device_ms_launches=head["eager_device_ms_launches"]["band"],
        per_piece_ms=head["per_piece_ms"],
        share_of_bound=head["share_of_bound"],
        host_ms_per_call=host["after"], first_design_host_ms_per_call=host["before"],
    )


def phase_probes(smi: str, reps: int):
    """The three probes: every probe kernel held against its plain version at
    the probe's shape with its time, bound and library call, then each probe
    driven through its own `run` with the counts set to 0 just before. Returns
    (entries of the kernels line, launches of the driven runs)."""
    from tair_tpu_torch.probes import dyngather, msda_lab, stream

    entries = []

    def entry(name, source, replaces, shape, err, ms, plain_ms, library_ms, nbytes, flops=0.0):
        entries.append(dict(
            name=name, route="cuda", source=f"tair_tpu_torch/ops/csrc/{source}",
            replaces=replaces, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, paths=("probes",),
            **bound_of(flops, nbytes, torch.float32),
        ))

    # P1: gather at the rate shape, bfloat16 table into float32
    G, C, R, S = (dyngather.RATE_SHAPE[k] for k in "GCRS")
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, S, (G, C, R, S), device="cuda", dtype=torch.int32, generator=gen)
    x = torch.randn((G, R, S), device="cuda", generator=gen).to(torch.bfloat16)
    want = dyngather.gather_plain(x, idx, torch.float32)
    idx64 = idx.long()
    x_planes = x[:, None].expand(-1, C, -1, -1)
    if not torch.equal(want, torch.take_along_dim(x_planes, idx64, dim=3).float()):
        raise AssertionError("the gather's plain version disagrees with torch.take_along_dim")
    plain_ms = time_ms(lambda: dyngather.gather_plain(x, idx, torch.float32), reps=3, inner=1)
    library_ms = time_ms(lambda: torch.take_along_dim(x_planes, idx64, dim=3), reps=3, inner=1)
    nbytes = x.numel() * 2 + idx.numel() * 4 + want.numel() * 4
    for where, site in (("global", 71), ("shared", 71)):
        got = dyngather.gather(x, idx, where, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):  # values are moved: equality
            raise AssertionError(f"probe gather {where} disagrees with its plain version")
        del got
        entry(f"probe_gather_{where}", "probe_gather.cu", f"scripts/dyngather_probe.py:{site}",
              f"x [{G},{R},{S}] bfloat16, idx [{G},{C},{R},{S}] int32 -> float32", 0.0,
              time_ms(lambda: dyngather.gather(x, idx, where, torch.float32), reps=3, inner=1),
              plain_ms, library_ms, nbytes)
    del idx, idx64, x, x_planes, want
    torch.cuda.empty_cache()

    # P2 and P3 share the 310 MB tensor
    g = stream.make_g("cuda")
    g_bytes = g.numel() * 2
    exact, tol = stream.reference(g)
    plain_ms = time_ms(lambda: stream.column_sums_plain(g), reps=3, inner=1)
    library_ms = time_ms(lambda: g.sum(0, dtype=torch.float32), reps=3, inner=1)
    for kernel, site, fn in (
        ("strided", 64, lambda: stream.column_sums(g, "strided", threads=256, unroll=8, blocks_per_sm=4)),
        ("pipeline", 132, lambda: stream.column_sums(g, "pipeline", threads=256, stages=8, chunk_rows=64)),
        ("bulk", 132, lambda: stream.column_sums(g, "bulk", threads=256, stages=4, chunk_rows=64)),
    ):
        out = fn()
        torch.cuda.synchronize()
        h = stream.held(out, exact, tol)  # raises beyond SUM_RTOL * sum|g|
        entry(f"probe_stream_{kernel}", "probe_stream.cu", f"scripts/stream_probe.py:{site}",
              f"g [{g.shape[0]},128] bfloat16 -> 128 float32 column sums, tol "
              f"{stream.SUM_RTOL} * sum|g| = {h['tol']:.3g}", h["max_abs_err"],
              time_ms(fn, reps=3, inner=2), plain_ms, library_ms, g_bytes + 512, float(g.numel()))
    del exact, tol

    g3, ws = msda_lab.make_inputs("cuda", g=g)
    k = msda_lab.K
    w_bytes = 4 * 4 * ws[0].numel()
    out_bytes = 4 * msda_lab.NQ * (msda_lab.LANES // k) * msda_lab.D
    plain_ms = time_ms(lambda: msda_lab.lab_plain("w32", g3, ws, k), reps=3, inner=1)
    for variant in msda_lab.VARIANTS:
        out = msda_lab.lab(variant, g3, ws, k)
        torch.cuda.synchronize()
        h = msda_lab.held(variant, out, g3, ws, k)  # raises beyond the variant's tolerance
        weighted = variant in ("w32", "w16")
        entry(f"probe_msda_lab_{variant}", "probe_msda_lab.cu", "scripts/msda_kernel_lab.py:176",
              f"NQ={msda_lab.NQ} lanes=128 K=16 D=32 bfloat16, tol {h['tol']:.3g}",
              h["max_abs_err"],
              time_ms(lambda: msda_lab.lab(variant, g3, ws, k), reps=3, inner=2),
              plain_ms if weighted else time_ms(
                  lambda: msda_lab.lab_plain(variant, g3, ws, k), reps=3, inner=1),
              None, g_bytes + out_bytes + (w_bytes if weighted else 0),
              {"copy": 0.0, "seg": 1.0}.get(variant, 2.0) * g.numel())
        del out
    del g3, ws

    # the probes as a user runs them, with the counts set to 0 just before
    reset_launch_counts()
    reports = [dyngather.run(reps=reps), stream.run(reps=reps, g=g), msda_lab.run(reps=reps, g=g)]
    torch.cuda.synchronize()
    counts = launch_counts()
    del g
    torch.cuda.empty_cache()
    for report in reports:
        emit("probes", card=smi, **report)
    emit("probes", kernels=entries, launches={e["name"]: counts[e["name"]] for e in entries})
    return entries, counts


def phase_reference(seed: int) -> dict:
    """The whole loop on a small input against a reference: the tiny model in
    float32 on the card (attention through the FMA forward, msda through the
    reduce kernel) and the same weights, input and noise on the CPU (plain
    versions). Returns the launch counts of the card's default request."""
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
    others = [k for k, n in counts.items() if n and k not in (
        "flash_attention_fwd", "msda_corner_reduce_fwd")]
    if others:  # float32: no tensor-core kernel, and no backward
        raise AssertionError(f"the float32 restore loop launched other kernels: {others}")
    img_r, tok_r = ref.restore_fused_feedback(
        lq, steps=steps, score_threshold=0.0, x_T=x_T, step_noises=noises
    )
    err = (img_d.cpu() - img_r).abs().max().item()
    if not err <= tol or not torch.equal(tok_d.cpu(), tok_r) or min(launches) == 0:
        raise AssertionError(
            f"tiny model on the card against the CPU: |d image| {err} (tol {tol}), "
            f"tokens equal {torch.equal(tok_d.cpu(), tok_r)}, launches {launches}"
        )
    # the same request with every deformable attention on the flatpatch core and
    # the patchify kernel: the same function, summed in another order
    patch_tol = 1e-4
    sites = set_msda(dut.testr, core="flatpatch", patchify="kernel")
    reset_launch_counts()
    img_p, tok_p = dut.restore_fused_feedback(
        lq.cuda(), steps=steps, score_threshold=0.0, x_T=x_T.cuda(),
        step_noises=[n.cuda() for n in noises],
    )
    torch.cuda.synchronize()
    k4 = launch_counts()["patchify_value_fwd"]
    patch_err = (img_p - img_d).abs().max().item()
    if not patch_err <= patch_tol or not torch.equal(tok_p, tok_d) or k4 != sites * steps:
        raise AssertionError(
            f"tiny model, flatpatch + patchify kernel against flatlanes: |d image| {patch_err} "
            f"(tol {patch_tol}), tokens equal {torch.equal(tok_p, tok_d)}, patchify launches "
            f"{k4} (structure says {sites * steps})"
        )
    emit(
        "reference", model="build_tiny_model float32", steps=steps, max_abs_err=err,
        tol=tol, tokens_equal=True, prompt_tokens=int((tok_r != 0).sum().item()),
        flash_launches=launches[0], msda_launches=launches[1],
        flatpatch_vs_flatlanes_max_abs_err=patch_err, flatpatch_tol=patch_tol,
        flatpatch_tokens_equal=True, patchify_launches=k4,
    )
    return counts


def set_msda(testr, **fields) -> int:
    """Set fields (core, patchify, ...) on every deformable attention of the
    spotter; returns how many there are."""
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    mods = [m for m in testr.modules() if isinstance(m, MSDeformAttn)]
    for m in mods:
        for key, val in fields.items():
            setattr(m, key, val)
    return len(mods)


MSDA_DEFAULT = dict(core="flatlanes", reduce_mode="kernel", patchify="concat")


def flash_launches(model, dtype: torch.dtype, steps: int, backward: bool) -> dict:
    """Flash-attention launches by kernel (the names of `launch_counts`) that
    the model's structure asks for when it computes in `dtype`: every attention
    of the UNet and the ControlNet runs its forward in each of `steps` passes,
    and dQ and dK/dV once if `backward`; the autoencoder's middle attention
    (D = 512, never differentiated) runs twice (encode and decode in a request,
    the two encodes of a training step). Each call on the kernel that
    `kernel_name` picks for its head width."""
    from tair_tpu_torch.models.attention import CrossAttention
    from tair_tpu_torch.models.vae import AttnBlock
    from tair_tpu_torch.ops import flash_attention as fa

    counts = dict.fromkeys(fa.launches, 0)
    for net in (model.cldm.unet, model.cldm.controlnet):
        for m in net.modules():
            if isinstance(m, CrossAttention):
                counts[fa.kernel_name(dtype, m.dim_head, "fwd")] += steps
                for kind in ("dq", "dkv") if backward else ():
                    counts[fa.kernel_name(dtype, m.dim_head, kind)] += 1
    (vae_width,) = {m.q.out_channels for m in model.cldm.vae.modules() if isinstance(m, AttnBlock)}
    counts[fa.kernel_name(dtype, vae_width, "fwd")] += 2
    return {f"flash_attention_{k}": n for k, n in counts.items()}


def check_bf16_flash(want: dict, steps: int, backward: bool) -> None:
    """The structure's flash launches of a full-width bfloat16 path are all on
    the tensor-core kernels: 46 attentions a pass (and their dQ and dK/dV once
    when `backward`), 2 D = 512 forwards; none on an FMA kernel."""
    expect = {
        k: n * (steps if k == "flash_attention_fwd_tc" else 1)
        for k, n in BF16_FLASH_PER_STEP.items() if backward or "fwd" in k
    }
    flash = {k: n for k, n in want.items() if k.startswith("flash_attention_") and n}
    if flash != expect:
        raise AssertionError(f"the model's bfloat16 flash launches {flash}, expected {expect}")


def matchings_per_criterion(model) -> int:
    """Exact matchings (J1 launches, one per batch) of one call of the TESTR
    criterion: the last decoder layer's output, the auxiliary outputs of the
    other decoder layers and the encoder proposals."""
    return model.testr.cfg.num_decoder_layers + 1


def predicted_train_launches(model, compute_dtype: torch.dtype) -> dict:
    """Kernel launches of one stage-3 training step, from the model's
    structure: `flash_launches` of one pass with the backward; every deformable
    attention of the spotter runs the reduce forward and backward once; the
    criterion's matchings run J1 once each."""
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    msda = sum(isinstance(m, MSDeformAttn) for m in model.testr.modules())
    return {
        **dict.fromkeys(launch_counts(), 0),  # no other kernel runs in a training step
        **flash_launches(model, compute_dtype, 1, backward=True),
        "msda_corner_reduce_fwd": msda, "msda_corner_reduce_bwd": msda,
        "jv_assign": matchings_per_criterion(model),
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


def make_trainer(model, compute_dtype, marks=None, matcher="hungarian", state=None):
    """(state, step) of stage 3, the criterion matching with `matcher`.
    `marks`, a `StageMarks`, is told when the criterion has returned. A
    `state` given is shared, not made anew."""
    from tair_tpu_torch.diffusion.diffusion import Diffusion
    from tair_tpu_torch.spotter.losses import CriterionConfig
    from tair_tpu_torch.train.step import create_train_state, make_train_step

    spotter_loss = model.spotter_loss_fn(CriterionConfig(matcher=matcher))

    def marked_loss(feats, batch):
        out = spotter_loss(feats, batch)
        if marks is not None:
            marks.mark("criterion_and_matcher")
        return out

    if state is None:
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


def phase_train_reference(seed: int) -> dict:
    """One stage-3 step of the tiny model in float32 on the card, through the
    FMA flash kernels and the msda kernels, against the same weights, batch and
    draws on the CPU through the plain versions. Returns the card's launch
    counts."""
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
    want_launches = predicted_train_launches(dut, torch.float32)
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
    return card["launches"]


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
    want = predicted_train_launches(model, torch.bfloat16)
    check_bf16_flash(want, 1, backward=True)
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
    emit("train_matcher", card=torch.cuda.get_device_name(0),
         **matcher_step_turns(model, state, batch, gen, want["jv_assign"]))
    if profile:
        phase_profile("train_profile", lambda: one_step()[0])
    return timed[-1][2]


def matcher_step_turns(model, state, batch, gen, matchings: int) -> dict:
    """One training step with the exact matcher on the card ("hungarian": J1)
    and on the host ("hungarian_host": a copy to the host, the native solver,
    a copy back), on the same state: the host synchronisations of a step
    (torch's sync debug mode; those of this script's own gradient check
    apart), and the step's seconds in turns (card, host, host, card)."""
    steps = {m: make_trainer(model, torch.bfloat16, matcher=m, state=state)[1]
             for m in ("hungarian", "hungarian_host")}

    def run(m) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps[m](state, batch, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run("hungarian_host")  # builds the native library outside the counts and the turns
    order = ("hungarian", "hungarian_host", "hungarian_host", "hungarian")
    turns = [run(m) for m in order]
    syncs = {}
    for m in steps:
        _, sites = host_syncs(lambda _, m=m: steps[m](state, batch, generator=gen), 1)
        syncs[m] = dict(sites=sites, count=sum(
            n for site, n in sites.items() if not site.startswith("chip_smoke.py:")))
    fewer = syncs["hungarian_host"]["count"] - syncs["hungarian"]["count"]
    if fewer < matchings:
        raise AssertionError(f"train: J1 saves {fewer} host syncs a step, not one per matching "
                             f"({matchings}): {syncs}")
    return dict(
        matchings_per_step=matchings,
        host_syncs_per_step={m: v["count"] for m, v in syncs.items()},
        host_sync_sites=syncs, fewer_host_syncs_with_j1=fewer,
        step_seconds_turns=[[m, t] for m, t in zip(order, turns)],
        median_step_seconds={"hungarian": (turns[0] + turns[3]) / 2,
                             "hungarian_host": (turns[1] + turns[2]) / 2},
        note="host syncs: CUDA's synchronisation warnings in one step, those raised in this "
             "script (its gradient check's .item()) apart; the same state takes every step",
    )


TRAIN_ENTRY_CONFIG = "configs/train_chip_demo.yaml"
VAL_STEPS, VAL_TAGS = 10, (10,)  # the trainer's validation: 10 steps, features of the last


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def phase_train_entry(seed: int, iqa_weights: dict) -> dict:
    """The port's trainer as a user starts it (``python -m tair_tpu_torch.train``)
    on configs/train_chip_demo.yaml in a scratch directory: three full-width
    steps that end in a checkpoint of the whole train state, then a second run
    that resumes from it at step 3 and takes one step. Then, in this process,
    the trainer's validation (10 steps at 256 x 256, features of step 10, PSNR,
    SSIM, OCR loss, NIQE fitted on the batch's ground truth, and the five
    learned metrics from `iqa_weights`) on the weights of the last checkpoint, the float16 weight
    export in the JAX layout and its reload, and the degradation of one batch
    timed on the card. Returns the launch counts of the trainer's steps and of
    the validation."""
    import shutil
    import tempfile

    from tair_tpu_torch.config import build_dataset, build_model, load_config
    from tair_tpu_torch.data.batch_transform import degrade_batch
    from tair_tpu_torch.data.satext import data_iterator
    from tair_tpu_torch.train import checkpoint as ckpt
    from tair_tpu_torch.train.__main__ import run_validation, stream_seed
    from tair_tpu_torch.weights.convert import jax_param_shapes

    root = Path(__file__).resolve().parent
    config = root / TRAIN_ENTRY_CONFIG
    cfg = load_config(str(config))
    torch.cuda.empty_cache()  # the trainer runs in processes of its own
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train_entry_", dir=root / "build"))
    try:
        free_gb = shutil.disk_usage(work).free / 1e9
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
        runs = []
        for max_steps in (3, 4):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tair_tpu_torch.train", "--config", str(config),
                 "--max-steps", str(max_steps)],
                cwd=work, env=env, capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                raise AssertionError(
                    f"the trainer (--max-steps {max_steps}) exited with {proc.returncode}:\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}"
                )
            runs.append(dict(seconds=time.perf_counter() - t0, stdout=proc.stdout))
        exp = work / Path(cfg.train.exp_dir)
        steps = read_jsonl(exp / "steps.jsonl")
        records = read_jsonl(exp / "metrics.jsonl")
        if [r["step"] for r in steps] != [1, 2, 3, 4]:
            raise AssertionError(f"train_entry: steps {[r['step'] for r in steps]}, want 1-4")
        if "at step 3" not in runs[1]["stdout"]:
            raise AssertionError(f"train_entry: the second run did not resume at step 3:\n"
                                 f"{runs[1]['stdout'][-2000:]}")
        for r in steps:
            losses = {k: r[k] for k in ("loss_total", "loss_diffusion", "loss_ocr")}
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"train_entry step {r['step']}: a loss is not finite: {losses}")
            total = r["loss_diffusion"] + TRAIN_OCR_WEIGHT * r["loss_ocr"]
            if not abs(r["loss_total"] - total) <= 1e-5 * abs(total):
                raise AssertionError(f"train_entry step {r['step']}: loss_total "
                                     f"{r['loss_total']} is not {total}")
        saved = next(r for r in records if r["step"] == 3 and "checkpoint/write_seconds" in r)
        restored = next(r for r in records if r["step"] == 3 and "checkpoint/read_seconds" in r)
        sums = {k[len("checkpoint/saved_"):]: v for k, v in saved.items()
                if k.startswith("checkpoint/saved_")}
        mismatched = {k: (v, restored[f"checkpoint/restored_{k}"]) for k, v in sums.items()
                      if restored[f"checkpoint/restored_{k}"] != v}
        if len(sums) != 7 or mismatched:
            raise AssertionError(f"train_entry: the restored state differs from the saved one: "
                                 f"{mismatched or sums}")
        last_write = next(r for r in records if r["step"] == 4 and "checkpoint/write_seconds" in r)

        # the trainer's model, as the last checkpoint holds it
        dev = torch.device("cuda")
        model = build_model(cfg, dev, training=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = torch.load(Path(ckpt.latest_checkpoint(str(exp / "checkpoints"))) /
                           ckpt.CHECKPOINT_FILE, map_location="cpu", mmap=True,
                           weights_only=True)
        model.load_state_dict(state["model"], strict=True)
        del state
        torch.cuda.synchronize()
        load_model_s = time.perf_counter() - t0

        want = predicted_train_launches(model, torch.bfloat16)
        check_bf16_flash(want, 1, backward=True)
        want_step = {k: n for k, n in want.items() if n}
        for r in steps:
            if r["launches"] != want_step:
                raise AssertionError(f"train_entry step {r['step']} launches {r['launches']}, "
                                     f"structure says {want_step}")

        # float16 export in the JAX package's layout, and its reload
        names = {key: leaf.shape for key, leaf in ckpt.flat_items(jax_param_shapes(model))}
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        export = work / "params.npz"
        t0 = time.perf_counter()
        ckpt.save_params(str(export), model, dtype=np.float16)
        export_s = time.perf_counter() - t0
        with np.load(export) as data:
            stored = {k: data[k].shape for k in data.files}
            dtypes = {str(data[k].dtype) for k in data.files}
        if stored != names or dtypes != {"float16"}:
            raise AssertionError(f"train_entry: the export's keys or dtypes differ from the JAX "
                                 f"layout ({len(stored)} keys, {len(names)} expected, {dtypes})")
        t0 = time.perf_counter()
        ckpt.load_params(str(export), model)
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        worst = 0.0
        for n, p in model.named_parameters():
            err = (p.detach() - before[n]).abs()
            tol = 2.0 ** -11 * before[n].abs() + 2.0 ** -24  # float16 rounding
            worst = max(worst, (err / tol).max().item())
        if worst > 1.0:
            raise AssertionError(f"train_entry: the reloaded export is {worst} x float16 "
                                 "rounding away from the weights")
        del before

        # one batch of the trainer's pipeline, degraded on the card
        it = data_iterator(build_dataset(cfg, "TRAIN"), cfg.train.batch_size,
                           seed=cfg.train.seed, max_inst=cfg.dataset.max_instances)
        raw = next(it)
        it.close()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                 if isinstance(v, np.ndarray)}

        def degrade():
            return degrade_batch(
                batch["hq"], batch["kernel1"], batch["kernel2"], batch["sinc_kernel"],
                cfg.degradation, rng=np.random.default_rng(stream_seed(seed, 1, 0)),
                generator=torch.Generator(device=dev).manual_seed(seed))

        gt, lq = degrade()
        size = cfg.dataset.out_size
        on_card = gt.device.type == lq.device.type == "cuda"
        if gt.shape != (cfg.train.batch_size, size, size, 3) or lq.shape != gt.shape \
                or not on_card or not (-1 <= gt.min() <= gt.max() <= 1) \
                or not (0 <= lq.min() <= lq.max() <= 1):
            raise AssertionError(f"train_entry: degrade_batch gave gt {tuple(gt.shape)} on "
                                 f"{gt.device} in [{gt.min()}, {gt.max()}], lq {tuple(lq.shape)} "
                                 f"in [{lq.min()}, {lq.max()}]")
        degrade_ms = time_ms(degrade, warmup=1, reps=5, inner=1)

        def degrade_wall() -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            degrade()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        # device busy seconds of one call, against its wall seconds
        degrade_prof = {k: v for k, v in profiled(degrade_wall).items() if k != "top_kernels"}

        # the trainer's validation
        targets = {k: batch[k] for k in ("inst_mask", "boxes", "ctrl_points", "texts")}
        for m, w in iqa_weights.items():
            setattr(cfg.val, f"{m}_weights", w)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = run_validation(model, cfg, gt, lq, batch["tokens"], n_images=1, steps=VAL_STEPS,
                             feat_iterations=VAL_TAGS, targets=targets, image_dir=str(work / "val"))
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        val_launches = launch_counts()
        from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

        msda = sum(isinstance(m, MSDeformAttn) for m in model.testr.modules())
        want_val = {**dict.fromkeys(val_launches, 0),
                    **flash_launches(model, torch.bfloat16, VAL_STEPS, backward=False),
                    "msda_corner_reduce_fwd": msda * len(VAL_TAGS),
                    "jv_assign": matchings_per_criterion(model) * len(VAL_TAGS)}  # its OCR loss
        if val_launches != want_val:
            raise AssertionError(f"train_entry validation launches {val_launches}, "
                                 f"structure says {want_val}")
        want_keys = {"psnr", "ssim", f"ocr_loss_iter{VAL_TAGS[0]}", "niqe", *iqa_weights}
        if set(val) != want_keys or not all(np.isfinite(v) for v in val.values()):
            raise AssertionError(f"train_entry: validation metrics {val}, want {want_keys} finite")
        if not (work / "val" / "val_0.png").is_file():
            raise AssertionError("train_entry: validation wrote no image")

        path_launches = dict(val_launches)
        for r in steps:
            for k, n in r["launches"].items():
                path_launches[k] += n
        step_s = [r["seconds"] for r in steps]
        emit(
            "train_entry", command="python -m tair_tpu_torch.train --config "
            f"{TRAIN_ENTRY_CONFIG} --max-steps 3, then --max-steps 4 (resume)",
            geometry="build_default_model, stage 3, float32 master weights, bfloat16 compute, "
            "SyntheticSAText 256x256, batch 1, 8 padded instances",
            trainer_process_seconds=[r["seconds"] for r in runs],
            step_seconds=step_s, median_step_seconds_steps_2_3=statistics.median(step_s[1:3]),
            host_batch_seconds=[r["host_batch_seconds"] for r in steps],
            data_wait_seconds=[r["data_wait_seconds"] for r in steps],
            degrade_ms_cuda_events_in_trainer=[r["degrade_ms"] for r in steps],
            degrade_ms_cuda_events=degrade_ms, degrade_device=degrade_prof,
            losses=[{k: r[k] for k in r if k.startswith("loss_")} for r in steps],
            peak_memory_bytes_trainer=max(r["peak_memory_bytes"] for r in steps),
            checkpoint_write_seconds=[saved["checkpoint/write_seconds"],
                                      last_write["checkpoint/write_seconds"]],
            checkpoint_read_seconds=restored["checkpoint/read_seconds"],
            checkpoint_gigabytes=saved["checkpoint/gigabytes"], checksums_equal=True,
            free_disk_gigabytes=free_gb, checkpoint_model_load_seconds=load_model_s,
            float16_export_seconds=export_s, float16_export_reload_seconds=reload_s,
            float16_export_gigabytes=export.stat().st_size / 1e9,
            float16_export_keys=len(stored), float16_reload_worst_share_of_rounding=worst,
            validation_seconds=val_s, validation=val,
            validation_peak_memory_bytes=torch.cuda.max_memory_allocated(),
            launches_per_step=want_step, validation_launches={k: n for k, n in val_launches.items() if n},
        )
        return path_launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the learned IQA metrics (phase iqa): scored on 512 x 512 images; the card's
# score held against the CPU's on the same weights and input:
# |card - CPU| <= IQA_TOL * max(1, |CPU|) (float32 on both sides with TF32 off,
# sums in another order through up to 12 ViT and 8 Swin blocks)
IQA_SIZE = 512
IQA_TOL = 1e-4
# parameters whose seeded values are 0.02-normal (embeddings, position tables)
_SMALL_PARAMS = ("cls_token", "pos_embed", "positional_embedding", "spatial_embedding",
                 "scale_embedding", "relative_position_bias_table")


def seeded_tree(build, seed: int) -> dict:
    """The JAX-layout tree of the module `build()` makes, with weights from a
    seed: normal with variance 1/fan_in, embeddings and position tables
    0.02-normal, norm scales and batch-norm variances 1, other vectors 0, and
    DISTS' alpha and beta its own init, normal(0.1, 0.01)."""
    from tair_tpu_torch.weights.convert import module_param_shapes, to_jax_tree

    with torch.device("meta"):
        module = build()
    module = module.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("alpha", "beta"):
                p.copy_(0.1 + 0.01 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 1:
                p.fill_(1.0 if leaf in ("weight", "var") else 0.0)
            else:
                std = 0.02 if leaf in _SMALL_PARAMS else p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return to_jax_tree(module.state_dict(), module_param_shapes(module))


def write_iqa_checkpoints(root: Path, seed: int) -> dict:
    """Each learned metric's checkpoint at full width in its published layout,
    written under `root` by the port's exporters from seeded trees: torchvision
    AlexNet + LPIPS lin, torchvision VGG16 + DISTS weights.pt, OpenAI CLIP RN50
    (its 12-layer width-512 text tower), IIGROUP/MANIQA (ViT-B/8 at 224, 2 + 2
    TAB blocks and Swin stages), MUSIQ (hidden 384, 14 layers, scales 384 and
    224 besides the image's own). Returns each metric's val.<name>_weights
    entry."""
    from tair_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower
    from tair_tpu_torch.utils import clipiqa, dists, lpips, maniqa, musiq
    from tair_tpu_torch.weights import export as tx

    def save(name, sd):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, root / name)
        return str(root / name)

    root.mkdir(parents=True, exist_ok=True)
    out = {}
    tree = seeded_tree(lpips.LPIPS, seed)
    for i in range(5):  # LPIPS's heads weigh squared differences: non-negative, as trained
        tree[f"lin{i}"]["kernel"] = np.abs(tree[f"lin{i}"]["kernel"])
    alex, lin = tx.export_lpips(tree)
    out["lpips"] = f"{save('alexnet.pth', alex)}:{save('lpips_lin.pth', lin)}"
    vgg, weights = tx.export_dists(seeded_tree(dists.DISTS, seed + 1))
    out["dists"] = f"{save('vgg16.pth', vgg)}:{save('dists_weights.pt', weights)}"
    vcfg = clipiqa.ModifiedResNetConfig()
    tcfg = CLIPTextConfig(width=512, heads=8, layers=12, layer="last", act="quick_gelu")
    gen = torch.Generator().manual_seed(seed + 2)
    tree = {"visual": seeded_tree(lambda: clipiqa.ModifiedResNet(vcfg), seed + 3),
            "text": seeded_tree(lambda: CLIPTextTower(tcfg), seed + 4),
            "text_projection": (torch.randn(tcfg.width, vcfg.embed_dim, generator=gen)
                                * tcfg.width ** -0.5).numpy(),
            "logit_scale": np.asarray(np.log(100.0), np.float32)}
    out["clipiqa"] = save("RN50.pt", tx.export_clipiqa(tree, vcfg, tcfg))
    mcfg = maniqa.MANIQAConfig()
    out["maniqa"] = save("ckpt_koniq10k.pt", tx.export_maniqa(
        seeded_tree(lambda: maniqa.MANIQA(mcfg), seed + 5), mcfg, "module."))
    qcfg = musiq.MUSIQConfig()
    out["musiq"] = save("musiq_koniq_ckpt.pth", tx.export_musiq(
        seeded_tree(lambda: musiq.MUSIQ(qcfg), seed + 6), qcfg, published=True))
    return out


def phase_iqa(weights: dict, seed: int, smi: str) -> None:
    """Each learned metric at full width, read by ``from_torch`` from the
    checkpoints of `write_iqa_checkpoints`, scoring a 512 x 512 SyntheticSAText
    image degraded on the card (LPIPS and DISTS against its ground truth):
    milliseconds per image (CUDA events, median of 5 calls after a warm-up),
    peak device memory of a call, a call's device busy time, idle share and
    top kernels (torch.profiler), two calls bit-equal, and the card's score
    against the CPU's with the same weights on the same input (MANIQA on one
    224 x 224 crop with num_crops=1: its 20 crops at full width are too slow
    for the CPU here)."""
    import copy

    from tair_tpu_torch.utils.iqa import METRICS, build_metric, score

    t_phase = time.perf_counter()
    lq, gt = synthetic_pairs(1, IQA_SIZE, seed)
    a, b = torch.from_numpy(lq).cuda(), torch.from_numpy(gt).cuda()
    report = {}
    for name in METRICS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric = build_metric(name, weights[name], "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        def run():
            return score(metric, name, a, b)

        first, second = run(), run()
        if first.shape != (1,) or not torch.isfinite(first).all():
            raise AssertionError(f"iqa {name}: score {first}")
        ms = time_ms(run, warmup=1, reps=5, inner=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        def wall() -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        prof = profiled(wall)
        prof["top_kernels"] = prof["top_kernels"][:3]

        # the same weights and input on the CPU
        card, x, y, size = metric, a, b, IQA_SIZE
        if name == "maniqa":
            size = metric.cfg.vit.img_size
            card = copy.copy(metric)
            card.num_crops = 1
            x, y = a[:, :size, :size], b[:, :size, :size]
        cpu = build_metric(name, weights[name], "cpu")
        if name == "maniqa":
            cpu.num_crops = 1
        got = score(card, name, x, y).item()
        want = score(cpu, name, x.cpu(), y.cpu()).item()
        err = abs(got - want)
        tol = IQA_TOL * max(1.0, abs(want))
        if not err <= tol:
            raise AssertionError(f"iqa {name}: card {got} against CPU {want}: |d| {err} > {tol}")
        report[name] = dict(
            ms_per_image_cuda_events=ms, peak_memory_bytes=peak, load_seconds=load_s,
            device=prof,
            score=first.item(), repeat_bit_equal=bool(torch.equal(first, second)),
            against_cpu=dict(size=size, card=got, cpu=want, max_abs_err=err, tol=tol),
        )
        if not report[name]["repeat_bit_equal"]:
            raise AssertionError(f"iqa {name}: two calls differ: {first} {second}")
        del metric, card, cpu
        torch.cuda.empty_cache()
    emit("iqa", device=smi, image=f"{IQA_SIZE}x{IQA_SIZE} SyntheticSAText, degraded on the card",
         metrics=report, phase_seconds=time.perf_counter() - t_phase)


VAL_CONFIG = "configs/val.yaml"
SPOTTER_EVAL_CONFIG = "configs/train_chip_demo.yaml"


def run_entry_point(module: str, args: list, cwd: Path) -> dict:
    """``python -m module args`` in `cwd` as a user starts it: its stdout, the
    JSON line each unit of work (image, batch) printed to stderr, and the
    process's seconds. Raises when it fails."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited with {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    reports = [json.loads(line) for line in proc.stderr.splitlines() if line.startswith("{")]
    return dict(stdout=proc.stdout, reports=reports, seconds=seconds)


def serving_structure():
    """The default model on the meta device: the structure that sets the
    kernel launches of the serving paths, without weights."""
    from tair_tpu_torch.pipeline import build_default_model

    return build_default_model(dtype=torch.bfloat16, device="meta")


def serving_launches(structure, unet_passes: int, spotter_passes: int) -> dict:
    """Launches of one request (or batch) of the bfloat16 serving paths: every
    UNet/ControlNet attention per UNet pass on the tensor-core forward, the
    autoencoder's two D = 512 forwards (encode and decode of a request, or two
    encodes), the 18 msda reduces per spotter pass; whatever the batch."""
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    flash = flash_launches(structure, torch.bfloat16, unet_passes, backward=False)
    check_bf16_flash(flash, unet_passes, backward=False)
    msda = sum(isinstance(m, MSDeformAttn) for m in structure.testr.modules())
    want = {**flash, "msda_corner_reduce_fwd": msda * spotter_passes}
    return {k: n for k, n in want.items() if n}


def check_reports(phase: str, reports: list, want: dict, n: int) -> dict:
    """Each of the `n` units' launches equal `want` (and no other kernel
    launched); returns the launches of all of them by kernel."""
    if len(reports) != n:
        raise AssertionError(f"{phase}: {len(reports)} reports, expected {n}")
    total = {}
    for r in reports:
        if r["launches"] != want:
            raise AssertionError(f"{phase}: launches {r['launches']}, structure says {want}")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def synthetic_pairs(n: int, size: int, seed: int):
    """n (lq, gt) pairs of [size, size, 3] numpy images in [0, 1]:
    SyntheticSAText images degraded on the card by ``degrade_batch`` (the
    trainer's RealESRGAN pipeline, default settings)."""
    from tair_tpu_torch.data.batch_transform import degrade_batch
    from tair_tpu_torch.data.satext import SyntheticSAText, collate

    raw = collate([SyntheticSAText(size=size, length=n, seed=seed)[i] for i in range(n)])
    dev = torch.device("cuda")
    gt, lq = degrade_batch(
        *(torch.from_numpy(raw[k]).to(dev) for k in ("hq", "kernel1", "kernel2", "sinc_kernel")),
        rng=np.random.default_rng(seed), generator=torch.Generator(device=dev).manual_seed(seed))
    return lq.cpu().numpy(), ((gt + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy()


def serving_config(path: Path, **val_fields) -> Path:
    """configs/val.yaml with the `val` fields given set (the block is the
    file's last)."""
    root = Path(__file__).resolve().parent
    lines = []
    for line in (root / VAL_CONFIG).read_text().splitlines():
        key = line.strip().split(":")[0]
        if line.startswith("  ") and key in val_fields:
            line = f"  {key}: {val_fields.pop(key)}"
        lines.append(line)
    lines += [f"  {key}: {value}" for key, value in val_fields.items()]
    path.write_text("\n".join(lines) + "\n")
    return path


def check_images(phase: str, out: Path, names: list, hw: tuple) -> None:
    from tair_tpu_torch.utils.image_io import load_image

    for name in names:
        img = load_image(str(out / name))
        if img.shape != (*hw, 3) or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
            raise AssertionError(f"{phase}: {name} is {img.shape} in [{img.min()}, {img.max()}]")


def check_metrics(phase: str, path: Path, keys: set, n: int) -> list:
    records = read_jsonl(path)
    if len(records) != n or any(set(r) != keys for r in records):
        raise AssertionError(f"{phase}: {path.name} holds {records}, want {n} records of {keys}")
    for r in records:
        if not (0 < r["psnr"] < 100 and -1 <= r["ssim"] <= 1):
            raise AssertionError(f"{phase}: metrics out of range: {r}")
    return records


def count_host_syncs(model, lq, steps=(2, 3)) -> dict:
    """Host synchronisations of one denoising step of each restore loop at
    512 x 512, batch 1: CUDA's synchronisation warnings (torch's sync debug
    mode) of requests of 2 and 3 steps, their difference."""
    def feedback(n):
        model.restore_with_ocr_feedback(
            lq, torch.Generator(device=lq.device).manual_seed(0), steps=n, score_threshold=0.0)

    def fused(n):
        model.restore_fused_feedback(
            lq, torch.Generator(device=lq.device).manual_seed(0), steps=n, score_threshold=0.0)

    return {name: syncs_per_step(fn, steps)
            for name, fn in (("caption_feedback", feedback), ("fused", fused))}


def host_syncs(fn, n):
    """(count, {file:line: count}) of CUDA's synchronisation warnings (torch's
    sync debug mode) of fn(n)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sum(sites.values()), sites


def syncs_per_step(fn, steps=(2, 3)) -> dict:
    """Host synchronisations of `fn(n)`, a request of n steps, after a warm-up
    request: requests of 2 and 3 steps, and their difference, one step's."""
    fn(steps[0])
    (short, _), (long, sites) = (host_syncs(fn, n) for n in steps)
    return dict(per_request={str(steps[0]): short, str(steps[1]): long},
                per_step=long - short, sites_of_the_longer_request=sites)


VAL_KEYS = {"step", "time", "image", "pred_texts", "psnr", "ssim"}


def phase_val(structure, seed: int, host_syncs: dict, iqa_weights: dict) -> dict:
    """``python -m tair_tpu_torch.val`` as a user starts it, on two 512 x 512
    LQ/GT pairs (SyntheticSAText, degraded on the card) with configs/val.yaml's
    settings (but score_threshold 0) and the five learned metrics' checkpoints
    (`iqa_weights`), once with the host-feedback CAPTION loop (the default)
    and once ``--fused``, SERVE_STEPS steps each: every image's line carries
    all five scores, finite. Returns the launch counts of all four requests."""
    import shutil
    import tempfile

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="val_", dir=root / "build"))
    try:
        lq, gt = synthetic_pairs(2, 512, seed)
        from tair_tpu_torch.utils.image_io import save_image

        for d, imgs in (("lq", lq), ("gt", gt)):
            (work / d).mkdir()
            for i, img in enumerate(imgs):
                save_image(str(work / d / f"img{i}.png"), img)
        want = serving_launches(structure, SERVE_STEPS, SERVE_STEPS)
        runs, launches = {}, {}
        for mode, extra in (("caption_feedback", []), ("fused", ["--fused"])):
            out = work / f"out_{mode}"
            # score_threshold 0 keeps every proposal of the randomly initialised
            # spotter, so the prompts carry words (and the CAPTION ones pass 77 tokens)
            cfg = serving_config(work / f"{mode}.yaml", lq_dir=work / "lq", gt_dir=work / "gt",
                                 output_dir=out, score_threshold=0.0,
                                 **{f"{m}_weights": f'"{w}"' for m, w in iqa_weights.items()})
            run = run_entry_point("tair_tpu_torch.val",
                                  ["--config", str(cfg), "--steps", str(SERVE_STEPS), *extra], work)
            for k, v in check_reports(f"val {mode}", run["reports"], want, 2).items():
                launches[k] = launches.get(k, 0) + v
            check_images(f"val {mode}", out, [f"{kind}_img{i}.png" for i in range(2)
                                              for kind in ("restored", "pred_texts")], (512, 512))
            records = check_metrics(f"val {mode}", out / "val_metrics.jsonl",
                                    VAL_KEYS | set(iqa_weights), 2)
            if not all(np.isfinite(r[m]) for r in records for m in iqa_weights):
                raise AssertionError(f"val {mode}: a learned metric is not finite: {records}")
            runs[mode] = dict(
                process_seconds=run["seconds"],
                seconds_per_image=[r["seconds"] for r in run["reports"]],
                peak_memory_bytes=[r["peak_memory_bytes"] for r in run["reports"]],
                psnr=[r["psnr"] for r in records], ssim=[r["ssim"] for r in records],
                words=[len(r["pred_texts"]) for r in records],
                **{m: [r[m] for r in records] for m in iqa_weights},
            )
        emit("val", steps=SERVE_STEPS, images=2, size=512, config=VAL_CONFIG,
             launches_per_image=want, host_syncs=host_syncs, **runs)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


PATCHES_KEYS = {"step", "time", "image", "out_hw", "psnr", "ssim"}


def phase_val_patches(structure, seed: int) -> dict:
    """``python -m tair_tpu_torch.val_patches`` on one 240 x 240 LQ (the corner
    of a degraded 512 x 512 SyntheticSAText image) with configs/val.yaml's
    tiling (patch 128, overlap 16, x4, the spotter in the loop): 4 patches
    restored as one batch of 4 at 512 x 512, with ``--dump-dir``; then with
    ``chunk: 3`` (two batches of 3, the second padded). SERVE_STEPS steps.
    Returns the launch counts of both runs."""
    import shutil
    import tempfile
    import zipfile

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="val_patches_", dir=root / "build"))
    try:
        lq, gt = synthetic_pairs(1, 512, seed + 1)
        from tair_tpu_torch.utils.image_io import save_image

        for d, img in (("lq", lq[0, :240, :240]), ("gt", gt[0, :240, :240])):
            (work / d).mkdir()
            save_image(str(work / d / "img0.png"), img)
        want = serving_launches(structure, SERVE_STEPS, SERVE_STEPS)
        runs, launches = {}, {}
        for name, chunk, batches in (("one_batch_of_4", "null", 1), ("chunk_3", 3, 2)):
            out, dump = work / f"out_{name}", work / f"dump_{name}"
            cfg = serving_config(work / f"{name}.yaml", lq_dir=work / "lq", gt_dir=work / "gt",
                                 output_dir=out, chunk=chunk)
            run = run_entry_point(
                "tair_tpu_torch.val_patches",
                ["--config", str(cfg), "--steps", str(SERVE_STEPS), "--dump-dir", str(dump)], work)
            per_image = {k: n * batches for k, n in want.items()}
            for k, v in check_reports(f"val_patches {name}", run["reports"], per_image, 1).items():
                launches[k] = launches.get(k, 0) + v
            if run["reports"][0]["patches"] != 4:
                raise AssertionError(f"val_patches: {run['reports'][0]['patches']} patches, want 4")
            check_images(f"val_patches {name}", out, ["restored_img0.png"], (960, 960))
            records = check_metrics(f"val_patches {name}", out / "val_patches_metrics.jsonl",
                                    PATCHES_KEYS, 1)
            preds = json.loads((dump / "text_results.json").read_text())
            with zipfile.ZipFile(dump / "det.zip") as z:
                members = z.namelist()
            if any(p["image_id"] != 1 or not 0 <= p["score"] <= 1 for p in preds) or \
                    not set(members) <= {"0000001.txt"}:
                raise AssertionError(f"val_patches {name}: dump {len(preds)} predictions, {members}")
            runs[name] = dict(
                process_seconds=run["seconds"], seconds_per_image=run["reports"][0]["seconds"],
                peak_memory_bytes=run["reports"][0]["peak_memory_bytes"],
                psnr=records[0]["psnr"], ssim=records[0]["ssim"],
                dumped_predictions=len(preds),
            )
        per_patch = runs["one_batch_of_4"]["peak_memory_bytes"] - runs["chunk_3"]["peak_memory_bytes"]
        emit("val_patches", steps=SERVE_STEPS, lq_hw=[240, 240], out_hw=[960, 960], patches=4,
             config=VAL_CONFIG, launches_per_batch=want,
             peak_bytes_per_added_patch_b3_to_b4=per_patch, **runs)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


SPOTTER_EVAL_KEYS = {
    "det_precision", "det_recall", "det_hmean", "e2e_precision", "e2e_recall", "e2e_hmean",
    "matched_det", "matched_e2e", "num_gt", "num_pred", "num_gt_det", "num_pred_det",
    "lexicon_words", "e2e_precision_lex", "e2e_recall_lex", "e2e_hmean_lex",
}


def phase_spotter_eval(structure) -> dict:
    """``python -m tair_tpu_torch.spotter_eval`` on configs/train_chip_demo.yaml
    (SyntheticSAText at 256 x 256, the full model), 4 images in pairs,
    ``--lexicon-from-gt``, every proposal scored (``--score-threshold 0``):
    one UNet pass and one spotter pass per pair.
    Returns the launch counts of both pairs."""
    import tempfile

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="spotter_eval_", dir=root / "build") as work:
        run = run_entry_point(
            "tair_tpu_torch.spotter_eval",
            ["--config", str(root / SPOTTER_EVAL_CONFIG), "--num-images", "4", "--lexicon-from-gt",
             "--score-threshold", "0.0", "--dump-dir", str(Path(work) / "dump")], Path(work))
        dumped = sorted(p.name for p in (Path(work) / "dump").iterdir())
    want = serving_launches(structure, 1, 1)
    launches = check_reports("spotter_eval", run["reports"], want, 2)
    out = json.loads(run["stdout"].strip().splitlines()[-1])
    ratios = [k for k in SPOTTER_EVAL_KEYS if k.endswith(("precision", "recall", "hmean"))]
    if set(out) != SPOTTER_EVAL_KEYS or not all(0 <= out[k] <= 1 for k in ratios) \
            or out["num_gt_det"] <= 0 or dumped != ["det.zip", "gt.zip", "text_results.json"]:
        raise AssertionError(f"spotter_eval printed {out}, dumped {dumped}")
    emit("spotter_eval", config=SPOTTER_EVAL_CONFIG, images=4, pairs=2, result=out,
         process_seconds=run["seconds"], seconds_per_pair=[r["seconds"] for r in run["reports"]],
         peak_memory_bytes=[r["peak_memory_bytes"] for r in run["reports"]],
         launches_per_pair=want)
    return launches


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


def restore_request(model, lq, req_seed: int, n_steps: int):
    """One request; (image, tokens, seconds by the host clock)."""
    # score_threshold=0.0 keeps every proposal of the randomly initialised
    # spotter, so the spliced prompt carries words and the re-encode matters
    gen = torch.Generator(device=lq.device).manual_seed(req_seed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    image, tokens = model.restore_fused_feedback(
        lq, generator=gen, steps=n_steps, spotter_every=1, score_threshold=0.0
    )
    torch.cuda.synchronize()
    return image, tokens, time.perf_counter() - t


def check_restored(image, tokens) -> None:
    from tair_tpu_torch.models.prompt_splice import SOT_TOKEN

    if tuple(image.shape) != (1, 512, 512, 3) or not torch.isfinite(image).all():
        raise AssertionError(f"restored image is not finite [1,512,512,3]: {tuple(image.shape)}")
    if image.min().item() < 0.0 or image.max().item() > 1.0:
        raise AssertionError("restored image leaves [0, 1]")
    if tuple(tokens.shape) != (1, 77) or tokens[0, 0].item() != SOT_TOKEN:
        raise AssertionError("tokens are not [1,77] starting with the start token")


def phase_restore(model, lq, seed: int, steps: int) -> dict:
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    check_steps = 10  # of the two requests that check same seed, same image
    msda_sites = sum(isinstance(m, MSDeformAttn) for m in model.testr.modules())

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    image, tokens, seconds = restore_request(model, lq, seed, steps)
    counts = launch_counts()
    check_restored(image, tokens)
    # every UNet/ControlNet attention (46, D=64) on the tensor-core forward in
    # every step; the autoencoder's two (D=512) on the wide tensor-core forward
    want = {**flash_launches(model, torch.bfloat16, steps, backward=False),
            "msda_corner_reduce_fwd": msda_sites * steps}
    check_bf16_flash(want, steps, backward=False)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got}, structure says {want}")
    peak = torch.cuda.max_memory_allocated()

    image_b, tokens_b, seconds_b = restore_request(model, lq, seed + 1, steps)
    check_restored(image_b, tokens_b)
    if torch.equal(image, image_b):
        raise AssertionError("two seeds gave the same image")
    image_c, tokens_c, seconds_c = restore_request(model, lq, seed + 2, check_steps)
    image_d, tokens_d, seconds_d = restore_request(model, lq, seed + 2, check_steps)
    check_restored(image_c, tokens_c)
    if not (torch.equal(image_c, image_d) and torch.equal(tokens_c, tokens_d)):
        raise AssertionError("the same seed gave two different images")

    emit("proposal_topk", **proposal_topk_turns(model, lq))
    emit(
        "restore", steps=steps, seconds_first_request=seconds,
        seconds_second_request=seconds_b, same_seed_check_steps=check_steps,
        same_seed_check_seconds=[seconds_c, seconds_d],
        msda_sites=msda_sites,
        flash_launches={k: n for k, n in got.items() if k.startswith("flash_attention_")},
        msda_launches=got["msda_corner_reduce_fwd"],
        peak_memory_bytes=peak, image_mean=image.mean().item(),
        tokens_head=tokens[0, :12].tolist(),
        prompt_tokens=int((tokens != 0).sum().item()),
    )
    return counts


def phase_restore_flatpatch(model, lq, seed: int, steps: int) -> dict:
    """The request of phase `restore` with every deformable attention of the
    spotter on the `flatpatch` core and the patchify kernel, held against the
    default (`flatlanes`, `concat`) request of the same seed; and `flatlanes`
    with the patchify kernel beside the default, as an A/B of the main path:
    seconds per step by the host clock, and kernel launches and device time of
    one spotter pass by torch.profiler. Returns the flatpatch request's counts."""
    from tair_tpu_torch.models.prompt_splice import empty_tokens

    settings = {
        "flatlanes_concat": MSDA_DEFAULT,
        "flatpatch_kernel": dict(MSDA_DEFAULT, core="flatpatch", patchify="kernel"),
        "flatlanes_kernel": dict(MSDA_DEFAULT, patchify="kernel"),
    }
    flash = flash_launches(model, torch.bfloat16, steps, backward=False)
    check_bf16_flash(flash, steps, backward=False)
    runs = {name: [] for name in settings}
    # default, change, change, ..., default: each setting twice in a row, the
    # default at both ends of the same call
    order = ["flatlanes_concat", "flatpatch_kernel", "flatpatch_kernel",
             "flatlanes_kernel", "flatlanes_kernel", "flatlanes_concat"]
    try:
        for name in order:
            sites = set_msda(model.testr, **settings[name])
            reset_launch_counts()
            image, tokens, seconds = restore_request(model, lq, seed + 2, steps)
            counts = launch_counts()
            check_restored(image, tokens)
            runs[name].append(dict(image=image, tokens=tokens, seconds=seconds, counts=counts))
            want = {
                **flash,
                "msda_corner_reduce_fwd": sites * steps if settings[name]["core"] == "flatlanes" else 0,
                "patchify_value_fwd": sites * steps if settings[name]["patchify"] == "kernel" else 0,
            }
            got = {k: counts[k] for k in want}
            if got != want or sum(counts.values()) != sum(want.values()):
                raise AssertionError(f"{name}: launches {counts}, structure says {want}")

        for name, (a, b) in runs.items():
            if not (torch.equal(a["image"], b["image"]) and torch.equal(a["tokens"], b["tokens"])):
                raise AssertionError(f"{name}: the same seed gave two different images")
        base = runs["flatlanes_concat"][0]
        against_default = {}
        for name in ("flatpatch_kernel", "flatlanes_kernel"):
            run = runs[name][0]
            against_default[name] = dict(
                image_max_abs_diff=(run["image"].float() - base["image"].float()).abs().max().item(),
                image_mean_abs_diff=(run["image"].float() - base["image"].float()).abs().mean().item(),
                tokens_equal=bool(torch.equal(run["tokens"], base["tokens"])),
            )
        # the patchify kernel moves the same values as the concat packing, so
        # flatlanes with it is the same arithmetic on the same bits
        if against_default["flatlanes_kernel"]["image_max_abs_diff"] != 0.0:
            raise AssertionError(
                f"flatlanes with the patchify kernel differs from the default: "
                f"{against_default['flatlanes_kernel']}"
            )

        # one spotter pass per setting on the same features: wall and device
        with torch.no_grad():
            clean = model.clean(lq)
            cond = dict(
                c_txt=model.cldm.clip_encode_tokens(
                    torch.from_numpy(empty_tokens(1)).to(lq.device).long()),
                c_img=model.cldm.vae_encode(clean * 2.0 - 1.0, sample=False),
            )
            x = torch.randn((1, 64, 64, 4), device=lq.device,
                            generator=torch.Generator(device=lq.device).manual_seed(0))
            _, feats = model.cldm.apply(
                x, torch.full((1,), 500, dtype=torch.int32, device=lq.device), cond)
            passes, outputs = {}, {}
            keys = ("enc_logits", "enc_boxes", "pred_logits", "pred_ctrl_points", "pred_texts")
            for name in settings:
                set_msda(model.testr, **settings[name])
                out = model.spotter_apply(feats)
                out.update(enc_logits=out["enc_outputs"]["pred_logits"],
                           enc_boxes=out["enc_outputs"]["pred_boxes"])
                outputs[name] = {k: out[k].float() for k in keys}

                def one_pass() -> float:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    model.spotter_apply(feats)
                    torch.cuda.synchronize()
                    return time.perf_counter() - t

                one_pass()
                walls = [one_pass() for _ in range(5)]
                prof = profiled(one_pass, watch=("patchify_band_kernel", "msda_corner_reduce_kernel"))
                passes[name] = dict(
                    wall_seconds_median_of_5=statistics.median(walls),
                    kernel_launches=prof["kernel_launches"],
                    device_busy_seconds=prof["device_busy_seconds"],
                    device_seconds_of=prof["watched"],
                    # bfloat16; the enc_* outputs are the encoder's, before the
                    # top-k choice of proposals, which small differences flip
                    outputs_max_abs_diff_from_default={
                        k: (outputs[name][k] - outputs["flatlanes_concat"][k]).abs().max().item()
                        for k in keys
                    },
                )
    finally:
        set_msda(model.testr, **MSDA_DEFAULT)

    emit(
        "restore_flatpatch", steps=steps, msda_sites=sites,
        seconds={name: [r["seconds"] for r in rs] for name, rs in runs.items()},
        seconds_per_step={name: [r["seconds"] / steps for r in rs] for name, rs in runs.items()},
        order=order, same_seed_same_image=True, against_default=against_default,
        launches_per_request={
            name: {k: v for k, v in rs[0]["counts"].items() if v} for name, rs in runs.items()
        },
        patchify_launches_per_step=runs["flatpatch_kernel"][0]["counts"]["patchify_value_fwd"] / steps,
        spotter_pass=passes,
        # the A/B of the three settings in brief: one pass's launches and device
        # seconds (profiler), and host seconds per step of each request
        summary={name: dict(
            pass_launches=passes[name]["kernel_launches"],
            pass_device_seconds=passes[name]["device_busy_seconds"],
            pass_patchify_device_seconds=passes[name]["device_seconds_of"]["patchify_band_kernel"],
            seconds_per_step=[r["seconds"] / steps for r in runs[name]],
        ) for name in settings},
    )
    return runs["flatpatch_kernel"][0]["counts"]


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


def spotter_features(model, lq):
    """The UNet's four decoder taps of one noised ControlNet + UNet pass on
    `lq` (t = 500): the spotter's input in a request."""
    from tair_tpu_torch.models.prompt_splice import empty_tokens

    dev = lq.device
    with torch.no_grad():
        cond = dict(
            c_txt=model.cldm.clip_encode_tokens(torch.from_numpy(empty_tokens(1)).to(dev).long()),
            c_img=model.cldm.vae_encode(model.clean(lq) * 2.0 - 1.0, sample=False),
        )
        side = lq.shape[1] // 8
        x = torch.randn((1, side, side, 4), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        return model.cldm.apply(x, torch.full((1,), 500, dtype=torch.int32, device=dev), cond)[1]


# the matcher's cases (phase matcher): name, B, Q, M, n_valid, costs. The train
# phase's decoder matching (one image, 8 target slots, 5 real); the stage-3
# config's 32 slots at batch 4, with none and all of them real; more slots than
# queries (solved query-major); integer costs in {0..3}, whose optima tie; a
# matrix too large to stage in shared memory (read from L2); and the encoder's
# box matching at 1024 x 1024 (37,888 tokens), whose vectors do not fit shared
# memory either (a workspace in device memory). Then the costs of a real spotter
# pass (phase matcher adds them): the decoder's control-point matching
# [1, 100, 8] and the encoder's box matching over all 9472 tokens [1, 9472, 8].
MATCHER_CASES = [
    ("train_batch", 1, 100, 8, (5,), "float"),
    ("stage3_b4", 4, 100, 32, (0, 32, 17, 5), "float"),
    ("more_slots_than_queries", 2, 100, 128, (128, 60), "float"),
    ("tied_stage3_b4", 4, 100, 32, (0, 32, 17, 5), "tied"),
    ("tied_b2_12x5", 2, 12, 5, (5, 3), "tied"),
    ("unstaged_300x256", 1, 300, 256, (200,), "float"),
    ("workspace_37888x8", 1, 37888, 8, (5,), "float"),
]


def host_path_parts(cost: torch.Tensor, n_valid: torch.Tensor, n: int = 20) -> dict:
    """Milliseconds of one matching on the host path ("hungarian_host"), by
    the host clock around synchronised work, medians of n: the whole call, and
    its copy to the host, ``lapjv_batch`` and the copy back; scipy's solve of
    the same matrices, as a yardstick only."""
    from scipy.optimize import linear_sum_assignment

    from tair_tpu_torch import native_ext
    from tair_tpu_torch.spotter import matcher as tm

    def clock(fn) -> float:
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)

    c, nv = cost.cpu().numpy(), n_valid.cpu().numpy()
    out = native_ext.lapjv_batch(c, nv)

    def scipy_solve():
        for i in range(c.shape[0]):
            if nv[i]:
                linear_sum_assignment(c[i, :, : nv[i]])

    return dict(
        host_path_ms=clock(lambda: tm.hungarian_assignment(cost, n_valid)),
        copy_to_host_ms=clock(lambda: (cost.cpu(), n_valid.cpu())),
        lapjv_batch_ms=clock(lambda: native_ext.lapjv_batch(c, nv)),
        copy_back_ms=clock(lambda: torch.from_numpy(out).to(cost.device)),
        scipy_ms=clock(scipy_solve),
    )


def matched_cost(cost: torch.Tensor, assignment: torch.Tensor) -> float:
    """Sum of the matched entries, in float64 on the host."""
    c, a = cost.double().cpu(), assignment.cpu()
    return sum(c[b, a[b, t], t].item() for b in range(a.shape[0]) for t in range(a.shape[1])
               if a[b, t] >= 0)


def phase_matcher(model, lq, seed: int, smi: str) -> dict:
    """Kernel J1 (the exact matcher, ``jv_assign``) against its plain version
    on the card, element for element, at every case of MATCHER_CASES and on
    the costs of a real spotter pass (the serving model's taps, seeded
    targets of the train phase's batch); J1's device time by CUDA-graph
    replay; the host path's time beside it; the bound from the bytes J1 must
    move and the float32 adds this data needs."""
    from tair_tpu_torch.spotter import matcher as tm

    dev = lq.device
    rng = np.random.default_rng(seed)
    cases = []
    for name, b, q, m, counts, kind in MATCHER_CASES:
        cost = (rng.standard_normal((b, q, m)) * 10 if kind == "float"
                else rng.integers(0, 4, (b, q, m)))
        cases.append((name, kind, torch.from_numpy(cost.astype(np.float32)).to(dev),
                      torch.tensor(counts, dtype=torch.long, device=dev)))
    batch = train_batch(rng, batch=1, size=512, max_inst=8, n_inst=5)
    targets = {k: torch.from_numpy(batch[k]).to(dev)
               for k in ("inst_mask", "boxes", "ctrl_points", "texts")}
    with torch.no_grad():
        out = model.spotter_apply(spotter_features(model, lq))
    cases.append(("spotter_decoder_points", "spotter", *tm.ctrl_point_cost(out, targets)))
    cases.append(("spotter_encoder_boxes", "spotter", *tm.box_cost(out["enc_outputs"], targets)))
    del out

    rows = []
    for name, kind, cost, n_valid in cases:
        got = tm._launch_jv(cost, n_valid)
        torch.cuda.synchronize()
        stats = {}
        t = time.perf_counter()
        want = tm.jv_assignment_reference(cost, n_valid, stats)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)
        if got.dtype != torch.long or not torch.equal(got, want):
            raise AssertionError(
                f"matcher {name}: J1's assignment differs from the plain version's at "
                f"{int((got != want).sum())} of {want.numel()} targets")
        host = host_path_parts(cost, n_valid)
        host_out = tm.hungarian_assignment(cost, n_valid)
        j1_total, host_total = matched_cost(cost, got), matched_cost(cost, host_out)
        if not abs(j1_total - host_total) <= 1e-5 * max(1.0, abs(host_total)):
            raise AssertionError(f"matcher {name}: J1's optimum {j1_total}, the host's "
                                 f"{host_total}")
        nbytes = cost.numel() * 4 + n_valid.numel() * 8 + got.numel() * 8
        flops = 3 * stats["relaxed"] + 2 * stats["dual"]
        ms = graph_ms(lambda: tm._launch_jv(cost, n_valid))
        b, q, m = cost.shape
        rows.append(dict(
            case=name, costs=kind, batch=b, queries=q, target_slots=m,
            n_valid=n_valid.tolist(), equal_to_plain=True, max_abs_err=0.0,
            same_assignment_as_host=torch.equal(got, host_out), optimum=j1_total,
            search_steps=stats["steps"], relaxed_columns=stats["relaxed"],
            ms=ms, host_ms_per_call=host_ms(lambda: tm._launch_jv(cost, n_valid), n=200),
            plain_ms=plain_ms, bytes=nbytes, float32_adds=flops,
            **bound_of(flops, nbytes, torch.float32), library_ms=None, **host,
        ))
        rows[-1]["share_of_bound"] = rows[-1]["bound_ms"] / ms
    by = {r["case"]: r for r in rows}
    head, enc = by["spotter_decoder_points"], by["spotter_encoder_boxes"]
    layers = model.testr.cfg.num_decoder_layers
    per_step = {key: layers * head[key] + enc[key] for key in ("ms", "host_path_ms", "bound_ms")}
    emit("matcher", card=smi, cases=rows, per_train_step=per_step,
         matchings_per_train_step=layers + 1,
         note="ms: device time of one J1 launch by CUDA events around the replay of a CUDA "
              "graph of 20 launches; host_ms_per_call: time.perf_counter over 200 wrapper calls "
              "without a synchronise; plain_ms: one call of jv_assignment_reference on the card "
              "(host clock, synchronised); host_path_ms and its parts, scipy_ms: host clock "
              "around synchronised calls, medians of 20; bound_ms: the larger of the bytes J1 "
              "must move (cost read once, n_valid, the output) at 3.35 TB/s and the float32 "
              "adds this data needs (3 a relaxed column, 2 a dual update) at 67 TFLOP/s. J1 is "
              "latency-bound, not bound by either: its time is a chain of search_steps "
              "dependent block-wide argmins. per_train_step: the decoder case times the "
              f"{layers} decoder matchings plus the encoder case")
    return dict(
        name="jv_assign", route="cuda", source="tair_tpu_torch/ops/csrc/jv_assign.cu",
        replaces="tair_tpu/spotter/matcher.py:86 (_jv_single :86-177 and jv_assignment "
                 ":180-211: lax loops, no Pallas kernel)",
        shape="B=1 Q=100 M=8 float32, the decoder matching of the train step",
        max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, paths=("train_reference", "train"),
        ms_per_train_step=per_step["ms"], host_path_ms=head["host_path_ms"],
        host_path_ms_per_train_step=per_step["host_path_ms"], scipy_ms=head["scipy_ms"],
        encoder_ms=enc["ms"], host_ms_per_call=head["host_ms_per_call"],
    )


# the spotter encoder's work in the profiler: kernels by a part of their name
# (PyTorch's gather kernel runs both the msda row gather and the sparse
# update's row gathers; K3), and the operators whose kernels' device time is
# told apart: the msda row gather (``index_select``), the sparse update's
# gathers of its rows and its scatter back
ENCODER_KERNELS = ("vectorized_gather_kernel", "msda_corner_reduce_kernel")
ENCODER_OPS = ("aten::index_select", "aten::gather", "aten::scatter")


def phase_enc_topk(model, lq, seed: int, steps: int) -> dict:
    """The sparse spotter encoder (``TESTRConfig.enc_topk``) on the full-width
    request: fused requests of `steps` steps at 512 x 512 in bfloat16 with
    enc_topk = ENC_TOPK beside enc_topk = 0 (every one of the S = 9472 tokens)
    and enc_topk = S, in the order dense, sparse, sparse, S, dense. Checks:
    each image finite, in range; the same seed the same image; enc_topk = S
    the dense image bit for bit; every request's launches the structure's
    (the sparse encoder launches K3 once a layer, as the dense one). Then one
    spotter pass of each setting on the same features: its wall seconds, its
    launches and device seconds (torch.profiler), and those of the 6 encoder
    layers alone (the row gather, the sparse update's gathers and scatter,
    K3). K3's launches are also counted by row count: each request's encoder
    layers launch it num_encoder_layers x steps times at their row count
    (ENC_TOPK when sparse, S otherwise) and the decoder's launches are the
    dense request's; the sparse image differs from the dense one. Returns the
    launches of the first sparse request, K3's split into those at ENC_TOPK
    rows (under msda_corner_reduce_fwd_nq<ENC_TOPK>) and the others."""
    from tair_tpu_torch.ops import msda_reduce as mr
    from tair_tpu_torch.spotter.transformer import encoder_reference_points

    t_phase = time.perf_counter()
    transformer = model.testr.transformer
    s_tokens = len(encoder_reference_points(SPOTTER_LEVELS))
    want = serving_launches(model, steps, steps)
    enc_launches = transformer.num_encoder_layers * steps
    settings = {"dense": 0, f"enc_topk_{ENC_TOPK}": ENC_TOPK, f"enc_topk_{s_tokens}": s_tokens}
    sparse_name = f"enc_topk_{ENC_TOPK}"
    order = ["dense", sparse_name, sparse_name, f"enc_topk_{s_tokens}", "dense"]
    runs = {name: [] for name in settings}
    passes = {}
    try:
        for name in order:
            transformer.enc_topk = settings[name]
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            image, tokens, seconds = restore_request(model, lq, seed, steps)
            counts = {k: n for k, n in launch_counts().items() if n}
            rows = dict(sorted(mr.fwd_launches_by_rows.items()))
            check_restored(image, tokens)
            if counts != want:
                raise AssertionError(f"enc_topk {name}: launches {counts}, structure says {want}")
            enc_rows = settings[name] if 0 < settings[name] < s_tokens else s_tokens
            decoder_rows = {n: c for n, c in rows.items() if n != enc_rows}
            # the first request is dense: the others' decoder launches are its
            dense_decoder = runs["dense"][0]["decoder_rows"] if runs["dense"] else decoder_rows
            if (rows.get(enc_rows) != enc_launches
                    or sum(rows.values()) != counts["msda_corner_reduce_fwd"]
                    or s_tokens in decoder_rows or decoder_rows != dense_decoder):
                raise AssertionError(
                    f"enc_topk {name}: K3 launches by row count {rows}; want {enc_launches} "
                    f"at {enc_rows} rows and the dense request's decoder launches")
            runs[name].append(dict(image=image, tokens=tokens, seconds=seconds, counts=counts,
                                   rows=rows, decoder_rows=decoder_rows,
                                   peak=torch.cuda.max_memory_allocated()))
        for name, rs in runs.items():
            if not all(torch.equal(r["image"], rs[0]["image"]) and
                       torch.equal(r["tokens"], rs[0]["tokens"]) for r in rs):
                raise AssertionError(f"enc_topk {name}: the same seed gave two different images")
        dense, exact = runs["dense"][0], runs[f"enc_topk_{s_tokens}"][0]
        if not (torch.equal(dense["image"], exact["image"])
                and torch.equal(dense["tokens"], exact["tokens"])):
            raise AssertionError(f"enc_topk = S = {s_tokens} differs from the dense request")
        sparse = runs[sparse_name][0]
        if torch.equal(sparse["image"], dense["image"]):
            raise AssertionError(f"enc_topk = {ENC_TOPK} gave the dense request's image")

        feats = spotter_features(model, lq)
        captured_args = []
        hook = transformer.enc_0.register_forward_pre_hook(
            lambda mod, args: captured_args.append(args))
        try:
            for name in ("dense", sparse_name):
                transformer.enc_topk = settings[name]
                captured_args.clear()
                with torch.no_grad():
                    model.spotter_apply(feats)
                memory, *rest = captured_args[-1]

                def one_pass() -> float:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    with torch.no_grad():
                        model.spotter_apply(feats)
                    torch.cuda.synchronize()
                    return time.perf_counter() - t

                def encoder() -> float:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    m = memory
                    with torch.no_grad():
                        for i in range(transformer.num_encoder_layers):
                            m = getattr(transformer, f"enc_{i}")(m, *rest)
                    torch.cuda.synchronize()
                    return time.perf_counter() - t

                one_pass()
                walls = [one_pass() for _ in range(5)]
                whole = profiled(one_pass, watch=ENCODER_KERNELS, ops=ENCODER_OPS)
                enc = profiled(encoder, watch=ENCODER_KERNELS, ops=ENCODER_OPS)
                passes[name] = dict(
                    selected_rows=settings[name] or s_tokens,
                    wall_seconds_median_of_5=statistics.median(walls),
                    pass_launches=whole["kernel_launches"],
                    pass_device_seconds=whole["device_busy_seconds"],
                    pass_device_seconds_of={**whole["watched"], **whole["ops"]},
                    encoder_launches=enc["kernel_launches"],
                    encoder_device_seconds=enc["device_busy_seconds"],
                    encoder_device_seconds_of={**enc["watched"], **enc["ops"]},
                    encoder_top_kernels=enc["top_kernels"][:12],
                )
        finally:
            hook.remove()
    finally:
        transformer.enc_topk = 0

    emit(
        "enc_topk", steps=steps, tokens=s_tokens, enc_topk=ENC_TOPK, order=order,
        seconds={name: [r["seconds"] for r in rs] for name, rs in runs.items()},
        peak_memory_bytes={name: rs[0]["peak"] for name, rs in runs.items()},
        launches_per_request=want, same_seed_same_image=True,
        enc_topk_s_equals_dense=True, sparse_differs_from_dense=True,
        k3_launches_by_rows={name: rs[0]["rows"] for name, rs in runs.items()},
        sparse_against_dense=dict(
            image_max_abs_diff=(sparse["image"].float() - dense["image"].float()).abs().max().item(),
            image_mean_abs_diff=(sparse["image"].float() - dense["image"].float()).abs().mean().item(),
            tokens_equal=bool(torch.equal(sparse["tokens"], dense["tokens"])),
        ),
        spotter_pass=passes, phase_seconds=time.perf_counter() - t_phase,
    )
    at_topk = sparse["rows"][ENC_TOPK]
    return {**sparse["counts"],
            "msda_corner_reduce_fwd": sparse["counts"]["msda_corner_reduce_fwd"] - at_topk,
            f"msda_corner_reduce_fwd_nq{ENC_TOPK}": at_topk}


# ---- w8a8 serving (phase quant) and the proposals' top-K (phase restore) ----

# the profiler's kernel names (a part of each) of the w8a8 wrappers' kernels
QUANT_KERNEL_NAMES = {"w8a8_conv": ("int8_conv_wgmma_kernel",), "w8a8_act": ("quant_act_kernel",)}
QUANT_SELECTIVE_RATIO = 1.0  # quant_min_ratio of the selective setting
# the request's settings, timed in turns with bfloat16 (the w8a8 fields of ControlLDM)
QUANT_SETTINGS = ("bf16", "dynamic", "static", "selective")
QUANT_ORDER = ("bf16", "dynamic", "static", "selective", "selective", "static", "dynamic", "bf16")


class _FirstStep(Exception):
    pass


def first_step_inputs(model, lq, seed: int, steps: int):
    """(x_noisy, t, cond) of the first ControlLDM.apply call of
    `restore_request`'s request (the request stops there)."""
    cldm = model.cldm
    seen = []

    def recording(x, t, cond, **kwargs):
        seen.append((x.clone(), t.clone(), dict(cond)))
        raise _FirstStep

    cldm.apply = recording  # an instance attribute: the request's step calls it
    try:
        restore_request(model, lq, seed, steps)
    except _FirstStep:
        pass
    finally:
        del cldm.apply
    return seen[0]


def quant_sites(model, x, t, cond):
    """``calibrate_quant`` on one step's inputs under the model's quant
    fields: (the record, each quantized site's kernel geometry in order)."""
    from tair_tpu_torch.ops import quant

    sites = []
    product = quant._kernel_product

    def logged(x_nhwc, w8, wscale, bias, dtype, stride, padding):
        sites.append((tuple(x_nhwc.shape), tuple(w8.shape), stride, padding, bias is not None))
        return product(x_nhwc, w8, wscale, bias, dtype, stride, padding)

    quant._kernel_product = logged
    try:
        record = model.cldm.calibrate_quant(x, t, cond)
    finally:
        quant._kernel_product = product
    if len(record) != len(sites):
        raise AssertionError(f"calibration recorded {len(record)} sites, the kernels saw {len(sites)}")
    return record, sites


def site_gemm(site) -> tuple:
    """(M, N, K) of the int8 product of a site of `quant_sites`."""
    (b, h, w, _), (o, kh, kw, cp), stride, pad, _ = site
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    return b * ho * wo, o, kh * kw * cp


def check_q2_nan(x2d: torch.Tensor) -> None:
    """Q2 on an activation holding a NaN: the abs-max and the scale are NaN
    on the card as in the plain version, so the NaN reaches the product."""
    from tair_tpu_torch.ops import quant

    x = x2d.clone()
    x.view(-1)[x.numel() // 3] = float("nan")
    got, want = quant.quantize_activation(x, None)[1], quant.quantize_activation_plain(x, None)[1]
    if not (bool(got.isnan().all()) and bool(want.isnan().all())):
        raise AssertionError(f"quant_act on a NaN activation: stats {got.tolist()}, "
                             f"plain {want.tolist()}; both must be NaN")


def check_quant_kernels(sites: list, smi: str, rng: np.random.Generator) -> list:
    """Q2 (activation quantize, dynamic and static), Q1 (int8 convolution
    with its epilogue) and a whole site (``w8a8_site``: one library call, Q2
    then Q1) at every distinct quantized site shape of one ControlNet + UNet
    step, on seeded bfloat16 values, each held bit for bit against its plain
    version (and Q2 on a NaN at the first shape). Device ms of one call by
    CUDA-graph replay, its share of the bound and its rate, the library
    yardsticks (bf16 ``F.conv2d`` / ``F.linear``, and the int8 route: unfold
    + ``torch._int_mm`` + the epilogue in tensor ops) at every shape; the
    wrappers' host ms and the plain versions' ms at the head shape, the one
    whose sites do the most operations in a step."""
    import torch.nn.functional as F

    from tair_tpu_torch.ops import quant

    shapes = {}
    for key in sites:
        shapes[key] = shapes.get(key, 0) + 1
    head_key = max(shapes, key=lambda s: math.prod(site_gemm(s)) * shapes[s])
    rows = []
    for key, n_sites in shapes.items():
        xs, ws, stride, pad, has_bias = key
        at_head = key == head_key
        b, h, w, c = xs
        o, kh, kw, cp = ws
        dense = kh == kw == h == w == 1
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).cuda().to(torch.bfloat16)
        weight = torch.from_numpy(
            rng.standard_normal((o, c, kh, kw), dtype=np.float32) / np.sqrt(c * kh * kw)
        ).cuda().to(torch.bfloat16)
        bias = (torch.from_numpy(rng.standard_normal(o, dtype=np.float32) * 0.1).cuda()
                .to(torch.bfloat16) if has_bias else None)
        x2d = x.reshape(-1, c)
        w8, wscale = quant._prepare_weight(weight)  # the layout Q1 reads
        half = 0.5 * x.float().abs().max().item()  # a static amax that clips
        for amax in (None, half):
            got, want = quant.quantize_activation(x2d, amax), quant.quantize_activation_plain(x2d, amax)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"quant_act {xs} static={amax}: not equal to the plain version")
            out, stats = quant.w8a8_site(x2d, (b, h, w), w8, wscale, bias, torch.bfloat16, stride,
                                         pad, amax)
            plain = quant.int8_conv_plain(want[0].view(b, h, w, cp), w8, want[1], wscale, bias,
                                          torch.bfloat16, stride, pad)
            torch.cuda.synchronize()
            if not (torch.equal(out, plain) and torch.equal(stats, want[1])):
                raise AssertionError(f"w8a8_site {xs} x {ws} static={amax}: not equal to the "
                                     f"plain versions")
        if not rows:
            check_q2_nan(x2d)
        x8, stats = quant.quantize_activation(x2d, None)
        x8v = x8.view(b, h, w, cp)

        def q1():
            return quant.int8_conv(x8v, w8, wscale, stats, bias, torch.bfloat16, stride, pad)

        def q1_plain():
            return quant.int8_conv_plain(x8v, w8, stats, wscale, bias, torch.bfloat16, stride, pad)

        def site():
            return quant.w8a8_site(x2d, (b, h, w), w8, wscale, bias, torch.bfloat16, stride, pad,
                                   None)

        got, want = q1(), q1_plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_conv {xs} x {ws} s{stride}: max |d| {err} from the plain version")
        got2 = q1()  # the split's workspace and counters are left as they were found
        torch.cuda.synchronize()
        if not torch.equal(got2, want):
            raise AssertionError(f"int8_conv {xs} x {ws} s{stride}: a second call differs")

        if dense:
            w2d = weight.reshape(o, c)

            def library():
                return F.linear(x2d, w2d, bias)
        else:
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as the model's
            wcl = weight.contiguous(memory_format=torch.channels_last)

            def library():
                return F.conv2d(x_nchw, wcl, bias, stride, pad)

        def int8_route():
            if kh == kw == 1 and stride == 1:
                a = x8v.reshape(-1, cp)
            else:
                xp = F.pad(x8v, (0, 0, pad, pad, pad, pad))
                a = (xp.unfold(1, kh, stride).unfold(2, kw, stride)
                     .permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * cp))
            acc = torch._int_mm(a, w8.reshape(o, -1).t())
            y = (acc.float() * (wscale * stats[1])).to(torch.bfloat16)
            return y if bias is None else y + bias

        try:
            route_equal = torch.equal(int8_route().reshape(got.shape), got)
            route_ms, route_error = graph_ms(int8_route), None
        except RuntimeError as e:  # a yardstick only: _int_mm refuses some shapes
            route_equal, route_ms, route_error = None, None, str(e).splitlines()[0][:160]
        m = got.shape[0] * got.shape[1] * got.shape[2]
        ops = 2.0 * m * o * kh * kw * cp
        q1_bytes = x8.numel() + w8.numel() + 2 * m * o + 4 * o + (2 * o if has_bias else 0) + 8
        q2_bytes = 2 * x.numel() + x8.numel() + 8
        q1_bound = bound_of(ops, q1_bytes, torch.int8)
        q2_bound = bound_of(0.0, q2_bytes, torch.bfloat16)
        ms, lib_ms = graph_ms(q1), graph_ms(library)
        act_ms = graph_ms(lambda: quant.quantize_activation(x2d, None))
        rows.append(dict(
            shape=f"{'dense' if dense else f'conv{kh}x{kw}s{stride}'} x{list(xs)} w[{o},{kh},{kw},{cp}]",
            sites_per_step=n_sites, m=m, n=o, k=kh * kw * cp,
            schedule=list(quant.conv_schedule(m, o, kh * kw * cp,
                                              quant.gathered(kh, kw, stride, pad))),
            max_abs_err=err, equal_to_plain=True, quant_act_equal_to_plain=True,
            site_equal_to_plain=True,
            ms=ms, share_of_bound=q1_bound["bound_ms"] / ms, tops=ops / ms / 1e9,
            bf16_library_ms=lib_ms, bf16_library_tops=ops / lib_ms / 1e9,
            int8_route_ms=route_ms, int8_route_equal=route_equal, int8_route_error=route_error,
            bound_ms=q1_bound["bound_ms"], bound_by=q1_bound["bound_by"],
            act_ms=act_ms, act_static_ms=graph_ms(lambda: quant.quantize_activation(x2d, half)),
            act_bound_ms=q2_bound["bound_ms"], act_bound_by=q2_bound["bound_by"],
            act_share_of_bound=q2_bound["bound_ms"] / act_ms, site_ms=graph_ms(site),
            head=at_head,
        ))
        if at_head:
            rows[-1].update(
                plain_ms=time_ms(q1_plain, warmup=1, reps=3, inner=1),
                host_ms_per_call=host_ms(q1, n=200),
                site_host_ms_per_call=host_ms(site, n=200),
                act_plain_ms=time_ms(lambda: quant.quantize_activation_plain(x2d, None),
                                     warmup=1, reps=3, inner=1),
                act_host_ms_per_call=host_ms(lambda: quant.quantize_activation(x2d, None), n=200),
            )
        del x, weight, x8, x8v, w8, got, got2, want
    per_step = {
        key: sum(r[key] * r["sites_per_step"] for r in rows if r[key] is not None)
        for key in ("ms", "bound_ms", "bf16_library_ms", "int8_route_ms", "act_ms",
                    "act_static_ms", "act_bound_ms", "site_ms")
    }
    median_share = {key: statistics.median(r[key] for r in rows)
                    for key in ("share_of_bound", "act_share_of_bound")}
    slower = [r["shape"] for r in rows if r["ms"] > r["bf16_library_ms"]]
    emit("kernels", kernel="w8a8", card=smi, sites_per_step=len(sites), shapes=rows,
         per_step=per_step, median_share_of_bound=median_share,
         shapes_slower_than_bf16_library=slower,
         note="ms, act_ms, act_static_ms, site_ms: device ms of one call by CUDA events "
              "around the replay of a CUDA graph of 20 calls (act_ms: Q2 dynamic, one "
              "launch; site_ms: w8a8_site, Q2 dynamic then Q1); host_ms_per_call: "
              "time.perf_counter over 200 calls without a synchronise; plain: CUDA events "
              "around eager calls of the plain versions (float64 im2col product); host and "
              "plain at the head shape only; bf16_library_ms: F.conv2d / F.linear in "
              "bfloat16 at the shape; int8_route_ms: pad + unfold + torch._int_mm + the "
              "epilogue in tensor ops; schedule: Q1's (tile width, splits of K, steps a "
              "split); per_step: each shape's time times its sites in one ControlNet + "
              "UNet step")
    head = next(r for r in rows if r["head"])
    common = dict(route="cuda", shape=head["shape"], library_ms=None, paths=("quant",),
                  sites_per_step=len(sites), distinct_shapes=len(rows))
    return [
        dict(name="w8a8_conv", source="tair_tpu_torch/ops/csrc/int8_conv.cu",
             replaces="tair_tpu/ops/quant.py:249 (w8a8_conv's s8 conv; :217 w8a8_dot_general; "
                      "XLA lowers both, no Pallas kernel)",
             max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["ms"],
             plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
             bf16_library_ms=head["bf16_library_ms"], int8_route_ms=head["int8_route_ms"],
             host_ms_per_call=head["host_ms_per_call"],
             site_host_ms_per_call=head["site_host_ms_per_call"], ms_per_step=per_step["ms"],
             bound_ms_per_step=per_step["bound_ms"],
             median_share_of_bound=median_share["share_of_bound"],
             split_k_sites_per_step=sum(r["schedule"][1] > 1 for r in rows for _ in
                                        range(r["sites_per_step"])),
             bf16_library_ms_per_step=per_step["bf16_library_ms"], **common),
        dict(name="w8a8_act_dynamic", source="tair_tpu_torch/ops/csrc/quant_act.cu",
             replaces="tair_tpu/ops/quant.py:154 (_quant_act; XLA fuses it, no Pallas kernel)",
             max_abs_err=0.0, ms=head["act_ms"], plain_ms=head["act_plain_ms"],
             bound_ms=head["act_bound_ms"], bound_by=head["act_bound_by"],
             static_ms=head["act_static_ms"], host_ms_per_call=head["act_host_ms_per_call"],
             ms_per_step=per_step["act_ms"], static_ms_per_step=per_step["act_static_ms"],
             bound_ms_per_step=per_step["act_bound_ms"],
             median_share_of_bound=median_share["act_share_of_bound"], **common),
    ]


def set_quant(cldm, setting: str, record, sites, sites_sel) -> int:
    """Sets ControlLDM's w8a8 fields for a setting of phase quant; returns its
    quantized sites a step."""
    cldm.quantized = setting != "bf16"
    cldm.quant_static_amax = tuple(record) if setting == "static" else None
    cldm.quant_min_ratio = QUANT_SELECTIVE_RATIO if setting == "selective" else None
    return len({"bf16": [], "selective": sites_sel}.get(setting, sites))


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def phase_quant(model, lq, seed: int, steps: int, smi: str) -> tuple:
    """w8a8 serving of the full-width request (``ControlLDM.quantized``): the
    calibration record of the request's first step (all sites, and under
    quant_min_ratio = QUANT_SELECTIVE_RATIO), Q1 and Q2 at each of its site
    shapes (`check_quant_kernels`), then `steps`-step fused requests in the
    settings bf16, dynamic, static (the record as quant_static_amax) and
    selective, in turns (QUANT_ORDER). Gates per request: finite, in range,
    the same seed the same image, the launches the structure's plus, per
    quantized site and step, two: one Q2 (dynamic, or static in the static
    setting) and one Q1, split K or not, and no other w8a8 kernel; a
    quantized image differs from the bf16 one; host
    synchronisations per step equal bf16's. Measures s/request, peak, one
    profiled request per setting (device busy s, idle share, launches) and
    the image's max |d| and PSNR against bf16, and the seconds of each part
    of the phase. Returns (the kernel entries, the first dynamic request's
    launches)."""
    t_phase = time.perf_counter()
    seconds_of, t_part = {}, time.perf_counter()

    def part_done(name):
        nonlocal t_part
        seconds_of[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    cldm = model.cldm
    x, t, cond = first_step_inputs(model, lq, seed, steps)
    base = serving_launches(model, steps, steps)
    runs = {name: [] for name in QUANT_SETTINGS}
    try:
        set_quant(cldm, "dynamic", (), (), ())
        resident = torch.cuda.memory_allocated()
        record, sites = quant_sites(model, x, t, cond)
        # the int8 weights and scales made once for the parameters' version,
        # resident from here on (in every request's peak below, bf16's too)
        cache_allocated = torch.cuda.memory_allocated() - resident
        cache_bytes = sum(
            m._wq.value[0].numel() + 4 * m._wq.value[1].numel()
            for m in cldm.modules() if getattr(m, "_wq", None) is not None and m._wq.value
        )
        set_quant(cldm, "selective", record, sites, ())
        record_sel, sites_sel = quant_sites(model, x, t, cond)
        part_done("calibration")
        kernels = check_quant_kernels(sites, smi, np.random.default_rng(seed + 11))
        part_done("kernels")
        for name in QUANT_ORDER:
            n = steps * set_quant(cldm, name, record, sites, sites_sel)
            want = dict(base)
            if n:
                want.update({"w8a8_conv": n,
                             "w8a8_act_static" if name == "static" else "w8a8_act_dynamic": n})
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            image, tokens, seconds = restore_request(model, lq, seed, steps)
            counts = launch_counts()
            check_restored(image, tokens)
            if {k: v for k, v in counts.items() if v} != want:
                raise AssertionError(f"quant {name}: launches {counts}, structure says {want}")
            runs[name].append(dict(image=image, tokens=tokens, seconds=seconds, counts=counts,
                                   peak=torch.cuda.max_memory_allocated()))
        for name, rs in runs.items():
            if not all(torch.equal(r["image"], rs[0]["image"]) and
                       torch.equal(r["tokens"], rs[0]["tokens"]) for r in rs):
                raise AssertionError(f"quant {name}: the same seed gave two different images")
            if name != "bf16" and torch.equal(rs[0]["image"], runs["bf16"][0]["image"]):
                raise AssertionError(f"quant {name}: the image is the bf16 one")
        part_done("requests")
        profiles, syncs = {}, {}
        for name in QUANT_SETTINGS:
            set_quant(cldm, name, record, sites, sites_sel)
            profiles[name] = profiled(lambda: restore_request(model, lq, seed, steps)[2],
                                      watch=sum(QUANT_KERNEL_NAMES.values(), ()), cpu=False)
        part_done("profiles")
        for name in QUANT_SETTINGS:
            set_quant(cldm, name, record, sites, sites_sel)
            syncs[name] = syncs_per_step(lambda n: model.restore_fused_feedback(
                lq, torch.Generator(device=lq.device).manual_seed(0), steps=n,
                score_threshold=0.0))
        part_done("host_syncs")
        for name in QUANT_SETTINGS:
            if syncs[name]["per_step"] != syncs["bf16"]["per_step"]:
                raise AssertionError(f"quant {name}: {syncs[name]} host syncs, bf16 {syncs['bf16']}")
    finally:
        set_quant(cldm, "bf16", (), (), ())
    bf16 = runs["bf16"][0]["image"]
    emit(
        "quant", steps=steps, card=smi, order=list(QUANT_ORDER),
        sites_per_step={"dynamic": len(record), "static": len(record),
                        "selective": len(record_sel)},
        selective_min_ratio=QUANT_SELECTIVE_RATIO, record_head=record[:8],
        int8_weight_cache_bytes=cache_bytes, allocated_by_first_calibration=cache_allocated,
        seconds={name: [r["seconds"] for r in rs] for name, rs in runs.items()},
        peak_memory_bytes={name: rs[0]["peak"] for name, rs in runs.items()},
        launches_per_request={name: {k: v for k, v in rs[0]["counts"].items() if v}
                              for name, rs in runs.items()},
        profile={name: {k: p[k] for k in ("wall_seconds", "wall_seconds_under_profiler",
                                          "device_busy_seconds", "device_idle_share",
                                          "kernel_launches", "watched")}
                 for name, p in profiles.items()},
        top_kernels={name: p["top_kernels"][:12] for name, p in profiles.items()},
        host_syncs_per_step={name: s["per_step"] for name, s in syncs.items()},
        host_syncs=syncs,
        against_bf16={name: dict(
            image_max_abs_diff=(rs[0]["image"].float() - bf16.float()).abs().max().item(),
            image_psnr_db=psnr(rs[0]["image"], bf16),
            tokens_equal=bool(torch.equal(rs[0]["tokens"], runs["bf16"][0]["tokens"])),
        ) for name, rs in runs.items() if name != "bf16"},
        same_seed_same_image=True, quantized_differs_from_bf16=True,
        w8a8_launches_per_site_and_step={
            name: sum(v for k, v in rs[0]["counts"].items() if k.startswith("w8a8_"))
            / (steps * n_sites)
            for name, rs in runs.items()
            for n_sites in [{"dynamic": len(record), "static": len(record),
                             "selective": len(record_sel)}.get(name, 0)] if n_sites},
        seconds_of=seconds_of, phase_seconds=time.perf_counter() - t_phase,
    )
    return kernels, runs["dynamic"][0]["counts"]


def proposal_topk_turns(model, lq) -> dict:
    """One spotter pass on a request's features with the proposals picked by
    the stable sort (``proposal_indices``, the repair) and by ``torch.topk``
    (before it), in turns (after, before, before, after): wall ms, median of
    5 after a warm-up, and whether the two picked the same proposals."""
    from tair_tpu_torch.spotter import transformer as tr

    feats = spotter_features(model, lq)
    stable = tr.proposal_indices

    def topk(scores, k):
        return torch.topk(scores, k, dim=1).indices

    outs = {}

    def timer(pick):
        def one() -> float:
            tr.proposal_indices = pick
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.no_grad():
                    outs[pick] = model.spotter_apply(feats)
                torch.cuda.synchronize()
                return 1e3 * (time.perf_counter() - t)
            finally:
                tr.proposal_indices = stable

        one()
        return statistics.median(one() for _ in range(5))

    after, before, turns = in_turns(stable, topk, timer=timer)
    same = all(torch.equal(outs[stable][k], outs[topk][k])
               for k in ("pred_logits", "pred_ctrl_points", "pred_texts"))
    return dict(stable_sort_ms=after, torch_topk_ms=before, turns_ms=turns,
                same_outputs=same)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def phase_ckpt(seed: int) -> dict:
    """The released checkpoints' path at full width: the default model from
    seed + 1 (another seed than the 0 that convert_weights and ``val``'s
    load_model start from, so that every equal tensor came through the files),
    exported by the port's exporters into the reference's files (the SD-2.1
    bundle as a Lightning .ckpt under state_dict with its three prefixes, the
    ControlNet as a .pt, SwinIR as a .pth with ``module.``, TESTR as a
    detectron2 .pkl under model and ``testr.``; float32, as released), turned
    into one npz by ``python -m tair_tpu_torch.convert_weights`` as a user runs
    it, and loaded on the card by ``val.load_model(..., ckpt=)`` with
    configs/val.yaml. Checks: every tensor of the loaded model equals the
    seeded model's bit for bit, and a fused SERVE_STEPS-step request at 512 x
    512 gives the seeded model's image bit for bit at the same seed, with the
    structure's launches. The files live in a temporary directory under build/,
    removed at the end. Returns the loaded model's request's launches."""
    import pickle
    import shutil
    import tempfile

    from tair_tpu_torch.config import load_config
    from tair_tpu_torch.val import load_model
    from tair_tpu_torch.weights import export as ex
    from tair_tpu_torch.weights.convert import SD_BUNDLE_PREFIX, jax_param_shapes, to_jax_params

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ckpt_", dir=root / "build"))
    try:
        model, lq = build_model(seed + 1)
        t0 = time.perf_counter()
        tree = to_jax_params(model.state_dict(), jax_param_shapes(model))
        cldm = model.cldm
        files = {"sd": work / "sd21-base-zsnr.ckpt", "controlnet": work / "DiffBIR_v2.1.pt",
                 "swinir": work / "realesrgan_s4_swinir_100k.pth",
                 "testr": work / "pretrain_testr_R50_polygon.pkl"}
        sd = {}
        for part, prefix in SD_BUNDLE_PREFIX.items():
            sd.update(getattr(ex, f"export_{part}")(tree[part], getattr(cldm, part).cfg, prefix))
        torch.save({"state_dict": _tensors(sd), "global_step": 0}, files["sd"])
        del sd
        torch.save(_tensors(ex.export_controlnet(tree["controlnet"], cldm.controlnet.cfg)),
                   files["controlnet"])
        swinir = ex.export_swinir(tree["swinir"], model.swinir.cfg)
        torch.save(_tensors({f"module.{k}": v for k, v in swinir.items()}), files["swinir"])
        with open(files["testr"], "wb") as f:
            pickle.dump({"model": {k: np.ascontiguousarray(v) for k, v in
                                   ex.export_testr(tree["testr"], model.testr.cfg).items()},
                         "__author__": "chip_smoke"}, f)
        del tree
        write_seconds = time.perf_counter() - t0

        npz = work / "tair.npz"
        run = run_entry_point(
            "tair_tpu_torch.convert_weights",
            ["--out", str(npz), *(a for k, p in files.items() for a in (f"--{k}", str(p)))], work)
        printed = run["stdout"].splitlines()
        expect = [f"loaded SD bundle from {files['sd']}",
                  f"loaded ControlNet from {files['controlnet']} (missing=0, unused=0)",
                  f"loaded SwinIR from {files['swinir']} (missing=0)",
                  f"loaded TESTR from {files['testr']} (missing=0)", f"wrote {npz}"]
        if printed != expect:
            raise AssertionError(f"convert_weights printed {printed}, expected {expect}")

        cfg = load_config(str(serving_config(work / "serve.yaml")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_model(cfg, lq.device, str(npz))
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        want_state, got_state = model.state_dict(), loaded.state_dict()
        if set(got_state) != set(want_state):
            raise AssertionError("the loaded model's parameters are not the seeded model's")
        differ = [k for k, v in want_state.items()
                  if v.dtype != got_state[k].dtype or not torch.equal(v, got_state[k])]
        if differ:
            raise AssertionError(f"{len(differ)} tensors differ from the seeded model: {differ[:5]}")

        image, tokens, seconds = restore_request(model, lq, seed, SERVE_STEPS)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        image_l, tokens_l, seconds_l = restore_request(loaded, lq, seed, SERVE_STEPS)
        counts = {k: n for k, n in launch_counts().items() if n}
        peak = torch.cuda.max_memory_allocated()
        check_restored(image_l, tokens_l)
        want = serving_launches(loaded, SERVE_STEPS, SERVE_STEPS)
        if counts != want:
            raise AssertionError(f"ckpt: launches {counts}, structure says {want}")
        if not (torch.equal(image, image_l) and torch.equal(tokens, tokens_l)):
            raise AssertionError("the converted weights' request differs from the seeded model's")
        emit(
            "ckpt", steps=SERVE_STEPS, files_bytes={k: p.stat().st_size for k, p in files.items()},
            npz_bytes=npz.stat().st_size, write_seconds=write_seconds,
            convert_seconds=run["seconds"], load_seconds=load_seconds,
            tensors=len(want_state), tensors_equal=True, image_equal=True,
            request_seconds=dict(seeded=seconds, converted=seconds_l),
            peak_memory_bytes=peak, launches_per_request=want,
            phase_seconds=time.perf_counter() - t_phase,
        )
        del model, loaded
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# DiffBIRPipeline.run (phase diffbir): model passes of each sampler family in a
# request of n steps without guidance (classifier-free guidance doubles them):
# the multistep DPM-Solver++ evaluates its n + 1 nodes once each, the
# singlestep one order passes an interval and the final node, EDM's heun skips
# its second pass where the next sigma is 0
DIFFBIR_SAMPLER_PASSES = {
    "spaced": lambda n: n, "ddim": lambda n: n,
    "dpm_solver_1": lambda n: n + 1, "dpm_solver_2": lambda n: n + 1,
    "dpm_solver_3": lambda n: n + 1, "dpm_solver_s1": lambda n: n + 1,
    "dpm_solver_s2": lambda n: 2 * n + 1, "dpm_solver_s3": lambda n: 3 * n + 1,
    "edm_euler": lambda n: n, "edm_heun": lambda n: 2 * n - 1, "edm_dpmpp_2m": lambda n: n,
    "edm_euler_ancestral": lambda n: n, "edm_dpmpp_2m_sde": lambda n: n,
}
DIFFBIR_REF_TOL = 1e-3  # float32 on both sides through a whole tiled request


def random_init(module, seed: int):
    """Weights of a cleaner from a seed: normal with variance 1/fan_in, norm
    scales 1, biases 0, relative-position tables 0.02-normal."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if name.endswith(".weight") else 0.0)
            else:
                std = 0.02 if name.endswith("rel_pos_bias_table") else p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


def phase_diffbir_reference(seed: int) -> dict:
    """A tiled request with classifier-free guidance (DDIM) of the tiny model
    in float32 on the card against the same weights, input and noise on the CPU;
    returns the card's launches."""
    from tair_tpu_torch.diffbir_pipeline import DiffBIRPipeline
    from tair_tpu_torch.models.tokenizer import tokenize
    from tair_tpu_torch.pipeline import build_tiny_model

    ref = build_tiny_model(dtype=torch.float32, device="cpu")
    ref.init_parameters(torch.Generator().manual_seed(seed))
    dut = build_tiny_model(dtype=torch.float32, device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(seed)
    lq = torch.from_numpy(rng.random((1, 96, 96, 3), dtype=np.float32))
    x_T = torch.from_numpy(rng.standard_normal((1, 16, 16, 4), dtype=np.float32))
    toks = torch.from_numpy(tokenize(["a shop sign"])).long()
    kw = dict(steps=2, cfg_scale=3.0, rescale_cfg=True, tiled=True, tile_size=64,
              tile_stride=32, sampler_type="ddim")
    reset_launch_counts()
    out_d = DiffBIRPipeline(dut).run(lq.cuda(), toks.cuda(), x_T=x_T.cuda(), **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), **flash_launches(dut, torch.float32, 2 * 2, backward=False)}
    if counts != want:
        raise AssertionError(f"diffbir reference: launches {counts}, structure says {want}")
    out_r = DiffBIRPipeline(ref).run(lq, toks, x_T=x_T, **kw)
    err = (out_d.cpu() - out_r).abs().max().item()
    if not err <= DIFFBIR_REF_TOL or tuple(out_d.shape) != (1, 96, 96, 3):
        raise AssertionError(f"diffbir tiny model on the card against the CPU: |d| {err} "
                             f"(tol {DIFFBIR_REF_TOL}), shape {tuple(out_d.shape)}")
    emit("diffbir_reference", model="build_tiny_model float32", request=kw, max_abs_err=err,
         tol=DIFFBIR_REF_TOL, flash_launches=counts["flash_attention_fwd"])
    return counts


def phase_diffbir(model, seed: int, steps: int) -> dict:
    """``DiffBIRPipeline.run`` on the full-width model (bf16, random weights):
    an untiled request with classifier-free guidance (rescaled), strength,
    noise_aug, MSE guidance and the colour fix on a 460 x 500 LQ; a tiled
    1024 x 1024 request (9 latent tiles of 64 x 64 in one batch per model
    pass, the tiled VAE of 9 tiles with pooled GroupNorm) with guidance and
    DDIM; every sampler family once; SCUNet as the cleaner; BSRNet alone. For
    each: shape, range, finite, the same seed giving the same image, and the
    kernel launches equal to the structure's (no other kernel). Returns the
    launches of all its requests together."""
    from tair_tpu_torch.diffbir_pipeline import DiffBIRPipeline
    from tair_tpu_torch.models.cleaners import RRDBNet, SCUNet
    from tair_tpu_torch.models.tokenizer import tokenize
    from tair_tpu_torch.utils.guidance import MSEGuidance
    from tair_tpu_torch.utils.tilevae import tiled_vae_decode, tiled_vae_encode

    t_phase = time.perf_counter()
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(tokenize(["a shop sign"])).long().to(dev)
    total, report = {}, {}

    def request(pipe, lq, passes: int, req_seed: int, **kw):
        """Two runs from one seed: both equal, each launching the structure's
        kernels; returns the seconds of both, the peak and the image."""
        want = {**dict.fromkeys(launch_counts(), 0),
                **flash_launches(model, torch.bfloat16, passes, backward=False)}
        images, seconds = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t = time.perf_counter()
            image = pipe.run(lq, tokens, torch.Generator(device=dev).manual_seed(req_seed),
                             steps=steps, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            counts = launch_counts()
            if counts != want:
                raise AssertionError(f"diffbir {kw}: launches "
                                     f"{ {k: n for k, n in counts.items() if n} }, structure "
                                     f"says { {k: n for k, n in want.items() if n} }")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            images.append(image)
        image = images[0]
        if (tuple(image.shape) != tuple(lq.shape) or not torch.isfinite(image).all()
                or image.min().item() < 0.0 or image.max().item() > 1.0):
            raise AssertionError(f"diffbir {kw}: image {tuple(image.shape)} for "
                                 f"{tuple(lq.shape)}, not finite or not in [0, 1]")
        if not torch.equal(images[0], images[1]):
            raise AssertionError(f"diffbir {kw}: the same seed gave two different images")
        return dict(seconds=seconds, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    image_mean=image.mean().item(),
                    fwd_tc_launches=want["flash_attention_fwd_tc"],
                    fwd_tc_wide_launches=want["flash_attention_fwd_tc_wide"]), image

    def lq_of(h, w):
        return torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32)).to(dev)

    pipe = DiffBIRPipeline(model)
    cfg = dict(cfg_scale=4.0, rescale_cfg=True, sampler_type="spaced", strength=0.9,
               noise_aug=10, guidance=MSEGuidance(scale=1e-4), color_fix=True)
    lq = lq_of(460, 500)
    report["untiled_cfg"], _ = request(pipe, lq, 2 * steps, seed, **cfg)
    report["untiled_cfg"]["host_syncs"] = syncs_per_step(
        lambda n: pipe.run(lq, tokens, torch.Generator(device=dev).manual_seed(seed),
                           steps=n, **cfg))

    tiled = dict(cfg_scale=4.0, tiled=True, tile_size=512, tile_stride=256, sampler_type="ddim")
    big = lq_of(1024, 1024)
    report["tiled_cfg_ddim"], _ = request(pipe, big, 2 * steps, seed, **tiled)
    report["tiled_cfg_ddim"]["host_syncs"] = syncs_per_step(
        lambda n: pipe.run(big, tokens, torch.Generator(device=dev).manual_seed(seed),
                           steps=n, **tiled))
    # the tiled autoencoder alone: one D = 512 launch a call, its 9 tiles one batch
    with torch.no_grad():
        clean = model.clean(big) * 2.0 - 1.0
        vae = {}
        for name, fn in (("encode", lambda: tiled_vae_encode(model.cldm, clean, 512, 256)),
                         ("decode", lambda: tiled_vae_decode(model.cldm, z, 64, 32))):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                reset_launch_counts()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                wide = launch_counts()["flash_attention_fwd_tc_wide"]
                if wide != 1:
                    raise AssertionError(f"tiled VAE {name}: {wide} D = 512 launches, not 1")
            if name == "encode":
                z = out
            vae[f"{name}_seconds"] = times
        if tuple(z.shape) != (1, 128, 128, 4) or tuple(out.shape) != (1, 1024, 1024, 3):
            raise AssertionError(f"tiled VAE shapes {tuple(z.shape)}, {tuple(out.shape)}")
    report["tiled_vae"] = vae

    samplers = {}
    lq512 = lq_of(512, 512)
    for k, (name, passes) in enumerate(DIFFBIR_SAMPLER_PASSES.items()):
        samplers[name], _ = request(pipe, lq512, passes(steps), seed + k, sampler_type=name)
    report["samplers"] = samplers

    scunet = random_init(SCUNet(), seed).to(dev, model.cldm.vae.dtype)
    report["scunet_cleaner"], _ = request(DiffBIRPipeline(model, cleaner=scunet), lq512,
                                          steps, seed)
    del scunet
    bsrnet = random_init(RRDBNet(), seed).to(dev, model.cldm.vae.dtype)
    with torch.no_grad():
        lq128 = lq_of(128, 128)
        outs, times = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(bsrnet(lq128))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    if tuple(outs[0].shape) != (1, 512, 512, 3) or not torch.isfinite(outs[0]).all() \
            or not torch.equal(outs[0], outs[-1]):
        raise AssertionError(f"BSRNet x4 on 128 x 128: {tuple(outs[0].shape)}, finite "
                             f"{bool(torch.isfinite(outs[0]).all())}, repeatable "
                             f"{torch.equal(outs[0], outs[-1])}")
    report["bsrnet_x4_128"] = dict(seconds=times)
    del bsrnet
    emit("diffbir", steps=steps, model="build_default_model bfloat16", **report,
         flash_launches={k: n for k, n in total.items() if n},
         phase_seconds=time.perf_counter() - t_phase)
    return total


def phase_profile(phase: str, run) -> None:
    emit(phase, **profiled(run))


def profiled(run, watch=(), ops=(), cpu: bool = True) -> dict:
    """Device time by kernel over one call of `run` (which returns its wall
    seconds), from torch.profiler, and the device's idle share against the
    same call's time without the profiler. `watch` names kernels (by a part of
    their name) whose device time and calls are reported whatever their rank;
    `ops` names operators (``aten::...``) whose kernels' device time and
    calls are reported. cpu=False traces the device alone (no operator
    events: `ops` reads nothing), which shortens the profiler's own
    processing of a request several times over."""
    from torch.profiler import ProfilerActivity, profile

    wall = run()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA], acc_events=True) as prof:
        wall_profiled = run()
    averages = prof.key_averages()
    rows = [
        (e.key, e.device_time_total / 1e6, e.count)
        for e in averages
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
        # a range such as "Optimizer.step#AdamW.step" repeats its kernels' time
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.")
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(
        wall_seconds=wall, wall_seconds_under_profiler=wall_profiled,
        device_busy_seconds=busy if rows else None,
        device_idle_share=(1.0 - busy / wall) if rows else None,
        kernel_launches=sum(r[2] for r in rows),
        top_kernels=[dict(name=n[:90], seconds=s, calls=c) for n, s, c in rows[:30]],
        **({"watched": {
            w: dict(seconds=sum(s for n, s, _ in rows if w in n),
                    calls=sum(c for n, _, c in rows if w in n)) for w in watch
        }} if watch else {}),
        **({"ops": {
            o: dict(seconds=sum(e.device_time_total for e in averages if e.key == o) / 1e6,
                    calls=sum(e.count for e in averages if e.key == o)) for o in ops
        }} if ops else {}),
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10, help="steps of the two full requests")
    ap.add_argument("--train-steps", type=int, default=1, help="timed training steps")
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
    kernels, path_launches = [], {}
    if "kernels" in phases:
        kernels = [
            *check_flash(rng, smi, args.steps),
            *check_flash_bwd(rng, smi),
            *check_msda(rng, smi, args.steps),
            check_msda_bwd(rng, smi),
            check_patchify(rng, smi, args.steps),
        ]
    if "probes" in phases:
        probe_kernels, path_launches["probes"] = phase_probes(smi, PROBE_REPS)
        kernels += probe_kernels
    if "reference" in phases:
        path_launches["reference"] = phase_reference(args.seed)
    host_syncs = None
    if "diffbir" in phases:
        path_launches["diffbir_reference"] = phase_diffbir_reference(args.seed)
    if phases & {"restore", "restore_flatpatch", "layers", "enc_topk", "quant", "matcher",
                 "diffbir", "val"} or args.profile_steps:
        model, lq = build_model(args.seed)
        if "restore" in phases:
            path_launches["restore"] = phase_restore(model, lq, args.seed, args.steps)
        if "restore_flatpatch" in phases:
            path_launches["restore_flatpatch"] = phase_restore_flatpatch(
                model, lq, args.seed, FLATPATCH_STEPS
            )
        if "layers" in phases:
            phase_layers(model, lq, args.steps)
        if "enc_topk" in phases:
            path_launches["enc_topk"] = phase_enc_topk(model, lq, args.seed, SERVE_STEPS)
        if "quant" in phases:
            quant_kernels, path_launches["quant"] = phase_quant(
                model, lq, args.seed, SERVE_STEPS, smi)
            kernels += quant_kernels
        if "matcher" in phases:
            kernels.append(phase_matcher(model, lq, args.seed, smi))
        if "diffbir" in phases:
            path_launches["diffbir"] = phase_diffbir(model, args.seed, SERVE_STEPS)
        if "val" in phases:
            host_syncs = count_host_syncs(model, lq)
        if args.profile_steps:
            def request() -> float:
                return restore_request(model, lq, args.seed, args.profile_steps)[2]

            phase_profile("profile", request)
        del model, lq
        torch.cuda.empty_cache()
    if "ckpt" in phases:
        path_launches["ckpt"] = phase_ckpt(args.seed)
    if "train_reference" in phases:
        path_launches["train_reference"] = phase_train_reference(args.seed)
    if "train" in phases:
        model_kernels = [e for e in kernels if "ms_per_train_step" in e]
        path_launches["train"] = phase_train(
            args.seed, args.train_steps, model_kernels, args.profile_train
        )
    iqa_weights = {}
    if phases & {"iqa", "train_entry", "val"}:
        import shutil

        iqa_root = Path(__file__).resolve().parent / "build" / "iqa"
        t0 = time.perf_counter()
        iqa_weights = write_iqa_checkpoints(iqa_root, args.seed)
        emit("iqa_checkpoints", seconds=time.perf_counter() - t0, weights=iqa_weights,
             megabytes=sum(p.stat().st_size for p in iqa_root.iterdir()) / 1e6)
    try:
        run_iqa_and_later_phases(args, phases, smi, kernels, path_launches, host_syncs,
                                 iqa_weights)
    finally:
        if iqa_weights:
            shutil.rmtree(iqa_root, ignore_errors=True)


def run_iqa_and_later_phases(args, phases, smi, kernels, path_launches, host_syncs,
                             iqa_weights) -> None:
    """Phases iqa, train_entry and the entry points, then the verdict."""
    if "iqa" in phases:
        phase_iqa(iqa_weights, args.seed, smi)
    if "train_entry" in phases:
        path_launches["train_entry"] = phase_train_entry(args.seed, iqa_weights)
        for entry in kernels:
            if "train" in entry["paths"]:  # the trainer runs every kernel of the train step
                entry["paths"] = (*entry["paths"], "train_entry")
    if phases & set(ENTRY_PHASES):
        torch.cuda.empty_cache()  # the entry points run in processes of their own
        structure = serving_structure()
        if "val" in phases:
            path_launches["val"] = phase_val(structure, args.seed, host_syncs, iqa_weights)
        if "val_patches" in phases:
            path_launches["val_patches"] = phase_val_patches(structure, args.seed)
        if "spotter_eval" in phases:
            path_launches["spotter_eval"] = phase_spotter_eval(structure)
        for entry in kernels:
            if entry["name"] in ("flash_attention_fwd_tc", "flash_attention_fwd_tc_wide",
                                 "msda_corner_reduce_fwd"):
                entry["paths"] = (*entry["paths"], *(p for p in ENTRY_PHASES if p in phases))
    for entry in kernels:
        # the requests of phases ckpt, enc_topk and quant run the serving path's kernels
        if entry["name"] in ("flash_attention_fwd_tc", "flash_attention_fwd_tc_wide",
                             "msda_corner_reduce_fwd"):
            entry["paths"] = (*entry["paths"],
                              *(p for p in ("enc_topk", "quant", "ckpt") if p in phases))
    if phases != set(PHASES):
        # a partial run is for development: it prints what it measured and no verdict
        print(json.dumps({"kernels": kernels, "launches": path_launches}), flush=True)
        raise SystemExit(f"partial run of phases {sorted(phases)}: no verdict")
    for entry in kernels:
        # each path was driven with the counts set to 0 just before it: one restore
        # request, one flatpatch request, the last training step, the probes' runs,
        # the tiny model's request and training step
        entry["launches_by_path"] = {
            path: path_launches[path][entry["name"]] for path in entry["paths"]
        }
        entry["launches"] = sum(entry["launches_by_path"].values())
        if min(entry["launches_by_path"].values()) < 1:
            raise AssertionError(
                f"{entry['name']} was not launched on a path that runs it: "
                f"{entry['launches_by_path']}"
            )
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
