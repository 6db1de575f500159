#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version at every shape the restore loop gives it,
then drives the port's main path (``TeReDiff.restore_fused_feedback``, full
width, bfloat16, random weights from a seed) and checks that it went through
the kernels. One JSON line per phase; the last line is the verdict. Any failed
check raises, so the exit code is non-zero and no verdict is printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in paths])


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
                calls_per_restore=per_step * steps + per_restore, max_abs_err=err,
                rtol=rtol, atol=atol, max_share_of_tol=share,
                mean_abs_plain=ref_abs_mean, lse_abs_err=lse_err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            ))
    head = next(r for r in rows if r["shape"] == "unet_self_64" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="flash_attention_fwd", card=smi, shapes=rows,
         **per_restore_sums(rows))
    return dict(
        name="flash_attention_fwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="tair_tpu/ops/flash_attention.py:168",
        shape="Tq=Tk=4096 H=5 D=64 bfloat16", max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
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
                calls_per_restore=per_pass * steps, max_abs_err=err,
                tol=K3_TOL, ms=time_ms(lambda: mr.msda_corner_reduce(g, *ws, k)),
                plain_ms=time_ms(lambda: mr.msda_corner_reduce_plain(g, *ws, k)),
                library_ms=None, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            ))
            del g, ws, out, ref
    head = next(r for r in rows if r["shape"] == "encoder" and r["dtype"] == "bfloat16")
    emit("kernels", kernel="msda_corner_reduce_fwd", card=smi, shapes=rows,
         **per_restore_sums(rows))
    return dict(
        name="msda_corner_reduce_fwd", route="cuda",
        source="tair_tpu_torch/ops/csrc/msda_reduce.cu",
        replaces="tair_tpu/ops/msda_reduce.py:150",
        shape="NQ=9472 lanes=128 K=16 D=32 bfloat16", max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
    )


def phase_reference(seed: int) -> None:
    """The whole loop on a small input against a reference: the tiny model in
    float32 on the card (attention and msda through the kernels) and the same
    weights, input and noise on the CPU (plain versions)."""
    from tair_tpu_torch.ops import flash_attention as fa
    from tair_tpu_torch.ops import msda_reduce as mr
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
    fa.launches = 0
    mr.launches = 0
    img_d, tok_d = dut.restore_fused_feedback(
        lq.cuda(), steps=steps, score_threshold=0.0, x_T=x_T.cuda(),
        step_noises=[n.cuda() for n in noises],
    )
    torch.cuda.synchronize()
    launches = (fa.launches, mr.launches)
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
    from tair_tpu_torch.ops import flash_attention as fa
    from tair_tpu_torch.ops import msda_reduce as mr
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
    fa.launches = 0
    mr.launches = 0
    image, tokens, seconds = request(seed, steps)
    k1_launches, k3_launches = fa.launches, mr.launches
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


def phase_profile(model, lq, seed: int, steps: int) -> None:
    """Device time by kernel over one short request, from torch.profiler, and
    the device's idle share against the same request's time without it."""
    from torch.profiler import ProfilerActivity, profile

    def request():
        gen = torch.Generator(device=lq.device).manual_seed(seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.restore_fused_feedback(lq, generator=gen, steps=steps, score_threshold=0.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall = request()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        wall_profiled = request()
    rows = [
        (e.key, e.device_time_total / 1e6, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    emit(
        "profile", steps=steps, wall_seconds=wall, wall_seconds_under_profiler=wall_profiled,
        device_busy_seconds=busy if rows else None,
        device_idle_share=(1.0 - busy / wall) if rows else None,
        kernel_launches=sum(r[2] for r in rows),
        top_kernels=[dict(name=n[:90], seconds=s, calls=c) for n, s, c in rows[:25]],
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50, help="steps of the two full requests")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="also trace a request of this many steps with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    import tair_tpu_torch.pipeline  # noqa: F401  (a missing package fails before any output)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    kernels = [check_flash(rng, smi, args.steps), check_msda(rng, smi, args.steps)]
    phase_reference(args.seed)
    model, lq = build_model(args.seed)
    launches = phase_restore(model, lq, args.seed, args.steps)
    phase_layers(model, lq, args.steps)
    if args.profile_steps:
        phase_profile(model, lq, args.seed, args.profile_steps)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
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
