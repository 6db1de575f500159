"""The port's trainer (three-stage TeReDiff training).

Counterpart of the JAX package's ``train.py``: per step a batch from the
dataset the config names (synthesis, collate and tokenization on the host, in
a background thread), the RealESRGAN degradation on the device, the
v-parameterisation diffusion loss (+ the weighted OCR loss in stages 2 and 3)
and an AdamW update; metric logging, checkpoints of the whole train state,
weight-only exports, and in-loop validation (sampling, PSNR/SSIM, OCR losses on
the UNet features). Usage:

    python -m tair_tpu_torch.train --config configs/train_chip_demo.yaml
    python -m tair_tpu_torch.train --config configs/train_smoke.yaml --device cpu

It runs on the CUDA device unless ``--device cpu`` is given, and raises when
there is none. Data parallelism (``n_data_devices`` > 1) and ``fsdp`` belong to
the parallel slice and raise. Besides the JAX trainer's metric stream
(``metrics.jsonl``) it writes one record per step to ``steps.jsonl`` in the
experiment directory: seconds of the step, of the wait for its batch and of
the batch's making on the host, milliseconds of the degradation (between CUDA
events around the call on the card, so the host's gaps between its launches
count; by the host clock on the CPU), the losses, the kernel launches of the
step, and peak device memory.

Randomness: each step's degradation and train-step draws come from generators
seeded by (seed, stream, step), so a resumed run draws what an uninterrupted
one would. As in the JAX trainer, the data iterator starts over from its seed
on a resume.
"""

from __future__ import annotations

import argparse
import os
import time


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tair_tpu_torch.train")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="override train.train_steps (smoke runs)")
    parser.add_argument("--init-params", default=None,
                        help="override train.init_params (warm start from a weight export)")
    parser.add_argument("--start-step", type=int, default=None,
                        help="set the starting global step (segmented training)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def stream_seed(seed: int, stream: int, step: int) -> int:
    """A 63-bit seed for one random stream of one step."""
    import numpy as np

    return int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0] >> 1)


# the random streams of a step
_DEGRADE, _STEP = 1, 2


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from ..config import build_dataset, build_model, compute_dtype, load_config
    from ..data.batch_transform import degrade_batch
    from ..data.satext import data_iterator
    from ..diffusion.diffusion import Diffusion
    from ..ops.launches import launch_counts, reset_launch_counts
    from ..pipeline import _resolve_device
    from ..utils.logging import MetricLogger, is_main_process
    from .checkpoint import (
        latest_checkpoint, load_params, restore_checkpoint, save_checkpoint, save_params,
        state_checksums,
    )
    from .step import create_train_state, make_train_step

    cfg = load_config(args.config)
    tc = cfg.train
    max_steps = args.max_steps or tc.train_steps
    device = _resolve_device(args.device)
    if tc.fsdp:
        raise NotImplementedError("train.fsdp belongs to the parallel slice of the port")
    n_data = tc.n_data_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if n_data != 1:
        raise NotImplementedError(
            f"n_data_devices={n_data}: data parallelism belongs to the parallel slice of the port"
        )
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    logger = MetricLogger(tc.exp_dir, log_tool=tc.log_tool)
    step_logger = MetricLogger(tc.exp_dir, filename="steps.jsonl")
    main_process = is_main_process()
    if main_process:
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        print(f"device={device} ({name}) stage={tc.stage}", flush=True)

    model = build_model(cfg, device, training=True)
    model.init_parameters(torch.Generator(device=device).manual_seed(tc.seed))
    init_params_path = args.init_params or tc.init_params
    if init_params_path:
        load_params(init_params_path, model)
        if main_process:
            print(f"initialized params from {init_params_path}", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    if main_process:
        print(f"total params: {n_params / 1e6:.1f}M", flush=True)

    state = create_train_state(model, tc.stage, tc.learning_rate, grad_accum=tc.grad_accum)
    if args.start_step:
        state.step = args.start_step

    ckpt_dir = os.path.join(tc.exp_dir, "checkpoints")
    resume_path = tc.resume or latest_checkpoint(ckpt_dir)
    if resume_path:
        sync()
        t0 = time.perf_counter()
        restore_checkpoint(resume_path, state)
        sync()
        read_s = time.perf_counter() - t0
        if main_process:
            print(f"resumed from {resume_path} at step {state.step}", flush=True)
            logger.log(state.step, {
                "read_seconds": read_s, "gigabytes": _dir_bytes(resume_path) / 1e9,
                **{f"restored_{k}": v for k, v in state_checksums(state).items()},
            }, prefix="checkpoint/")

    spotter_fn = None
    if tc.stage in ("stage2", "stage3"):
        from ..spotter.losses import CriterionConfig

        spotter_fn = model.spotter_loss_fn(criterion_cfg=CriterionConfig(matcher=tc.matcher))
    step_fn = make_train_step(
        model, Diffusion(model.schedule, parameterization="v"),
        spotter_loss_fn=spotter_fn, ocr_loss_weight=tc.ocr_loss_weight,
        timestep_max=tc.timestep_max, compute_dtype=compute_dtype(cfg),
    )

    train_ds = build_dataset(cfg, "TRAIN")
    batch_seconds = []
    it = data_iterator(
        train_ds, tc.batch_size * n_data, seed=tc.seed,
        max_inst=cfg.dataset.max_instances, batch_seconds=batch_seconds,
    )

    def save(step: int) -> None:
        sync()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, state, step)
        logger.log(step, {
            "write_seconds": time.perf_counter() - t0, "gigabytes": _dir_bytes(path) / 1e9,
            **{f"saved_{k}": v for k, v in state_checksums(state).items()},
        }, prefix="checkpoint/")
        print(f"saved checkpoint {path}", flush=True)

    def export(step: int) -> None:
        path = os.path.join(tc.exp_dir, f"params_step_{step:08d}.npz")
        save_params(path, model, dtype=np.float16)
        print(f"exported weights {path}", flush=True)

    loss_acc, t_last = [], time.time()
    batches_taken = 0
    global_step = state.step
    while global_step < max_steps:
        t_iter = time.perf_counter()
        raw = next(it)
        wait_s = time.perf_counter() - t_iter
        host_s = batch_seconds[batches_taken]
        batches_taken += 1
        host_batch = {
            k: torch.from_numpy(raw[k]).to(device)
            for k in ("hq", "kernel1", "kernel2", "sinc_kernel", "tokens", "inst_mask",
                      "boxes", "ctrl_points", "texts")
        }
        reset_launch_counts()
        deg_seed = stream_seed(tc.seed, _DEGRADE, global_step)
        timer = _DeviceTimer(cuda)
        gt, lq = degrade_batch(
            host_batch["hq"], host_batch["kernel1"], host_batch["kernel2"],
            host_batch["sinc_kernel"], cfg.degradation, rng=np.random.default_rng(deg_seed),
            generator=torch.Generator(device=device).manual_seed(deg_seed),
        )
        timer.stop()
        batch = {"gt": gt, "lq": lq, **{
            k: host_batch[k] for k in ("tokens", "inst_mask", "boxes", "ctrl_points", "texts")
        }}
        step_gen = torch.Generator(device=device).manual_seed(
            stream_seed(tc.seed, _STEP, global_step))
        state, aux = step_fn(state, batch, generator=step_gen)
        aux = {k: float(v) for k, v in aux.items()}  # waits for the step
        global_step += 1
        loss_acc.append(aux)
        step_logger.log(global_step, {
            "seconds": time.perf_counter() - t_iter,
            "data_wait_seconds": wait_s, "host_batch_seconds": host_s,
            "degrade_ms": timer.ms(), **aux,
            "launches": {k: n for k, n in launch_counts().items() if n},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        })

        if global_step % tc.log_loss_every == 0:
            metrics = {k: float(np.mean([a[k] for a in loss_acc])) for k in loss_acc[-1]}
            dt = (time.time() - t_last) / len(loss_acc)
            metrics["sec_per_step"] = dt
            metrics["img_per_sec"] = tc.batch_size * n_data / dt
            logger.log(global_step, metrics, prefix="train/")
            loss_acc, t_last = [], time.time()

        if global_step % tc.ckpt_every == 0 and main_process:
            save(global_step)

        if tc.save_params_every and global_step % tc.save_params_every == 0 and main_process:
            export(global_step)

        if global_step % tc.log_image_every == 0:
            val_metrics = run_validation(
                model, cfg, gt, lq, host_batch["tokens"], n_images=tc.num_val_images,
                feat_iterations=tc.unet_feat_sampling_timestep,
                targets={
                    k: host_batch[k] for k in ("inst_mask", "boxes", "ctrl_points", "texts")
                } if tc.stage in ("stage2", "stage3") else None,
                image_dir=os.path.join(tc.exp_dir, "val_images", f"step_{global_step}"),
            )
            logger.log(global_step, val_metrics, prefix="val/")

    if main_process:
        # skip the final export when the in-loop one just fired at this step
        if tc.save_params_every and global_step % tc.save_params_every != 0:
            export(global_step)
        if tc.final_checkpoint:
            save(global_step)
        print("training done", flush=True)


class _DeviceTimer:
    """Milliseconds between its creation and `stop`: between CUDA events on the
    card, by the host clock on the CPU. Read with `ms` after the work has
    finished."""

    def __init__(self, cuda: bool):
        import torch

        self.cuda = cuda
        if cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return 1e3 * (self.t1 - self.t0)


def _dir_bytes(path: str) -> int:
    return sum(
        os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files
    )


# the JAX trainer's validation metrics beyond PSNR/SSIM, which need modules
# (NIQE) or external weights (the others) that the port does not have yet
_AUX_METRICS = ("lpips", "dists", "clipiqa", "maniqa", "musiq")


def skipped_val_metrics(cfg) -> list:
    """Names of the JAX trainer's extra validation metrics that this run
    would compute there and cannot here: NIQE always, the learned ones where
    the config names their weights."""
    return ["niqe"] + [m for m in _AUX_METRICS if getattr(cfg.val, f"{m}_weights", None)]


def run_validation(
    model, cfg, gt, lq, tokens, n_images: int = 2, steps: int = 10,
    feat_iterations=(), targets=None, image_dir=None, generator=None,
):
    """In-loop validation: restore a few images with their prompt, report
    PSNR/SSIM against the ground truth, and (stage 2/3) the OCR loss of the
    spotter on the UNet features captured at each tagged iteration. Runs
    under the config's compute type; the metrics the port lacks are reported
    by name under ``skipped_metrics``."""
    import numpy as np
    import torch

    from ..config import compute_dtype
    from ..spotter.losses import CriterionConfig, set_criterion
    from ..utils.logging import is_main_process
    from ..utils.metrics import psnr, ssim
    from ..utils.png import write_png

    n = min(n_images, lq.shape[0])
    lq_n, gt_n, tok_n = lq[:n], gt[:n], tokens[:n]
    tags = tuple(t for t in feat_iterations if t <= steps) if targets else ()
    if generator is None:
        generator = torch.Generator(device=lq.device).manual_seed(0)
    dtype = compute_dtype(cfg)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), torch.autocast(
            lq.device.type, dtype=dtype, enabled=dtype != torch.float32
        ):
            restored, _, feats = model.restore(
                lq_n, tok_n, generator=generator, steps=steps, feat_iterations=tags
            )
            gt01 = (gt_n.float() + 1.0) / 2.0
            metrics = {
                "psnr": psnr(restored, gt01).mean().item(),
                "ssim": ssim(restored, gt01).mean().item(),
            }
            if tags and model.testr is not None:
                tgt = {k: v[:n] for k, v in targets.items()}
                for ti, tag in enumerate(sorted(tags)):
                    out = model.spotter_apply(tuple(f[ti] for f in feats))
                    losses = set_criterion(out, tgt, CriterionConfig())
                    metrics[f"ocr_loss_iter{tag}"] = losses["loss_total"].item()
    finally:
        model.train(was_training)
    metrics["skipped_metrics"] = ",".join(skipped_val_metrics(cfg))
    if image_dir is not None and is_main_process():
        os.makedirs(image_dir, exist_ok=True)
        panel = torch.cat([lq_n.float(), restored, gt01], dim=2).cpu().numpy()
        for bi in range(panel.shape[0]):  # lq | restored | gt
            write_png(os.path.join(image_dir, f"val_{bi}.png"),
                      (np.clip(panel[bi], 0, 1) * 255).astype(np.uint8))
    return metrics


if __name__ == "__main__":
    main()
