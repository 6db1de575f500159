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
    torchrun --nproc_per_node=N -m tair_tpu_torch.train --config configs/train_stage3.yaml
    torchrun --nproc_per_node=2 -m tair_tpu_torch.train --config configs/train_smoke_fsdp.yaml --device cpu

It runs on the CUDA device unless ``--device cpu`` is given, and raises when
there is none. Under ``torchrun`` each process drives one card (NCCL; gloo on
the CPU) and the data axis spans the processes: ``n_data_devices`` defaults to
their number and must equal it. Every process reads the same global batch of
``batch_size × n_data`` rows, degrades it, and steps on its own rows with its
rows of the global batch's draws; the gradients are averaged over the
processes (``train.fsdp``: sharded by the JAX package's rule with FSDP2), so
the update is the global batch's. Logging, images and checkpoint files come
from rank 0; a checkpoint of a sharded state is gathered first and loads into
a single process. Besides the JAX trainer's metric stream
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
from typing import Optional


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
    from ..parallel.fsdp import (
        GradientSync, apply_fsdp, fsdp_units, local_bytes, sharded_fraction,
    )
    from ..parallel.mesh import DATA_AXIS, create_mesh, init_distributed, shard_batch, world_size
    from ..pipeline import _resolve_device
    from ..utils.logging import MetricLogger, is_main_process
    from .checkpoint import (
        latest_checkpoint, load_params, restore_checkpoint, save_checkpoint, save_params,
        state_checksums, state_dicts,
    )
    from .stages import apply_trainable_mask
    from .step import create_train_state, make_draws, make_train_step

    cfg = load_config(args.config)
    tc = cfg.train
    max_steps = args.max_steps or tc.train_steps
    device = init_distributed(_resolve_device(args.device).type, group_of_one=tc.fsdp)
    n_data = tc.n_data_devices or world_size()
    if world_size() > n_data and world_size() % n_data == 0:
        raise ValueError(
            f"{world_size()} processes over {n_data} data devices leave a model axis of "
            f"{world_size() // n_data}: the trainer, like the JAX package's train.py, "
            "shards on the data axis only; a model axis trains through "
            "train.step.make_train_step on parallel.mesh.create_mesh(n_data, n_model)"
        )
    # a mesh wherever more than one process or FSDP is asked for; one the
    # group cannot hold raises
    mesh = create_mesh(n_data, device_type=device.type) if (
        n_data > 1 or world_size() > 1 or tc.fsdp) else None
    group = mesh.get_group(DATA_AXIS) if mesh is not None else None
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    logger = MetricLogger(tc.exp_dir, log_tool=tc.log_tool)
    step_logger = MetricLogger(tc.exp_dir, filename="steps.jsonl")
    main_process = is_main_process()
    if main_process:
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        print(f"device={device} ({name}) data={n_data} fsdp={tc.fsdp} stage={tc.stage}",
              flush=True)

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

    units, replicated = [], list(model.parameters())
    if tc.fsdp:
        apply_trainable_mask(model, tc.stage)  # FSDP reads requires_grad as it shards
        replicated = apply_fsdp(model, mesh)
        units = fsdp_units(model)
    state = create_train_state(model, tc.stage, tc.learning_rate, grad_accum=tc.grad_accum)
    if mesh is not None:
        state.sync = GradientSync(replicated, units, group)
    if tc.fsdp and main_process:
        trained = [p for g in state.optimizer.param_groups for p in g["params"]]
        _, total, per_dev = sharded_fraction(model, n_data, moments=trained)
        print(f"fsdp: state {total / 2**30:.2f} GiB -> {per_dev / 2**30:.2f} GiB/device",
              flush=True)
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
        sums = state_checksums(state) if (main_process or tc.fsdp) else {}
        if main_process:
            print(f"resumed from {resume_path} at step {state.step}", flush=True)
            logger.log(state.step, {
                "read_seconds": read_s, "gigabytes": _dir_bytes(resume_path) / 1e9,
                **{f"restored_{k}": v for k, v in sums.items()},
            }, prefix="checkpoint/")

    spotter_fn = None
    if tc.stage in ("stage2", "stage3"):
        from ..spotter.losses import CriterionConfig

        spotter_fn = model.spotter_loss_fn(
            criterion_cfg=CriterionConfig(matcher=tc.matcher), group=group)
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

    # a sharded state is gathered by every process, so every process calls
    # these; only rank 0 writes
    def save(step: int) -> None:
        if not (main_process or tc.fsdp):
            return
        sync()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, state, step, write=main_process)
        write_s = time.perf_counter() - t0
        sums = state_checksums(state)
        if main_process:
            logger.log(step, {
                "write_seconds": write_s, "gigabytes": _dir_bytes(path) / 1e9,
                **{f"saved_{k}": v for k, v in sums.items()},
            }, prefix="checkpoint/")
            print(f"saved checkpoint {path}", flush=True)

    def export(step: int) -> None:
        if not (main_process or tc.fsdp):
            return
        model_sd, _ = state_dicts(state)
        if main_process:
            path = os.path.join(tc.exp_dir, f"params_step_{step:08d}.npz")
            save_params(path, model, dtype=np.float16, state_dict=model_sd)
            print(f"exported weights {path}", flush=True)

    loss_acc, t_last = [], time.time()
    val_metric_cache: dict = {}  # NIQE parameters and metrics built, for every validation
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
        # this process's rows of the global batch and of its draws
        batch = shard_batch(mesh, {"gt": gt, "lq": lq, **{
            k: host_batch[k] for k in ("tokens", "inst_mask", "boxes", "ctrl_points", "texts")
        }})
        step_gen = torch.Generator(device=device).manual_seed(
            stream_seed(tc.seed, _STEP, global_step))
        draws = make_draws(step_gen, gt.shape[0], (gt.shape[1] // 8, gt.shape[2] // 8),
                           tc.timestep_max or model.schedule.num_timesteps, device,
                           vae_dtype=compute_dtype(cfg))
        state, aux = step_fn(state, batch, draws=shard_batch(mesh, draws))
        aux = {k: float(v) for k, v in aux.items()}  # waits for the step
        global_step += 1
        loss_acc.append(aux)
        step_logger.log(global_step, {
            "seconds": time.perf_counter() - t_iter,
            "data_wait_seconds": wait_s, "host_batch_seconds": host_s,
            "degrade_ms": timer.ms(), **aux,
            "launches": {k: n for k, n in launch_counts().items() if n},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            # what this process holds of the parameters and AdamW's moments
            **({"state_bytes_here": local_bytes([
                *model.parameters(),
                *(t for s in state.optimizer.state.values() for t in s.values()
                  if torch.is_tensor(t) and t.dim()),
            ])} if tc.fsdp else {}),
        })

        if global_step % tc.log_loss_every == 0:
            metrics = {k: float(np.mean([a[k] for a in loss_acc])) for k in loss_acc[-1]}
            dt = (time.time() - t_last) / len(loss_acc)
            metrics["sec_per_step"] = dt
            metrics["img_per_sec"] = tc.batch_size * n_data / dt
            logger.log(global_step, metrics, prefix="train/")
            loss_acc, t_last = [], time.time()

        if global_step % tc.ckpt_every == 0:
            save(global_step)

        if tc.save_params_every and global_step % tc.save_params_every == 0:
            export(global_step)

        if global_step % tc.log_image_every == 0:
            val_metrics = run_validation(
                model, cfg, gt, lq, host_batch["tokens"], n_images=tc.num_val_images,
                feat_iterations=tc.unet_feat_sampling_timestep,
                targets={
                    k: host_batch[k] for k in ("inst_mask", "boxes", "ctrl_points", "texts")
                } if tc.stage in ("stage2", "stage3") else None,
                image_dir=os.path.join(tc.exp_dir, "val_images", f"step_{global_step}"),
                metric_cache=val_metric_cache,
            )
            logger.log(global_step, val_metrics, prefix="val/")

    # skip the final export when the in-loop one just fired at this step
    if tc.save_params_every and global_step % tc.save_params_every != 0:
        export(global_step)
    if tc.final_checkpoint:
        save(global_step)
    if main_process:
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


def aux_val_metrics(cfg, restored, gt01, cache: Optional[dict] = None) -> dict:
    """The validation metrics beyond PSNR/SSIM, as the JAX trainer's
    ``_aux_val_metrics`` computes them (``train.py:262-345``), each the mean
    over the batch of ``[B, H, W, 3]`` images in [0, 1]:

    - NIQE where the images are at least 96 pixels on their short side (its
      patch size), against ``val.niqe_params`` when set, else against a
      pristine model fitted on the batch's ground-truth rows;
    - LPIPS, DISTS, CLIP-IQA, MANIQA, MUSIQ where ``val.<name>_weights`` names
      their checkpoints (``utils/iqa.build_metric``), on the images' device.

    `cache` keeps the NIQE parameters and the metrics built, by (name, path),
    across calls (the trainer passes one for the run)."""
    import numpy as np

    from ..utils.iqa import METRICS, build_metric, score
    from ..utils.niqe import NIQEParams, fit_niqe_params, niqe, rgb_to_gray255

    cache = {} if cache is None else cache
    vc = getattr(cfg, "val", None)
    out = {}
    if min(restored.shape[1:3]) >= 96:
        restored_h = restored.detach().float().cpu().numpy()
        src = getattr(vc, "niqe_params", None) if vc is not None else None
        if ("niqe", src) not in cache:
            cache[("niqe", src)] = NIQEParams.load(src) if src else None
        params = cache[("niqe", src)]
        if params is None:
            gt_h = gt01.detach().float().cpu().numpy()
            params = fit_niqe_params([rgb_to_gray255(g) for g in gt_h])
        out["niqe"] = float(np.mean([niqe(r, params) for r in restored_h]))
    if vc is None:
        return out
    for name in METRICS:
        path = getattr(vc, f"{name}_weights", None)
        if not path:
            continue
        if (name, path) not in cache:
            cache[(name, path)] = build_metric(name, path, restored.device)
        out[name] = score(cache[(name, path)], name, restored, gt01).mean().item()
    return out


def run_validation(
    model, cfg, gt, lq, tokens, n_images: int = 2, steps: int = 10,
    feat_iterations=(), targets=None, image_dir=None, generator=None, metric_cache=None,
):
    """In-loop validation: restore a few images with their prompt, report
    PSNR/SSIM against the ground truth, `aux_val_metrics` (NIQE, and the
    learned metrics the config names; `metric_cache` as there), and (stage
    2/3) the OCR loss of the spotter on the UNet features captured at each
    tagged iteration. The restore runs under the config's compute type, the
    metrics in float32."""
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
    metrics.update(aux_val_metrics(cfg, restored, gt01, metric_cache))
    if image_dir is not None and is_main_process():
        os.makedirs(image_dir, exist_ok=True)
        panel = torch.cat([lq_n.float(), restored, gt01], dim=2).cpu().numpy()
        for bi in range(panel.shape[0]):  # lq | restored | gt
            write_png(os.path.join(image_dir, f"val_{bi}.png"),
                      (np.clip(panel[bi], 0, 1) * 255).astype(np.uint8))
    return metrics


if __name__ == "__main__":
    main()
