"""Tiled restoration: the port's ``val_patches``.

Counterpart of the JAX package's ``val_patches.py``: every image of
``val.lq_dir`` is split into ``val.patch_size`` patches with
``val.overlap`` pixels of overlap, each upscaled x ``val.out_scale``
(bicubic) and restored, all patches as ONE batch (``val.chunk: null``) or in
batches of ``val.chunk``, each through ``restore_fused_feedback`` when
``val.tiled_ocr_loop`` (the spotter in the loop per patch) or through
``restore`` with the empty prompt; then merged with the linear edge-fade
window (``tiling.restore_tiled``). It writes ``restored_{stem}.png`` and one
line per image to ``val_patches_metrics.jsonl`` (image, out_hw, and PSNR/SSIM
against the ground truth resized to the output with the cubic kernel). With
``--dump-dir`` it also writes the interchange bundle (``text_results.json``
and ``det.zip``) of the patches' spotter decodes in the merged image's
coordinates. Usage:

    python -m tair_tpu_torch.val_patches --config configs/val.yaml
    python -m tair_tpu_torch.val_patches --config configs/val_smoke.yaml --device cpu
    torchrun --nproc_per_node=N -m tair_tpu_torch.val_patches --config configs/val.yaml

It runs on one CUDA device unless ``--device cpu`` is given, and raises when
there is none. Under ``torchrun`` (or in a process group its caller made) the
patch batch is sharded over the processes, one card each, as the JAX script shards it over its chips: the
batch (``val.chunk``, or all patches) is rounded up to a multiple of the
process count and padded with zero patches; every process draws the batch's
noise at the whole batch's shape and restores its rows of it
(`ShardedRestore`), and rank 0 gathers the rows, merges and writes, so the
result is one process's at that batch. Image i draws its noise from a
``torch.Generator`` seeded with ``val.seed + i``. Each image prints one JSON
line to stderr from rank 0 (seconds, patches, kernel launches, peak device
memory).
"""

from __future__ import annotations

import argparse
import os


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tair_tpu_torch.val_patches")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", default=None, help="weight export (.npz, the JAX layout)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument(
        "--spotter-every", type=int, default=1,
        help="(tiled_ocr_loop) refresh the OCR prompt every k-th step",
    )
    parser.add_argument(
        "--enc-topk", type=int, default=None,
        help="sparse spotter encoder top-K (0 or unset: every token, the exact path)",
    )
    parser.add_argument(
        "--dump-dir", default=None,
        help="write text_results.json (COCO) + det.zip (RRC) of the patches' spotter "
             "decodes in merged-image coordinates there; needs val.tiled_ocr_loop",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .config import load_config
    from .data.resize import resize
    from .models.prompt_splice import empty_tokens
    from .parallel.mesh import create_mesh, init_distributed, world_size
    from .pipeline import _resolve_device
    from .tiling import restore_tiled, split_grid
    from .utils.image_io import list_images, load_image, save_image
    from .utils.logging import MetricLogger, is_main_process
    from .utils.metrics import psnr, ssim
    from .val import ImageReport, load_model

    cfg = load_config(args.config)
    if args.enc_topk:
        cfg.testr_overrides = dict(cfg.testr_overrides or {}, enc_topk=args.enc_topk)
    vc = cfg.val
    dump_spots = bool(args.dump_dir)
    if dump_spots and not vc.tiled_ocr_loop:
        raise SystemExit("--dump-dir needs the spotter in the loop: set val.tiled_ocr_loop")
    device = init_distributed(_resolve_device(args.device).type)
    # a group (torchrun's, or one the caller made) shards the patch batch
    mesh = create_mesh(device_type=device.type) if dist.is_initialized() else None
    main_process = is_main_process()
    steps = args.steps or vc.steps
    os.makedirs(vc.output_dir, exist_ok=True)
    logger = MetricLogger(vc.output_dir, "val_patches_metrics.jsonl")
    model = load_model(cfg, device, args.ckpt)

    def restore_batch(lq_batch, generator, x_T=None, step_noises=None):
        if vc.tiled_ocr_loop:
            restored, _, spots = model.restore_fused_feedback(
                lq_batch, generator, steps=steps, score_threshold=vc.score_threshold,
                spotter_every=args.spotter_every, return_spots=True,
                x_T=x_T, step_noises=step_noises,
            )
        else:
            toks = torch.from_numpy(empty_tokens(lq_batch.shape[0])).to(device).long()
            restored, _, _ = model.restore(
                lq_batch, toks, generator, steps=steps, x_T=x_T, step_noises=step_noises
            )
            spots = None
        return (restored, spots) if dump_spots else restored

    if mesh is not None:
        restore_batch = ShardedRestore(
            restore_batch, mesh, model.sampler().make_schedule(steps).num_steps, dump_spots
        )

    all_preds = []
    for i, name in enumerate(list_images(vc.lq_dir)):
        lq = load_image(os.path.join(vc.lq_dir, name))
        n_h, n_w, _, _ = split_grid(lq.shape[0], lq.shape[1], vc.patch_size, vc.overlap)
        chunk = vc.chunk
        if mesh is not None:  # a batch that splits evenly over the processes
            chunk = -(-(chunk or n_h * n_w) // world_size()) * world_size()
        report = ImageReport(device)
        out = restore_tiled(
            restore_batch, torch.from_numpy(lq).to(device),
            torch.Generator(device=device).manual_seed(vc.seed + i),
            patch=vc.patch_size, overlap=vc.overlap, out_scale=vc.out_scale,
            chunk=chunk, return_aux=dump_spots,
        )
        if dump_spots:
            out, spots = out
            out_hw = tuple(out.shape[:2])
            all_preds.append(_spots_to_image_preds(
                {k: v.cpu().numpy() for k, v in spots.items()}, n_w, vc.patch_size,
                vc.overlap, vc.out_scale, out_hw,
            ))
        out = out.cpu()
        if not main_process:
            continue
        report.emit(image=name, patches=n_h * n_w, chunk=chunk, steps=steps)
        stem = os.path.splitext(name)[0]
        save_image(os.path.join(vc.output_dir, f"restored_{stem}.png"), out.numpy())

        metrics = {"image": name, "out_hw": list(out.shape[:2])}
        if vc.gt_dir:
            gt = torch.from_numpy(load_image(os.path.join(vc.gt_dir, name)))[None]
            gt = resize(gt, tuple(out.shape[:2]), "cubic")
            metrics["psnr"] = float(psnr(out[None], gt)[0])
            metrics["ssim"] = float(ssim(out[None], gt)[0])
        logger.log(i, metrics)

    if not main_process:
        return
    if dump_spots:
        from .utils.submission import dump_submission

        paths = dump_submission(
            args.dump_dir, all_preds, list(range(1, len(all_preds) + 1)),
            confidence_threshold=vc.score_threshold,
        )
        print(f"submission bundle: {paths}")

    print(f"wrote results to {vc.output_dir}")


class ShardedRestore:
    """A patch-batch restore (`restore_batch(lq_batch, generator, x_T,
    step_noises)`) sharded over `mesh`'s data axis: the batch's noise is
    drawn on every process at the whole batch's shape, in the order one
    process draws it (the start `x_T`, then one noise per step but the
    last), each process restores its rows ``[r·B, (r+1)·B)`` with its rows
    of the noise, and the rows are gathered on every process."""

    def __init__(self, restore_batch, mesh, total_steps: int, with_aux: bool):
        self.restore_batch = restore_batch
        self.mesh = mesh
        self.total = total_steps
        self.with_aux = with_aux

    def __call__(self, lq_batch, generator):
        import torch

        from .parallel.mesh import DATA_AXIS, local_rows

        b, h, w, _ = lq_batch.shape
        shape = (b, h // 8, w // 8, 4)

        def draw():
            return torch.randn(shape, dtype=torch.float32, device=lq_batch.device,
                               generator=generator)

        x_T = draw()
        noises = [draw() for _ in range(self.total - 1)]
        noises.append(torch.zeros_like(x_T))  # the last step adds no noise
        rows = local_rows(b, self.mesh)
        out = self.restore_batch(
            lq_batch[rows], generator, x_T=x_T[rows], step_noises=[n[rows] for n in noises]
        )
        group = self.mesh.get_group(DATA_AXIS)
        if not self.with_aux:
            return _gather_rows(out, group)
        restored, aux = out
        return _gather_rows(restored, group), {k: _gather_rows(v, group) for k, v in aux.items()}


def _gather_rows(x, group):
    """The processes' row blocks of `x`, in rank order, on every process."""
    import torch
    import torch.distributed as dist

    if x.dtype == torch.bool:  # gloo moves no booleans
        return _gather_rows(x.to(torch.uint8), group).bool()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def _spots_to_image_preds(spots, n_w, patch, overlap, out_scale, canvas_hw, iou_dedup=0.5):
    """Per-patch spotter decodes -> one deduplicated prediction list in the
    merged canvas's pixel coordinates.

    Each patch's polygons are in the restored patch's frame (patch*out_scale
    square); the patch at grid (r, c) starts at (r, c) * stride in LQ pixels,
    times out_scale on the canvas. Instances found again in overlapping
    patches are merged by a greedy score-ordered polygon-IoU suppression (the
    ICDAR protocol's IoU, ``utils.text_eval.polygon_iou``)."""
    import numpy as np

    from .spotter.charset import decode_text
    from .utils.text_eval import SpottingInstance, polygon_iou

    stride = (patch - overlap) * out_scale
    cand = []
    for p in range(spots["scores"].shape[0]):
        r, c = p // n_w, p % n_w
        off = np.array([c * stride, r * stride], np.float32)  # (x, y)
        keep = np.asarray(spots["keep"][p])
        for j in np.nonzero(keep)[0]:
            poly = np.asarray(spots["polygons"][p][j], np.float32) + off
            poly[:, 0] = poly[:, 0].clip(0, canvas_hw[1] - 1)
            poly[:, 1] = poly[:, 1].clip(0, canvas_hw[0] - 1)
            cand.append(SpottingInstance(
                poly, decode_text(np.asarray(spots["recs"][p][j])),
                float(spots["scores"][p][j]),
            ))
    cand.sort(key=lambda s: -(s.score or 0.0))
    kept = []
    for s in cand:
        if all(polygon_iou(s.polygon, k.polygon) <= iou_dedup for k in kept):
            kept.append(s)
    return kept


if __name__ == "__main__":
    main()
