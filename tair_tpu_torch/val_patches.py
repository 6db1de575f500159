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

It runs on one CUDA device unless ``--device cpu`` is given, and raises when
there is none; with more than one card visible it uses the first and says so
(sharding the patch batch over cards belongs to the parallel slice). Image i
draws its noise from a ``torch.Generator`` seeded with ``val.seed + i``. Each
image prints one JSON line to stderr (seconds, patches, kernel launches, peak
device memory).
"""

from __future__ import annotations

import argparse
import os
import sys


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

    from .config import load_config
    from .data.resize import resize
    from .models.prompt_splice import empty_tokens
    from .pipeline import _resolve_device
    from .tiling import restore_tiled, split_grid
    from .utils.image_io import list_images, load_image, save_image
    from .utils.logging import MetricLogger
    from .utils.metrics import psnr, ssim
    from .val import ImageReport, load_model

    cfg = load_config(args.config)
    if args.enc_topk:
        cfg.testr_overrides = dict(cfg.testr_overrides or {}, enc_topk=args.enc_topk)
    vc = cfg.val
    dump_spots = bool(args.dump_dir)
    if dump_spots and not vc.tiled_ocr_loop:
        raise SystemExit("--dump-dir needs the spotter in the loop: set val.tiled_ocr_loop")
    device = _resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} cards visible: the patch batch runs on cuda:0 "
              "(sharding it belongs to the parallel slice)", file=sys.stderr, flush=True)
    steps = args.steps or vc.steps
    os.makedirs(vc.output_dir, exist_ok=True)
    logger = MetricLogger(vc.output_dir, "val_patches_metrics.jsonl")
    model = load_model(cfg, device, args.ckpt)

    def restore_batch(lq_batch, generator):
        if vc.tiled_ocr_loop:
            restored, _, spots = model.restore_fused_feedback(
                lq_batch, generator, steps=steps, score_threshold=vc.score_threshold,
                spotter_every=args.spotter_every, return_spots=True,
            )
        else:
            toks = torch.from_numpy(empty_tokens(lq_batch.shape[0])).to(device).long()
            restored, _, _ = model.restore(lq_batch, toks, generator, steps=steps)
            spots = None
        return (restored, spots) if dump_spots else restored

    all_preds = []
    for i, name in enumerate(list_images(vc.lq_dir)):
        lq = load_image(os.path.join(vc.lq_dir, name))
        n_h, n_w, _, _ = split_grid(lq.shape[0], lq.shape[1], vc.patch_size, vc.overlap)
        report = ImageReport(device)
        out = restore_tiled(
            restore_batch, torch.from_numpy(lq).to(device),
            torch.Generator(device=device).manual_seed(vc.seed + i),
            patch=vc.patch_size, overlap=vc.overlap, out_scale=vc.out_scale,
            chunk=vc.chunk, return_aux=dump_spots,
        )
        if dump_spots:
            out, spots = out
            out_hw = tuple(out.shape[:2])
            all_preds.append(_spots_to_image_preds(
                {k: v.cpu().numpy() for k, v in spots.items()}, n_w, vc.patch_size,
                vc.overlap, vc.out_scale, out_hw,
            ))
        out = out.cpu()
        report.emit(image=name, patches=n_h * n_w, chunk=vc.chunk, steps=steps)
        stem = os.path.splitext(name)[0]
        save_image(os.path.join(vc.output_dir, f"restored_{stem}.png"), out.numpy())

        metrics = {"image": name, "out_hw": list(out.shape[:2])}
        if vc.gt_dir:
            gt = torch.from_numpy(load_image(os.path.join(vc.gt_dir, name)))[None]
            gt = resize(gt, tuple(out.shape[:2]), "cubic")
            metrics["psnr"] = float(psnr(out[None], gt)[0])
            metrics["ssim"] = float(ssim(out[None], gt)[0])
        logger.log(i, metrics)

    if dump_spots:
        from .utils.submission import dump_submission

        paths = dump_submission(
            args.dump_dir, all_preds, list(range(1, len(all_preds) + 1)),
            confidence_threshold=vc.score_threshold,
        )
        print(f"submission bundle: {paths}")

    print(f"wrote results to {vc.output_dir}")


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
