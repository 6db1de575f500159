"""Whole-image restoration with the spotter in the loop: the port's ``val``.

Counterpart of the JAX package's ``val.py``: for every image of
``val.lq_dir`` (sorted), ``TeReDiff.restore_with_ocr_feedback`` (the default:
the prompt rebuilt on the host each step, ``val.prompt_style`` CAPTION or
TAG) or, with ``--fused``, ``restore_fused_feedback`` (the TAG prompt spliced
on the device, refreshed every ``--spotter-every`` steps). It writes
``restored_{stem}.png``, the overlay ``pred_texts_{stem}.png`` and one line
per image to ``val_metrics.jsonl`` in ``val.output_dir`` (image, pred_texts,
NIQE when ``val.niqe_params`` is set, CLIP-IQA, MANIQA and MUSIQ when their
``val.<name>_weights`` are set, and against ``val.gt_dir`` PSNR/SSIM and,
when set, LPIPS and DISTS). The learned metrics' weights are PyTorch
checkpoints in their published layouts (``utils/iqa.py``): ``lpips_weights``
is ``alexnet.pth:lpips_lin.pth`` (torchvision's AlexNet, LPIPS's ``lin``
heads), ``dists_weights`` ``vgg16.pth:weights.pt``, ``clipiqa_weights``
OpenAI CLIP RN50, ``maniqa_weights`` IIGROUP/MANIQA's checkpoint,
``musiq_weights`` a MUSIQ state dict. Each metric is built once and scores
the restored image on the model's device.
Usage:

    python -m tair_tpu_torch.val --config configs/val.yaml [--ckpt params.npz]
    python -m tair_tpu_torch.val --config configs/val_smoke.yaml --device cpu

It runs on the CUDA device unless ``--device cpu`` is given, and raises when
there is none. The weights are random from seed 0 unless ``--ckpt`` names an
npz in the JAX package's layout: ``python -m tair_tpu_torch.convert_weights``
writes one from the released PyTorch checkpoints. ``--enc-topk N`` serves
with the sparse spotter encoder update (``TESTRConfig.enc_topk``). Image i
draws its noise from a ``torch.Generator`` seeded with ``val.seed + i``.
Besides the files, each image prints one JSON line to stderr: its seconds
(host clock, after a synchronise), the kernel launches of its restore, and
the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tair_tpu_torch.val")
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--ckpt", default=None,
        help="weights as an .npz in the JAX layout: written by `python -m "
             "tair_tpu_torch.convert_weights` from the released checkpoints, or by a "
             "weight export of either package",
    )
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--image-size", type=int, default=512)
    parser.add_argument(
        "--fused", action="store_true",
        help="the loop with the TAG prompt spliced on the device instead of the "
             "host-tokenized CAPTION feedback",
    )
    parser.add_argument(
        "--spotter-every", type=int, default=1,
        help="(fused only) refresh the OCR prompt every k-th denoising step",
    )
    parser.add_argument(
        "--enc-topk", type=int, default=None,
        help="sparse spotter encoder top-K (0 or unset: every token, the exact path)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def load_model(cfg, device, ckpt=None):
    """The config's serving model on `device`: weights of the config's dtype,
    random from seed 0, then the weight export `ckpt` (an .npz in the JAX
    layout) where given."""
    import torch

    from .config import build_model
    from .train.checkpoint import load_params

    model = build_model(cfg, device, training=False)
    model.init_parameters(torch.Generator(device=device).manual_seed(0))
    if ckpt:
        if os.path.isdir(ckpt):
            raise NotImplementedError(
                f"{ckpt} is a directory (an orbax checkpoint): the port reads weight "
                "exports (.npz) only; the JAX package's train/checkpoint.py::save_params "
                "writes one from it"
            )
        load_params(ckpt, model)
        print(f"loaded weights from {ckpt}", flush=True)
    return model


class ImageReport:
    """Seconds, kernel launches and peak device memory of one unit of work,
    printed as one JSON line to stderr."""

    def __init__(self, device):
        import torch

        from .ops.launches import reset_launch_counts

        self.cuda = device.type == "cuda"
        self.device = device
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        self.t0 = time.perf_counter()

    def emit(self, **fields) -> None:
        import torch

        from .ops.launches import launch_counts

        if self.cuda:
            torch.cuda.synchronize(self.device)
        record = {
            **fields, "seconds": time.perf_counter() - self.t0,
            "launches": {k: n for k, n in launch_counts().items() if n},
            "peak_memory_bytes": (
                torch.cuda.max_memory_allocated(self.device) if self.cuda else None
            ),
        }
        print(json.dumps(record), file=sys.stderr, flush=True)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from .config import load_config
    from .pipeline import _resolve_device
    from .spotter.charset import decode_text
    from .utils.image_io import list_images, load_image, save_image
    from .utils.iqa import FULL_REFERENCE, METRICS, build_metric, score
    from .utils.logging import MetricLogger
    from .utils.metrics import psnr, ssim
    from .utils.visualizer import TextVisualizer

    cfg = load_config(args.config)
    if args.enc_topk:
        cfg.testr_overrides = dict(cfg.testr_overrides or {}, enc_topk=args.enc_topk)
    vc = cfg.val
    device = _resolve_device(args.device)
    steps = args.steps or vc.steps
    os.makedirs(vc.output_dir, exist_ok=True)
    logger = MetricLogger(vc.output_dir, "val_metrics.jsonl")
    # the learned metrics, built once ("backbone:head" for LPIPS and DISTS)
    learned = {name: build_metric(name, getattr(vc, f"{name}_weights"), device)
               for name in METRICS if getattr(vc, f"{name}_weights", None)}

    model = load_model(cfg, device, args.ckpt)

    niqe_params = None
    if vc.niqe_params:
        from .utils.niqe import NIQEParams, niqe

        niqe_params = NIQEParams.load(vc.niqe_params)

    for i, name in enumerate(list_images(vc.lq_dir)):
        lq = load_image(os.path.join(vc.lq_dir, name), args.image_size)
        lq_b = torch.from_numpy(lq)[None].to(device)
        gen = torch.Generator(device=device).manual_seed(vc.seed + i)
        report = ImageReport(device)
        if args.fused:
            restored, _, spots = model.restore_fused_feedback(
                lq_b, gen, steps=steps, score_threshold=vc.score_threshold,
                spotter_every=args.spotter_every, return_spots=True,
            )
            sp = {k: v[0].cpu().numpy() for k, v in spots.items()}
            keep = sp["keep"]
            final = {
                "pred_texts": [decode_text(sp["recs"][j]) for j in range(len(keep)) if keep[j]],
                "pred_polys": sp["polygons"][keep].astype(np.int32),
                "scores": sp["scores"][keep],
            }
        else:
            restored, ts_results = model.restore_with_ocr_feedback(
                lq_b, gen, steps=steps, prompt_style=vc.prompt_style,
                score_threshold=vc.score_threshold,
            )
            final = ts_results[-1][0]
        restored_np = restored[0].cpu().numpy()
        report.emit(image=name, steps=steps, fused=args.fused)

        stem = os.path.splitext(name)[0]
        save_image(os.path.join(vc.output_dir, f"restored_{stem}.png"), restored_np)
        overlay = TextVisualizer().draw_spotter_output(restored_np, final)
        save_image(os.path.join(vc.output_dir, f"pred_texts_{stem}.png"), overlay)

        metrics = {"image": name, "pred_texts": final["pred_texts"]}
        if niqe_params is not None:
            metrics["niqe"] = niqe(restored_np, niqe_params)
        for m in ("clipiqa", "maniqa", "musiq"):  # no reference needed
            if m in learned:
                metrics[m] = float(score(learned[m], m, restored)[0])
        if vc.gt_dir:
            gt = load_image(os.path.join(vc.gt_dir, name), args.image_size)
            gt_b = torch.from_numpy(gt)[None]
            metrics["psnr"] = float(psnr(restored.cpu(), gt_b)[0])
            metrics["ssim"] = float(ssim(restored.cpu(), gt_b)[0])
            for m in FULL_REFERENCE:
                if m in learned:
                    metrics[m] = float(score(learned[m], m, restored, gt_b)[0])
        logger.log(i, metrics)

    print(f"wrote results to {vc.output_dir}")


if __name__ == "__main__":
    main()
