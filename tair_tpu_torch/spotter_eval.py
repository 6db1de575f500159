"""Text-spotting evaluation on diffusion features: the port's ``spotter_eval``.

Counterpart of the JAX package's ``spotter_eval.py``: the spotter reads the
UNet decoder features of one noised forward pass at a fixed timestep, with
the ControlNet conditioned on the RealESRGAN-degraded LQ (the training-time
feature distribution; ``--no-degrade`` conditions on the clean image), and
its predictions are scored with the ICDAR protocol: detection and end-to-end
precision, recall and F-measure (``utils.text_eval.evaluate_dataset``),
and with ``--lexicon`` / ``--lexicon-from-gt`` the lexicon-constrained
end-to-end scores. Images come from ``build_dataset(cfg, "VAL")`` two at a
time. Prints one JSON line with the JAX script's keys. Usage:

    python -m tair_tpu_torch.spotter_eval --config configs/train_chip_demo.yaml
    python -m tair_tpu_torch.spotter_eval --config configs/train_smoke.yaml --device cpu

It runs on the CUDA device unless ``--device cpu`` is given, and raises when
there is none. Batch i (images i and i+1) degrades with draws seeded from
(train.seed + 1, i) and draws its latent sample and noise from a
``torch.Generator`` seeded with i. Each batch prints one JSON line to stderr
(seconds, kernel launches, peak device memory).
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tair_tpu_torch.spotter_eval")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", default=None, help="weight export (.npz, the JAX layout)")
    parser.add_argument("--timestep", type=int, default=200)
    parser.add_argument("--num-images", type=int, default=16)
    parser.add_argument("--score-threshold", type=float, default=0.5)
    parser.add_argument(
        "--lexicon", default=None,
        help="optional word-list file for lexicon-constrained decoding",
    )
    parser.add_argument(
        "--lexicon-from-gt", action="store_true",
        help="ICDAR 'weak lexicon' protocol: constrain transcriptions to the union "
             "of the eval set's GT words; reported as e2e_*_lex",
    )
    parser.add_argument(
        "--no-degrade", action="store_true",
        help="condition the ControlNet on the clean HQ image instead of the "
             "training-time RealESRGAN-degraded LQ",
    )
    parser.add_argument(
        "--dump-dir", default=None,
        help="also write text_results.json (COCO) + det.zip/gt.zip (RRC) there",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from .config import build_dataset, load_config
    from .data.batch_transform import degrade_batch
    from .data.satext import collate
    from .diffusion.diffusion import Diffusion
    from .pipeline import _resolve_device
    from .spotter.charset import decode_text
    from .spotter.testr import spotter_inference
    from .train.__main__ import stream_seed
    from .utils.text_eval import LexiconMatcher, SpottingInstance, evaluate_dataset
    from .val import ImageReport, load_model

    lexicon = None
    if args.lexicon:
        with open(args.lexicon) as f:
            lexicon = LexiconMatcher([w.strip() for w in f if w.strip()])

    cfg = load_config(args.config)
    device = _resolve_device(args.device)
    model = load_model(cfg, device, args.ckpt)
    diffusion = Diffusion(model.schedule, parameterization="v")
    ds = build_dataset(cfg, "VAL")
    size = cfg.dataset.out_size

    @torch.no_grad()
    def spot(batch, generator):
        cldm = model.cldm
        clean = model.clean(batch["lq"])
        z_0 = cldm.vae_encode(batch["gt"], sample=True, generator=generator)
        cond = dict(
            c_txt=cldm.clip_encode_tokens(batch["tokens"]),
            c_img=cldm.vae_encode(clean * 2 - 1, sample=False),
        )
        t = torch.full((z_0.shape[0],), args.timestep, dtype=torch.int32, device=device)
        noise = torch.randn(z_0.shape, dtype=torch.float32, device=device, generator=generator)
        z_t = diffusion.q_sample(z_0.float(), t, noise)
        _, feats = cldm.apply(z_t, t, cond)
        res = spotter_inference(model.spotter_apply(feats), args.score_threshold, image_size=size)
        return {k: res[k].cpu().numpy() for k in ("scores", "keep", "polygons", "recs")}

    all_gts, all_preds = [], []
    n = min(args.num_images, len(ds))
    for i in range(0, n, 2):
        items = [ds[j] for j in range(i, min(i + 2, n))]
        raw = collate(items, max_inst=cfg.dataset.max_instances)
        report = ImageReport(device)
        hq = torch.from_numpy(raw["hq"]).to(device)
        if args.no_degrade:
            gt, lq = hq * 2 - 1, hq
        else:
            seed = stream_seed(cfg.train.seed + 1, 0, i)
            gt, lq = degrade_batch(
                hq, *(torch.from_numpy(raw[k]).to(device)
                      for k in ("kernel1", "kernel2", "sinc_kernel")),
                cfg.degradation, rng=np.random.default_rng(seed),
                generator=torch.Generator(device=device).manual_seed(seed),
            )
        batch = {"gt": gt, "lq": lq,
                 "tokens": torch.from_numpy(raw["tokens"]).to(device).long()}
        res = spot(batch, torch.Generator(device=device).manual_seed(i))
        report.emit(batch=i // 2, images=len(items), timestep=args.timestep)
        for bi, item in enumerate(items):
            all_gts.append([
                SpottingInstance(np.asarray(p) * size, t)
                for p, t in zip(item["poly"], item["text"])
            ])
            keep = res["keep"][bi]
            all_preds.append([
                SpottingInstance(
                    res["polygons"][bi][j], decode_text(res["recs"][bi][j]),
                    float(res["scores"][bi][j]),
                )
                for j in range(len(keep)) if keep[j]
            ])

    if args.lexicon_from_gt and lexicon is None:
        lexicon = LexiconMatcher(sorted({g.text for gts in all_gts for g in gts}))

    if args.dump_dir:
        from .utils.submission import dump_submission

        paths = dump_submission(
            args.dump_dir, all_preds, list(range(1, len(all_preds) + 1)),
            gts_per_image=all_gts, confidence_threshold=args.score_threshold,
        )
        print(f"# submission bundle: {paths}", file=sys.stderr)

    scores = evaluate_dataset(all_gts, all_preds)
    out = {k: round(v, 4) if isinstance(v, float) else v for k, v in scores.items()}

    if lexicon is not None:
        lex_preds = []
        for preds in all_preds:
            row = []
            for p in preds:
                matched = lexicon.find_match_word(p.text)
                if matched is not None:
                    row.append(SpottingInstance(p.polygon, matched, p.score))
            lex_preds.append(row)
        lex_scores = evaluate_dataset(all_gts, lex_preds)
        out["lexicon_words"] = len(lexicon.lexicon)
        for k in ("e2e_precision", "e2e_recall", "e2e_hmean"):
            out[f"{k}_lex"] = round(lex_scores[k], 4)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
