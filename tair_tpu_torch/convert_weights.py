"""The released PyTorch checkpoints -> one npz of weights in the JAX layout.

Counterpart of the repository's root ``convert_weights.py``, without JAX: the
SD-2.1 bundle split into UNet, autoencoder and CLIP text tower; DiffBIR's
ControlNet, or a ControlNet started from the converted UNet (the hint's input
channels zero); Real-ESRGAN's SwinIR (``module.`` stripped); TESTR's
detectron2 checkpoint (non-strict). It starts from ``build_default_model``'s
float32 parameters drawn from seed 0 on `--device` (the CUDA device unless
``--device cpu`` is given; it raises when there is none), so a part no file
supplies keeps them. The trees are converted and written on the host: one npz
in the JAX package's layout, which ``python -m tair_tpu_torch.val --ckpt``
(and the JAX package) loads. A BSRNet
or SCUNet checkpoint is written to ``<stem>_bsrnet.npz`` /
``<stem>_scunet.npz`` beside it, holding only what the file gave; those load
into ``models/cleaners.py``'s modules through ``weights.convert.convert_tree``.
Usage:

    python -m tair_tpu_torch.convert_weights --out weights/tair.npz \\
        --sd weights/sd2.1-base-zsnr-laionaes5.ckpt \\
        --controlnet weights/DiffBIR_v2.1.pt \\
        --swinir weights/realesrgan_s4_swinir_100k.pth \\
        --testr weights/pretrain_testr_R50_polygon.pth

Any subset of the files may be given. Only the initial parameters are drawn
on the device; the tool launches none of the port's kernels.
"""

from __future__ import annotations

import argparse
import os


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tair_tpu_torch.convert_weights",
        description="Convert the released PyTorch checkpoints into one npz of the port's "
                    "weights in the JAX layout (loaded by `python -m tair_tpu_torch.val "
                    "--ckpt`). The initial parameters (seed 0) are drawn on --device; the "
                    "files are read, converted and written on the host.",
    )
    parser.add_argument("--out", required=True)
    parser.add_argument("--sd", default=None, help="SD-2.1 bundle ckpt")
    parser.add_argument("--controlnet", default=None, help="DiffBIR ControlNet")
    parser.add_argument("--swinir", default=None)
    parser.add_argument("--testr", default=None)
    parser.add_argument(
        "--bsrnet", default=None,
        help="BSRNet/BSRGAN RRDBNet ckpt -> <out>_bsrnet.npz (DiffBIR BSRNetPipeline cleaner)",
    )
    parser.add_argument(
        "--scunet", default=None,
        help="SCUNet ckpt -> <out>_scunet.npz (DiffBIR SCUNetPipeline cleaner)",
    )
    parser.add_argument(
        "--controlnet-from-unet", action="store_true",
        help="init ControlNet from the converted UNet (zero-padded hint conv)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the seed-0 parameters are drawn: cuda (the default; "
                             "raises without a card) or cpu")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import torch

    from .models.cleaners import RRDBNetConfig, SCUNetConfig
    from .pipeline import _resolve_device, build_default_model
    from .train.checkpoint import save_tree
    from .weights.convert import (
        _cast_like,
        controlnet_from_unet,
        convert_bsrnet,
        convert_controlnet,
        convert_scunet,
        convert_swinir,
        convert_testr,
        jax_param_shapes,
        load_pretrained_sd_bundle,
        load_torch_file,
        to_jax_params,
    )

    device = _resolve_device(args.device)
    model = build_default_model(dtype=torch.float32, device=device)
    model.init_parameters(torch.Generator(device=device).manual_seed(0))
    params = to_jax_params(model.state_dict(), jax_param_shapes(model))  # on the host

    if args.sd:
        params = load_pretrained_sd_bundle(params, load_torch_file(args.sd), model)
        print(f"loaded SD bundle from {args.sd}")

    if args.controlnet:
        converted, reader = convert_controlnet(
            load_torch_file(args.controlnet), model.cldm.controlnet.cfg
        )
        params["controlnet"] = _cast_like(converted, params["controlnet"])
        print(f"loaded ControlNet from {args.controlnet} "
              f"(missing={len(reader.missing)}, unused={len(reader.unused())})")
    elif args.controlnet_from_unet:
        params["controlnet"] = controlnet_from_unet(params["unet"], params["controlnet"])
        print("initialized ControlNet from UNet weights (hint channels zeroed)")

    if args.swinir:
        converted, reader = convert_swinir(load_torch_file(args.swinir), model.swinir.cfg)
        params["swinir"] = _cast_like(converted, params["swinir"])
        print(f"loaded SwinIR from {args.swinir} (missing={len(reader.missing)})")

    if args.testr:
        converted, reader = convert_testr(load_torch_file(args.testr), model.testr.cfg)
        params["testr"] = _cast_like(converted, params["testr"])
        print(f"loaded TESTR from {args.testr} (missing={len(reader.missing)})")

    stem = os.path.splitext(args.out)[0]
    for path, convert, cfg, name in (
        (args.bsrnet, convert_bsrnet, RRDBNetConfig(), "bsrnet"),
        (args.scunet, convert_scunet, SCUNetConfig(), "scunet"),
    ):
        if path:
            converted, reader = convert(load_torch_file(path), cfg)
            save_tree(f"{stem}_{name}.npz", converted)
            print(f"wrote {stem}_{name}.npz (missing={len(reader.missing)})")

    save_tree(args.out, params)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
