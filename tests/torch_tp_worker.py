"""One rank of the port's tensor- and sequence-parallel checks
(``test_torch_tensor_parallel.py``).

Run as ``python tests/torch_tp_worker.py RANK WORLD STORE_FILE OUT_DIR``: it
joins a gloo group of WORLD processes on a file store, builds a 1 x WORLD
("data", "model") mesh and runs every multi-rank case in turn, writing what
the test compares to ``OUT_DIR/tp_rank{RANK}.pt``. It imports torch and the
port only; the test builds the one-process references from the helpers below
while it runs. The cases:

- the tiny restore with the parameters sharded by ``shard_params_tp`` (TP),
  and with the spotter encoder sequence-parallel as well (TP + SP);
- a UNet layer (``QuantLinear``) sharded and called in a quantized scope,
  which must raise;
- a ``SpatialTransformer`` of 5 heads, whose shard boundary falls inside a
  head (q, k and v gathered), and one of 4 (heads kept local), on the
  parameters and input of ``OUT_DIR/attention_cases.pt``;
- one ``EncoderLayer`` with ``sp_axis="model"`` on the layer parameters and
  inputs of ``OUT_DIR/encoder_cases.pt`` (dense and sparse, an even and an
  uneven token count).
"""

from __future__ import annotations

import os
import sys
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED, LQ_SEED, GEN_SEED, STEPS = 181, 182, 183, 2
# above 1: no proposal is kept, the prompt stays empty, so a reordered
# all-reduce sum cannot flip a word of it (the JAX TP test's choice)
SCORE_THRESHOLD = 1.1


def tiny_model(**testr_overrides):
    from tair_tpu_torch.pipeline import build_tiny_model

    model = build_tiny_model(device="cpu", testr_overrides=testr_overrides or None)
    model.init_parameters(torch.Generator().manual_seed(SEED))
    return model.eval()


def restore(model):
    lq = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(LQ_SEED))
    with torch.no_grad():
        image, tokens, spots = model.restore_fused_feedback(
            lq, torch.Generator().manual_seed(GEN_SEED), steps=STEPS,
            score_threshold=SCORE_THRESHOLD, return_spots=True,
        )
    return dict(image=image, tokens=tokens, scores=spots["scores"])


def encoder_layer(case: dict, sp_axis=None):
    from tair_tpu_torch.spotter.transformer import EncoderLayer
    from tair_tpu_torch.weights.convert import convert_tree

    layer = EncoderLayer(d_model=16, d_ffn=32, n_levels=2, n_heads=4, n_points=2,
                         sp_axis=sp_axis)
    layer.load_state_dict(convert_tree(case["params"]), strict=True)
    return layer.eval()


def encoder_outputs(layer, case: dict) -> dict:
    shapes = case["shapes"]
    src, pos, ref, sel = (torch.from_numpy(case[k]) for k in ("src", "pos", "ref", "sel"))
    with torch.no_grad():
        return dict(dense=layer(src, pos, ref, shapes), sparse=layer(src, pos, ref, shapes, sel))


def spatial_transformer(heads: int):
    from tair_tpu_torch.models.attention import SpatialTransformer

    block = SpatialTransformer(channels=40, heads=heads, dim_head=40 // heads, context_dim=16)
    block.load_state_dict(torch.load(Path(sys.argv[4]) / f"attention_{heads}.pt"))
    return block.eval()


def attention_case(heads: int, group, world: int, rank: int):
    """The block's output under the JAX rules' placement on its dense layers,
    and the heads each attention runs."""
    from tair_tpu_torch.parallel.tp import shard_layers

    block = spatial_transformer(heads)
    dims = {f"{name}.weight": (0 if name.endswith(("to_q", "to_k", "to_v", "proj_in", "proj"))
                               else 1)
            for name, m in block.named_modules() if isinstance(m, torch.nn.Linear)}
    shard_layers(block, dims, group, world, rank)
    x = torch.load(Path(sys.argv[4]) / "attention_input.pt")
    with torch.no_grad():
        out = block(x["x"], x["context"])
    return out, block.blocks[0].attn1.heads


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from tair_tpu_torch.models.attention import CrossAttention
    from tair_tpu_torch.models.layers import QuantLinear
    from tair_tpu_torch.ops import quant
    from tair_tpu_torch.parallel.mesh import create_mesh
    from tair_tpu_torch.parallel.tp import bind_sequence_parallel, shard_layers, shard_params_tp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    out = Path(out_dir)
    mesh = create_mesh(1, world, device_type="cpu")
    result = {}

    model = tiny_model()
    result["sharded_layers"], result["n_model"] = shard_params_tp(mesh, model)
    result["local_heads"] = sorted({m.heads for m in model.modules()
                                    if isinstance(m, CrossAttention)})
    result["tp"] = restore(model)

    model = tiny_model(enc_sp_axis="model")
    shard_params_tp(mesh, model)
    result["tp_sp"] = restore(model)

    # a UNet layer (QuantLinear) sharded, called in a quantized scope
    block = torch.nn.Sequential(QuantLinear(16, 32), QuantLinear(32, 16))
    shard_layers(block, {"0.weight": 0, "1.weight": 1}, mesh.get_group("model"), world, rank)
    try:
        with torch.no_grad(), quant.quantized():
            block(torch.ones(2, 16))
        result["w8a8_raised"] = None
    except ValueError as e:
        result["w8a8_raised"] = str(e)

    result["attention"] = {h: attention_case(h, mesh.get_group("model"), world, rank)
                           for h in (4, 5)}

    cases = torch.load(out / "encoder_cases.pt", weights_only=False)
    result["encoder"] = {}
    for name, case in cases.items():
        layer = encoder_layer(case, sp_axis="model")
        assert bind_sequence_parallel(mesh, layer) == 1
        result["encoder"][name] = encoder_outputs(layer, case)

    torch.save(result, out / f"tp_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
