"""One rank of the port's tensor- and sequence-parallel checks
(``test_torch_tensor_parallel.py``).

Run as ``python tests/torch_tp_worker.py RANK WORLD STORE_FILE OUT_DIR`` with
WORLD 4: it joins a gloo group of four processes on a file store, builds a
2 x 2 ("data", "model") mesh (rank r at data r // 2, model r % 2) and runs
every multi-rank case in turn, writing what the test compares to
``OUT_DIR/tp_rank{RANK}.pt`` (the heavy parts from ranks 0 and 1 only). It
imports torch and the port only; the test builds the one-process references
from the helpers below and ``torch_parallel_worker.py``'s while it runs. The
serving cases run on a data row's pair of model ranks, w8a8's dynamic and
static cases on row 1 while the others run on row 0:

- the tiny restore with the parameters sharded by ``shard_params_tp`` (TP),
  and with the spotter encoder sequence-parallel as well (TP + SP);
- the tiny restore in a quantized scope with the UNet's and the
  ControlNet's dense layers sharded: dynamic and static after a calibration
  under TP (row 1), and selective (row 0) (`w8a8_restores`);
- a ``SpatialTransformer`` of 5 heads, whose shard boundary falls inside a
  head (q, k and v gathered), and one of 4 (heads kept local), on the
  parameters and input of ``OUT_DIR/attention_cases.pt``;
- one ``EncoderLayer`` with ``sp_axis="model"`` on the layer parameters and
  inputs of ``OUT_DIR/encoder_cases.pt`` (dense and sparse, an even and an
  uneven token count).

The training cases take the whole mesh (``torch_parallel_worker.run_steps``
with ``tp``): two stage-3 steps DP x TP x SP (the spotter encoder
sequence-parallel on the model axis), and two FSDP x TP with FSDP's size
floor lowered to 2048 elements, so that the partial gradients of msda's
offsets and weights are summed on FSDP shards too (and most TP slices are
FSDP-sharded: 453 leaves, 305 at the rule's 8192); the FSDP x TP state is written as a
checkpoint, and the one-process checkpoint that the test writes
(``OUT_DIR/one/step_*``) is resumed into that state and gathered back.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "tests"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

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


# the quantized restores' selective ratio: the gate skips the context
# projections (to_k, to_v: column-parallel, the plain product of whole weight
# rows) of the widest level and quantizes every other site; every row-parallel
# site is quantized, where its product is the whole one on every process
MIN_RATIO = 0.45


def calibration_inputs():
    """A seeded (x_noisy, t, cond) of the tiny ControlLDM for calibrate_quant."""
    gen = torch.Generator().manual_seed(184)
    return (torch.randn((1, 8, 8, 4), generator=gen), torch.tensor([500]),
            dict(c_txt=torch.randn((1, 77, 64), generator=gen),
                 c_img=torch.randn((1, 8, 8, 4), generator=gen)))


W8A8_SCOPES = ("dynamic", "static", "selective")


def w8a8_restores(scopes=W8A8_SCOPES, group=None, n: int = 1, rank: int = 0) -> dict:
    """The tiny restore in each quantized scope of `scopes` (dynamic, static
    after a calibration pass, selective), with the UNet's and the
    ControlNet's dense layers (every quantized dense site) cut over `group`
    when given: the other sub-models' TP products sum float partials over
    the axis and round otherwise than one process
    (``test_tiny_restore_equals_one_process`` holds them at its bound), and
    nothing else takes part in a quantized site. Returns {scope: restore},
    with the calibration record under "record" when "static" is asked."""
    from tair_tpu_torch.parallel.tp import shard_dims, shard_layers

    model = tiny_model()
    if group is not None:
        dims = {k: v for k, v in shard_dims(model, n).items()
                if k.startswith(("cldm.unet.", "cldm.controlnet."))}
        assert shard_layers(model, dims, group, n, rank) > 0
    cldm = model.cldm
    cldm.quantized = True
    out = {}
    for scope in scopes:
        cldm.quant_static_amax, cldm.quant_min_ratio = None, None
        if scope == "static":
            out["record"] = cldm.calibrate_quant(*calibration_inputs())
            cldm.quant_static_amax = tuple(out["record"])
        elif scope == "selective":
            cldm.quant_min_ratio = MIN_RATIO
        out[scope] = restore(model)
    return out


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


def train_cases(mesh, out: Path, rank: int) -> dict:
    """The training cases (see the module's docstring)."""
    import torch.distributed as dist

    import torch_parallel_worker as pw
    from tair_tpu_torch.parallel import fsdp
    from tair_tpu_torch.parallel.mesh import MODEL_AXIS
    from tair_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, state_dicts
    from tair_tpu_torch.train.stages import trainable_mask

    result, fresh, trained = {}, None, None
    min_elems = fsdp._MIN_ELEMS
    for case, overrides, use_fsdp in (("dp_tp_sp", {"enc_sp_axis": MODEL_AXIS}, False),
                                      ("fsdp_tp", {}, True)):
        grads = {}
        model = pw.tiny_model(**overrides)
        if fresh is None:  # every case starts from these parameters (one seed)
            fresh = {k: v.clone() for k, v in model.state_dict().items()}
            trained = {k for k, on in trainable_mask(model, pw.STAGE).items() if on}
        fsdp._MIN_ELEMS = 2048 if use_fsdp else min_elems
        try:
            aux, state, (model_sd, opt_sd), _ = pw.run_steps(
                model, mesh, fsdp=use_fsdp, tp=True, grads=grads)
        finally:
            fsdp._MIN_ELEMS = min_elems
        frozen = sorted(k for k in fresh if k not in trained)
        got = dict(aux=aux, frozen_changed=[k for k in frozen
                                            if not torch.equal(model_sd[k], fresh[k])])
        if rank in (0, 1):  # copies: a state dict shares the parameters' storage
            got.update(grads=grads, trained={k: model_sd[k].clone() for k in trained})
        result[case] = got
    if rank == 0:  # the gathered optimizer state (its parameters are "trained" above), copied
        result["fsdp_tp_optimizer"] = {**opt_sd, "state": {
            i: {k: v.clone() for k, v in s.items()} for i, s in opt_sd["state"].items()}}
    path = save_checkpoint(str(out / "tp_ckpt"), state, pw.STEPS, write=rank == 0)
    dist.barrier()
    result["tp_checkpoint"] = path

    # the one-process checkpoint the test writes while the group runs, resumed
    # into the FSDP x TP state (its parameters, moments and step replaced)
    one = out / "one" / f"step_{pw.STEPS:08d}"
    for _ in range(1200):
        if one.is_dir():
            break
        time.sleep(0.5)
    state.step = 0
    resumed = restore_checkpoint(str(one), state)
    model_sd, opt_sd = state_dicts(resumed)  # a collective: every rank gathers
    if rank == 0:
        want = torch.load(one / "state.pt", weights_only=True)
        differ = [k for k, v in want["model"].items() if not torch.equal(model_sd[k], v)]
        for i, s in want["optimizer"]["state"].items():
            differ += [f"opt/{i}/{k}" for k, v in s.items()
                       if not torch.equal(opt_sd["state"][i][k], v)]
        result["one_process_resume"] = dict(step=resumed.step, differ=differ,
                                            n_moments=len(want["optimizer"]["state"]))
    return result


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from tair_tpu_torch.models.attention import CrossAttention
    from tair_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
    from tair_tpu_torch.parallel.tp import bind_sequence_parallel, shard_params_tp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    out = Path(out_dir)
    mesh = create_mesh(2, world // 2, device_type="cpu")
    group, n, mrank = (mesh.get_group(MODEL_AXIS), mesh[MODEL_AXIS].size(),
                       mesh.get_local_rank(MODEL_AXIS))
    result = {}

    if mesh.get_local_rank(DATA_AXIS) == 0:  # the serving cases, on ranks 0 and 1
        model = tiny_model()
        result["sharded_layers"], result["n_model"] = shard_params_tp(mesh, model)
        result["local_heads"] = sorted({m.heads for m in model.modules()
                                        if isinstance(m, CrossAttention)})
        result["tp"] = restore(model)

        model = tiny_model(enc_sp_axis="model")
        shard_params_tp(mesh, model)
        result["tp_sp"] = restore(model)

        result["attention"] = {h: attention_case(h, group, n, mrank) for h in (4, 5)}
        result["w8a8"] = w8a8_restores(("selective",), group, n, mrank)

        cases = torch.load(out / "encoder_cases.pt", weights_only=False)
        result["encoder"] = {}
        for name, case in cases.items():
            layer = encoder_layer(case, sp_axis="model")
            assert bind_sequence_parallel(mesh, layer) == 1
            result["encoder"][name] = encoder_outputs(layer, case)
    else:  # meanwhile the rest of w8a8 under TP, on ranks 2 and 3
        result["w8a8"] = w8a8_restores(("dynamic", "static"), group, n, mrank)

    result.update(train_cases(mesh, out, rank))

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
