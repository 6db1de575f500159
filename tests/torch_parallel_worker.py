"""One rank of the port's data-parallel checks (``test_torch_data_parallel.py``).

Run as ``python tests/torch_parallel_worker.py RANK WORLD STORE_FILE OUT_DIR``:
it joins a gloo group of WORLD processes on a file store and runs every
multi-rank case in turn, writing what the test compares to
``OUT_DIR/rank{RANK}.pt``. It imports torch and the port only, so that the
test's one-process references (built from the same helpers below) can run
beside it. The cases:

- two DP steps and two FSDP steps of the tiny stage-3 model on a global batch
  of 2 whose halves hold 2 and 0 text instances, two FSDP steps with
  ``use_checkpoint`` (each recomputed block gathers its shard again in the
  backward), and two FSDP micro-steps with ``grad_accum`` 2 (losses,
  parameters after);
- a checkpoint written under FSDP, and a sharded resume of it;
- the TESTR criterion on each rank's half of a global batch, normalised over
  the group;
- the trainer on ``configs/train_smoke_fsdp.yaml`` (``fsdp: true``) for two
  steps, and ``val_patches`` with the patch batch sharded;
- a mesh larger than the group, which must raise.
"""

from __future__ import annotations

import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STAGE, LR, OCR_WEIGHT = "stage3", 1e-4, 0.01
B, HW, M, STEPS = 2, 64, 3, 2
N_PTS, N_CHARS, VOC = 16, 25, 97


def tiny_model(**testr_overrides):
    from tair_tpu_torch.pipeline import build_tiny_model

    model = build_tiny_model(device="cpu", training=True,
                             testr_overrides=testr_overrides or None)
    model.init_parameters(torch.Generator().manual_seed(171))
    return model.train()


def global_batch():
    """Rows 0 and 1 hold 2 and 0 instances: the two ranks' counts differ."""
    rng = np.random.default_rng(172)
    cxcy = rng.uniform(0.25, 0.75, (B, M, 2))
    wh = rng.uniform(0.1, 0.4, (B, M, 2))
    batch = dict(
        gt=rng.random((B, HW, HW, 3), dtype=np.float32) * 2 - 1,
        lq=rng.random((B, HW, HW, 3), dtype=np.float32),
        tokens=rng.integers(1, 1000, (B, 77)),
        inst_mask=np.array([[True, True, False], [False, False, False]]),
        boxes=np.concatenate([cxcy, wh], -1).astype(np.float32),
        ctrl_points=rng.uniform(0.1, 0.9, (B, M, N_PTS, 2)).astype(np.float32),
        texts=rng.integers(0, VOC, (B, M, N_CHARS)),
    )
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def run_steps(model, mesh=None, fsdp=False, grad_accum=1, use_checkpoint=False, tp=False,
              grads=None):
    """STEPS train steps on this process's rows of the global batch and of
    the global batch's draws (with `grad_accum` 2, two micro-steps and one
    update), with the model's blocks checkpointed or not, and with `tp` the
    model cut over the mesh's model axis (``shard_params_tp``; the sequence
    parallelism its spotter encoder asks for bound) before FSDP shards it;
    returns (aux of each step, the state, the gathered state dicts,
    {parameter name: the least |gradient| over the steps} of the trained
    parameters as this process's optimizer saw them). `grads`: a dict that
    receives {name: gradient} of the first update, gathered to the
    one-process layout."""
    from tair_tpu_torch.diffusion.diffusion import Diffusion
    from tair_tpu_torch.parallel.fsdp import (
        GradientSync, apply_fsdp, fsdp_units, shard_dims, whole_tensors,
    )
    from tair_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, local_rows
    from tair_tpu_torch.parallel.tp import partial_grad_params, shard_params_tp, tp_weights
    from tair_tpu_torch.train import step as tstep
    from tair_tpu_torch.train.checkpoint import state_dicts
    from tair_tpu_torch.train.stages import apply_trainable_mask

    group = mesh.get_group(DATA_AXIS) if mesh is not None else None
    model.set_use_checkpoint(use_checkpoint)
    dims, partial, model_group = None, (), None
    if tp:  # the FSDP placement is read on the whole model's shapes, before the cut
        dims = shard_dims(model, mesh[DATA_AXIS].size(), mesh[MODEL_AXIS].size())
        shard_params_tp(mesh, model)
    units, replicated = [], list(model.parameters())
    if fsdp:
        apply_trainable_mask(model, STAGE)
        replicated = apply_fsdp(model, mesh, dims)
        units = fsdp_units(model)
    if tp:  # FSDP's parameters, which replace the ones it shards
        partial, model_group = partial_grad_params(model), mesh.get_group(MODEL_AXIS)
    state = tstep.create_train_state(model, STAGE, LR, grad_accum=grad_accum)
    if mesh is not None:
        state.sync = GradientSync(replicated, units, group, partial, model_group)
    layers = tp_weights(model)
    step = tstep.make_train_step(
        model, Diffusion(model.schedule, parameterization="v"),
        spotter_loss_fn=model.spotter_loss_fn(group=group), ocr_loss_weight=OCR_WEIGHT,
    )
    names = {id(p): name for name, p in model.named_parameters()}
    least = {}

    def record(*_):
        trained = [p for group_ in state.optimizer.param_groups for p in group_["params"]]
        for p in trained:
            g = p.grad.detach().abs()
            name = names[id(p)]
            least[name] = torch.minimum(least[name], g) if name in least else g
        if grads is not None and not grads:  # a collective where the gradients are sharded
            whole = whole_tensors([p.grad.detach() for p in trained],
                                  [layers.get(names[id(p)]) for p in trained])
            grads.update((names[id(p)], g.clone()) for p, g in zip(trained, whole))

    state.optimizer.register_step_pre_hook(record)
    batch = global_batch()
    rows = local_rows(B, mesh)
    auxes = []
    for i in range(STEPS):
        draws = tstep.make_draws(torch.Generator().manual_seed(173 + i), B, (HW // 8, HW // 8),
                                 1000, torch.device("cpu"))
        state, aux = step(state, {k: v[rows] for k, v in batch.items()},
                          draws={k: v[rows] for k, v in draws.items()})
        auxes.append({k: float(v) for k, v in aux.items()})
    return auxes, state, state_dicts(state), least


def criterion_case(seed: int = 174, q: int = 10, s: int = 40):
    """Seeded TESTR outputs and targets for a global batch of 2 whose rows
    hold 4 and 0 instances (numpy)."""
    rng = np.random.default_rng(seed)

    def layer():
        return dict(
            pred_logits=rng.standard_normal((B, q, N_PTS, 1), dtype=np.float32) * 2,
            pred_ctrl_points=rng.random((B, q, N_PTS, 2), dtype=np.float32),
            pred_texts=rng.standard_normal((B, q, N_CHARS, VOC), dtype=np.float32),
        )

    outputs = layer()
    outputs["aux_outputs"] = [layer() for _ in range(2)]
    outputs["enc_outputs"] = dict(
        pred_logits=rng.standard_normal((B, s, 1), dtype=np.float32) * 2,
        pred_boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (B, s, 2)), rng.uniform(0.05, 0.5, (B, s, 2))], -1
        ).astype(np.float32),
    )
    m = 4
    targets = dict(
        inst_mask=np.arange(m)[None] < np.array([[m], [0]]),
        boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (B, m, 2)), rng.uniform(0.05, 0.5, (B, m, 2))], -1
        ).astype(np.float32),
        ctrl_points=rng.random((B, m, N_PTS, 2), dtype=np.float32),
        texts=rng.integers(0, VOC, (B, m, N_CHARS)).astype(np.int32),
    )
    return outputs, targets


def tree_map(fn, node):
    if isinstance(node, dict):
        return {k: tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_map(fn, v) for v in node]
    return fn(node)


def trainer_config(path: Path, exp_dir: Path, fsdp: bool, batch_size: int) -> Path:
    """``configs/train_smoke_fsdp.yaml`` with its experiment directory, its
    batch per device and its ``fsdp`` switch set."""
    text = (ROOT / "configs" / "train_smoke_fsdp.yaml").read_text()
    text = text.replace("./runs/smoke_fsdp", str(exp_dir))
    text = text.replace("batch_size: 1 ", f"batch_size: {batch_size} ")
    text = text.replace("fsdp: true", f"fsdp: {'true' if fsdp else 'false'}")
    path.write_text(text)
    return path


def val_patches_config(path: Path, lq_dir: Path, out_dir: Path) -> Path:
    """``configs/val_smoke.yaml`` on `lq_dir` with the spotter in the loop,
    two steps, and the patch batch whole."""
    text = (ROOT / "configs" / "val_smoke.yaml").read_text()
    text = text.replace("./assets/smoke/lq", str(lq_dir)).replace("./results/smoke", str(out_dir))
    text = text.replace("  gt_dir: ./assets/smoke/gt\n", "").replace("steps: 3", "steps: 2")
    text = text.replace("chunk: 8", "chunk: null")
    text = text.replace("tiled_ocr_loop: false", "tiled_ocr_loop: true")
    path.write_text(text)
    return path


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from tair_tpu_torch.parallel.fsdp import apply_fsdp
    from tair_tpu_torch.parallel.mesh import create_mesh
    from tair_tpu_torch.spotter.losses import set_criterion
    from tair_tpu_torch.train import step as tstep
    from tair_tpu_torch.train.__main__ import main as train_main
    from tair_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, state_dicts
    from tair_tpu_torch.train.stages import apply_trainable_mask
    from tair_tpu_torch.val_patches import main as val_patches_main

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    out = Path(out_dir)
    result = {}
    mesh = create_mesh(world, device_type="cpu")
    group = mesh.get_group("data")

    result["dp"], _, (dp_model_sd, _), _ = run_steps(tiny_model(), mesh)

    result["fsdp"], state, (model_sd, opt_sd), _ = run_steps(tiny_model(), mesh, fsdp=True)
    result["fsdp_ckpt"], _, (ckpt_model_sd, _), _ = run_steps(tiny_model(), mesh, fsdp=True,
                                                              use_checkpoint=True)
    result["fsdp_accum"], _, (accum_model_sd, _), _ = run_steps(tiny_model(), mesh, fsdp=True,
                                                              grad_accum=2)
    path = save_checkpoint(str(out / "fsdp_ckpt"), state, STEPS, write=rank == 0)
    dist.barrier()
    resumed = tiny_model()  # a fresh model, sharded alike, resumed from the file
    apply_trainable_mask(resumed, STAGE)
    apply_fsdp(resumed, mesh)
    resumed_state = restore_checkpoint(path, tstep.create_train_state(resumed, STAGE, LR))
    resumed_model_sd, resumed_opt_sd = state_dicts(resumed_state)
    if rank == 0:
        result["dp_state"] = dp_model_sd
        result["fsdp_accum_state"] = accum_model_sd
        result["fsdp_ckpt_state"] = ckpt_model_sd
        result["fsdp_state"] = (model_sd, opt_sd)
        result["fsdp_checkpoint"] = path
        result["resumed_state"] = (resumed_model_sd, resumed_opt_sd)

    outputs, targets = criterion_case()
    rows = slice(rank, rank + 1)
    local = set_criterion(
        tree_map(lambda a: torch.from_numpy(a[rows]), outputs),
        tree_map(lambda a: torch.from_numpy(a[rows]), targets),
        group=group,
    )
    keys = sorted(local)
    mean = torch.stack([local[k] for k in keys])
    dist.all_reduce(mean, group=group)
    result["criterion"] = dict(zip(keys, (mean / world).tolist()))

    try:
        create_mesh(world + 2, device_type="cpu")
        result["larger_mesh_raised"] = False
    except ValueError:
        result["larger_mesh_raised"] = True

    cfg = trainer_config(out / f"train_{rank}.yaml", out / "trainer", fsdp=True, batch_size=1)
    train_main(["--config", str(cfg), "--device", "cpu", "--max-steps", str(STEPS)])
    vp = val_patches_config(out / f"vp_{rank}.yaml", out / "lq", out / "val_patches")
    val_patches_main(["--config", str(vp), "--device", "cpu"])

    torch.save(result, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
