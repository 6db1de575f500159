"""Checkpoints of the whole train state, and weight-only exports.

Counterpart of ``tair_tpu/train/checkpoint.py``. A checkpoint holds the step
counter, every parameter and buffer of the model and the optimizer's state
(AdamW's moments and step counts), written with ``torch.save`` under
``ckpt_dir/step_XXXXXXXX``, so resuming is exact. A state sharded by FSDP is
gathered before it is written (every process takes part; one writes), and so
is a model cut by tensor parallelism (each layer's slices put back at their
global features, AdamW's moments too), so a checkpoint has one layout
whatever wrote it: it loads into a single process, and a sharded resume
keeps each process's part of it. The weight-only export keeps
the JAX package's ``.npz`` layout: one array per JAX leaf, keyed by its
``/``-joined tree path, in the JAX layout (HWIO kernels, [in, H, D] attention
projections), so an export of either package loads into the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.fsdp import full_state, full_tensor, load_full_state
from ..weights.convert import from_jax_params, jax_param_shapes, to_jax_params

CHECKPOINT_FILE = "state.pt"


def is_sharded(model: torch.nn.Module) -> bool:
    """Whether FSDP or tensor parallelism holds a part of `model` here."""
    from torch.distributed.tensor import DTensor

    from ..parallel.tp import tp_weights

    return any(isinstance(p, DTensor) for p in model.parameters()) or bool(tp_weights(model))


def state_dicts(state):
    """(model, optimizer) state dicts of `state` in a single process's
    layout: gathered where FSDP or tensor parallelism shards them (a
    collective then)."""
    if is_sharded(state.model):
        return full_state(state.model, state.optimizer)
    return state.model.state_dict(), state.optimizer.state_dict()


def save_checkpoint(ckpt_dir: str, state, step: int, write: bool = True) -> str:
    """Write `state` (a ``train.step.TrainState``) as the checkpoint of
    `step`. Saving a step that already has one is a no-op (resume + exit).
    A sharded state is gathered first, so every process calls; those with
    `write` false write nothing."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    model_sd, opt_sd = state_dicts(state)
    if not write or os.path.exists(path):
        return path
    tmp = path + ".partial"
    os.makedirs(tmp, exist_ok=True)
    torch.save(
        {"step": int(state.step), "model": model_sd, "optimizer": opt_sd},
        os.path.join(tmp, CHECKPOINT_FILE),
    )
    os.replace(tmp, path)  # a checkpoint directory is complete or absent
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".partial")
        and os.path.isdir(os.path.join(ckpt_dir, d))
    )
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def restore_checkpoint(path: str, state):
    """Load the checkpoint at `path` into `state` (model, optimizer, step) in
    place, onto the model's device; a sharded state keeps its shard of each
    tensor. Returns `state`."""
    device = next(state.model.parameters()).device
    data = torch.load(
        os.path.join(path, CHECKPOINT_FILE), map_location=device, weights_only=True
    )
    if is_sharded(state.model):
        load_full_state(state.model, state.optimizer, data["model"], data["optimizer"])
    else:
        state.model.load_state_dict(data["model"], strict=True)
        state.optimizer.load_state_dict(data["optimizer"])
    state.step = int(data["step"])
    return state


def state_checksums(state) -> Dict[str, float]:
    """Float64 sums and sums of squares of the parameters and of AdamW's two
    moments, and the sum of AdamW's step counts: what a restore must
    reproduce. Tensors are visited in the optimizer's parameter order; sharded
    ones are gathered (a collective)."""
    def sums(tensors):
        tensors = [full_tensor(t) for t in tensors]
        per = torch.stack([
            torch.stack([t.double().sum(), t.double().square().sum()]) for t in tensors
        ]) if tensors else torch.zeros(1, 2, dtype=torch.float64)
        total = per.sum(0).tolist()
        return total[0], total[1]

    trained = [p for group in state.optimizer.param_groups for p in group["params"]]
    moments = [state.optimizer.state[p] for p in trained if p in state.optimizer.state]
    out = {}
    for name, tensors in (
        ("params", [p.detach() for p in state.model.parameters()]),
        ("exp_avg", [m["exp_avg"] for m in moments]),
        ("exp_avg_sq", [m["exp_avg_sq"] for m in moments]),
    ):
        out[f"{name}_sum"], out[f"{name}_sumsq"] = sums(tensors)
    out["adam_steps"] = float(sum(float(m["step"]) for m in moments))
    return out


def flat_items(tree, prefix: str = ""):
    """(``/``-joined path, leaf) of every leaf of a tree of nested dicts: the
    npz keys of a weight export."""
    for key, node in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from flat_items(node, path)
        else:
            yield path, node


def save_tree(path: str, tree, dtype=None) -> None:
    """A JAX-layout tree (nested dicts of numpy arrays) as an npz, one array
    per leaf keyed by its ``/``-joined path. `dtype` casts floating leaves
    before writing (float16 halves the size; bfloat16 does not survive an npz
    round trip)."""
    arrays = {}
    for key, arr in flat_items(tree):
        if dtype is not None and np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(dtype)
        arrays[key] = arr
    np.savez(path, **arrays)


def save_params(path: str, model: torch.nn.Module, dtype=None, state_dict=None) -> None:
    """Weight-only export of `model` in the JAX package's npz layout
    (`save_tree` of its JAX-layout tree); `state_dict` in place of the
    model's own (a gathered one, for a sharded model)."""
    sd = model.state_dict() if state_dict is None else state_dict
    save_tree(path, to_jax_params(sd, jax_param_shapes(model)), dtype)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Weight-only import in place (non-strict: parameters the file lacks keep
    their values). Floating arrays are cast to the parameter's dtype."""
    with np.load(path) as data:
        found, stored = {}, set(data.files)
        for key, _ in flat_items(jax_param_shapes(model)):
            if key in stored:
                node = found
                *parents, leaf = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = data[key]
    state = from_jax_params(found)
    current = model.state_dict()
    model.load_state_dict(
        {k: v.to(current[k].dtype) for k, v in state.items()}, strict=False
    )
    return model
