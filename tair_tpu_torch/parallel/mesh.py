"""Process group, device mesh and batch sharding of the port.

Counterpart of ``tair_tpu/parallel/mesh.py`` over ``torch.distributed``: one
process per device, joined by the environment that ``torchrun`` sets; a
``DeviceMesh`` with the axes ("data", "model"); the global batch split on the
data axis, rank r holding rows ``[r·B, (r+1)·B)`` (JAX's ``P("data")``), the
same rows on every process of one model group.
Nothing here falls back to one process when more were asked for: a mesh the
group cannot hold raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(device_type: str, group_of_one: bool = False) -> torch.device:
    """Join the process group and return this process's device.

    Under ``torchrun`` (``WORLD_SIZE`` set) the group comes from its
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
    NCCL for ``cuda`` and gloo for ``cpu``, and the device is
    ``cuda:LOCAL_RANK``. A single process joins no group, unless
    `group_of_one` asks for one (FSDP needs a group even of one): then a group
    of one on an in-process store, with no socket. A group that is already
    initialised is used as it is."""
    cuda = device_type == "cuda"
    device = torch.device("cpu")
    if cuda:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kwargs = dict(backend="nccl" if cuda else "gloo", device_id=device if cuda else None)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(init_method="env://", **kwargs)
    elif group_of_one:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kwargs)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(
    n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda"
) -> DeviceMesh:
    """A ("data", "model") mesh over the process group, one device per
    process, rank r at (r // n_model, r % n_model). `n_data` defaults to all
    processes over `n_model`. A mesh that asks for more or fewer devices than
    the group has raises ValueError, as the JAX mesh does for more devices
    than it sees. The model axis carries tensor and sequence parallelism
    (``parallel/tp.py``), in serving and in ``train.step.make_train_step``;
    the trainer's entry point (``python -m tair_tpu_torch.train``), like the
    JAX package's ``train.py``, builds a data-only mesh."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} impossible with {world} devices")
    if n_data * n_model != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} leaves {world - n_data * n_model} of the group's "
            f"{world} processes without a device"
        )
    if not dist.is_initialized():
        raise ValueError("a mesh needs a process group: call init_distributed first")
    return init_device_mesh(
        device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)
    )


def local_rows(global_batch: int, mesh: Optional[DeviceMesh]) -> slice:
    """This process's rows of a global batch: ``[r·B, (r+1)·B)`` for its rank
    r on the data axis (all of them without a mesh), whatever its rank on the
    model axis."""
    if mesh is None:
        return slice(0, global_batch)
    n = mesh[DATA_AXIS].size()
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split over {n} devices")
    per = global_batch // n
    r = mesh.get_local_rank(DATA_AXIS)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh: Optional[DeviceMesh], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This process's rows of every tensor of a global batch."""
    rows = local_rows(next(iter(batch.values())).shape[0], mesh)
    return {k: v[rows] for k, v in batch.items()}
