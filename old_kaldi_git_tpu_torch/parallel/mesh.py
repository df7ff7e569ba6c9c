"""Device mesh construction and sharding helpers.

Counterpart of old_kaldi_git_tpu/parallel/mesh.py.  The canonical mesh is
("data", "model") over the ranks of the default torch.distributed process
group (`torch.distributed.device_mesh.init_device_mesh`): utterance batches
split over "data", parameters over "model" when they exceed one card.  The
JAX package's `data_parallel_shardings` (pjit's in/out shardings) has no
counterpart: a rank holds its slice itself (`shard_batch`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("mesh")


@dataclasses.dataclass
class MeshConfig:
    data: int = -1  # -1: all remaining ranks
    model: int = 1


def mesh_shape(config: MeshConfig, n: int):
    """(data, model) for n ranks; raises when the shape does not fit."""
    model = max(1, config.model)
    data = config.data if config.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def make_mesh(config: Optional[MeshConfig] = None, device_type: Optional[str] = None):
    """A ("data", "model") DeviceMesh over the world's ranks; the device type
    is the process group's ("cuda" for NCCL, "cpu" for gloo)."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        raise KaldiError("make_mesh needs a process group: call "
                         "parallel.scaling.init_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    data, model = mesh_shape(config, n)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
    log.info("mesh: data=%d model=%d (%s)", data, model, device_type)
    return mesh


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, batch):
    """This rank's slice, along the first axis, of every [B, ...] tensor or
    array of a pytree, split over the mesh's "data" axis, on the mesh's
    device.  B must divide by the axis' size."""
    size = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    dev = _mesh_device(mesh)

    def piece(x):
        x = torch.as_tensor(x)
        if x.shape[0] % size:
            raise ValueError(f"batch {x.shape[0]} does not split over {size} ranks")
        w = x.shape[0] // size
        return x[r * w:(r + 1) * w].to(dev)

    return tree_map(piece, batch)


def replicate(mesh, tree):
    """Every tensor of a pytree as the mesh's first rank holds it, on every
    rank of the mesh (a broadcast along each mesh axis)."""
    dev = _mesh_device(mesh)

    def bcast(x):
        x = torch.as_tensor(x).to(dev).contiguous().clone()
        for name in mesh.mesh_dim_names:
            g = mesh.get_group(name)
            dist.broadcast(x, src=dist.get_global_rank(g, 0), group=g)
        return x

    return tree_map(bcast, tree)
