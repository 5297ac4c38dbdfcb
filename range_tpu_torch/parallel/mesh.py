"""Device meshes over a `torch.distributed` process group.

Counterpart of `range_tpu/parallel/mesh.py:25-40`.  One process drives one
device; the mesh arranges the group's ranks on named axes:

  * "data": batch parallelism (each data row of the mesh takes a slice of
    the queries);
  * "bank": bank-row sharding for retrieval (each rank holds a slab of the
    bank's rows; the per-shard partial softmaxes combine exactly).

The caller starts the process group (`torch.distributed.init_process_group`
with its address, world size and rank, e.g. a `FileStore` on one host);
`make_mesh` never falls back to one device when there is none.  JAX's
`NamedSharding` helpers have no counterpart: placement is explicit here
(`parallel/sharded.shard_bank` keeps this rank's slab).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "bank"),
              device_type: str = "cuda"):
    """A `DeviceMesh` of the process group's ranks (`init_device_mesh`).

    Args:
      shape: per-axis sizes; None puts every rank on the first axis.
      axis_names: the axes' names, cut to len(shape).
      device_type: "cuda" (NCCL groups, one card per rank) or "cpu" (gloo).
    Raises RuntimeError without a process group and ValueError when the
    shape's size is not the group's world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group: "
                           "call init_process_group first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(n) for n in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
