"""The ("data", "model") mesh of ranks, and FSDP over "model".

Counterpart of ``dove_tpu/parallel/mesh.py``. There a mesh is an array of
devices driven by one process and XLA inserts the collectives from the
shardings; here every rank is a process and a mesh names its process
groups: rank r sits at (r // model, r % model), row-major as JAX lays out
``make_mesh``'s device array, and a ``torch.distributed`` ``DeviceMesh``
with the same axis names gives the "data" and "model" groups.

  * serving: independent work (chunks, spatial windows, tile batches) is
    spread over the ranks (``pipeline.py``); the DiT runs tensor-parallel
    over "model" (``tp.py``);
  * training: each "data" row takes its slice of the batch and the trainer
    averages the gradients over "data" (DDP); "model" carries FSDP
    (``shard_params``: FSDP2's ``fully_shard`` on the "model" sub-mesh, so
    with the data rows this is HSDP) or tensor parallelism.

A mesh of size 1 needs no process group: its groups are None and every
collective on them is skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from dove_tpu_torch.parallel.distributed import world
from dove_tpu_torch.parallel.tp import Group

AXES = ("data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, model) grid of ranks; ``shape`` maps axis -> size."""

    shape: dict[str, int]
    rank: int
    device_mesh: Any = None  # torch.distributed DeviceMesh, None at size 1

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        model = self.shape["model"]
        return self.rank // model if axis == "data" else self.rank % model

    def group(self, axis: str | None = None):
        """The process group of ``axis`` that holds this rank (every rank of
        the mesh for None); None where that group has one rank."""
        n = self.size if axis is None else self.shape[axis]
        if n == 1:
            return None
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def axis_group(self, axis: str | None) -> Group | None:
        """``group(axis)`` with this rank's index in it and its size (every
        rank of the mesh for None); None where it has one rank."""
        n = self.size if axis is None else self.shape[axis]
        if n == 1:
            return None
        return Group(self.group(axis), n, self.rank if axis is None else self.coord(axis))


def make_mesh(data: int | None = None, model: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """A ("data", "model") mesh over every rank of the run; ``data``
    defaults to world size // model. ``device`` names the DeviceMesh's
    device type (the card unless "cpu")."""
    rank, n = world()
    if data is None:
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"data({data}) * model({model}) must equal the "
                         f"world size ({n}): one rank per mesh position")
    shape = {"data": data, "model": model}
    if not dist.is_initialized():
        return Mesh(shape, rank)
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device("cuda" if device is None else device).type
    return Mesh(shape, rank, init_device_mesh(kind, (data, model), mesh_dim_names=AXES))


def fsdp_spec(shape: Any, axis: str, axis_size: int) -> tuple:
    """Shard the largest divisible dim of a leaf over ``axis`` (ZeRO-3 style)
    -> a PartitionSpec-like tuple: () replicated, else one entry per dim.

    The JAX package's rule: a leading (layer-stack) dim is skipped whenever
    a later dim can shard; leaves too small to shard stay replicated; ties
    go to the last dim. ``shape`` is a shape or anything with ``.shape``."""
    shape = tuple(getattr(shape, "shape", shape))
    if not shape:
        return ()

    def divisible(idx_range):
        return [(shape[i], i) for i in idx_range
                if shape[i] % axis_size == 0 and shape[i] >= axis_size and shape[i] > 1]

    candidates = divisible(range(1, len(shape))) or divisible(range(0, 1))
    if not candidates:
        return ()
    _, best = max(candidates, key=lambda t: (t[0], t[1]))
    spec: list[str | None] = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def shard_params(dit: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """FSDP of the DiT over "model": FSDP2's ``fully_shard`` on each block
    and on the DiT itself, each parameter sharded on the dim ``fsdp_spec``
    picks (dim 0 where it picks none: FSDP2 shards every parameter). Each
    rank then holds 1/n of the weights between uses; a block's forward
    gathers its own, and its gradients are reduce-scattered (averaged, over
    ranks that see the same batch). With one "model" rank the DiT is
    returned as it is."""
    axis = "model"
    n = mesh.shape[axis]
    if n == 1:
        return dit
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def placement(p: torch.nn.Parameter):
        spec = fsdp_spec(p.shape, axis, n)
        return Shard(spec.index(axis)) if spec else None

    sub = mesh.device_mesh[axis]
    for block in dit.transformer_blocks:
        fully_shard(block, mesh=sub, shard_placement_fn=placement)
    fully_shard(dit, mesh=sub, shard_placement_fn=placement)
    return dit
