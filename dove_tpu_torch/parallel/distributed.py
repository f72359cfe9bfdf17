"""Multi-process support on ``torch.distributed``: one process per device.

Counterpart of ``dove_tpu/parallel/distributed.py``. The JAX package runs one
process per host and sees every device of the run; here each process drives
one device, as ``torchrun`` starts them::

    torchrun --nproc-per-node 4 -m dove_tpu_torch.train --multihost true ...
    torchrun --nproc-per-node 2 -m dove_tpu_torch.inference --is_vae_st \\
        --tensor_parallel 2 ...

or, with the JAX package's variables, one command per process::

    DOVE_COORDINATOR=host0:1234 DOVE_NUM_PROCESSES=2 DOVE_PROCESS_ID=<i> \\
        python -m dove_tpu_torch.train --multihost true ...

``DOVE_COORDINATOR`` may also be a ``file://`` or ``tcp://`` URL. A CUDA
device is ``cuda:LOCAL_RANK`` and takes NCCL; the CPU takes gloo. A process
with no configuration runs alone (world size 1) and nothing is initialised.

What differs from one process is the data: every rank builds the same batch
order from the shared seed and keeps its own slice (the loader's
``process_shard``), so no global array is assembled (``put_global``'s
counterpart is "each rank keeps its local batch"). Host objects (finished
frames, metric sums) travel over a gloo group beside the device backend,
and rank 0 assembles, writes and logs.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

_HOST_GROUP: Any = None


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def local_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``cuda`` becomes ``cuda:LOCAL_RANK`` (raising
    where there is no card); ``cpu`` stays. ``None`` means the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.index is not None:
        return device
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = (dist.get_rank() if dist.is_initialized() else 0) % torch.cuda.device_count()
    return torch.device("cuda", local)


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[int, int]:
    """Join the process group (idempotent) -> (rank, world size).

    Explicit arguments win; then torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``; then ``DOVE_COORDINATOR`` /
    ``DOVE_NUM_PROCESSES`` / ``DOVE_PROCESS_ID``. With none of them this is
    a no-op at world size 1. ``device`` picks the backend: NCCL for the
    card (this rank's ``cuda:LOCAL_RANK``), gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "DOVE_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "DOVE_PROCESS_ID")
    if coordinator is None:
        if "MASTER_ADDR" in os.environ:
            coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        else:
            coordinator = os.environ.get("DOVE_COORDINATOR")
    if not coordinator and not num_processes:
        return 0, 1
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator, a process count and a "
            f"process id (got {coordinator!r}, {num_processes}, {process_id})")
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=coordinator if "://" in coordinator else f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(minutes=30))
    # the host group is made now, while every rank is at the same point; a
    # startup barrier: a broken rendezvous fails here, not at the first step
    dist.barrier(group=host_group())
    return dist.get_rank(), dist.get_world_size()


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return world()[0] == 0


def host_group():
    """A gloo group over every rank for host objects: the default group when
    it is gloo already. Every rank must make its first call at the same
    point of the program (``init_distributed`` does)."""
    global _HOST_GROUP
    if not dist.is_initialized():
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


def barrier() -> None:
    if world()[1] > 1:
        dist.barrier(group=host_group())


def gather_objects(obj: Any, dst: int = 0) -> list[Any] | None:
    """Every rank's ``obj`` in rank order on rank ``dst`` (pickled over the
    host group), None on the others; ``[obj]`` without a process group."""
    if world()[1] == 1:
        return [obj]
    rank = dist.get_rank()
    out: list[Any] | None = [None] * dist.get_world_size() if rank == dst else None
    dist.gather_object(obj, out, dst=dst, group=host_group())
    return out
