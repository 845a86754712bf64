"""Multi-process launch of the port's distributed engine.

Port of ``nds_tpu/parallel/multihost.py`` (``maybe_initialize``,
``is_primary``, ``global_mesh``). Every process runs the same program; the
environment names the world, with the reference's names, so that one
launch line drives both packages:

    NDS_TPU_COORDINATOR=host0:12355   rank 0's address for the TCP store
    NDS_TPU_NUM_PROCESSES=4           world size
    NDS_TPU_PROCESS_ID=0..3           this process's rank

On the card each process takes CUDA device ``rank % device_count()``
and the world runs NCCL; on the CPU (``device="cpu"``) gloo. With no
environment, a one-rank world starts at the first ``make_mesh``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from nds_tpu_torch.device import resolve_device
from nds_tpu_torch.parallel.mesh import make_mesh, timeout


def maybe_initialize(device=None) -> bool:
    """Initialize the ``torch.distributed`` world when the environment
    asks for one of more than one process (once per process; later calls
    return at once). Returns True when running multi-process."""
    coord = os.environ.get("NDS_TPU_COORDINATOR")
    nproc = os.environ.get("NDS_TPU_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1 and not dist.is_initialized():
        rank = int(os.environ.get("NDS_TPU_PROCESS_ID", "0"))
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coord}", world_size=int(nproc), rank=rank,
            timeout=timeout())
        return True
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that writes the reports: rank 0 (every
    process computes the same replicated result)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(shards: "int | None" = None, device=None):
    """1-D data mesh over the whole world. Multi-process, the mesh must
    span every rank: any ``shards`` other than the world size is an
    error, not a silent subset. Single-process, a mesh of one rank."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        if shards not in (None, world):
            raise ValueError(
                f"engine.mesh.shards={shards} but the multi-process "
                f"world has {world} ranks; the mesh must span all of them "
                f"(omit the knob or set it to {world})")
        return make_mesh(world, device=device)
    return make_mesh(shards if shards and shards > 1 else None,
                     device=device)
