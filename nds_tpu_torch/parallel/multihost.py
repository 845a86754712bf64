"""Multi-process launch of the port's distributed engine.

Port of ``nds_tpu/parallel/multihost.py`` (``maybe_initialize``,
``is_primary``, ``global_mesh``, and the scheduler's small all-rank
exchanges ``gather_votes``, ``barrier`` and ``gather_floats``). Every
process runs the same program; the
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


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _gather(value, dtype) -> list:
    """All-gather one number from every rank, in rank order: on the
    card's NCCL world through the current CUDA device, on gloo through
    the CPU."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor([value], dtype=dtype, device=dev)
    parts = [torch.empty_like(mine) for _ in range(_world())]
    dist.all_gather(parts, mine)
    return [p.item() for p in parts]


def gather_votes(vote: int) -> "list[int] | None":
    """All-gather one small int from every rank: the transport under the
    scheduler's placement consensus (``engine/scheduler.py``). Every
    rank calls it at the same decision point, reads back every vote and
    applies the same rule, so a placement switches on all ranks or on
    none. None when the gather fails (a lost or lagging rank): the
    caller keeps its placement rather than diverge."""
    if _world() == 1:
        return [int(vote)]
    try:
        return [int(v) for v in _gather(int(vote), torch.int64)]
    except Exception:  # noqa: BLE001 - consensus must degrade, not hang
        return None


def barrier(tag: str) -> bool:
    """World-wide barrier: True when every rank arrived, False when the
    barrier failed (the process group's timeout ends a lost rank's wait;
    the caller degrades, never hangs). Trivially True in a world of one.
    ``tag`` names the barrier in the error a failure prints."""
    if _world() == 1:
        return True
    try:
        dist.barrier()
        return True
    except Exception as exc:  # noqa: BLE001 - alignment must degrade
        print(f"[multihost] barrier {tag!r} failed: {exc}")
        return False


def gather_floats(value: float) -> "list[float] | None":
    """All-gather one float (float64) from every rank, in rank order;
    None when the gather fails."""
    if _world() == 1:
        return [float(value)]
    try:
        return [float(v) for v in _gather(float(value), torch.float64)]
    except Exception:  # noqa: BLE001 - alignment must degrade, not hang
        return None
