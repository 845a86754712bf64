"""Meshes of ranks over ``torch.distributed``.

Port of ``nds_tpu/parallel/mesh.py``. Where the reference lays a
``jax.sharding.Mesh`` over the devices of one program, the port runs one
process per device (one rank of a ``torch.distributed`` world: NCCL on
the card, gloo on the CPU) and a ``Mesh`` says where this rank sits:

- the world size and this rank; the shape, ``(n,)`` with the axis
  ``DATA_AXIS``, or ``(n_hosts, n_lanes)`` with ``(HOST_AXIS,
  DATA_AXIS)``;
- global rank ``r`` at host ``r // n_lanes``, lane ``r % n_lanes``: the
  reference's row-major device grid, so that gathers in rank order give
  the reference's order;
- one ``AxisGroup`` per axis (the process group of the ranks that share
  this rank's position on the other axis) and one over the whole world.
  Global rank ``r``'s position along an axis is its index in that
  axis' group.

The collectives take the reference's forms: ``all_to_all`` is
``lax.all_to_all(x.reshape(size, -1), axis, 0, 0)`` (rank ``j`` gets
chunk ``j`` of every rank, in rank order), ``all_gather`` is the tiled
``lax.all_gather``, ``all_reduce`` is ``psum``/``pmin``/``pmax``. Bool
tensors travel as uint8, as NCCL requires.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from nds_tpu_torch.device import resolve_device

DATA_AXIS = "d"
HOST_AXIS = "h"

# seconds a collective may wait before the process group fails it
# (``NDS_TPU_DIST_TIMEOUT_S``): a lost rank ends the run with an error
# instead of hanging it
DEFAULT_TIMEOUT_S = 300.0


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(
        os.environ.get("NDS_TPU_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S)))


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
# the tiled gather under its newer name where the installed torch has it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, bool viewed as uint8."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class AxisGroup:
    """One axis of the mesh as this rank sees it: its ``size`` and the
    process ``group`` of its ranks."""

    def __init__(self, size: int, group=None):
        self.size = size
        self.group = group

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Equal splits: chunk ``j`` of ``t`` goes to the axis' rank
        ``j``; chunk ``i`` of the result came from rank ``i``."""
        src = _wire(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        src = _wire(t)
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _ALL_GATHER(out, src, group=self.group)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("sum", "min", "max") of ``t`` over the axis, in a new
        tensor of ``t``'s shape."""
        out = t.reshape(1).clone() if t.dim() == 0 else t.clone()
        out = out.contiguous()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out.reshape(t.shape)


class Mesh:
    """This rank's place in a 1-D or 2-D mesh of the world's ranks."""

    def __init__(self, shape: tuple, axis_names: tuple, axes: dict):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.axes = axes
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.world = AxisGroup(self.size, dist.group.WORLD)

    def axis(self, name: str) -> AxisGroup:
        return self.axes[name]


def _init_world_of_one(device) -> None:
    """A world of one rank (NCCL for a CUDA device, gloo for the CPU)
    over an in-process store: no address, no port."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timeout())


def make_mesh(n_devices: "int | None" = None, device=None) -> Mesh:
    """1-D mesh over the whole initialized world, which must hold exactly
    ``n_devices`` ranks. With no world and ``n_devices`` in (None, 1),
    a world of one is initialized on ``device`` (the card unless the
    CPU is asked for)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"need a torch.distributed world of {n_devices} ranks; "
                f"none is initialized (multihost.maybe_initialize)")
        _init_world_of_one(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the world has {world}")
    return Mesh((world,), (DATA_AXIS,),
                {DATA_AXIS: AxisGroup(world, dist.group.WORLD)})


def make_multihost_mesh(n_hosts: int, n_lanes: int, device=None) -> Mesh:
    """2-D (host, lane) mesh: the ``h`` axis joins the ranks of one lane
    across hosts, the ``d`` axis the lanes of one host. Every rank
    creates every group, in the same order, as ``new_group`` requires."""
    need = n_hosts * n_lanes
    if not dist.is_initialized() and need == 1:
        _init_world_of_one(device)
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"need {need} ranks, the world has {have}")
    host, lane = divmod(dist.get_rank(), n_lanes)
    across_hosts = [dist.new_group([h * n_lanes + ln for h in range(n_hosts)],
                                   timeout=timeout())
                    for ln in range(n_lanes)]
    within_host = [dist.new_group([h * n_lanes + ln for ln in range(n_lanes)],
                                  timeout=timeout())
                   for h in range(n_hosts)]
    return Mesh((n_hosts, n_lanes), (HOST_AXIS, DATA_AXIS), {
        HOST_AXIS: AxisGroup(n_hosts, across_hosts[lane]),
        DATA_AXIS: AxisGroup(n_lanes, within_host[host])})


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
