"""Hash-partition exchange over ``torch.distributed``: the engine's shuffle.

Port of ``nds_tpu/parallel/exchange.py``: rows hash to a destination
rank and move in one all-to-all along a mesh axis (NCCL on the card,
gloo on the CPU). The send buffers are packed by one kernel,
``kernels.exchange_pack`` (``csrc/exchange.cu``): splitmix64 of the key,
the destination, each row's stable rank within it, the overflow count
and the scatter of every payload column. The all-to-all is one
``all_to_all_single`` per payload with equal splits, which is what
``lax.all_to_all(x.reshape(n_dev, bucket), axis, 0, 0)`` does.

Static-shape contract, as the reference's: each rank sends a bucket of
``ceil(local_rows * slack / n_dev)`` rows to every peer; rows past a
full bucket are dropped and counted, and the executor retries with a
doubled slack. Each exchange fires the ``exchange`` fault point and
beats the watchdog (``resilience/``) first. The reference's skew gauge
and trace-time counter belong to observability (ROADMAP Queue 1 item
7).

``axis`` is an axis name of ``mesh`` (of the initialized world's 1-D
mesh when no mesh is given) or an object with the ``AxisGroup``
collectives.
"""

from __future__ import annotations

import torch.distributed as dist

from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.resilience import faults, watchdog
from nds_tpu_torch.parallel.mesh import DATA_AXIS, HOST_AXIS, make_mesh


def _axis(axis, mesh):
    if not isinstance(axis, str):
        return axis
    if mesh is None:
        if not dist.is_initialized():
            raise ValueError(f"exchange over axis {axis!r}: no mesh given "
                             f"and no torch.distributed world initialized")
        mesh = make_mesh()
    return mesh.axis(axis)


def _bucket(n: int, slack: float, n_dev: int) -> int:
    return max(1, int(-(-n * slack // n_dev)))


def _exchange(arrays, ok, n_dev: int, bucket: int, axis, **route):
    if axis.size != n_dev:
        raise ValueError(f"exchange over {n_dev} ranks on an axis of "
                         f"{axis.size}")
    # chaos site: an injected fault surfaces where a real capacity
    # failure would, and the executor's retry classifies it
    faults.fault_point("exchange", n_dev=n_dev)
    watchdog.beat("engine", phase="exchange")
    payload = [a.contiguous() for a in arrays]
    bufs, send_ok, n_over = KX.exchange_pack(
        payload, ok.contiguous(), n_dev, bucket, **route)
    out_ok = axis.all_to_all(send_ok)
    return [axis.all_to_all(b) for b in bufs], out_ok, n_over


def exchange(arrays: list, key, ok, n_dev: int, slack: float = 2.0,
             axis=DATA_AXIS, mesh=None):
    """Repartition rows by hash(key) across the mesh axis.

    arrays: per-row payload tensors (this rank's rows). key: int32 or
    int64 per row. ok: bool per row (invalid rows don't travel).
    Returns (out_arrays, out_ok, overflow_count) where out_* have
    capacity n_dev * bucket ( = local_n * slack rounded up)."""
    return _exchange(arrays, ok, n_dev, _bucket(key.shape[0], slack, n_dev),
                     _axis(axis, mesh), key=key, modulus=n_dev)


def exchange_by_dest(arrays: list, dest, ok, n_dev: int,
                     slack: float = 2.0, axis=DATA_AXIS,
                     bucket: "int | None" = None, mesh=None):
    """Exchange routed by an explicit int32 destination in [0, n_dev)
    per row. ``bucket`` overrides the per-peer capacity."""
    if bucket is None:
        bucket = _bucket(dest.shape[0], slack, n_dev)
    return _exchange(arrays, ok, n_dev, bucket, _axis(axis, mesh),
                     dest=dest)


def exchange_hierarchical(arrays: list, key, ok, n_hosts: int,
                          n_lanes: int, slack: float = 2.0,
                          host_axis=HOST_AXIS, lane_axis=DATA_AXIS,
                          key_index: "int | None" = None, mesh=None):
    """Two-stage shuffle on a (host, lane) mesh: rows move to their
    destination host over ``host_axis``, then to their lane over
    ``lane_axis``. The destination of a key is the flat exchange's over
    hosts * lanes ranks: g = hash(key) % (hosts * lanes), host = g //
    lanes, lane = g % lanes. Stage 2 recomputes the lane from the key
    carried through stage 1 (``arrays[key_index]``, or the key appended
    for the trip and dropped after it) and sizes its bucket from the
    logical rows. Returns (out_arrays, out_ok, overflow) with both
    stages' overflow summed."""
    n = key.shape[0]
    modulus = n_hosts * n_lanes
    payload = list(arrays)
    appended = key_index is None
    if appended:
        payload = payload + [key]
        key_index = len(payload) - 1
    outs1, ok1, over1 = _exchange(
        payload, ok, n_hosts, _bucket(n, slack, n_hosts),
        _axis(host_axis, mesh), key=key, modulus=modulus, div=n_lanes)
    key1 = outs1[key_index]
    outs2, ok2, over2 = _exchange(
        outs1[:-1] if appended else outs1, ok1, n_lanes,
        _bucket(n, slack, n_lanes), _axis(lane_axis, mesh), key=key1,
        modulus=modulus)
    return outs2, ok2, over1 + over2
