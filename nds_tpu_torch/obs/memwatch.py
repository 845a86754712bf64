"""The device memory a run held.

Port of a part of ``nds_tpu/obs/memwatch.py``: ``process_record``, the
process's peak allocated and reserved bytes and the device placement's
graph pool, in GiB, on the card (what a power or throughput process
prints when it ends). Read from ``torch.cuda.memory_stats()`` only where
CUDA is already initialized (reading never starts a backend, the
reference's rule).

The gauges the execution pipeline reads (``live_bytes``, ``high_water``
and ``table_bytes``: the memory governor's projection and the cost
model's per-query high-water marks) come back with the chunked rung,
ROADMAP Queue 1 item 6; the sampler thread, the accounted live buffers
(``add_live``, ``sub_live``) and the summary's ``memory`` block wait for
item 7 (observability).
"""

from __future__ import annotations

import torch


def process_record(pipeline=None) -> "dict | None":
    """On the card: the process's peak allocated and reserved bytes and
    the bytes in the graph pool of ``pipeline``'s device placement, all
    in GiB (the pool None where the allocator cannot tell it apart). None
    where CUDA is not initialized in this process."""
    if not torch.cuda.is_initialized():
        return None
    try:
        stats = torch.cuda.memory_stats()
    except RuntimeError:  # the gauge must never fail a run
        return None
    gib = float(1 << 30)
    ex = getattr(pipeline, "_executors", {}).get("device")
    graphs = getattr(ex, "_graphs", None)
    pool = graphs.pool_bytes() if graphs is not None else None
    return {"peak_allocated_gib":
                int(stats.get("allocated_bytes.all.peak", 0)) / gib,
            "peak_reserved_gib":
                int(stats.get("reserved_bytes.all.peak", 0)) / gib,
            "graph_pool_gib": None if pool is None else pool / gib}
