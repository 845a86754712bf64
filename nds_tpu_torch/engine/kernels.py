"""Relational kernels of the port, and the planner's kernel-selection pass.

Port of ``nds_tpu/engine/kernels.py``. The selection half (``annotate``,
the thresholds, ``domain_of``, ``direct_feasible``) is copied verbatim,
so both packages stamp the same kernel on every plan node. The kernel
half replaces the JAX formulations with hand-written CUDA C++ for Hopper
(``nds_tpu_torch/csrc``):

=====================  ===================================  ======================
wrapper                replaces (nds_tpu/engine/kernels.py)  source
=====================  ===================================  ======================
direct_lookup_join     ``direct_lookup_join`` (K1)           csrc/dense_domain.cu
matmul_probe_join      ``matmul_probe_join`` (K2)            csrc/small_build_probe.cu
bitmask_semi           ``bitmask_semi`` (K3)                 csrc/dense_domain.cu
keyed_minmax_semi      ``keyed_minmax_semi`` (K4)            csrc/dense_domain.cu
seg_reduce_at_ends     ``seg_scan`` + ``seg_reduce_at_ends``  csrc/seg_scan.cu
                       (K5); with op "sum",
                       ``device_exec.py`` ``_seg_sum`` (L2)
pack_group_key         ``device_exec.py`` ``_group_ids``'    csrc/group_key.cu
                       sort operands, packed (L2)
group_bounds           ``device_exec.py`` ``_group_ids``      csrc/seg_scan.cu
                       after its sort (L2)
running_max            ``device_exec.py`` the windows'        csrc/seg_scan.cu
                       ``lax.cummax``
partitioned_mn_join    ``partitioned_mn_join`` +             csrc/partitioned_join.cu
                       ``_radix_scatter`` + ``_pids`` (K6)   (+ csrc/seg_scan.cu)
partition_sort         K6's build sort, ``lax.sort`` of      csrc/partitioned_join.cu
                       ``(keys, gidx)`` with ``num_keys=1``;
                       ``_group_ids``' ``lax.sort`` over one
                       packed key (L2); ``_build_lookup``'s
                       sort (L3); each word of the sorts below
pack_sort_key          ``device_exec.py`` the multi-operand  csrc/sort_key.cu
                       ``lax.sort`` of ``_run_sort``, the
                       windows, count-distinct, the ``<>``
                       residual and the unpacked group-bys,
                       as words for ``partition_sort``
sorted_search          ``device_exec.py`` ``_ss`` and        csrc/sorted_search.cu
                       ``_probe`` (L3)
compact_perm           ``device_exec.py`` ``_compactor`` and  csrc/compact.cu
                       ``_compact`` (L1)
seg_scan               ``seg_scan``, per row (K7)            csrc/seg_scan.cu
part_reduce_broadcast  ``part_reduce_broadcast`` (K7)        csrc/seg_scan.cu
last_of_group          ``last_of_group`` (K7)                csrc/seg_scan.cu
bitpack_decode         ``nds_tpu/columnar/device.py``        csrc/columnar_decode.cu
                       ``_unpack_words`` + bitpack
                       ``decode`` (K8)
unpack_mask            ``columnar/device.py`` ``unpack_mask``  csrc/columnar_decode.cu
                       (K8, one bit per row)
rle_decode             ``columnar/device.py`` RLE ``decode``  csrc/columnar_decode.cu
                       (K9)
exchange_pack          ``nds_tpu/parallel/exchange.py``      csrc/exchange.cu
                       ``_mix64`` + ``exchange_by_dest``
                       before its ``all_to_all`` (L5)
=====================  ===================================  ======================

Each wrapper dispatches on the device of its tensors: on a CUDA tensor
it launches its kernel (or raises), on a CPU tensor it runs its plain
PyTorch version ``<name>_plain``, which mirrors the JAX function step by
step and is what the CPU tests compare with the reference. There is no
fallback from the kernel to the plain version. Each wrapper counts its
kernel launches in ``LAUNCHES[<wrapper>]`` (``reset_launches`` zeroes
them), so a run can show that it went through the kernels.

All twenty are bound by bytes on the card: the source files say how
many, and what their design does about it. The scans, the group bounds,
the M:N join's partition and its build sort, and the compactor's counts
are single-pass kernels with decoupled look-back
(``csrc/lookback.cuh``); their tile words live in buffers kept across
calls, one per device, stream and word layout (``_lookback``), and each
launch draws an epoch of its own from a counter word on the card, so
nothing is zeroed between calls and a CUDA graph's replays do not
repeat an epoch.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from nds_tpu_torch.sql import plan as P

# ------------------------------------------------------------ selection

# Join kernels (Join.kernel). "" = unannotated: legacy trace heuristics.
JOIN_SORT = "sortmerge"
JOIN_DIRECT = "direct"
JOIN_MATMUL = "matmul"
JOIN_PARTITIONED = "partitioned"
JOIN_KERNELS = ("", JOIN_SORT, JOIN_DIRECT, JOIN_MATMUL,
                JOIN_PARTITIONED)

# SemiJoin kernels
SEMI_SORT = "sortmerge"
SEMI_BITMASK = "bitmask"
SEMI_KERNELS = ("", SEMI_SORT, SEMI_BITMASK)

# Aggregate kernels
AGG_SEGSCAN = "segscan"
AGG_SCATTER = "scatter"
AGG_KERNELS = ("", AGG_SEGSCAN, AGG_SCATTER)

# builds at or below this many estimated rows probe via one-hot matmul
# (the equality matrix is (probe x build); 64 keeps it a thin MXU tile
# even against multi-million-row probes)
MATMUL_MAX_BUILD = 64
# largest dense direct-address table the trace will materialize
# (entries, not bytes: int32 -> 32 MiB at the cap)
DIRECT_MAX_DOMAIN = 1 << 23
# the dense table may be at most this many times larger than the build
# capacity — beyond it the scatter/gather wins are eaten by the
# table's own HBM traffic (surrogate keys are near-dense, ratio ~1-4)
DIRECT_DOMAIN_FACTOR = 16
# both sides of an M:N join must estimate at least this many rows for
# radix partitioning to beat one flat sort
PARTITION_MIN_ROWS = 1 << 16
# radix partition count (power of two; per-partition sort depth drops
# by log2(NPART) and all NPART sorts run as ONE batched lax.sort)
NPART = 8

ENV_FLAG = "NDS_TPU_KERNELS"


def kernels_enabled() -> bool:
    """Kill switch: NDS_TPU_KERNELS=0 leaves every plan unannotated so
    the legacy sort-based paths serve everything (A/B runs, ndsperf's
    "old" lane)."""
    return os.environ.get(ENV_FLAG, "1") not in ("0", "off")


# scan-filter selectivity guess per conjunct for the row estimator —
# only drives kernel thresholds, never correctness (the trace
# re-validates feasibility against real bounds at compile time)
_FILTER_SEL = 0.4


def _est_rows(node: P.Node, sizes: dict, memo: dict) -> float:
    """Planning-time row estimate per node, from the catalog's relative
    size statistics (the estimate_plan source the scheduler cost model
    already uses). Deterministic; coarse is fine — thresholds are
    order-of-magnitude decisions."""
    nid = id(node)
    if nid in memo:
        return memo[nid]
    memo[nid] = 1.0  # cycle guard
    if isinstance(node, P.Scan):
        rows = float(sizes.get(node.table, 1000.0))
        rows *= _FILTER_SEL ** min(len(node.filters), 3)
    elif isinstance(node, P.Join):
        lr = _est_rows(node.left, sizes, memo)
        rr = _est_rows(node.right, sizes, memo)
        rows = lr if node.right_unique else max(lr, rr) * 2.0
        if node.kind in ("left", "full"):
            rows = lr + rr if node.kind == "full" else max(lr, rows)
    elif isinstance(node, P.SemiJoin):
        rows = _est_rows(node.left, sizes, memo)
    elif isinstance(node, P.SetOp):
        rows = (_est_rows(node.left, sizes, memo)
                + _est_rows(node.right, sizes, memo))
    elif isinstance(node, P.Aggregate):
        rows = _est_rows(node.child, sizes, memo)
    elif isinstance(node, P.Limit):
        rows = float(min(node.count,
                         _est_rows(node.child, sizes, memo)))
    elif isinstance(node, P.Filter):
        rows = _est_rows(node.child, sizes, memo) * _FILTER_SEL
    else:
        child = getattr(node, "child", None)
        rows = (_est_rows(child, sizes, memo)
                if isinstance(child, P.Node) else 1000.0)
    rows = max(rows, 1.0)
    memo[nid] = rows
    return rows


def select_join_kernel(left_rows: float, right_rows: float,
                       right_unique: bool, kind: str) -> str:
    """The selection rule for one Join node (README documents it):
    unique builds go matmul (tiny) or direct (everything else — the
    trace demotes to sortmerge when bounds/domain disqualify); M:N
    inner joins go partitioned when both sides are large enough to
    amortize the radix scatter."""
    if right_unique:
        if right_rows <= MATMUL_MAX_BUILD:
            return JOIN_MATMUL
        return JOIN_DIRECT
    if (kind == "inner"
            and min(left_rows, right_rows) >= PARTITION_MIN_ROWS):
        return JOIN_PARTITIONED
    return JOIN_SORT


def annotate(planned, catalog=None) -> None:
    """Stamp a kernel choice on every Join/SemiJoin/Aggregate of a
    planned statement (in place; nodes already carrying an explicit
    choice are left alone). Called by the planner at the end of
    ``plan_statement``; a disabled env flag leaves plans untouched."""
    if not kernels_enabled():
        return
    if not isinstance(planned, P.PlannedQuery):
        return
    sizes = dict(getattr(catalog, "sizes", None) or {})
    memo: dict = {}
    for root in [planned.root, *planned.scalar_subplans]:
        if not isinstance(root, P.Node):
            continue
        for node in P.walk_plan(root):
            if isinstance(node, P.Join) and not node.kernel:
                node.kernel = select_join_kernel(
                    _est_rows(node.left, sizes, memo),
                    _est_rows(node.right, sizes, memo),
                    node.right_unique, node.kind)
            elif isinstance(node, P.SemiJoin) and not node.kernel:
                node.kernel = SEMI_BITMASK
            elif isinstance(node, P.Aggregate) and not node.kernel:
                node.kernel = AGG_SEGSCAN


def domain_of(lo, hi) -> "int | None":
    """Dense-table entry count for host key bounds, or None when the
    bounds are unusable (unknown, or too wide to enumerate)."""
    if lo is None or hi is None:
        return None
    dom = int(hi) - int(lo) + 1
    if dom < 1 or dom > DIRECT_MAX_DOMAIN:
        return None
    return dom


def direct_feasible(dom: "int | None", build_capacity: int) -> bool:
    """Whether a dense direct-address table of ``dom`` entries is worth
    building for a ``build_capacity``-slot build side (trace-time
    check; a False here demotes the node to the sort path and the
    demotion is visible in the per-query kernel counts)."""
    if dom is None:
        return False
    return dom <= max(build_capacity, 1) * DIRECT_DOMAIN_FACTOR



# ------------------------------------------------------------ plumbing

def _launch_device(*tensors) -> bool:
    """True to launch the CUDA kernel, False for the plain version: the
    plain version is taken only because the tensors lie on the CPU."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _require(t: torch.Tensor, name: str, dtypes, n: "int | None" = None):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected 1-D, got shape {tuple(t.shape)}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: length {t.shape[0]} != {n}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


_KEY_DTYPES = (torch.int32, torch.int64)


def _keys_of(bkey, bok, pkey, pok) -> int:
    """Checks a (build, probe) key pair; returns 1 for int64 keys."""
    _require(bkey, "bkey", _KEY_DTYPES)
    _require(pkey, "pkey", (bkey.dtype,))
    _require(bok, "bok", (torch.bool,), bkey.shape[0])
    _require(pok, "pok", (torch.bool,), pkey.shape[0])
    return int(bkey.dtype == torch.int64)


def _domain_args(lo: int, dom: int) -> tuple:
    if not 1 <= dom <= DIRECT_MAX_DOMAIN:
        raise ValueError(f"domain {dom} outside [1, {DIRECT_MAX_DOMAIN}]")
    return int(lo), int(dom)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _lib(name: str):
    from nds_tpu_torch.engine import cuda_build
    if (capturing() or _POOL_RUNS[0]) and not cuda_build.is_loaded(name):
        raise RuntimeError(
            f"the kernel library {name!r} would be loaded during a graph "
            f"capture or a run from its pool: run the launch once on the "
            f"capturing stream first")
    return cuda_build, cuda_build.library(name)


# kernel launches per wrapper, counted where each wrapper launches its
# kernel and nowhere else (the plain versions count nothing)
LAUNCHES: dict[str, int] = {}


def _counted(fn):
    LAUNCHES[fn.__name__] = 0
    return fn


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def count_launches(deltas: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``deltas`` ({wrapper: launches}) to the counts:
    a CUDA graph's replay launches what its capture recorded without a
    call of a wrapper, and a capture's calls launch nothing."""
    for name, n in deltas.items():
        LAUNCHES[name] += sign * n


# plan captures, and eager runs from a graph pool, in progress
# (``capture_scope``): while one runs, no cache that a captured launch
# reads may be made or filled
_CAPTURES = [0]
_POOL_RUNS = [0]


@contextlib.contextmanager
def capture_scope(pool_run: bool = False):
    """The span of one plan's graph capture (``engine/plan_graph.py``), or
    with ``pool_run`` of one eager run that allocates from the graphs'
    pool: no look-back buffer may be made and no library loaded in
    either, and ``capturing()`` is true inside a capture."""
    scope = _POOL_RUNS if pool_run else _CAPTURES
    scope[0] += 1
    try:
        yield
    finally:
        scope[0] -= 1


def capturing(dev=None) -> bool:
    """True inside a plan's capture, or where the current CUDA stream of
    ``dev`` (a CUDA device) captures a graph."""
    if _CAPTURES[0]:
        return True
    return (dev is not None and dev.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


# -------------------------------------------------------- join kernels

def direct_lookup_join_plain(bkey, bok, pkey, pok, lo: int, dom: int):
    """Plain version of ``direct_lookup_join``: scatter each valid build
    row's index at ``key - lo`` (invalid rows and keys outside the
    domain go to an extra slot past the table, the JAX version's
    dropped index), then one clamped gather."""
    dev = bkey.device
    n_build = bkey.shape[0]
    slots = bkey.to(torch.int64) - lo
    keep = bok & (slots >= 0) & (slots < dom)
    idx = torch.where(keep, slots, torch.full_like(slots, dom))
    tbl = torch.full((dom + 1,), -1, dtype=torch.int32, device=dev)
    tbl.scatter_(0, idx, torch.arange(n_build, dtype=torch.int32,
                                      device=dev))
    tbl = tbl[:dom]
    pos = pkey.to(torch.int64) - lo
    inb = (pos >= 0) & (pos < dom)
    ridx = tbl[pos.clamp(0, dom - 1)]
    hit = pok & inb & (ridx >= 0)
    return ridx.clamp_min(0), hit


@_counted
def direct_lookup_join(bkey, bok, pkey, pok, lo: int, dom: int):
    """Unique-build equi-join through a dense table of ``dom`` int32
    slots over keys ``[lo, lo + dom)``. Returns ``(ridx int32, hit
    bool)`` per probe row, ``ridx`` clamped to >= 0 (the JAX contract:
    a valid row index wherever ``hit`` is False)."""
    if not _launch_device(bkey, bok, pkey, pok):
        return direct_lookup_join_plain(bkey, bok, pkey, pok, lo, dom)
    key64 = _keys_of(bkey, bok, pkey, pok)
    lo, dom = _domain_args(lo, dom)
    cb, lib = _lib("dense_domain")
    np_ = pkey.shape[0]
    tbl = torch.empty(dom, dtype=torch.int32, device=pkey.device)
    ridx = torch.empty(np_, dtype=torch.int32, device=pkey.device)
    hit = torch.empty(np_, dtype=torch.bool, device=pkey.device)
    err = lib.nds_direct_lookup_join(
        _ptr(bkey), _ptr(bok), bkey.shape[0], _ptr(pkey), _ptr(pok), np_,
        key64, lo, dom, _ptr(tbl), _ptr(ridx), _ptr(hit),
        cb.stream_handle())
    cb.check(err, "direct_lookup_join")
    LAUNCHES["direct_lookup_join"] += 1
    return ridx, hit


def matmul_probe_join_plain(bkey, bok, pkey, pok):
    """Plain version of ``matmul_probe_join``: the (probe x build)
    one-hot equality matrix contracted in float32 against the build
    iota and against ones."""
    dev = bkey.device
    n_build = bkey.shape[0]
    eq = (pkey[:, None] == bkey[None, :]) & bok[None, :]
    eqf = eq.to(torch.float32)
    iota = torch.arange(n_build, dtype=torch.float32, device=dev)
    ridx = torch.matmul(eqf, iota).to(torch.int32)
    cnt = torch.matmul(eqf, torch.ones(n_build, dtype=torch.float32,
                                       device=dev))
    hit = pok & (cnt > 0)
    return ridx.clamp(0, n_build - 1), hit


# K2's hash (csrc/small_build_probe.cu): a key's first slot of 2^bits is
# the top ``bits`` bits of the low 32 bits of its mixed key times
# _SMALL_HASH_MUL; an int64 key is mixed as lo ^ (hi * _SMALL_HASH_MIX)
_SMALL_HASH_MUL = 0x9E3779B1
_SMALL_HASH_MIX = 0x85EBCA6B


def matmul_probe_slot_bits(n_build: int) -> int:
    """log2 of the slots of K2's table for a build of ``n_build`` rows:
    the least power of two >= 4 x n_build, at least 16."""
    return max(4, (4 * n_build - 1).bit_length())


def _mul32(x, m: int):
    # (x * m) mod 2^32 for x in [0, 2^32), in int64 without overflow
    return (x * (m & 0xFFFF) + ((x * (m >> 16)) & 0xFFFF) * 65536) \
        & 0xFFFFFFFF


def matmul_probe_slots(keys, n_build: int):
    """Plain mirror of K2's hash: the first slot of each key (an int32 or
    int64 tensor) in the hash table of a build of ``n_build`` rows."""
    k = keys.to(torch.int64)
    x = k & 0xFFFFFFFF
    if keys.dtype == torch.int64:
        x = x ^ _mul32((k >> 32) & 0xFFFFFFFF, _SMALL_HASH_MIX)
    return _mul32(x, _SMALL_HASH_MUL) >> (32 - matmul_probe_slot_bits(
        n_build))


@_counted
def matmul_probe_join(bkey, bok, pkey, pok):
    """Unique-build equi-join for builds of at most 256 rows: the sum of
    the matching build indices (clamped to ``[0, n_build)``) and whether
    any matched, as the JAX version's f32 products give them."""
    if not _launch_device(bkey, bok, pkey, pok):
        return matmul_probe_join_plain(bkey, bok, pkey, pok)
    key64 = _keys_of(bkey, bok, pkey, pok)
    cb, lib = _lib("small_build_probe")
    nb = bkey.shape[0]
    if not 1 <= nb <= lib.nds_small_build_max():
        raise ValueError(f"matmul_probe_join: build of {nb} rows outside "
                         f"[1, {lib.nds_small_build_max()}]")
    np_ = pkey.shape[0]
    ridx = torch.empty(np_, dtype=torch.int32, device=pkey.device)
    hit = torch.empty(np_, dtype=torch.bool, device=pkey.device)
    err = lib.nds_matmul_probe_join(
        _ptr(bkey), _ptr(bok), nb, _ptr(pkey), _ptr(pok), np_, key64,
        _ptr(ridx), _ptr(hit), cb.stream_handle())
    cb.check(err, "matmul_probe_join")
    LAUNCHES["matmul_probe_join"] += 1
    return ridx, hit


def bitmask_semi_plain(bkey, bok, pkey, pok, lo: int, dom: int):
    """Plain version of ``bitmask_semi``: a dense membership table."""
    dev = bkey.device
    slots = bkey.to(torch.int64) - lo
    keep = bok & (slots >= 0) & (slots < dom)
    idx = torch.where(keep, slots, torch.full_like(slots, dom))
    bm = torch.zeros(dom + 1, dtype=torch.bool, device=dev)
    bm[idx] = True
    bm = bm[:dom]
    pos = pkey.to(torch.int64) - lo
    inb = (pos >= 0) & (pos < dom)
    return pok & inb & bm[pos.clamp(0, dom - 1)]


@_counted
def bitmask_semi(bkey, bok, pkey, pok, lo: int, dom: int):
    """EXISTS membership per probe row through a dense table over keys
    ``[lo, lo + dom)`` (the caller negates for NOT EXISTS)."""
    if not _launch_device(bkey, bok, pkey, pok):
        return bitmask_semi_plain(bkey, bok, pkey, pok, lo, dom)
    key64 = _keys_of(bkey, bok, pkey, pok)
    lo, dom = _domain_args(lo, dom)
    cb, lib = _lib("dense_domain")
    np_ = pkey.shape[0]
    bm = torch.empty(dom, dtype=torch.uint8, device=pkey.device)
    out = torch.empty(np_, dtype=torch.bool, device=pkey.device)
    err = lib.nds_bitmask_semi(
        _ptr(bkey), _ptr(bok), bkey.shape[0], _ptr(pkey), _ptr(pok), np_,
        key64, lo, dom, _ptr(bm), _ptr(out), cb.stream_handle())
    cb.check(err, "bitmask_semi")
    LAUNCHES["bitmask_semi"] += 1
    return out


def keyed_minmax_semi_plain(bkey, bok, bval, pkey, pok, pval, lo: int,
                            dom: int):
    """Plain version of ``keyed_minmax_semi``: per-key min, max and
    presence tables by masked ``scatter_reduce_``, then three gathers."""
    dev = bkey.device
    slots = bkey.to(torch.int64) - lo
    keep = bok & (slots >= 0) & (slots < dom)
    idx = torch.where(keep, slots, torch.full_like(slots, dom))
    info = torch.iinfo(bval.dtype)
    mn = torch.full((dom + 1,), info.max, dtype=bval.dtype, device=dev)
    mn.scatter_reduce_(0, idx, bval, "amin", include_self=True)
    mx = torch.full((dom + 1,), info.min, dtype=bval.dtype, device=dev)
    mx.scatter_reduce_(0, idx, bval, "amax", include_self=True)
    present = torch.zeros(dom + 1, dtype=torch.bool, device=dev)
    present[idx] = True
    pos = pkey.to(torch.int64) - lo
    inb = (pos >= 0) & (pos < dom)
    at = pos.clamp(0, dom - 1)
    has_key = pok & inb & present[at]
    differs = (mn[at] != pval) | (mx[at] != pval)
    return has_key & differs


@_counted
def keyed_minmax_semi(bkey, bok, bval, pkey, pok, pval, lo: int,
                      dom: int):
    """EXISTS with the q21 ``<>`` residual: a build row with this key
    and a different value exists iff the key is present and its
    [min, max] of build values is not exactly [pval, pval]."""
    if not _launch_device(bkey, bok, bval, pkey, pok, pval):
        return keyed_minmax_semi_plain(bkey, bok, bval, pkey, pok, pval,
                                       lo, dom)
    key64 = _keys_of(bkey, bok, pkey, pok)
    _require(bval, "bval", _KEY_DTYPES, bkey.shape[0])
    _require(pval, "pval", (bval.dtype,), pkey.shape[0])
    lo, dom = _domain_args(lo, dom)
    cb, lib = _lib("dense_domain")
    dev = pkey.device
    np_ = pkey.shape[0]
    # one {min, max} slot a key
    tbl = torch.empty(2 * dom, dtype=bval.dtype, device=dev)
    out = torch.empty(np_, dtype=torch.bool, device=dev)
    err = lib.nds_keyed_minmax_semi(
        _ptr(bkey), _ptr(bok), _ptr(bval), bkey.shape[0], _ptr(pkey),
        _ptr(pok), _ptr(pval), np_, key64, int(bval.dtype == torch.int64),
        lo, dom, _ptr(tbl), _ptr(out), cb.stream_handle())
    cb.check(err, "keyed_minmax_semi")
    LAUNCHES["keyed_minmax_semi"] += 1
    return out


# ------------------------------------------------- aggregation kernels

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
# op codes of the C entry points
_OP_CODES = {"sum": 0, "min": 1, "max": 2}


def seg_scan_plain(op: str, vals, flags):
    """Segmented inclusive scan restarting ``op`` ("sum", "min" or
    "max") at every True flag: the (value, reset-flag) combiner of the
    JAX version, as a Hillis-Steele scan (log2(n) doubling steps). The
    values keep their dtype: an int32 sum stays int32 and wraps, as the
    JAX scan's does."""
    f_op = _OPS[op]
    v, f = vals, flags
    n = v.shape[0]
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], f_op(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def seg_reduce_at_ends_plain(op: str, data, gid, starts2):
    """Plain version of ``seg_reduce_at_ends``: the segmented scan over
    sorted group ids, read at each group's last row (``starts2`` holds
    each group's first sorted row, n past the last group). A sum is the
    reference's ``_seg_sum``: inclusive-cumsum differences at each group's
    bounding rows, in the data's dtype, 0 for a group with no rows."""
    n = data.shape[0]
    nxt = torch.cat([starts2[1:],
                     torch.full((1,), n, dtype=starts2.dtype,
                                device=starts2.device)])
    end = (nxt - 1).clamp(0, n - 1)
    if op == "sum":
        csum = torch.cumsum(data, 0, dtype=data.dtype)
        hi = csum.index_select(0, end)
        lo = torch.where(starts2 > 0,
                         csum.index_select(0, (starts2 - 1).clamp(0, n - 1)),
                         torch.zeros((), dtype=csum.dtype,
                                     device=csum.device))
        return hi - lo
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=gid.device),
                       gid[1:] != gid[:-1]])
    run = seg_scan_plain(op, data, first)
    return run[end]


_SCAN_VTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                torch.float64: 3}

# The tile words of the decoupled look-back kernels (seg_scan.cu,
# partitioned_join.cu, compact.cu) and their counter word, kept across
# calls: one set per (device, stream, layout). The two layouts never share
# words, so a word is only ever read in the layout it was written in: "scan"
# holds seg_scan.cu's tile state (a status word tagged with the epoch at bit
# 35, beside a raw value), "count" the count words of lookback.cuh (tagged
# at bit 34) of the partition, the radix sort and the compactor. The epoch
# lives on the card: the counter word holds the next launch's epoch above
# its tile counter, and each launch (each pass of the sort) draws one, so
# nothing is zeroed between calls and the host passes no epoch, which a
# CUDA graph would replay. Launches on one stream run in order; another
# stream gets words and a counter of its own.
#
# The range: a status word holds 29 bits of the epoch (a count word 30).
# The host cannot read the card's epoch without a synchronize, so it counts
# the epochs its own calls draw, and once they would pass _EPOCH_HOST (half
# the range) it zeroes the buffer in place, on the stream, and sets its
# counter word back to epoch 1. The other half, 2^28 epochs, is headroom
# for the launches that a CUDA graph replays without a call of the host: a
# graph of k look-back launches (a sort counts one per pass) can be
# replayed 2^28 / k times between two such resets, about 1.3M replays of a
# graph of 200, and whoever replays graphs must count its replays' epochs
# into the host's count before that (past the range a tile could read a
# stale word of another epoch): ``engine/plan_graph.py`` reserves and
# counts each replay's epochs (``lookback_reserve``, ``lookback_count``)
# and takes back what its captures' calls counted.
#
# The lifetime: a captured graph holds the pointers of the buffer and the
# counter word that its launches were given. So neither is ever freed or
# replaced while the process runs: the reset zeroes them in place (a graph
# sees it), and a need for more words gives the entry a new, larger buffer
# and counter word but keeps the old ones alive beside it (``retired``),
# still zeroed at every reset. Each growth at least doubles the buffer, so
# the retired ones hold less than the current one. A buffer is never made,
# grown or zeroed during a capture (``_lookback`` raises): a launch runs
# once on the capturing stream before its capture.
# (device, stream, layout) -> (buffer, counter word, epochs the host's
# calls drew since the last reset, retired (buffer, counter word) pairs)
_LOOKBACK: dict = {}
# (device, stream, layout) -> epochs counted since the process started,
# resets or not (``lookback_epochs``)
_DRAWN: dict = {}
_LOOKBACK_LAYOUTS = ("scan", "count")
_EPOCH_END = 1 << 29
_EPOCH_HOST = 1 << 28
_EPOCH_FIRST = 1 << 32   # the counter word at epoch 1, tile id 0
_LOOKBACK_LOCK = threading.Lock()


def _capturing(dev) -> bool:
    return capturing(dev)


def _reset_lookback(key) -> None:
    """Zero every buffer of ``key`` in place and set its counter words
    back to epoch 1, on the current stream (``key``'s own)."""
    buf, ctr, _used, retired = _LOOKBACK[key]
    if _capturing(key[0]):
        raise RuntimeError(
            f"the look-back {key[2]} buffer would be zeroed during a graph "
            f"capture")
    for b, c in retired + ((buf, ctr),):
        b.zero_()
        c.fill_(_EPOCH_FIRST)
    _LOOKBACK[key] = (buf, ctr, 0, retired)


def _lookback(dev, stream: int, layout: str, words: int,
              epochs: int = 1) -> tuple:
    """(tile words int64[>= words], counter word int64[1]) for one launch
    on ``stream`` that draws ``epochs`` epochs of ``layout`` ("scan" or
    "count") from the counter word on the card."""
    if layout not in _LOOKBACK_LAYOUTS:
        raise ValueError(f"look-back layout {layout!r}")
    key = (dev, stream, layout)
    with _LOOKBACK_LOCK:
        buf, ctr, used, retired = _LOOKBACK.get(key, (None, None, 0, ()))
        grow = buf is None or buf.numel() < words
        if grow and (_capturing(dev) or _POOL_RUNS[0]):
            raise RuntimeError(
                f"the look-back {layout} buffer would be made during a "
                f"graph capture or a run from its pool: run the launch "
                f"once on the capturing stream first")
        if used + epochs > _EPOCH_HOST:
            _reset_lookback(key)
            used = 0
        if grow:
            if buf is not None:
                retired += ((buf, ctr),)
            buf = torch.zeros(max(words, 1 << 16,
                                  2 * buf.numel() if buf is not None else 0),
                              dtype=torch.int64, device=dev)
            ctr = torch.full((1,), _EPOCH_FIRST, dtype=torch.int64,
                             device=dev)
        _LOOKBACK[key] = (buf, ctr, used + epochs, retired)
        _DRAWN[key] = _DRAWN.get(key, 0) + epochs
        return buf, ctr


def lookback_epochs() -> dict:
    """{(device, stream, layout): epochs counted for it since the process
    started}: what a run drew is the difference of two of these."""
    with _LOOKBACK_LOCK:
        return dict(_DRAWN)


def lookback_reserve(epochs: dict) -> None:
    """Room for ``epochs`` ({key: epochs}, ``lookback_epochs``'
    differences) before launches that draw them without a call of the
    host: a graph's capture or replay. Where a key's count would pass
    _EPOCH_HOST, its buffers are reset in place first, on the current
    stream, which must be the key's; never during a capture."""
    with _LOOKBACK_LOCK:
        for key, n in epochs.items():
            dev, stream, _layout = key
            if dev.type == "cuda" and (
                    stream != torch.cuda.current_stream(dev).cuda_stream):
                raise RuntimeError(f"look-back {key}: reserved from "
                                   f"another stream")
            if _LOOKBACK[key][2] + n > _EPOCH_HOST:
                _reset_lookback(key)


def lookback_count(epochs: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``epochs`` to the host's counts: a replay draws
    its capture's epochs on the card with no call of the host (reserve
    them first), and a capture's calls drew none."""
    with _LOOKBACK_LOCK:
        for key, n in epochs.items():
            buf, ctr, used, retired = _LOOKBACK[key]
            _LOOKBACK[key] = (buf, ctr, used + sign * n, retired)
            _DRAWN[key] += sign * n


def _scan_state(lib, n: int, dev, stream: int) -> tuple:
    """The look-back state of one scan launch over ``n`` rows."""
    ntiles = -(-n // lib.nds_seg_scan_tile())
    return _lookback(dev, stream, "scan",
                     ntiles * lib.nds_seg_scan_state_words())


@_counted
def seg_reduce_at_ends(op: str, data, gid, starts2):
    """Grouped sum, min or max (``op``) over rows sorted by group id,
    with no scatter: a segmented scan read at segment ends. Rows outside
    any group must carry the op's identity (0 for a sum); ``starts2``
    holds each group's first sorted row (n past the last group), so it
    does not decrease. A sum keeps the data's dtype (int32 counts and
    int64 sums are exact) and is 0 for a group with no rows; a float sum
    adds in another order than the reference's cumsum differences."""
    if op not in _OP_CODES:
        raise ValueError(f"seg_reduce_at_ends: op {op!r}")
    if not _launch_device(data, gid, starts2):
        return seg_reduce_at_ends_plain(op, data, gid, starts2)
    n = data.shape[0]
    _require(data, "data", tuple(_SCAN_VTYPES))
    _require(gid, "gid", (torch.int32,), n)
    _require(starts2, "starts2", _KEY_DTYPES)
    G = starts2.shape[0]
    if n < 1 or G < 1:
        raise ValueError(f"seg_reduce_at_ends: n={n}, G={G}")
    cb, lib = _lib("seg_scan")
    dev = data.device
    out = torch.empty(G, dtype=data.dtype, device=dev)
    tail = torch.empty((), dtype=torch.int64, device=dev)
    stream = cb.stream_handle()
    words, ctr = _scan_state(lib, n, dev, stream)
    err = lib.nds_seg_reduce_at_ends(
        _ptr(data), _SCAN_VTYPES[data.dtype], _OP_CODES[op], _ptr(gid),
        n, _ptr(starts2), int(starts2.dtype == torch.int64), G, _ptr(out),
        _ptr(tail), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "seg_reduce_at_ends")
    LAUNCHES["seg_reduce_at_ends"] += 1
    return out


def _check_scan(op: str, vals, flags, name: str) -> int:
    if op not in _OP_CODES:
        raise ValueError(f"{name}: op {op!r}")
    n = vals.shape[0]
    _require(vals, "vals", tuple(_SCAN_VTYPES))
    _require(flags, "flags", (torch.bool,), n)
    if n < 1:
        raise ValueError(f"{name}: n={n}")
    return n


@_counted
def seg_scan(op: str, vals, flags):
    """Per-row segmented inclusive scan of ``vals`` with ``op`` ("sum",
    "min" or "max"), restarting at every True ``flags`` row: running
    window aggregates (count, sum, min, max under a ROWS frame). The
    output keeps the values' dtype (int32 counts stay int32)."""
    if not _launch_device(vals, flags):
        if op not in _OPS:
            raise ValueError(f"seg_scan: op {op!r}")
        return seg_scan_plain(op, vals, flags)
    n = _check_scan(op, vals, flags, "seg_scan")
    cb, lib = _lib("seg_scan")
    dev = vals.device
    out = torch.empty(n, dtype=vals.dtype, device=dev)
    stream = cb.stream_handle()
    words, ctr = _scan_state(lib, n, dev, stream)
    err = lib.nds_seg_scan(
        _ptr(vals), _SCAN_VTYPES[vals.dtype], _OP_CODES[op], _ptr(flags), 0,
        n, _ptr(out), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "seg_scan")
    LAUNCHES["seg_scan"] += 1
    return out


def part_reduce_broadcast_plain(op: str, data, part_start, pend):
    """Plain version of ``part_reduce_broadcast``: the segmented scan
    read at each row's partition end."""
    run = seg_scan_plain(op, data, part_start)
    return run.index_select(0, pend.to(torch.int64))


@_counted
def part_reduce_broadcast(op: str, data, part_start, pend):
    """Whole-partition ``op`` ("min" or "max"; "sum" works too) per
    row: the segmented scan restarting at ``part_start``, read at each
    row's partition end ``pend`` (already per row, in ``[0, n)``)."""
    if not _launch_device(data, part_start, pend):
        if op not in _OPS:
            raise ValueError(f"part_reduce_broadcast: op {op!r}")
        return part_reduce_broadcast_plain(op, data, part_start, pend)
    n = _check_scan(op, data, part_start, "part_reduce_broadcast")
    _require(pend, "pend", _KEY_DTYPES, n)
    cb, lib = _lib("seg_scan")
    dev = data.device
    run = torch.empty(n, dtype=data.dtype, device=dev)
    out = torch.empty(n, dtype=data.dtype, device=dev)
    stream = cb.stream_handle()
    words, ctr = _scan_state(lib, n, dev, stream)
    err = lib.nds_part_reduce_broadcast(
        _ptr(data), _SCAN_VTYPES[data.dtype], _OP_CODES[op],
        _ptr(part_start), n, _ptr(pend), int(pend.dtype == torch.int64),
        _ptr(out), _ptr(run), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "part_reduce_broadcast")
    LAUNCHES["part_reduce_broadcast"] += 1
    return out


def last_of_group_plain(change, n: int):
    """Plain version of ``last_of_group``: the reversed running minimum
    of the next change position, as flip, ``cummin``, flip."""
    iota = torch.arange(n, dtype=torch.int32, device=change.device)
    chg_at = torch.where(change, iota, torch.full_like(iota, n))
    future = torch.cat([chg_at[1:], torch.full((1,), n, dtype=torch.int32,
                                                device=change.device)])
    nxt = torch.flip(torch.cummin(torch.flip(future, [0]), 0).values, [0])
    return (nxt - 1).clamp(0, n - 1)


@_counted
def last_of_group(change, n: int):
    """int32 index of the last row of each row's group, for sorted group
    ``change`` flags (True at each group's first row): the reversed
    running minimum of the next change position, minus one."""
    if not _launch_device(change):
        return last_of_group_plain(change, n)
    _require(change, "change", (torch.bool,), n)
    if not 1 <= n < 2**31 - 1:
        raise ValueError(f"last_of_group: n={n}")
    cb, lib = _lib("seg_scan")
    dev = change.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    stream = cb.stream_handle()
    words, ctr = _scan_state(lib, n, dev, stream)
    err = lib.nds_last_of_group(_ptr(change), n, _ptr(out), _ptr(words),
                                _ptr(ctr), stream)
    cb.check(err, "last_of_group")
    LAUNCHES["last_of_group"] += 1
    return out


def running_max_plain(vals):
    """Plain version of ``running_max``: ``torch.cummax`` along the rows,
    the reference's ``lax.cummax``."""
    return torch.cummax(vals, 0).values


@_counted
def running_max(vals):
    """Running maximum of int32 or int64 ``vals`` over all rows (the
    windows' partition starts, peer-group starts and last changes): the
    segmented scan with op max and one segment, exact."""
    if not _launch_device(vals):
        return running_max_plain(vals)
    _require(vals, "vals", _KEY_DTYPES)
    n = vals.shape[0]
    if n < 1:
        raise ValueError(f"running_max: n={n}")
    cb, lib = _lib("seg_scan")
    dev = vals.device
    out = torch.empty(n, dtype=vals.dtype, device=dev)
    stream = cb.stream_handle()
    words, ctr = _scan_state(lib, n, dev, stream)
    err = lib.nds_seg_scan(
        _ptr(vals), _SCAN_VTYPES[vals.dtype], _OP_CODES["max"], None, n, n,
        _ptr(out), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "running_max")
    LAUNCHES["running_max"] += 1
    return out


# the most fields (keys with a validity bit or value bits) one packed
# group key takes: the kernel holds them in its parameters
PACK_MAX_FIELDS = 16
_PACK_TYPES = {torch.int32: 0, torch.int64: 1, torch.bool: 2}


# the bias of a key of exactly 32 bits, stored as int32
_BIAS32 = 1 << 31


def pack_group_key_plain(row, arrs, valids, fields, bits: int):
    """Plain version of ``pack_group_key``, in int64 elementwise ops, the
    counts a histogram of the key's digits (``sort_digit_counts_plain``)."""
    dev = row.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key = torch.where(row, zero, torch.full((), 1 << (bits - 1),
                                            dtype=torch.int64, device=dev))
    shift = bits - 1
    for arr, valid, (has_valid, lo, width) in zip(arrs, valids, fields):
        ok = row if valid is None else row & valid
        if has_valid:
            shift -= 1
            key |= (~valid).to(torch.int64) << shift
        if width:
            shift -= width
            val = torch.where(ok, arr.to(torch.int64) - lo,
                              torch.full((), -lo, dtype=torch.int64,
                                         device=dev))
            key |= val << shift
    if bits == 32:
        key -= _BIAS32
    key = key.to(torch.int32 if bits <= 32 else torch.int64)
    return key, sort_digit_counts_plain(key)


@_counted
def pack_group_key(row, arrs, valids, fields, bits: int):
    """The group-id sort's operands as one non-negative key, and the
    counts of its digits: the presence bit (set where ``row`` is False)
    at bit ``bits - 1``, then per key, the most significant first, its
    validity bit (set where NULL; only where ``fields`` gives it one,
    exactly where ``valids`` holds a mask) and its value filled with 0
    where not present or NULL, minus ``lo``, in ``width`` bits
    (``fields``: one ``(has_valid, lo, width)`` per key, from the
    executor's ``_pack_layout``). The key is int32 for ``bits <= 32``,
    else int64 (``bits <= 63``); a key of exactly 32 bits is biased by
    -2^31, which keeps its order as int32. Returns ``(key, counts)``:
    the counts are ``sort_digit_counts_plain``'s (int32[4 * 256] for an
    int32 key, [8 * 256] for an int64 one), which ``partition_sort``
    takes in place of its own histogram pass. ``arrs``: int32, int64 or
    bool values."""
    if not _launch_device(row, *arrs, *[v for v in valids if v is not None]):
        return pack_group_key_plain(row, arrs, valids, fields, bits)
    n = row.shape[0]
    _require(row, "row", (torch.bool,))
    if not 1 <= bits <= 63 or n < 1:
        raise ValueError(f"pack_group_key: {bits} bits, n={n}")
    keep = []
    for arr, valid, (has_valid, lo, width) in zip(arrs, valids, fields):
        if has_valid != (valid is not None) or lo > 0 or width < 0:
            raise ValueError(f"pack_group_key: field {(has_valid, lo, width)}")
        if width:
            _require(arr, "arr", tuple(_PACK_TYPES), n)
        if valid is not None:
            _require(valid, "valid", (torch.bool,), n)
        if width or has_valid:
            keep.append((arr if width else None, valid, int(lo), int(width)))
    cb, lib = _lib("group_key")
    k = len(keep)
    if k > lib.nds_pack_max_fields():
        raise ValueError(f"pack_group_key: {k} fields")
    if 1 + sum(w + (v is not None) for _a, v, _l, w in keep) != bits:
        raise ValueError(f"pack_group_key: the fields do not make {bits} "
                         f"bits")
    m = max(k, 1)
    key64 = int(bits > 32)
    out = torch.empty(n, dtype=torch.int64 if key64 else torch.int32,
                      device=row.device)
    # zeroed on the stream, so that a graph's replays count from zero
    counts = torch.zeros((8 if key64 else 4) * 256, dtype=torch.int32,
                         device=row.device)
    err = lib.nds_pack_group_key(
        _ptr(row), n, k,
        (ctypes.c_void_p * m)(*[None if a is None else _ptr(a)
                                for a, _v, _l, _w in keep]),
        (ctypes.c_void_p * m)(*[None if v is None else _ptr(v)
                                for _a, v, _l, _w in keep]),
        (ctypes.c_longlong * m)(*[lo for _a, _v, lo, _w in keep]),
        (ctypes.c_int * m)(*[0 if a is None else _PACK_TYPES[a.dtype]
                             for a, _v, _l, _w in keep]),
        (ctypes.c_int * m)(*[w for _a, _v, _l, w in keep]),
        bits, key64, _ptr(out), _ptr(counts), cb.stream_handle())
    cb.check(err, "pack_group_key")
    LAUNCHES["pack_group_key"] += 1
    return out, counts


def group_bounds_plain(keys, pbit: int, G: int):
    """Plain version of ``group_bounds``, step by step as the executor's
    ``_group_ids`` after its sort (the reference's ``:2221-2230``) and its
    callers' clamp and ``searchsorted``."""
    n = keys.shape[0]
    packed = keys.to(torch.int64)
    if keys.dtype == torch.int32 and pbit == 31:
        packed = packed + _BIAS32
    present = ((packed >> pbit) & 1) == 0
    diff = torch.ones(n, dtype=torch.bool, device=keys.device)
    diff[1:] = keys[1:] != keys[:-1]
    first_s = present & diff
    gid = torch.cumsum(first_s.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = gid.clamp(0, n - 1).clamp_max(G - 1)
    ngroups = first_s.sum()
    starts2 = torch.searchsorted(
        gid, torch.arange(G, dtype=torch.int32, device=keys.device))
    return present, gid, ngroups, starts2


@_counted
def group_bounds(keys, pbit: int, G: int):
    """The group ids of rows sorted by their packed group key (int32 or
    int64, as ``pack_group_key`` writes it; bit ``pbit`` set for rows that
    are not present, so present rows come first): ``(present_s bool, gid
    int32, ngroups int64 scalar, starts2 int64[G])``. A group's first row
    is a present row whose key differs from the row before (row 0
    always); gid is the count of first rows up to each row, minus one,
    clipped to ``[0, G - 1]``; starts2[g] is the first row whose gid is at
    least g (n for the groups past the last; 0 for group 0 when there is
    none), ``searchsorted`` of g in gid. An int32 key with ``pbit`` 31 is
    a 32-bit key, biased by -2^31. The kernel (one launch) reads no key
    past the first absent row, since the keys are sorted with presence on
    top, and writes the starts in the same pass."""
    if not _launch_device(keys):
        return group_bounds_plain(keys, pbit, G)
    _require(keys, "keys", _KEY_DTYPES)
    n = keys.shape[0]
    key64 = int(keys.dtype == torch.int64)
    if not 1 <= n < 2**31 - 1 or not 1 <= G <= n:
        raise ValueError(f"group_bounds: n={n}, G={G}")
    if not 0 <= pbit <= (62 if key64 else 31):
        raise ValueError(f"group_bounds: presence bit {pbit}")
    cb, lib = _lib("seg_scan")
    dev = keys.device
    present = torch.empty(n, dtype=torch.bool, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    starts2 = torch.empty(G, dtype=torch.int64, device=dev)
    ngroups = torch.empty((), dtype=torch.int64, device=dev)
    stream = cb.stream_handle()
    ntiles = -(-n // lib.nds_group_bounds_tile())
    words, ctr = _lookback(dev, stream, "scan",
                           ntiles * lib.nds_seg_scan_state_words())
    err = lib.nds_group_bounds(
        _ptr(keys), key64, int(pbit), n, int(G), _ptr(present), _ptr(gid),
        _ptr(starts2), _ptr(ngroups), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "group_bounds")
    LAUNCHES["group_bounds"] += 1
    return present, gid, ngroups, starts2


# ---------------------------------- the executor's sorts, searches, compactor

# a sort operand's value type, its field's mode and its flags, as
# csrc/sort_key.cu reads them
_SORT_TYPES = {torch.int32: 0, torch.int64: 1, torch.bool: 2,
               torch.float32: 3, torch.float64: 4}
SORT_SPAN = 0    # value - lo in the field's width
SORT_INT = 1     # the full 32 or 64 bits, sign bit flipped
SORT_FLOAT = 2   # lax.sort's float order, as order-preserving bits
SORT_USE_ROW = 1  # filled with 0 where the row mask is False
SORT_INVERT = 2   # a bool taken as 1 - value, after the fill
SORT_NEGATE = 4   # negated after the fill (a descending key)
# the most fields one word takes: the kernel holds them in its parameters
SORT_MAX_FIELDS = 16
_NAN_BITS = {torch.float32: 0x7FC00000, torch.float64: 0x7FF8000000000000}
_I64_MIN = -(1 << 63)


def _sort_field_plain(row, arr, valid, flags: int, mode: int, lo: int):
    """One operand's order-preserving bits (in int64, as unsigned bits:
    a 64-bit operand's top bit is the sign), for rows already in the
    word's order."""
    ok = row if flags & SORT_USE_ROW else None
    if valid is not None:
        ok = valid if ok is None else ok & valid
    if mode == SORT_FLOAT:
        zero = torch.zeros((), dtype=arr.dtype, device=arr.device)
        x = arr if ok is None else torch.where(ok, arr, zero)
        if flags & SORT_NEGATE:
            x = -x
        x = torch.where(x == 0, zero, x)
        if arr.dtype == torch.float64:
            b = torch.where(torch.isnan(x), _NAN_BITS[arr.dtype],
                            x.view(torch.int64))
            return torch.where(b < 0, ~b, b ^ _I64_MIN)
        b = torch.where(torch.isnan(x), _NAN_BITS[arr.dtype],
                        x.view(torch.int32).to(torch.int64))
        return torch.where(b < 0, ~b & 0xFFFFFFFF, b | 0x80000000)
    v = arr.to(torch.int64)
    if ok is not None:
        v = torch.where(ok, v, torch.zeros((), dtype=torch.int64,
                                           device=v.device))
    if flags & SORT_INVERT:
        v = 1 - v
    if flags & SORT_NEGATE:
        v = -v
    if mode == SORT_SPAN:
        return v - lo
    if arr.dtype == torch.int32:
        return (v & 0xFFFFFFFF) ^ 0x80000000
    return v ^ _I64_MIN


def sort_digit_counts_plain(word):
    """The counts of each 8-bit digit of an int32 or int64 key's
    order-preserving unsigned bits (its sign bit flipped): int32[passes *
    256] (4 passes for int32, 8 for int64), digit d's counts at ``[d *
    256, d * 256 + 256)``, as ``partition_sort`` reads them for one
    partition."""
    passes = word.element_size()
    u = word.to(torch.int64)
    u = (u & 0xFFFFFFFF) ^ 0x80000000 if passes == 4 else u ^ _I64_MIN
    return torch.cat([torch.bincount((u >> (8 * d)) & 0xFF, minlength=256)
                      for d in range(passes)]).to(torch.int32)


def pack_sort_key_plain(row, arrs, valids, fields, bits: int, perm=None):
    """Plain version of ``pack_sort_key``, in int64 elementwise ops."""
    if perm is not None:
        perm = perm.to(torch.int64)
        row = None if row is None else row.index_select(0, perm)
        arrs = [a.index_select(0, perm) for a in arrs]
        valids = [None if v is None else v.index_select(0, perm)
                  for v in valids]
    key = torch.zeros(arrs[0].shape[0], dtype=torch.int64,
                      device=arrs[0].device)
    pos = bits
    for arr, valid, (flags, mode, lo, width, shift) in zip(arrs, valids,
                                                           fields):
        pos -= width
        b = _sort_field_plain(row, arr, valid, flags, mode, lo)
        key |= ((b >> shift) & ((1 << width) - 1)) << pos
    if bits == 32:
        key = key - (1 << 31)
    word = key.to(torch.int32)
    return word, sort_digit_counts_plain(word)


@_counted
def pack_sort_key(row, arrs, valids, fields, bits: int, perm=None):
    """One word of a multi-key sort, and its digit counts: per row, a
    piece of each operand (``arrs``, the most significant first) from the
    word's top bit down, so that the words' order, from the most
    significant word down, is the operands' lexicographic order. Each
    operand is read at row ``perm[i]`` (int32, the permutation of the
    words sorted so far; row i where None), filled with 0 where its
    ``valids`` entry (or None) or, with ``SORT_USE_ROW``, ``row`` is
    False, taken as 1 - value with ``SORT_INVERT`` (a bool), negated with
    ``SORT_NEGATE``, then made order-preserving bits by its mode:
    ``SORT_SPAN`` value - lo, ``SORT_INT`` its 32 or 64 bits with the
    sign bit flipped, ``SORT_FLOAT`` ``lax.sort``'s float order (-0.0 as
    +0.0, every NaN as one NaN above +inf). ``fields``: one ``(flags,
    mode, lo, width, shift)`` per piece, from the executor's
    ``_sort_layout``: the word takes bits ``[shift, shift + width)`` of
    those. Returns ``(word int32[n], counts int32[4 * 256])``: a word of
    exactly 32 bits is biased by -2^31, which keeps its order; the counts
    are ``sort_digit_counts_plain``'s, which ``partition_sort`` takes in
    place of its own histogram pass. ``arrs``: int32, int64, bool,
    float32 or float64 values."""
    opt = [t for t in (row, perm, *valids) if t is not None]
    if not _launch_device(*arrs, *opt):
        return pack_sort_key_plain(row, arrs, valids, fields, bits, perm)
    n = arrs[0].shape[0] if arrs else 0
    if not 1 <= bits <= 32 or n < 1:
        raise ValueError(f"pack_sort_key: {bits} bits, n={n}")
    if row is not None:
        _require(row, "row", (torch.bool,), n)
    if perm is not None:
        _require(perm, "perm", (torch.int32,), n)
    for arr, valid, (flags, *_f) in zip(arrs, valids, fields):
        _require(arr, "arr", tuple(_SORT_TYPES), n)
        if valid is not None:
            _require(valid, "valid", (torch.bool,), n)
        if flags & SORT_USE_ROW and row is None:
            raise ValueError("pack_sort_key: a field fills by the row mask "
                             "but no row mask is given")
    cb, lib = _lib("sort_key")
    k = len(arrs)
    if not 1 <= k <= lib.nds_sort_max_fields() or len(fields) != k:
        raise ValueError(f"pack_sort_key: {k} fields")
    if sum(f[3] for f in fields) != bits:
        raise ValueError(f"pack_sort_key: the fields do not make {bits} "
                         f"bits")
    dev = arrs[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    # zeroed on the stream, so that a graph's replays count from zero
    counts = torch.zeros(4 * 256, dtype=torch.int32, device=dev)

    def ints(at):
        return (ctypes.c_int * k)(*[int(f[at]) for f in fields])
    err = lib.nds_pack_sort_key(
        None if row is None else _ptr(row),
        None if perm is None else _ptr(perm), n, k,
        (ctypes.c_void_p * k)(*[_ptr(a) for a in arrs]),
        (ctypes.c_void_p * k)(*[None if v is None else _ptr(v)
                                for v in valids]),
        (ctypes.c_longlong * k)(*[int(f[2]) for f in fields]),
        (ctypes.c_int * k)(*[_SORT_TYPES[a.dtype] for a in arrs]),
        ints(1), ints(3), ints(4), ints(0), bits, _ptr(out), _ptr(counts),
        cb.stream_handle())
    cb.check(err, "pack_sort_key")
    LAUNCHES["pack_sort_key"] += 1
    return out, counts


_SEARCH_MODES = {"left": 0, "right": 1, "both": 2, "probe": 3}


def sorted_search_plain(ks, q, mode: str = "left", order=None, pok=None):
    """Plain version of ``sorted_search``: ``torch.searchsorted``, and for
    "probe" the reference's ``_probe`` step by step."""
    if mode in ("left", "right"):
        return torch.searchsorted(ks, q, right=mode == "right")
    if mode == "both":
        return torch.searchsorted(ks, q), torch.searchsorted(ks, q,
                                                             right=True)
    if mode != "probe":
        raise ValueError(f"sorted_search: mode {mode!r}")
    pos = torch.searchsorted(ks, q).clamp(0, ks.shape[0] - 1)
    hit = ks.index_select(0, pos) == q
    if pok is not None:
        hit = hit & pok
    return (None if order is None else order.index_select(0, pos)), hit


@_counted
def sorted_search(ks, q, mode: str = "left", order=None, pok=None):
    """The places of the queries ``q`` in the non-decreasing ``ks`` (int32
    or int64, one dtype for both), exactly ``torch.searchsorted``'s, as
    int64: "left" (the count of keys below each query), "right" (at or
    below), "both" (``(left, right)``, a match range); "probe" is the
    reference's ``_probe``: with ``pos`` the left place clamped to ``[0,
    n - 1]`` (``n >= 1``), ``(order[pos], ks[pos] == q & pok)``, where
    ``order`` (int32) and ``pok`` (bool) may be None (no index, no
    mask)."""
    opt = [t for t in (order, pok) if t is not None]
    if not _launch_device(ks, q, *opt):
        return sorted_search_plain(ks, q, mode, order, pok)
    if mode not in _SEARCH_MODES:
        raise ValueError(f"sorted_search: mode {mode!r}")
    _require(ks, "ks", _KEY_DTYPES)
    _require(q, "q", (ks.dtype,))
    n, m = ks.shape[0], q.shape[0]
    probe = mode == "probe"
    if probe and n < 1:
        raise ValueError("sorted_search: a probe into no keys")
    if order is not None:
        _require(order, "order", (torch.int32,), n)
    if pok is not None:
        _require(pok, "pok", (torch.bool,), m)
    dev = ks.device
    pos_a = pos_b = idx = hit = None
    if probe:
        hit = torch.empty(m, dtype=torch.bool, device=dev)
        if order is not None:
            idx = torch.empty(m, dtype=torch.int32, device=dev)
    else:
        pos_a = torch.empty(m, dtype=torch.int64, device=dev)
        if mode == "both":
            pos_b = torch.empty(m, dtype=torch.int64, device=dev)
    if m:
        cb, lib = _lib("sorted_search")
        err = lib.nds_sorted_search(
            _ptr(ks), int(ks.dtype == torch.int64), n, _ptr(q), m,
            _SEARCH_MODES[mode], None if pok is None else _ptr(pok),
            None if order is None else _ptr(order),
            *[None if t is None else _ptr(t) for t in (pos_a, pos_b, idx,
                                                       hit)],
            cb.stream_handle())
        cb.check(err, "sorted_search")
        LAUNCHES["sorted_search"] += 1
    if probe:
        return idx, hit
    return (pos_a, pos_b) if mode == "both" else pos_a


def compact_perm_plain(row):
    """Plain version of ``compact_perm``: the stable sort of the 0/1 key
    ``~row`` (the reference's compactor sort), and the present count."""
    perm = torch.sort((~row).to(torch.int32), stable=True)[1]
    return perm.to(torch.int32), row.sum()


def compact_tiles(n: int, tile: int) -> int:
    """The tiles of the compactor's scratch for ``n`` rows: its tiles are
    cut at the mask's 16-byte boundaries, so the rows start up to 15 bytes
    into the first tile."""
    return -(-(n + 15) // tile)


@_counted
def compact_perm(row):
    """The stable partition of the rows by ``row``: ``(perm int32[n],
    count int64 scalar)``, the present rows' ids in row order, then the
    absent rows' ids in row order, and the present count, on the card.
    Two launches: the tiles' counts with their offsets by decoupled
    look-back (its words kept across calls, ``_lookback``'s "count"
    layout), then the ids, launched as a programmatic dependent."""
    if not _launch_device(row):
        return compact_perm_plain(row)
    _require(row, "row", (torch.bool,))
    n = row.shape[0]
    if not 1 <= n < 2**31 - 1:
        raise ValueError(f"compact_perm: n={n}")
    cb, lib = _lib("compact")
    dev = row.device
    tiles = compact_tiles(n, lib.nds_compact_tile())
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    offs = torch.empty(tiles, dtype=torch.int32, device=dev)
    stream = cb.stream_handle()
    words, ctr = _lookback(dev, stream, "count", tiles)
    err = lib.nds_compact_perm(_ptr(row), n, _ptr(offs), _ptr(perm),
                               _ptr(count), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "compact_perm")
    LAUNCHES["compact_perm"] += 1
    return perm, count


# ------------------------------------------------ partitioned M:N join

_KNUTH = 2654435761


def _part_caps(nl: int, nr: int, part_slack: float, nparts: int) -> tuple:
    """(lcap, rcap): per-partition capacities, as the JAX version
    computes them."""
    return (max(-(-int(nl * part_slack) // nparts), 1),
            max(-(-int(nr * part_slack) // nparts), 1))


def _pids_plain(key, log2r: int):
    """Partition id from the key's low 32 bits by the Knuth
    multiplicative hash, ``(uint32(key) * 2654435761) >> (32 - log2r)``.
    The 32x32-bit product is taken modulo 2^32 in two 16-bit halves, so
    no int64 product overflows."""
    if log2r == 0:
        return torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    u = key.to(torch.int64) & 0xFFFFFFFF
    prod = ((u & 0xFFFF) * _KNUTH
            + ((((u >> 16) * _KNUTH) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (prod >> (32 - log2r)).to(torch.int32)


def _radix_scatter_plain(key, ok, nparts: int, cap: int, log2r: int):
    """Plain version of the JAX ``_radix_scatter``: (keys, gidx, occ)
    blocks of shape (nparts, cap) and the count of rows dropped because
    their partition overflowed ``cap``. Each valid row's slot is its
    stable rank in its partition (a cumsum over the one-hot); dropped
    rows go to an extra slot past the blocks."""
    dev = key.device
    n = key.shape[0]
    pid = _pids_plain(key, log2r)
    oh = ((pid[:, None] == torch.arange(nparts, dtype=torch.int32,
                                        device=dev)[None, :])
          & ok[:, None])
    ohi = oh.to(torch.int32)
    rank = torch.cumsum(ohi, 0, dtype=torch.int32).gather(
        1, pid[:, None].to(torch.int64))[:, 0] - 1
    counts = ohi.sum(0)
    okc = ok & (rank < cap)
    dest = torch.where(okc, pid.to(torch.int64) * cap + rank,
                       torch.full((n,), nparts * cap, dtype=torch.int64,
                                  device=dev))
    size = nparts * cap + 1
    sent = torch.iinfo(key.dtype).max
    keys = torch.full((size,), sent, dtype=key.dtype, device=dev)
    keys.scatter_(0, dest, key)
    gidx = torch.zeros(size, dtype=torch.int32, device=dev)
    gidx.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    occ = torch.zeros(size, dtype=torch.bool, device=dev)
    occ.scatter_(0, dest, torch.ones(n, dtype=torch.bool, device=dev))
    over = (counts - cap).clamp_min(0).sum().to(torch.int64)
    return (keys[:-1].reshape(nparts, cap), gidx[:-1].reshape(nparts, cap),
            occ[:-1].reshape(nparts, cap), over)


def partitioned_mn_join_plain(lkey, lok, rkey, rok, out_capacity: int,
                              part_slack: float, nparts: int = NPART):
    """Plain version of ``partitioned_mn_join``, step by step as the JAX
    function: radix scatter of both sides, a batched stable sort of the
    build block, searchsorted match ranges, an int64 count prefix per
    partition, and the expansion into ``nparts * ceil(K / nparts)``
    output slots."""
    dev = lkey.device
    log2r = max(nparts.bit_length() - 1, 0)
    lcap, rcap = _part_caps(lkey.shape[0], rkey.shape[0], part_slack,
                            nparts)
    lk_p, lg_p, _lok_p, lover = _radix_scatter_plain(lkey, lok, nparts,
                                                     lcap, log2r)
    rk_p, rg_p, rok_p, rover = _radix_scatter_plain(rkey, rok, nparts,
                                                    rcap, log2r)
    ks, order = torch.sort(lk_p, dim=1, stable=True)
    gs = lg_p.gather(1, order)
    lo_i = torch.searchsorted(ks, rk_p)
    hi_i = torch.searchsorted(ks, rk_p, right=True)
    cnt = torch.where(rok_p, hi_i - lo_i, torch.zeros_like(lo_i))
    offs = torch.cumsum(cnt, 1, dtype=torch.int64)
    total = offs[:, -1]
    kp = max(-(-out_capacity // nparts), 1)
    slots = torch.arange(kp, dtype=torch.int32, device=dev)
    offsc = offs.clamp_max(kp + 1).to(torch.int32)
    rloc = torch.searchsorted(offsc, slots.expand(nparts, kp).contiguous(),
                              right=True).clamp(0, rcap - 1)
    prev = torch.where(rloc > 0,
                       offsc.gather(1, (rloc - 1).clamp_min(0)).to(
                           torch.int64),
                       torch.zeros((), dtype=torch.int64, device=dev))
    within = slots[None, :].to(torch.int64) - prev
    lpos = (lo_i.gather(1, rloc) + within).clamp(0, lcap - 1)
    lidx = gs.gather(1, lpos)
    ridx = rg_p.gather(1, rloc)
    present = slots[None, :] < total.clamp_max(kp)[:, None]
    overflow = (total - kp).clamp_min(0).sum() + lover + rover
    return (lidx.reshape(-1), ridx.reshape(-1), present.reshape(-1),
            overflow)


def _sort_hist_size(keys) -> int:
    """Entries of ``partition_sort``'s digit counts: 256 per pass (8 for
    int64 keys, 4 for int32) per partition."""
    return keys.shape[0] * keys.element_size() * 256


def partition_sort_plain(keys, gidx, counts, hist=None):
    """Plain version of ``partition_sort``: per partition ``p``, the
    first ``counts[p]`` (key, row) pairs sorted stably by key, and the
    rest of the partition (iinfo(key).max, 0). Where the blocks' tails
    already hold those, as the JAX version's radix scatter leaves them,
    this is the stable sort of the whole block with its row ids
    gathered (the JAX version's ``lax.sort`` with ``num_keys=1``). With
    ``hist``, the digit counts the caller took, the sort reads only the
    digits that the kernel's plan moves: those where no one digit value
    holds every row of the partition."""
    ks = torch.full_like(keys, torch.iinfo(keys.dtype).max)
    gs = torch.zeros_like(gidx)
    passes = keys.element_size()
    for p, c in enumerate(counts.tolist()):
        k = keys[p, :c]
        by = k
        if hist is not None:
            h = hist.view(-1, passes, 256)[p]
            moves = (h == c).any(1).logical_not().tolist()
            mask = sum(0xFF << (8 * d) for d in range(passes) if moves[d])
            # the moved digits of the order-preserving bits (the sign bit
            # flipped), compared as unsigned: their top bit flipped back for
            # torch's signed order, in the key's own type
            top = 8 * passes - 1
            lo = torch.iinfo(keys.dtype).min
            by = ((k ^ lo) & (mask - (2 << top) if mask >> top else mask)) ^ lo
        _s, order = torch.sort(by, stable=True)
        ks[p, :c] = k.index_select(0, order)
        gs[p, :c] = gidx[p, :c].index_select(0, order)
    return ks, gs


@_counted
def partition_sort(keys, gidx, counts, hist=None):
    """The build sort of ``partitioned_mn_join``: each partition's
    occupied (key, row) pairs, the first ``counts[p]`` slots of row
    ``p`` of the ``(nparts, cap)`` blocks ``keys`` (int32 or int64) and
    ``gidx`` (int32), sorted stably by key, and the unoccupied slots
    after them as (iinfo(key).max, 0); ``0 <= counts[p] <= cap``, as the
    partition kernel writes them. ``hist``, where given: the counts of
    each 8-bit digit of the occupied keys' order-preserving unsigned bits
    (the sign bit flipped), int32[nparts * passes * 256] (8 passes for
    int64 keys, 4 for int32), at ``(p * passes + d) * 256 + digit``, as
    ``pack_sort_key`` takes them; the sort then launches no histogram
    pass of its own. Returns ``(keys, rows)``; the inputs are left as
    they are."""
    if not _launch_device(keys, gidx, counts,
                          *([] if hist is None else [hist])):
        return partition_sort_plain(keys, gidx, counts, hist)
    if (keys.dtype not in _KEY_DTYPES or keys.dim() != 2
            or not keys.is_contiguous()):
        raise ValueError(f"partition_sort: keys {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if (gidx.dtype != torch.int32 or gidx.shape != keys.shape
            or not gidx.is_contiguous()):
        raise ValueError(f"partition_sort: gidx {gidx.dtype} "
                         f"{tuple(gidx.shape)}")
    nparts, cap = keys.shape
    _require(counts, "counts", (torch.int32,), nparts)
    cb, lib = _lib("partitioned_join")
    if not 1 <= nparts <= lib.nds_pj_max_parts() or cap < 1:
        raise ValueError(f"partition_sort: {nparts} partitions of {cap}")
    dev = keys.device
    key64 = int(keys.dtype == torch.int64)
    ks, gs = torch.empty_like(keys), torch.empty_like(gidx)
    tk, tg = torch.empty_like(keys), torch.empty_like(gidx)
    counted = hist is not None
    if counted:
        _require(hist, "hist", (torch.int32,), _sort_hist_size(keys))
    else:
        # counts of every digit (8 bits, up to 8 passes) per partition
        hist = torch.zeros(nparts * 8 * 256, dtype=torch.int32, device=dev)
    dbase = torch.empty(nparts * 8 * 256, dtype=torch.int32, device=dev)
    info = torch.empty(nparts * 8, dtype=torch.int32, device=dev)
    tiles = -(-cap // lib.nds_pj_sort_tile(key64))
    stream = cb.stream_handle()
    # one epoch per pass
    words, ctr = _lookback(dev, stream, "count", nparts * tiles * 256,
                           8 if key64 else 4)
    err = lib.nds_pj_sort(
        _ptr(keys), _ptr(gidx), _ptr(tk), _ptr(tg), _ptr(ks), _ptr(gs),
        key64, nparts, cap, _ptr(counts), _ptr(hist), int(counted),
        _ptr(dbase), _ptr(info), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "partition_sort")
    LAUNCHES["partition_sort"] += 1
    return ks, gs


def _radix_partition(lib, cb, key, ok, nparts: int, cap: int, log2r: int,
                     count, over, side: int) -> tuple:
    """One side's (nparts, cap) key and row-index blocks, written by the
    partition kernel of ``partitioned_join.cu``: only each partition's
    occupied prefix, whose length lands in ``count`` (int32[nparts]);
    the side's dropped rows land in ``over[side]``."""
    dev = key.device
    n = key.shape[0]
    keys = torch.empty((nparts, cap), dtype=key.dtype, device=dev)
    gidx = torch.empty((nparts, cap), dtype=torch.int32, device=dev)
    ntiles = -(-n // lib.nds_pj_partition_tile())
    stream = cb.stream_handle()
    words, ctr = _lookback(dev, stream, "count",
                           ntiles * lib.nds_pj_max_parts())
    err = lib.nds_pj_partition(
        _ptr(key), _ptr(ok), n, int(key.dtype == torch.int64), nparts,
        log2r, cap, _ptr(keys), _ptr(gidx), _ptr(count),
        _ptr(over) + side * over.element_size(), _ptr(words), _ptr(ctr),
        stream)
    cb.check(err, "partitioned_mn_join (partition)")
    return keys, gidx


@_counted
def partitioned_mn_join(lkey, lok, rkey, rok, out_capacity: int,
                        part_slack: float, nparts: int = NPART):
    """Radix-partitioned M:N expanding inner join. Both sides scatter
    into ``nparts`` hash partitions of capacity ``ceil(n * part_slack /
    nparts)``; the build block sorts per partition, each probe slot
    finds its match range, and the matches expand into ``nparts *
    ceil(out_capacity / nparts)`` slots. Returns ``(lidx int32, ridx
    int32, present bool, overflow int64)``; ``overflow`` counts rows
    dropped by a full partition and matches past a partition's output
    capacity, for the executor's doubled-slack retry."""
    if not _launch_device(lkey, lok, rkey, rok):
        return partitioned_mn_join_plain(lkey, lok, rkey, rok,
                                         out_capacity, part_slack, nparts)
    steps = partitioned_mn_join_steps(lkey, lok, rkey, rok, out_capacity,
                                      part_slack, nparts)
    while True:
        try:
            next(steps)
        except StopIteration as done:
            LAUNCHES["partitioned_mn_join"] += 1
            return done.value


def partitioned_mn_join_steps(lkey, lok, rkey, rok, out_capacity: int,
                              part_slack: float, nparts: int = NPART):
    """The launches of ``partitioned_mn_join`` on the card, as a
    generator: it yields each step's name ("partition_left",
    "partition_right", "build_sort", "ranges", "prefix", "expand") right
    after it enqueues the step, and returns the join's result. The
    wrapper runs it to its end; a measurement can record a CUDA event at
    each step (chip_smoke.py's K6 breakdown)."""
    _keys_of(lkey, lok, rkey, rok)
    if nparts < 1 or nparts & (nparts - 1) or nparts > 32:
        raise ValueError(f"partitioned_mn_join: nparts={nparts}")
    nl, nr = lkey.shape[0], rkey.shape[0]
    if not (1 <= nl < 2**31 and 1 <= nr < 2**31):
        raise ValueError(f"partitioned_mn_join: sides of {nl} and {nr} "
                         f"rows")
    log2r = max(nparts.bit_length() - 1, 0)
    lcap, rcap = _part_caps(nl, nr, part_slack, nparts)
    kp = max(-(-out_capacity // nparts), 1)
    if max(nparts * lcap, nparts * rcap, kp + 1) >= 2**31:
        raise ValueError("partitioned_mn_join: capacities exceed int32")
    cb, lib = _lib("partitioned_join")
    _cs, scan = _lib("seg_scan")
    dev = lkey.device
    over = torch.empty(2, dtype=torch.int64, device=dev)
    counts = torch.empty((2, nparts), dtype=torch.int32, device=dev)
    lk_p, lg_p = _radix_partition(lib, cb, lkey, lok, nparts, lcap, log2r,
                                  counts[0], over, 0)
    yield "partition_left"
    rk_p, rg_p = _radix_partition(lib, cb, rkey, rok, nparts, rcap, log2r,
                                  counts[1], over, 1)
    yield "partition_right"
    ks, gs = partition_sort(lk_p, lg_p, counts[0])
    yield "build_sort"
    stream = cb.stream_handle()
    lo_i = torch.empty((nparts, rcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((nparts, rcap), dtype=torch.int64, device=dev)
    err = lib.nds_pj_ranges(
        _ptr(ks), int(lkey.dtype == torch.int64), lcap, _ptr(rk_p), rcap,
        nparts, _ptr(counts[0]), _ptr(counts[1]), _ptr(lo_i), _ptr(cnt),
        stream)
    cb.check(err, "partitioned_mn_join (ranges)")
    yield "ranges"
    # per-partition int64 prefix of the match counts: the segmented scan
    # kernel, restarting every rcap slots
    m = nparts * rcap
    offs = torch.empty(m, dtype=torch.int64, device=dev)
    words, ctr = _scan_state(scan, m, dev, stream)
    err = scan.nds_seg_scan(
        _ptr(cnt), _SCAN_VTYPES[torch.int64], _OP_CODES["sum"], None, rcap,
        m, _ptr(offs), _ptr(words), _ptr(ctr), stream)
    cb.check(err, "partitioned_mn_join (prefix)")
    yield "prefix"
    lidx = torch.empty(nparts * kp, dtype=torch.int32, device=dev)
    ridx = torch.empty(nparts * kp, dtype=torch.int32, device=dev)
    present = torch.empty(nparts * kp, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    err = lib.nds_pj_expand(
        _ptr(offs), _ptr(lo_i), _ptr(gs), _ptr(rg_p), nparts, lcap, rcap,
        kp, _ptr(counts[1]), _ptr(over), _ptr(lidx), _ptr(ridx),
        _ptr(present), _ptr(overflow), stream)
    cb.check(err, "partitioned_mn_join (expand)")
    yield "expand"
    return lidx, ridx, present, overflow


# ------------------------------------------------- columnar store decode

# payload widths of the bit-packed encoding (columnar/encodings.py)
_PACK_BITS = (1, 2, 4, 8, 16, 32)
_DECODE_OUT = {torch.int32: 0, torch.int64: 1}


def _bias_fits_int32(lo: int, bits: int) -> bool:
    """The reference's test for its native-width decode path: the bias
    and the bias plus 2^bits both fit int32."""
    return -2**31 < lo and lo + (1 << bits) < 2**31


def _unpack_words_plain(words, n: int, bits: int):
    """Gather + shift + mask of ``n`` fields of ``bits`` bits from int32
    words, low field first, in int32 arithmetic (the arithmetic shift's
    sign bits are masked off), as ``columnar/device.py``'s
    ``_unpack_words``."""
    per = 32 // bits
    idx = torch.arange(n, dtype=torch.int32, device=words.device)
    w = words.index_select(0, torch.div(idx, per,
                                        rounding_mode="floor").to(torch.int64))
    return (w >> ((idx % per) * bits)) & ((1 << bits) - 1)


def bitpack_decode_plain(words, n: int, bits: int, lo: int, dtype):
    """Plain version of the bitpack branch of ``decode``: a widen plus
    the bias for ``bits = 32``, else the unpacked field plus the bias,
    in int32 where the bias allows and in int64 otherwise, cast to
    ``dtype``."""
    if bits >= 32:
        return (words.to(torch.int64) + lo).to(dtype)
    field = _unpack_words_plain(words, n, bits)
    if _bias_fits_int32(lo, bits):
        return (field + lo).to(dtype)
    return (field.to(torch.int64) + lo).to(dtype)


def _packed_words(words, n: int, bits: int) -> None:
    """Checks that the int32 ``words`` hold ``n`` fields of ``bits``
    bits."""
    _require(words, "words", (torch.int32,))
    if bits not in _PACK_BITS:
        raise ValueError(f"bit width {bits} not in {_PACK_BITS}")
    need = n if bits == 32 else -(-n // (32 // bits))
    if n < 0 or words.shape[0] < need:
        raise ValueError(f"{words.shape[0]} words hold fewer than {n} "
                         f"fields of {bits} bits")


@_counted
def bitpack_decode(words, n: int, bits: int, lo: int, dtype):
    """``n`` values of ``dtype`` (int32 or int64) from the bit-packed
    int32 ``words`` of one column: the field of each row plus the bias
    ``lo``, exactly as the reference's ``decode`` gives them."""
    if not _launch_device(words):
        return bitpack_decode_plain(words, n, bits, lo, dtype)
    _packed_words(words, n, bits)
    if dtype not in _DECODE_OUT:
        raise TypeError(f"bitpack_decode: output dtype {dtype} not in "
                        f"{tuple(_DECODE_OUT)} (a bool mask is "
                        f"unpack_mask's)")
    out = torch.empty(n, dtype=dtype, device=words.device)
    if n == 0:
        return out
    wide = int(bits >= 32 or not _bias_fits_int32(lo, bits))
    cb, lib = _lib("columnar_decode")
    err = lib.nds_bitpack_decode(
        _ptr(words), n, bits.bit_length() - 1, int(lo), wide,
        _DECODE_OUT[dtype], _ptr(out), cb.stream_handle())
    cb.check(err, "bitpack_decode")
    LAUNCHES["bitpack_decode"] += 1
    return out


def unpack_mask_plain(words, n: int):
    """Plain version of ``unpack_mask``: the 1-bit fields as bools."""
    return _unpack_words_plain(words, n, 1).to(torch.bool)


@_counted
def unpack_mask(words, n: int):
    """The validity mask of ``n`` rows packed at one bit per row, low
    bit first, from int32 ``words`` at any offset (more words than ``n``
    needs are not read): its own kernel, 16 rows a thread as one 16-byte
    store (``columnar_decode.cu``)."""
    if not _launch_device(words):
        return unpack_mask_plain(words, n)
    _packed_words(words, n, 1)
    # torch's allocator aligns a new tensor to 512 bytes, as the kernel's
    # 16-byte stores need
    out = torch.empty(n, dtype=torch.bool, device=words.device)
    if n == 0:
        return out
    cb, lib = _lib("columnar_decode")
    err = lib.nds_unpack_mask(_ptr(words), n, _ptr(out), cb.stream_handle())
    cb.check(err, "unpack_mask")
    LAUNCHES["unpack_mask"] += 1
    return out


def rle_decode_plain(values, starts, n: int):
    """Plain version of the RLE branch of ``decode``: a 1 added at each
    run start (a start at or past ``n`` is dropped, as the JAX scatter
    drops it), an int32 cumsum minus one for the run ids, then a gather
    of the run values. The last run id carries over a padded tail."""
    dev = values.device
    st = starts.to(torch.int64)
    st = torch.where((st >= 0) & (st < n), st,
                     torch.full_like(st, n))
    ids = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, st, torch.ones(st.shape[0], dtype=torch.int32, device=dev))[:n]
    seg = torch.cumsum(ids, 0, dtype=torch.int32) - 1
    return values.index_select(0, seg.to(torch.int64))


@_counted
def rle_decode(values, starts, n: int):
    """``n`` rows from run-length encoded ``values`` (int32 or int64)
    and their int32 run ``starts`` (strictly increasing from 0): each
    row takes the value of the last run starting at or before it, the
    last run reaching ``n``."""
    if not _launch_device(values, starts):
        return rle_decode_plain(values, starts, n)
    _require(values, "values", _KEY_DTYPES)
    runs = values.shape[0]
    _require(starts, "starts", (torch.int32,), runs)
    if not 1 <= runs < 2**31 or n < 0:
        raise ValueError(f"rle_decode: {runs} runs into {n} rows")
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    if n == 0:
        return out
    cb, lib = _lib("columnar_decode")
    err = lib.nds_rle_decode(
        _ptr(values), _ptr(starts), runs, n,
        int(values.dtype == torch.int64), _ptr(out), cb.stream_handle())
    cb.check(err, "rle_decode")
    LAUNCHES["rle_decode"] += 1
    return out


# ------------------------------------------- hash-partition exchange pack

# splitmix64's multipliers as the int64 values of their bits: torch's
# int64 product wraps modulo 2^64 as the uint64 one does
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(x, k: int):
    """Logical right shift of the uint64 bits held in int64 ``x``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64_plain(key):
    """splitmix64's finalizer of ``int64(key)`` as uint64 bits, held in an
    int64 tensor (the JAX version's ``_mix64``)."""
    x = key.to(torch.int64)
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _umod_plain(x, m: int):
    """``x % m`` of the uint64 bits held in int64 ``x``, exact for any
    ``0 < m < 2^31``: the 32-bit halves are reduced apart, so no signed
    ``%`` sees a value at or above 2^63."""
    hi, lo = _srl(x, 32), x & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def _exchange_dest_plain(key, dest, n_dev: int, modulus: int, div: int):
    if dest is not None:
        return dest.to(torch.int32)
    g = _umod_plain(mix64_plain(key), modulus)
    return (torch.div(g, div, rounding_mode="floor") % n_dev).to(torch.int32)


def exchange_pack_plain(payloads, ok, n_dev: int, bucket: int, key=None,
                        dest=None, modulus: "int | None" = None,
                        div: int = 1):
    """Plain version of ``exchange_pack``, step by step as the JAX
    ``exchange_by_dest`` (with the destination of ``exchange`` or of an
    ``exchange_hierarchical`` stage): dead rows to the sentinel dest
    ``n_dev``, a stable sort of (dest, iota), the destination starts by
    searchsorted, ranks, the overflow count, and a scatter of each sorted
    payload into a zero buffer with one trash slot past its end."""
    dev = ok.device
    n = ok.shape[0]
    d = _exchange_dest_plain(key, dest, n_dev,
                             n_dev if modulus is None else modulus, div)
    d = torch.where(ok, d, torch.full_like(d, n_dev))
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    dest_s, order = torch.sort(d, stable=True)
    ok_s = ok.index_select(0, order)
    bounds = torch.searchsorted(
        dest_s, torch.arange(n_dev + 1, dtype=torch.int32, device=dev))
    first_of_dest = bounds[:-1]
    rank = iota - first_of_dest.index_select(
        0, dest_s.clamp(0, n_dev - 1).to(torch.int64))
    overflow = (ok_s & (rank >= bucket)).sum().to(torch.int64)
    keep = ok_s & (rank < bucket)
    trash = n_dev * bucket
    slot = torch.where(keep, dest_s.to(torch.int64) * bucket
                       + rank.clamp(0, bucket - 1),
                       torch.full_like(rank, trash))

    def scatter(vals_sorted):
        buf = torch.zeros(trash + 1, dtype=vals_sorted.dtype, device=dev)
        return buf.scatter_(0, slot, vals_sorted)[:-1]

    send_ok = scatter(keep)
    outs = [scatter(a.index_select(0, order)) for a in payloads]
    return outs, send_ok, overflow


_PAY_SIZES = (1, 2, 4, 8)


@_counted
def exchange_pack(payloads, ok, n_dev: int, bucket: int, key=None,
                  dest=None, modulus: "int | None" = None, div: int = 1):
    """Pack the send buffers of one hash-partition exchange: each row
    that is ``ok`` goes to destination ``d`` in ``[0, n_dev)``, either
    ``dest[i]`` or ``(splitmix64(key[i]) % modulus // div) % n_dev``
    (``modulus`` defaults to ``n_dev``), at slot ``d * bucket + rank``,
    ``rank`` its stable rank among the live rows bound for ``d``; rows
    of rank ``>= bucket`` are dropped and counted. Returns ``(buffers,
    send_ok, overflow)``: one ``(n_dev * bucket)`` buffer per payload
    (zero where no row landed), the bool ``send_ok`` of the same length,
    and the dropped rows as an int64 scalar."""
    if (key is None) == (dest is None):
        raise ValueError("exchange_pack: give exactly one of key and dest")
    route = key if dest is None else dest
    if not _launch_device(ok, route, *payloads):
        return exchange_pack_plain(payloads, ok, n_dev, bucket, key, dest,
                                   modulus, div)
    n = ok.shape[0]
    _require(ok, "ok", (torch.bool,))
    if dest is not None:
        _require(dest, "dest", (torch.int32,), n)
        mode = 0
    else:
        _require(key, "key", _KEY_DTYPES, n)
        mode = 2 if key.dtype == torch.int64 else 1
    modulus = n_dev if modulus is None else int(modulus)
    cb, lib = _lib("exchange")
    if not 1 <= n_dev <= lib.nds_exchange_max_dest():
        raise ValueError(f"exchange_pack: n_dev={n_dev}")
    if bucket < 1 or n_dev * bucket >= 2**31 or n >= 2**31:
        raise ValueError(f"exchange_pack: {n} rows, bucket {bucket}")
    if modulus < 1 or div < 1:
        raise ValueError(f"exchange_pack: modulus {modulus}, div {div}")
    for p in payloads:
        _require(p, "payload", (p.dtype,), n)
        if p.element_size() not in _PAY_SIZES:
            raise TypeError(f"exchange_pack: payload dtype {p.dtype}")
    dev = ok.device
    m = n_dev * bucket
    outs = [torch.empty(m, dtype=p.dtype, device=dev) for p in payloads]
    send_ok = torch.empty(m, dtype=torch.bool, device=dev)
    nblocks = max(-(-n // lib.nds_exchange_tile()), 1)
    block_cnt = torch.empty(nblocks * n_dev, dtype=torch.int32, device=dev)
    fill_from = torch.empty(n_dev, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    k = len(payloads)
    src = (ctypes.c_void_p * max(k, 1))(*[_ptr(p) for p in payloads])
    dst = (ctypes.c_void_p * max(k, 1))(*[_ptr(o) for o in outs])
    sizes = (ctypes.c_int * max(k, 1))(*[p.element_size() for p in payloads])
    err = lib.nds_exchange_pack(
        _ptr(key) if dest is None else None,
        _ptr(dest) if dest is not None else None, mode, _ptr(ok), n,
        modulus, int(div), n_dev, bucket, k, src, dst, sizes,
        _ptr(send_ok), _ptr(block_cnt), _ptr(fill_from), _ptr(overflow),
        cb.stream_handle())
    cb.check(err, "exchange_pack")
    LAUNCHES["exchange_pack"] += 1
    return outs, send_ok, overflow
