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
                       (K5)
partitioned_mn_join    ``partitioned_mn_join`` +             csrc/partitioned_join.cu
                       ``_radix_scatter`` + ``_pids`` (K6)   (+ csrc/seg_scan.cu)
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

All thirteen are bound by bytes on the card: the source files say how many,
and what their design does about it. One library call sits inside a
kernel: ``partitioned_mn_join`` sorts its (partitions x capacity) build
block with one batched ``torch.sort``, the step the JAX version hands to
XLA's library sort (``lax.sort``); everything the JAX version computes
with its own arithmetic is CUDA C++.
"""

from __future__ import annotations

import ctypes
import os

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
    mn = torch.empty(dom, dtype=bval.dtype, device=dev)
    mx = torch.empty(dom, dtype=bval.dtype, device=dev)
    present = torch.empty(dom, dtype=torch.uint8, device=dev)
    out = torch.empty(np_, dtype=torch.bool, device=dev)
    err = lib.nds_keyed_minmax_semi(
        _ptr(bkey), _ptr(bok), _ptr(bval), bkey.shape[0], _ptr(pkey),
        _ptr(pok), _ptr(pval), np_, key64, int(bval.dtype == torch.int64),
        lo, dom, _ptr(mn), _ptr(mx), _ptr(present), _ptr(out),
        cb.stream_handle())
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
    each group's first sorted row, n past the last group)."""
    n = data.shape[0]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=gid.device),
                       gid[1:] != gid[:-1]])
    run = seg_scan_plain(op, data, first)
    nxt = torch.cat([starts2[1:],
                     torch.full((1,), n, dtype=starts2.dtype,
                                device=starts2.device)])
    end = (nxt - 1).clamp(0, n - 1)
    return run[end]


_SCAN_VTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                torch.float64: 3}


@_counted
def seg_reduce_at_ends(op: str, data, gid, starts2):
    """Grouped min or max (``op`` is "min" or "max") over rows sorted
    by group id, with no scatter: a segmented scan read at segment
    ends. Rows outside any group must carry the op's identity."""
    if op not in ("min", "max"):
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
    tile = lib.nds_seg_scan_tile()
    ntiles = -(-n // tile)
    dev = data.device
    run = torch.empty(n, dtype=data.dtype, device=dev)
    fl = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_v = torch.empty(ntiles, dtype=data.dtype, device=dev)
    tile_f = torch.empty(ntiles, dtype=torch.uint8, device=dev)
    carry = torch.empty(ntiles, dtype=data.dtype, device=dev)
    out = torch.empty(G, dtype=data.dtype, device=dev)
    err = lib.nds_seg_reduce_at_ends(
        _ptr(data), _SCAN_VTYPES[data.dtype], int(op == "max"), _ptr(gid),
        n, _ptr(starts2), int(starts2.dtype == torch.int64), G, _ptr(run),
        _ptr(fl), _ptr(tile_v), _ptr(tile_f), _ptr(carry), _ptr(out),
        cb.stream_handle())
    cb.check(err, "seg_reduce_at_ends")
    LAUNCHES["seg_reduce_at_ends"] += 1
    return out


def _scan_scratch(lib, n: int, dtype, dev) -> tuple:
    """Per-tile aggregates and carries of the three-pass scan."""
    ntiles = -(-n // lib.nds_seg_scan_tile())
    return (torch.empty(ntiles, dtype=dtype, device=dev),
            torch.empty(ntiles, dtype=torch.uint8, device=dev),
            torch.empty(ntiles, dtype=dtype, device=dev))


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
    fl = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_v, tile_f, carry = _scan_scratch(lib, n, vals.dtype, dev)
    err = lib.nds_seg_scan(
        _ptr(vals), _SCAN_VTYPES[vals.dtype], _OP_CODES[op], _ptr(flags), 0,
        n, _ptr(out), _ptr(fl), _ptr(tile_v), _ptr(tile_f), _ptr(carry),
        cb.stream_handle())
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
    fl = torch.empty(n, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=data.dtype, device=dev)
    tile_v, tile_f, carry = _scan_scratch(lib, n, data.dtype, dev)
    err = lib.nds_part_reduce_broadcast(
        _ptr(data), _SCAN_VTYPES[data.dtype], _OP_CODES[op],
        _ptr(part_start), n, _ptr(pend), int(pend.dtype == torch.int64),
        _ptr(out), _ptr(run), _ptr(fl), _ptr(tile_v), _ptr(tile_f),
        _ptr(carry), cb.stream_handle())
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
    run = torch.empty(n, dtype=torch.int32, device=dev)
    fl = torch.empty(n, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    tile_v, tile_f, carry = _scan_scratch(lib, n, torch.int32, dev)
    err = lib.nds_last_of_group(
        _ptr(change), n, _ptr(out), _ptr(run), _ptr(fl), _ptr(tile_v),
        _ptr(tile_f), _ptr(carry), cb.stream_handle())
    cb.check(err, "last_of_group")
    LAUNCHES["last_of_group"] += 1
    return out


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


def _radix_partition(lib, cb, key, ok, nparts: int, cap: int, log2r: int,
                     over, side: int):
    """One side's (nparts, cap) key, row-index and occupancy blocks,
    written by the partition kernels of ``partitioned_join.cu``; the
    side's dropped-row count lands in ``over[side]``."""
    dev = key.device
    n = key.shape[0]
    tile = lib.nds_pj_tile()
    nblocks = max(-(-n // tile), 1)
    keys = torch.empty((nparts, cap), dtype=key.dtype, device=dev)
    gidx = torch.empty((nparts, cap), dtype=torch.int32, device=dev)
    occ = torch.empty((nparts, cap), dtype=torch.bool, device=dev)
    block_cnt = torch.empty((nblocks, nparts), dtype=torch.int32,
                            device=dev)
    err = lib.nds_pj_partition(
        _ptr(key), _ptr(ok), n, int(key.dtype == torch.int64), nparts,
        log2r, cap, _ptr(keys), _ptr(gidx), _ptr(occ), _ptr(block_cnt),
        _ptr(over), side, cb.stream_handle())
    cb.check(err, "partitioned_mn_join (partition)")
    return keys, gidx, occ


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
    _keys_of(lkey, lok, rkey, rok)
    if nparts < 1 or nparts & (nparts - 1) or nparts > 32:
        raise ValueError(f"partitioned_mn_join: nparts={nparts}")
    nl, nr = lkey.shape[0], rkey.shape[0]
    if nl < 1 or nr < 1:
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
    lk_p, lg_p, _ = _radix_partition(lib, cb, lkey, lok, nparts, lcap,
                                     log2r, over, 0)
    rk_p, rg_p, rok_p = _radix_partition(lib, cb, rkey, rok, nparts,
                                         rcap, log2r, over, 1)
    # the one library call: the batched stable sort of the build block
    # (the JAX version's lax.sort)
    ks, order = torch.sort(lk_p, dim=1, stable=True)
    gs = lg_p.gather(1, order)
    lo_i = torch.empty((nparts, rcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((nparts, rcap), dtype=torch.int64, device=dev)
    err = lib.nds_pj_ranges(
        _ptr(ks), int(lkey.dtype == torch.int64), lcap, _ptr(rk_p),
        _ptr(rok_p), rcap, nparts, _ptr(lo_i), _ptr(cnt),
        cb.stream_handle())
    cb.check(err, "partitioned_mn_join (ranges)")
    # per-partition int64 prefix of the match counts: the segmented scan
    # kernel, restarting every rcap slots
    m = nparts * rcap
    offs = torch.empty(m, dtype=torch.int64, device=dev)
    fl = torch.empty(m, dtype=torch.uint8, device=dev)
    tile_v, tile_f, carry = _scan_scratch(scan, m, torch.int64, dev)
    err = scan.nds_seg_scan(
        _ptr(cnt), _SCAN_VTYPES[torch.int64], _OP_CODES["sum"], None, rcap,
        m, _ptr(offs), _ptr(fl), _ptr(tile_v), _ptr(tile_f), _ptr(carry),
        cb.stream_handle())
    cb.check(err, "partitioned_mn_join (prefix)")
    lidx = torch.empty(nparts * kp, dtype=torch.int32, device=dev)
    ridx = torch.empty(nparts * kp, dtype=torch.int32, device=dev)
    present = torch.empty(nparts * kp, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    err = lib.nds_pj_expand(
        _ptr(offs), _ptr(lo_i), _ptr(gs), _ptr(rg_p), nparts, lcap, rcap,
        kp, _ptr(over), _ptr(lidx), _ptr(ridx), _ptr(present),
        _ptr(overflow), cb.stream_handle())
    cb.check(err, "partitioned_mn_join (expand)")
    LAUNCHES["partitioned_mn_join"] += 1
    return lidx, ridx, present, overflow


# ------------------------------------------------- columnar store decode

# payload widths of the bit-packed encoding (columnar/encodings.py)
_PACK_BITS = (1, 2, 4, 8, 16, 32)
_DECODE_OUT = {torch.int32: 0, torch.int64: 1, torch.bool: 2}


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


def _bitpack_launch(name: str, words, n: int, bits: int, lo: int, dtype):
    """One launch of the decode kernel of ``columnar_decode.cu`` into a
    new tensor of ``n`` rows of ``dtype``."""
    _require(words, "words", (torch.int32,))
    if bits not in _PACK_BITS:
        raise ValueError(f"bit width {bits} not in {_PACK_BITS}")
    need = n if bits == 32 else -(-n // (32 // bits))
    if n < 0 or words.shape[0] < need:
        raise ValueError(f"{words.shape[0]} words hold fewer than {n} "
                         f"fields of {bits} bits")
    if dtype not in _DECODE_OUT:
        raise TypeError(f"{name}: output dtype {dtype} not in "
                        f"{tuple(_DECODE_OUT)}")
    out = torch.empty(n, dtype=dtype, device=words.device)
    if n == 0:
        return out
    wide = int(bits >= 32 or not _bias_fits_int32(lo, bits))
    cb, lib = _lib("columnar_decode")
    err = lib.nds_bitpack_decode(
        _ptr(words), n, bits.bit_length() - 1, int(lo), wide,
        _DECODE_OUT[dtype], _ptr(out), cb.stream_handle())
    cb.check(err, name)
    LAUNCHES[name] += 1
    return out


@_counted
def bitpack_decode(words, n: int, bits: int, lo: int, dtype):
    """``n`` values of ``dtype`` (int32 or int64) from the bit-packed
    int32 ``words`` of one column: the field of each row plus the bias
    ``lo``, exactly as the reference's ``decode`` gives them."""
    if not _launch_device(words):
        return bitpack_decode_plain(words, n, bits, lo, dtype)
    if dtype == torch.bool:
        raise TypeError("bitpack_decode: a bool output is unpack_mask's")
    return _bitpack_launch("bitpack_decode", words, n, bits, lo, dtype)


def unpack_mask_plain(words, n: int):
    """Plain version of ``unpack_mask``: the 1-bit fields as bools."""
    return _unpack_words_plain(words, n, 1).to(torch.bool)


@_counted
def unpack_mask(words, n: int):
    """The validity mask of ``n`` rows packed at one bit per row, low
    bit first: the bitpack decode kernel at ``bits = 1`` with a bool
    output."""
    if not _launch_device(words):
        return unpack_mask_plain(words, n)
    return _bitpack_launch("unpack_mask", words, n, 1, 0, torch.bool)


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
