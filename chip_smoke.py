#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the NDS-H and NDS power runs on one card.

    python3 chip_smoke.py [--sf 1.0] [--sf-ds 1.0] [--out results/smoke.json]

Drives ``nds_tpu_torch`` (never ``jax``, never ``nds_tpu``) on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; exits 2 without a CUDA device;
2. generates both legs' data with the port's generators, then forks the
   pool of CPU oracle workers (one per core, at most 8), before the card
   is touched: the workers inherit the tables and run only numpy;
3. builds the CUDA C++ kernels from ``nds_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once);
4. NDS-H leg at ``--sf`` (default SF1, ``bench.py``'s scale):
   ``Session.for_nds_h(make_device_factory())`` on ``cuda``;
   an untimed pass of the 22 queries captures each kernel's largest call;
   every kernel runs against its plain PyTorch version on those inputs
   and at the main path's join shapes built from the real columns
   (probe 6,001,215 rows at SF1; builds of 1,500,000, 200,000, 25 and 256
   rows; the segmented scan at several group counts); launch counts set to
   0, the 22 queries timed, the counts read; a pass under
   ``torch.profiler`` for the card's busy time; every result checked
   against the CPU oracle by the validator's rules, in the worker pool;
   the executor's library steps (L1-L3: the compactor sort, the
   multi-key sort, segment sums, the sort-merge build and probe) counted
   and their largest calls timed, here and on the NDS leg;
4b. distributed phase: a world of one rank over NCCL
   (``parallel.mesh.make_mesh(1)``) and ``make_distributed_factory`` over
   it: the NDS-H leg again at ``--sf``, its kernels (the exchange's
   ``exchange_pack`` among them) checked on their largest calls and its
   results against the oracle frames the raw leg kept; ``exchange_pack``
   over SF1 ``l_orderkey`` (a tenth of the rows dead) laid out over 2, 4
   and 8 ranks and over the two stages of a 2 x 2 mesh, at slack 2 and
   0.8, exact against its plain version on every rank, the buckets
   transposed in this process as the all-to-all moves them and every
   valid row found once at the rank its key hashes to; then the NDS leg
   through the distributed factory at the smaller of ``--sf-ds`` and
   ``SF_DS_DIST`` (a cut of depth, see there), every kernel checked on
   its largest call there, results against the CPU oracle;
5. NDS leg at ``--sf-ds`` (default SF1, ``bench.py``'s ``BENCH_NDS_SF``):
   the same phases over the 103 statements of the NDS power run
   (``Session.for_nds``), with the validator's two carve-outs (q65 on its
   row count, q78's column 3 at rel tol 0.01001);
6. window path: whole-partition MIN/MAX and a running SUM under the
   default RANGE frame over ``store_sales`` at the NDS leg's scale (no NDS
   statement takes either form: the only path to
   ``part_reduce_broadcast``), kernels checked, timed with counts read,
   results checked against the oracle;
7. columnar phase, after the raw executors are released: both legs again
   under ``columnar.set_mode("auto")`` (the compressed columnar store),
   each through a fresh executor, with the same untimed, timed and
   profiled passes; every result checked against the oracle frames the
   raw legs' checks kept, every unit's kernel block against the mode-off
   run's; the decode kernels (``bitpack_decode``, ``unpack_mask``,
   ``rle_decode``) checked at their largest captured calls (K1-K7 repeat
   the raw legs' calls, checked there) and over a
   sweep of every bit width at 6,001,215 rows; their launches required
   in the timed passes (a forced-``rle`` NDS-H pass where ``auto`` picks
   no RLE); power totals, busy shares, peak memory, ``bytes_scanned``,
   compression ratios and the executors' resident buffer bytes printed
   beside the mode-off legs', and each leg's power total timed in turns
   (mode off, auto, auto, mode off; the last two through fresh
   executors);
8. prints the kernels line (one entry per kernel wrapper: launches summed
   over the timed runs, each kernel's numbers from the path that runs
   it), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Kernel checks: integer, bool and min/max outputs must equal the plain
version's exactly; a float sum (the segmented scan's "sum" on float
values) within |got - plain| <= 1e-9 * max(1, |plain|), since the two add
in other orders. Each check gives the kernel's time (CUDA events, median
of 7 after 2 warm-ups), the host's time for one call of the wrapper up to
its return (``host_ms``), the plain version's time, the bytes it must
move, the least time the card could take for them (``bound_ms``) and,
where one PyTorch call computes the same thing, that call's time. Each
profiled pass also lists the operators that take the most host time.

Any failed phase raises: the exit code is then non-zero and no result
line is printed. ``--device cpu`` rehearses the script on the CPU, where
the wrappers take their plain versions and the launch check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

KERNELS = {
    # wrapper: (source, TPU kernel it replaces)
    "direct_lookup_join": ("nds_tpu_torch/csrc/dense_domain.cu",
                           "nds_tpu/engine/kernels.py:233"),
    "matmul_probe_join": ("nds_tpu_torch/csrc/small_build_probe.cu",
                          "nds_tpu/engine/kernels.py:255"),
    "bitmask_semi": ("nds_tpu_torch/csrc/dense_domain.cu",
                     "nds_tpu/engine/kernels.py:271"),
    "keyed_minmax_semi": ("nds_tpu_torch/csrc/dense_domain.cu",
                          "nds_tpu/engine/kernels.py:285"),
    "seg_reduce_at_ends": ("nds_tpu_torch/csrc/seg_scan.cu",
                           "nds_tpu/engine/kernels.py:420,438"),
    "partitioned_mn_join": ("nds_tpu_torch/csrc/partitioned_join.cu",
                            "nds_tpu/engine/kernels.py:349,321,310"),
    "seg_scan": ("nds_tpu_torch/csrc/seg_scan.cu",
                 "nds_tpu/engine/kernels.py:420"),
    "part_reduce_broadcast": ("nds_tpu_torch/csrc/seg_scan.cu",
                              "nds_tpu/engine/kernels.py:456"),
    "last_of_group": ("nds_tpu_torch/csrc/seg_scan.cu",
                      "nds_tpu/engine/kernels.py:466"),
    "bitpack_decode": ("nds_tpu_torch/csrc/columnar_decode.cu",
                       "nds_tpu/columnar/device.py:21,41"),
    "unpack_mask": ("nds_tpu_torch/csrc/columnar_decode.cu",
                    "nds_tpu/columnar/device.py:31"),
    "rle_decode": ("nds_tpu_torch/csrc/columnar_decode.cu",
                   "nds_tpu/columnar/device.py:52"),
    "exchange_pack": ("nds_tpu_torch/csrc/exchange.cu",
                      "nds_tpu/parallel/exchange.py:51,61,74,157"),
}
# the kernels each timed run must have launched
H_REQUIRED = ("direct_lookup_join", "matmul_probe_join", "bitmask_semi",
              "keyed_minmax_semi", "seg_reduce_at_ends")
DS_REQUIRED = ("partitioned_mn_join", "seg_scan", "last_of_group")
WINDOW_REQUIRED = ("part_reduce_broadcast", "last_of_group")
# the columnar decode kernels (K8, K9): the timed passes under "auto"
# must launch all three between them, the NDS pass the mask unpack
DECODE_KERNELS = ("bitpack_decode", "unpack_mask", "rle_decode")
COLUMNAR_DS_REQUIRED = ("unpack_mask",)
# the distributed legs (a world of one over NCCL) must launch the
# exchange's pack kernel
DIST_REQUIRED = ("exchange_pack",)
# the exchange sweep: SF1 lineitem's l_orderkey over 2, 4 and 8 ranks and
# the two stages of a 2 x 2 mesh, at a slack that fits and one that
# overflows (a tenth of the rows dead)
EXCHANGE_DESTS = (2, 4, 8)
EXCHANGE_SLACKS = (2.0, 0.8)
EXCHANGE_DEAD = 0.1
# the path whose largest call gives each kernel's numbers in the line
# (the decode kernels: the columnar path with their largest call)
LINE_PATH = {**{n: "nds_h" for n in H_REQUIRED},
             "partitioned_mn_join": "nds", "seg_scan": "nds",
             "last_of_group": "nds", "part_reduce_broadcast": "window",
             "exchange_pack": "dist_nds_h"}
# the bit-width sweep of the decode kernels: TPC-H's SF1 lineitem count
SWEEP_ROWS = 6_001_215
# float sums add in other orders in the kernel and its plain version
FLOAT_SUM_RTOL = 1e-9
# the distributed NDS leg's largest scale, a cut of depth: each exchange
# of two sharded sides doubles a side's capacity (the reference's
# static-shape contract), so the leg's memory and time grow faster than
# the single-device leg's (on an H100, q67 peaks near 42 GiB at SF0.2 and
# the leg takes about 100 s, a sixth of the whole smoke)
SF_DS_DIST = 0.2

# the window path: no NDS statement takes a whole-partition MIN/MAX or a
# running aggregate under the default RANGE frame; each is wrapped in an
# outer aggregate so that the result is small and deterministic
WINDOW_SQL = {
    "partition_minmax": (
        "select ss_store_sk, count(*) cnt, sum(pmn) smn, sum(pmx) smx "
        "from (select ss_store_sk, min(ss_net_paid) over (partition by "
        "ss_item_sk) pmn, max(ss_net_paid) over (partition by ss_item_sk) "
        "pmx from store_sales) w group by ss_store_sk order by ss_store_sk"),
    "running_sum_range": (
        "select ss_store_sk, count(*) cnt, sum(rq) srq, max(rq) mrq "
        "from (select ss_store_sk, sum(ss_quantity) over (partition by "
        "ss_item_sk order by ss_sold_date_sk) rq from store_sales) w "
        "group by ss_store_sk order by ss_store_sk"),
}


class SmokeError(RuntimeError):
    pass


def log(*args) -> None:
    print("[smoke]", *args, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi rc={out.returncode}"


# ------------------------------------------------------------ measuring

def time_ms(fn, dev, reps: int = 7, warm: int = 2) -> float:
    """Median time of one call: CUDA events on the card (each run ends
    in its event's synchronize), the host clock on the CPU."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def host_call_ms(fn, dev, reps: int = 7) -> float:
    """Median host time of one call up to its return, the card drained
    before each: what the wrapper costs the host (checks, allocation,
    the launch), apart from the kernel's own time."""
    import torch
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return statistics.median(times)


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def max_abs_err(got, exp) -> float:
    """0.0 when every output tensor equals the plain version's exactly
    (NaN equal to NaN); else the largest absolute difference."""
    import torch
    err = 0.0
    for a, b in zip(_tensors(got), _tensors(exp)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.dtype == torch.bool:
            err = max(err, float((a != b).sum().item()))
            continue
        same = (a == b)
        if a.dtype.is_floating_point:
            same = same | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            continue
        d = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(d[~same].max().item()) or float("inf"))
    return err


def within_float_sum_tol(got, exp) -> bool:
    """|got - exp| <= FLOAT_SUM_RTOL * max(1, |exp|) everywhere."""
    import torch
    d = (got.to(torch.float64) - exp.to(torch.float64)).abs()
    lim = FLOAT_SUM_RTOL * exp.to(torch.float64).abs().clamp_min(1.0)
    return bool((d <= lim).all())


def work_of(name: str, args, out) -> tuple:
    """(bytes the function must move, operations it does): each input
    read once, each output written once; the operations are one per
    row handled, and one compare per (probe row, build row) pair for
    the small-build probe."""
    tens = _tensors(list(args))
    moved = nbytes(tens) + nbytes(out)
    rows = sum(a.numel() for a in tens)
    ops = rows
    if name == "matmul_probe_join":
        ops = args[2].numel() * args[0].numel()
    if name == "partitioned_mn_join":
        # one step per input row and per output slot
        ops = rows + out[0].numel()
    if name in DECODE_KERNELS:
        # a few integer operations per output row
        ops = out.numel()
    if name == "exchange_pack":
        # a hash, a rank and a copy per row, a store per output slot
        ops = rows + sum(t.numel() for t in _tensors(out))
    return moved, ops


def bound(moved: int, ops: int) -> tuple:
    t_bytes = moved / HBM_BYTES_PER_S * 1000
    t_ops = ops / F32_OPS_PER_S * 1000
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same thing, timed as a yardstick
    only (the port never calls it); None where there is none."""
    import torch
    if name == "seg_reduce_at_ends":
        # grouped min/max by one scatter-reduce over the group ids
        op, data, gid, starts2 = args
        idx = gid.to(torch.int64)
        out = torch.empty(starts2.shape[0], dtype=data.dtype,
                          device=data.device)
        return lambda: out.scatter_reduce_(
            0, idx, data, "amin" if op == "min" else "amax",
            include_self=False)
    if name == "seg_scan" and args[0] == "sum":
        # the unsegmented running sum: the same function where no row
        # resets
        vals = args[1]
        return lambda: torch.cumsum(vals, 0)
    if name == "keyed_minmax_semi":
        bkey, bok, bval, _pk, _po, _pv, lo, dom = args
        idx = torch.where(bok, bkey.to(torch.int64) - lo,
                          torch.full_like(bkey, dom, dtype=torch.int64))
        tbl = torch.empty(dom + 1, dtype=bval.dtype, device=bval.device)
        return lambda: tbl.fill_(torch.iinfo(bval.dtype).max).scatter_reduce_(
            0, idx, bval, "amin", include_self=True)
    return None


def check_kernel(KX, name: str, args, label: str, dev,
                 kwargs=None) -> dict:
    """Kernel vs its plain version on the same inputs: exact equality
    required; times and bound of this call."""
    import torch
    kwargs = kwargs or {}
    fn = functools.partial(getattr(KX, name), **kwargs)
    plain = functools.partial(getattr(KX, name + "_plain"), **kwargs)
    got = fn(*args)
    t0 = time.perf_counter()
    exp = plain(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - t0
    err = max_abs_err(got, exp)
    float_sum = (name == "seg_scan" and args[0] == "sum"
                 and got.dtype.is_floating_point)
    if err != 0.0 and not (float_sum and within_float_sum_tol(got, exp)):
        raise SmokeError(f"{name} [{label}] differs from its plain "
                         f"version: max_abs_err={err}")
    ms = time_ms(lambda: fn(*args), dev)
    host_ms = host_call_ms(lambda: fn(*args), dev)
    # a plain version that takes seconds is timed once more, not four
    # times
    slow = plain_first_s > 1.0
    plain_ms = time_ms(lambda: plain(*args), dev, reps=1 if slow else 3,
                       warm=0 if slow else 1)
    lib = library_call(name, args)
    library_ms = time_ms(lib, dev) if lib is not None else None
    moved, ops = work_of(name, list(args) + list(kwargs.values()), got)
    bound_ms, bound_by = bound(moved, ops)
    shapes = [list(a.shape) + [str(a.dtype).replace("torch.", "")]
              for a in _tensors(list(args) + list(kwargs.values()))]
    rec = {"kernel": name, "case": label, "shapes": shapes,
           "size": call_size(name, args, kwargs),
           "max_abs_err": err, "ms": ms, "host_ms": host_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "bytes": moved, "ops": ops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(json.dumps(rec))
    return rec


# ------------------------------------------------------------------ data

def make_tables(suite: str, sf: float) -> dict:
    """The port's generator for one suite ("nds_h" or "nds")."""
    from nds_tpu_torch.io.host_table import from_arrays
    if suite == "nds_h":
        from nds_tpu_torch.datagen import tpch as gen
        from nds_tpu_torch.nds_h.schema import get_schemas
    else:
        from nds_tpu_torch.datagen import tpcds as gen
        from nds_tpu_torch.nds.schema import get_schemas
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], gen.gen_table(t, sf))
            for t in schemas}


def suite_units(suite: str) -> list:
    """[(unit name, [statement, ...]), ...] of one power run."""
    if suite == "nds_h":
        from nds_tpu_torch.nds_h import streams
        return [(str(qn), streams.statements(qn)) for qn in range(1, 23)]
    from nds_tpu_torch.nds import streams
    return streams.power_units()


def suite_session(suite: str, factory=None):
    from nds_tpu_torch.engine.session import Session
    return (Session.for_nds_h(factory) if suite == "nds_h"
            else Session.for_nds(factory))


def sf1_shape_cases(tables: dict, dev) -> list:
    """(kernel, args, label) at the SF1 shapes of the main path, built
    from the real key columns: int32 keys, as the executor narrows them
    when host bounds allow."""
    import numpy as np
    import torch

    def col(t, c):
        return tables[t].columns[c].values

    def dt(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    cases = []
    l_ok = dt(col("lineitem", "l_orderkey"))
    n_li = l_ok.shape[0]
    o_key = col("orders", "o_orderkey")
    l_key = col("lineitem", "l_orderkey")
    lo = int(min(o_key.min(), l_key.min()))
    dom = int(max(o_key.max(), l_key.max())) - lo + 1
    cases.append(("direct_lookup_join",
                  (dt(o_key), ones(len(o_key)), l_ok, ones(n_li), lo, dom),
                  f"orders {len(o_key)} <- lineitem {n_li}"))
    # the same join with int64 keys, as the executor passes keys whose
    # bounds do not fit int32
    cases.append(("direct_lookup_join",
                  (dt(o_key, torch.int64), ones(len(o_key)),
                   l_ok.to(torch.int64), ones(n_li), lo, dom),
                  f"orders {len(o_key)} <- lineitem {n_li}, int64 keys"))
    p_key = col("part", "p_partkey")
    l_pk = dt(col("lineitem", "l_partkey"))
    lo, hi = int(p_key.min()), int(p_key.max())
    cases.append(("direct_lookup_join",
                  (dt(p_key), ones(len(p_key)), l_pk, ones(n_li), lo,
                   hi - lo + 1), f"part {len(p_key)} <- lineitem {n_li}"))
    # the supplier's nation of every lineitem row, against nation (25)
    s_nat = col("supplier", "s_nationkey")
    l_sk = col("lineitem", "l_suppkey")
    s_key = col("supplier", "s_suppkey")
    l_nat = dt(s_nat[np.searchsorted(s_key, l_sk)])
    n_key = col("nation", "n_nationkey")
    cases.append(("matmul_probe_join",
                  (dt(n_key), ones(len(n_key)), l_nat, ones(n_li)),
                  f"nation {len(n_key)} <- lineitem {n_li}"))
    cases.append(("matmul_probe_join",
                  (dt(p_key[:256]), ones(256), l_pk, ones(n_li)),
                  f"part[:256] <- lineitem {n_li}"))
    # EXISTS orders of one year, probed by every lineitem row (q4 shape)
    o_date = col("orders", "o_orderdate")
    in_year = (o_date >= o_date.min() + 365) & (o_date < o_date.min() + 730)
    cases.append(("bitmask_semi",
                  (dt(o_key), dt(in_year, torch.bool), l_ok, ones(n_li), lo,
                   dom), f"orders {len(o_key)} (one year) <- lineitem {n_li}"))
    # q21: other supplier on the same order, lineitem against itself
    l_sk_t = dt(l_sk)
    late = dt(col("lineitem", "l_receiptdate")
              > col("lineitem", "l_commitdate"), torch.bool)
    cases.append(("keyed_minmax_semi",
                  (l_ok, late, l_sk_t, l_ok, ones(n_li), l_sk_t, lo, dom),
                  f"lineitem {n_li} <- lineitem {n_li}"))
    cases.append(("keyed_minmax_semi",
                  (l_ok, late, l_sk_t.to(torch.int64), l_ok, ones(n_li),
                   l_sk_t.to(torch.int64), lo, dom),
                  f"lineitem {n_li} <- lineitem {n_li}, int64 values"))
    # grouped min/max over n = 6.0M sorted rows at several group counts
    price = col("lineitem", "l_extendedprice")
    rng = np.random.default_rng(7)
    for G, vdtype, op in ((1, torch.int64, "max"), (7, torch.float64, "min"),
                          (200_000, torch.int64, "min"),
                          (1_500_000, torch.int32, "max")):
        G = min(G, n_li)
        cuts = np.sort(rng.choice(np.arange(1, n_li), size=G - 1,
                                  replace=False)) if G > 1 else []
        gid = np.zeros(n_li, dtype=np.int32)
        if G > 1:
            gid[cuts] = 1
            gid = np.cumsum(gid).astype(np.int32)
        starts2 = np.searchsorted(gid, np.arange(G, dtype=np.int32))
        data = dt(price, vdtype)
        cases.append(("seg_reduce_at_ends",
                      (op, data, dt(gid), dt(starts2, torch.int64)),
                      f"n={n_li} G={G} {str(vdtype)[6:]} {op}"))
    return cases


def decode_sweep_cases(dev) -> list:
    """(kernel, args, label) of the decode kernels over SWEEP_ROWS rows:
    every bit width into int32 (bias added in int32) and into int64 (bias
    added in int64) from random words, the mask unpack, and RLE at about
    four rows a run over the whole column and over a padded view."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    n = SWEEP_ROWS

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def words(count):
        return dt(rng.integers(-2**31, 2**31, count,
                               dtype=np.int64).astype(np.int32))

    cases = []
    for bits in (1, 2, 4, 8, 16, 32):
        w = words(n if bits == 32 else -(-n // (32 // bits)))
        cases.append(("bitpack_decode", (w, n, bits, -12345, torch.int32),
                      f"n={n} bits={bits} int32, int32 bias"))
        cases.append(("bitpack_decode",
                      (w, n, bits, -(2**40) - 3, torch.int64),
                      f"n={n} bits={bits} int64, int64 bias"))
    cases.append(("unpack_mask", (words(-(-n // 32)), n), f"n={n} mask"))
    steps = rng.random(n) < 0.25
    steps[0] = False
    vals = np.cumsum(steps).astype(np.int64) * 3 - 7
    starts = np.concatenate(
        [[0], np.nonzero(vals[1:] != vals[:-1])[0] + 1]).astype(np.int32)
    cases.append(("rle_decode", (dt(vals[starts]), dt(starts), n),
                  f"n={n} runs={len(starts)} int64"))
    # a padded view: the runs of the first three quarters of the rows,
    # decoded to a power-of-two capacity past the column's end
    k = int(np.searchsorted(starts, n * 3 // 4))
    cap = 1 << (n - 1).bit_length()
    cases.append(("rle_decode", (dt(vals[starts[:k]].astype(np.int32)),
                                 dt(starts[:k]), cap),
                  f"padded n={cap} live={n * 3 // 4} runs={k} int32"))
    return cases


# ------------------------------------------------------------- main path

def run_query(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    return result


def call_size(name: str, args, kwargs=None) -> int:
    """How large one kernel call is: its input elements, or for a decode
    the rows it writes."""
    if name in DECODE_KERNELS:
        return int(args[2] if name == "rle_decode" else args[1])
    return sum(a.numel() for a in _tensors(list(args)
                                           + list((kwargs or {}).values())))


def _cloned(x):
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_cloned(y) for y in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


class Recorder:
    """Wraps functions during an untimed pass: per name, its calls and a
    copy of the inputs of its largest call. ``targets`` maps a name to
    the (owner, attribute) of the function to wrap; a call's size is
    ``call_size``."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.calls: dict = {n: 0 for n in targets}
        self.largest: dict = {}
        self.saved: dict = {}

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            raw = owner.__dict__[attr]
            self.saved[name] = raw
            static = isinstance(raw, staticmethod)
            fn = self._wrap(name, raw.__func__ if static else raw)
            setattr(owner, attr, staticmethod(fn) if static else fn)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.saved[name])

    def function(self, name):
        raw = self.saved[name]
        return raw.__func__ if isinstance(raw, staticmethod) else raw

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            self.calls[name] += 1
            size = call_size(name, args, kwargs)
            cur = self.largest.get(name)
            if cur is None or size > cur[0]:
                self.largest[name] = (size, _cloned(args), _cloned(kwargs))
            return fn(*args, **kwargs)
        return wrapper


def kernel_targets(KX) -> dict:
    """The kernel wrappers, for a ``Recorder``."""
    return {n: (KX, n) for n in KERNELS}


# the executor's library steps, L1-L3 of PERF.md's kernel table: torch
# ops, not hand kernels. The raw legs count each pure step's calls in
# their untimed pass (the plans fix them: the timed pass makes the same)
# and time its largest call
LIBRARY_STEPS = {
    # name: (row, owner of the function, attribute)
    "compact_perm": ("L1", "module", "_compact_perm"),
    "lexsort": ("L2, L3", "module", "_lexsort"),
    "seg_sum": ("L2", "trace", "_seg_sum"),
    "build_lookup": ("L3", "trace", "_build_lookup"),
    "probe": ("L3", "trace", "_probe"),
}


def library_targets() -> dict:
    """The executor's library steps, for a ``Recorder``."""
    from nds_tpu_torch.engine import device_exec as dx
    owners = {"module": dx, "trace": dx._Trace}
    return {name: (owners[where], attr)
            for name, (_row, where, attr) in LIBRARY_STEPS.items()}


def library_step_checks(lib: Recorder, label: str, dev) -> list:
    """Each library step's largest call timed on the card (CUDA events,
    median of 7), with the bytes it must move and their bound."""
    out = []
    for name, (row, _where, _attr) in LIBRARY_STEPS.items():
        if name not in lib.largest:
            continue
        args = lib.largest[name][1]
        fn = lib.function(name)
        res = fn(*args)
        moved = nbytes(list(args)) + nbytes(res)
        bound_ms, bound_by = bound(moved, sum(
            t.numel() for t in _tensors(list(args))))
        rec = {"step": name, "row": row, "path": label,
               "calls": lib.calls[name],
               "shapes": [list(t.shape) + [str(t.dtype).replace("torch.", "")]
                          for t in _tensors(list(args))],
               "library_ms": time_ms(lambda: fn(*args), dev),
               "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by}
        log(json.dumps(rec))
        out.append(rec)
    return out


def profile_pass(dsess, units, dev, per_unit, label) -> dict:
    """One more pass of the units under torch.profiler. Each unit ends in
    its device->host copy, so the device work a unit launched runs inside
    its host range: per unit, the time the card spent in kernels and
    copies that started in that range. The busy share is that device time
    over the timed pass's wall clock (the profiler slows the host, not the
    card); the kernels that hold the card longest are listed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for name, stmts in units:
            with record_function(f"unit:{name}"):
                run_query(dsess, stmts)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ranges, work = {}, []
    for ev in prof.events():
        on_dev = ev.device_type == DeviceType.CUDA
        if ev.name.startswith("unit:"):
            if not on_dev:
                ranges[ev.name[5:]] = (ev.time_range.start,
                                       ev.time_range.end)
            continue
        if on_dev:
            work.append((ev.time_range.start,
                         ev.time_range.elapsed_us() / 1000, ev.name))
    work.sort()
    starts = [t for t, _ms, _n in work]
    by_unit = {}
    import bisect
    for name, (s0, e0) in ranges.items():
        lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_left(starts,
                                                                    e0)
        by_unit[name] = sum(ms for _t, ms, _n in work[lo:hi])
    by_name: dict = {}
    for _t, ms, name in work:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # where the host spends its time: operators by their own CPU time
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:12]
    device_ms = sum(by_unit.values())
    wall_ms = sum(per_unit[n]["wall_ms"] for n, _ in units)
    out = {"device_ms": device_ms, "timed_wall_ms": wall_ms,
           "profiled_wall_ms": sum((e - s) / 1000
                                   for s, e in ranges.values()),
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "device_launches": len(work),
           "top_device_kernels": [{"kernel": k[:160], "ms": ms, "count": c}
                                  for k, (ms, c) in top],
           "top_host_ops": [{"op": e.key[:120],
                             "self_cpu_ms": e.self_cpu_time_total / 1000,
                             "count": e.count} for e in host_ops]}
    for name, _ in units:
        per_unit[name]["profiled_device_ms"] = by_unit.get(name)
    log(json.dumps({"phase": f"{label} profile", **out}))
    return out


# the tables of both legs, set before the oracle workers are forked:
# the workers inherit them and never touch the card
_ORACLE_TABLES: dict = {}
# one CPU oracle process per core, at most 8 (a one-card machine has 8)
ORACLE_WORKERS = min(8, os.cpu_count() or 1)
# a worker's CPU oracle session per suite, made at its first task
_ORACLE_SESSIONS: dict = {}


def _oracle_unit(task: tuple) -> tuple:
    """In a forked worker: run one unit on the CPU oracle and compare
    with the card's result frame; the oracle's frame goes back too, for
    the columnar legs."""
    suite, name, stmts, got, rules = task
    sess = _ORACLE_SESSIONS.get(suite)
    if sess is None:
        sess = suite_session(suite)
        for t in _ORACLE_TABLES[suite].values():
            sess.register_table(t)
        _ORACLE_SESSIONS[suite] = sess
    t0 = time.perf_counter()
    try:
        exp = run_query(sess, stmts).to_pandas()
    except Exception as exc:  # noqa: BLE001 - reported as a mismatch
        return name, f"oracle failed: {type(exc).__name__}: {exc}", None, \
            None
    ms = (time.perf_counter() - t0) * 1000
    return name, unit_mismatch(got, exp, name, rules), ms, exp


def unit_mismatch(got, exp, name: str, rules: str):
    """None when the card's frame matches the oracle's under the rules
    of "nds_h", "nds" (the validator's carve-outs) or "window" (plain
    rules, and rows required); else why not."""
    from nds_tpu_torch.nds.validate import unit_differs
    from nds_tpu_torch.utils.validate_core import frames_equal
    why = (unit_differs(got, exp, name) if rules == "nds"
           else frames_equal(got, exp))
    if why is None and rules == "window" and not len(exp):
        why = "no rows"
    return why


# the oracle's frame per (suite, unit), from the raw legs' checks: the
# columnar legs run the same statements over the same tables
ORACLE_ANSWERS: dict = {}


def oracle_check(pool, suite, units, results, per_unit,
                 rules: str) -> tuple:
    """Every unit's card result against the port's CPU oracle, in the
    worker pool, under the rules of "nds_h", "nds" (the validator's
    carve-outs) or "window" (plain rules, and rows required). Returns
    (mismatches, seconds)."""
    t0 = time.perf_counter()
    tasks = [(suite, name, stmts, results[name].to_pandas(), rules)
             for name, stmts in units]
    bad = []
    for name, why, ms, exp in pool.imap_unordered(_oracle_unit, tasks):
        per_unit[name]["cpu_oracle_ms"] = ms
        per_unit[name]["match"] = why is None
        if exp is not None:
            ORACLE_ANSWERS[(suite, name)] = exp
        if why is not None:
            bad.append(f"{suite} {name}: {why}")
    return bad, time.perf_counter() - t0


def answers_check(suite, units, results, per_unit, rules: str) -> tuple:
    """Every unit's card result against the oracle's frame that the raw
    leg's check kept for the same tables and statement. Returns
    (mismatches, seconds)."""
    t0 = time.perf_counter()
    bad = []
    for name, _stmts in units:
        exp = ORACLE_ANSWERS.get((suite, name))
        why = ("no oracle answer kept" if exp is None else
               unit_mismatch(results[name].to_pandas(), exp, name, rules))
        per_unit[name]["match"] = why is None
        if why is not None:
            bad.append(f"{suite} {name}: {why}")
    return bad, time.perf_counter() - t0


def gc_collections() -> list:
    """The garbage collector's collections so far, per generation."""
    import gc
    return [g["collections"] for g in gc.get_stats()]


def timed_pass(dsess, ex, units, dev) -> tuple:
    """Each unit once, timed on the host clock to its synchronize."""
    import torch
    per_unit, results = {}, {}
    for name, stmts in units:
        t0 = time.perf_counter()
        res = run_query(dsess, stmts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        results[name] = res
        lt = ex.last_timings
        per_unit[name] = {"wall_ms": ms,
                          "execute_ms": lt.get("execute_ms"),
                          "materialize_ms": lt.get("materialize_ms"),
                          "slack_retries": lt.get("slack_retries"),
                          "staged_programs": lt.get("staged_programs"),
                          "kernels": lt.get("__kernels"),
                          "bytes_scanned": lt.get("bytes_scanned"),
                          "bytes_scanned_raw": lt.get("bytes_scanned_raw"),
                          "compression_ratio": lt.get("compression_ratio"),
                          "rows": res.nrows}
    return per_unit, results


def kernel_checks(KX, rec, label, dev, only=KERNELS) -> dict:
    """Each kernel of ``only`` the untimed pass called, against its plain
    version on its largest captured call."""
    out = {}
    for name in only:
        if name in rec.largest:
            _size, args, kwargs = rec.largest[name]
            out[name] = check_kernel(KX, name, args, f"{label} main path",
                                     dev, kwargs)
    return out


def resident_bytes(ex) -> int:
    """Bytes of the executor's pooled scan buffers on the card."""
    return sum(t.numel() * t.element_size() for t in ex._buffers.values())


def rules_of(suite: str) -> str:
    """The validator rules of a suite's results ("nds_dist" is NDS)."""
    return "nds_h" if suite == "nds_h" else "nds"


def run_leg(suite, KX, factory_of, dev, pool, record, path=None,
            raw=None, check_names=None, required=None,
            same_kernels=True) -> tuple:
    """One power run on the card over the suite's generated tables: the
    untimed pass with its captured kernel calls, the kernel checks, the
    timed pass with launch counts read, the profiled pass and the oracle
    check. ``path`` names the run in the record (the suite by default);
    a run of the same statements over the same tables as an earlier one
    (a columnar run, a distributed run) passes that run as ``raw``: its
    results are checked against the oracle frames that run's check kept,
    and, with ``same_kernels``, each unit's kernel block must equal that
    run's. ``check_names`` lists the kernels held against their plain
    versions on their largest captured calls (every kernel, or the decodes
    when ``raw`` is given); the timed pass must launch every kernel the
    untimed pass called and those of ``required`` (the suite's own set by
    default)."""
    import torch
    path = path or suite
    tables = _ORACLE_TABLES[suite]
    factory = factory_of()
    dsess = suite_session(suite, factory)
    for t in tables.values():
        dsess.register_table(t)
    units = suite_units(suite)

    # untimed pass: uploads, host-side planning, captured kernel inputs;
    # each unit's time and peak device memory logged as it ends
    t0 = time.perf_counter()
    warm_peaks = {}
    with Recorder(kernel_targets(KX)) as rec, \
            Recorder(library_targets()) as lib:
        for name, stmts in units:
            t1 = time.perf_counter()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            run_query(dsess, stmts)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                warm_peaks[name] = torch.cuda.max_memory_allocated()
            log(f"warm {path} {name} {time.perf_counter() - t1:.2f}s "
                f"peak {warm_peaks.get(name, 0) / 2**30:.2f} GiB")
    warm_s = time.perf_counter() - t0
    log(json.dumps({"phase": f"{path} warm pass", "seconds": warm_s,
                    "kernel_calls": rec.calls}))
    # a columnar run makes the raw run's K1-K7 calls on the same inputs
    # (the decode is exact), checked there: here only the decodes
    if check_names is None:
        check_names = KERNELS if raw is None else DECODE_KERNELS
    main_cases = kernel_checks(KX, rec, path, dev, check_names)
    checks = list(main_cases.values())
    called = [n for n, c in rec.calls.items() if c > 0]
    del rec
    # the library steps (L1-L3) on the single-device legs
    library_steps = (library_step_checks(lib, path, dev)
                     if path in ("nds_h", "nds") else [])
    del lib
    if suite == "nds_h" and raw is None:
        for name, kargs, label in sf1_shape_cases(tables, dev):
            checks.append(check_kernel(KX, name, kargs, label, dev))

    checks_s = time.perf_counter() - t0 - warm_s

    # the timed run: counts at 0, every unit once, counts read
    ex = factory(dsess.tables)
    KX.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc0 = gc_collections()
    per_unit, results = timed_pass(dsess, ex, units, dev)
    launches = KX.launch_counts()
    gcs = [b - a for a, b in zip(gc0, gc_collections())]
    power_ms = sum(u["wall_ms"] for u in per_unit.values())
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    resident = resident_bytes(ex)
    t1 = time.perf_counter()
    profile = profile_pass(dsess, units, dev, per_unit, path)
    profile_s = time.perf_counter() - t1

    if raw is None:
        bad, oracle_s = oracle_check(pool, suite, units, results, per_unit,
                                     rules=rules_of(suite))
    else:
        bad, oracle_s = answers_check(suite, units, results, per_unit,
                                      rules=rules_of(suite))
        for name, _ in units:
            if not same_kernels:
                break
            if per_unit[name]["kernels"] != raw["per_unit"][name]["kernels"]:
                bad.append(f"{path} {name}: kernel block "
                           f"{per_unit[name]['kernels']} != mode off "
                           f"{raw['per_unit'][name]['kernels']}")
    for name, _ in units:
        log(json.dumps({"suite": path, "unit": name, **per_unit[name]}))
    scanned = sum(u["bytes_scanned"] or 0 for u in per_unit.values())
    scanned_raw = sum(u["bytes_scanned_raw"] or u["bytes_scanned"] or 0
                      for u in per_unit.values())
    leg = {"warm_pass_s": warm_s, "checks_s": checks_s,
           "profile_s": profile_s, "leg_s": time.perf_counter() - t0,
           "power_total_ms": power_ms, "launches": launches,
           "peak_device_bytes": peak, "oracle_s": oracle_s,
           "resident_buffer_bytes": resident, "gc_collections": gcs,
           "bytes_scanned": scanned, "bytes_scanned_raw": scanned_raw,
           "compression_ratio": scanned_raw / scanned if scanned else None,
           "profile": profile, "kernel_checks": checks,
           "per_unit": per_unit, "called_in_warm_pass": called,
           "library_steps": library_steps,
           "warm_peak_device_bytes": warm_peaks,
           "mismatches": bad}
    record[path] = leg
    log(json.dumps({"phase": f"{path} main path",
                    "units": len(units), "power_total_ms": power_ms,
                    "launches": launches, "peak_device_bytes": peak,
                    "resident_buffer_bytes": resident,
                    "bytes_scanned": scanned,
                    "oracle_s": oracle_s, "mismatches": len(bad)}))
    if bad:
        raise SmokeError("results differ from the CPU oracle: "
                         + "; ".join(bad))
    if required is None:
        required = H_REQUIRED if suite == "nds_h" else DS_REQUIRED
    required = set(called) | set(required)
    missing = sorted(n for n in required if launches.get(n, 0) <= 0)
    if missing:
        raise SmokeError(f"the timed {path} run launched no {missing}")
    leg["main_cases"] = main_cases
    return leg, dsess


def run_window_path(KX, dsess, dev, pool, record) -> dict:
    """The window forms no NDS statement takes, over the NDS leg's
    store_sales on the card session: kernels checked on the captured
    calls, a timed run with counts read, results against the oracle."""
    units = [(name, [sql]) for name, sql in WINDOW_SQL.items()]
    with Recorder(kernel_targets(KX)) as rec:
        for _name, stmts in units:
            run_query(dsess, stmts)
    main_cases = kernel_checks(KX, rec, "window", dev)
    del rec
    ex = dsess._executor_factory(dsess.tables)
    KX.reset_launches()
    per_unit, results = timed_pass(dsess, ex, units, dev)
    launches = KX.launch_counts()
    bad, _s = oracle_check(pool, "nds", units, results, per_unit,
                           rules="window")
    for name, _ in units:
        per_unit[name]["result"] = results[name].to_pandas().to_dict(
            orient="list")
        log(json.dumps({"suite": "window", "unit": name, **{
            k: v for k, v in per_unit[name].items() if k != "result"}}))
    out = {"launches": launches, "per_unit": per_unit,
           "kernel_checks": list(main_cases.values()), "mismatches": bad}
    record["window"] = out
    log(json.dumps({"phase": "window path", "launches": launches,
                    "mismatches": len(bad)}))
    if bad:
        raise SmokeError("; ".join(bad))
    missing = [n for n in WINDOW_REQUIRED if launches.get(n, 0) <= 0]
    if missing:
        raise SmokeError(f"the window path launched no {missing}")
    out["main_cases"] = main_cases
    return out


def release(dev) -> None:
    """Free what the executors a leg dropped held on the card."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def power_pass(suite, factory_of, dev, mode: str) -> dict:
    """A fresh executor of the suite under columnar ``mode``: one
    untimed pass, then the timed pass; its power total and the garbage
    collections during it."""
    from nds_tpu_torch import columnar
    columnar.set_mode(mode)
    try:
        factory = factory_of()
        dsess = suite_session(suite, factory)
        for t in _ORACLE_TABLES[suite].values():
            dsess.register_table(t)
        units = suite_units(suite)
        for _name, stmts in units:
            run_query(dsess, stmts)
        gc0 = gc_collections()
        per_unit, _results = timed_pass(dsess, factory(dsess.tables), units,
                                        dev)
        out = {"mode": mode, "power_total_ms": sum(
            u["wall_ms"] for u in per_unit.values()),
            "gc_collections": [b - a for a, b in zip(gc0,
                                                     gc_collections())]}
    finally:
        columnar.set_mode(None)
    del dsess, factory
    release(dev)
    log(json.dumps({"phase": f"{suite} power pass", **out}))
    return out


def run_columnar(KX, factory_of, dev, pool, record, paths) -> None:
    """The columnar phase: both legs under ``columnar.set_mode("auto")``
    through fresh executors, each checked against the raw legs' oracle
    frames and kernel blocks; the decode kernels checked at their
    largest captured calls and over the bit-width sweep; launches of
    ``bitpack_decode`` and ``rle_decode`` required in the timed passes
    and of ``unpack_mask`` in the NDS pass (a forced-``rle`` NDS-H pass
    is added where ``auto`` picks no RLE on either leg)."""
    from nds_tpu_torch import columnar
    t0 = time.perf_counter()
    legs = [("nds_h", "columnar_nds_h"), ("nds", "columnar_nds")]
    columnar.set_mode("auto")
    try:
        for suite, path in legs:
            paths[path], dsess = run_leg(suite, KX, factory_of, dev, pool,
                                         record, path=path,
                                         raw=paths[suite])
            del dsess
            release(dev)
        if not any(paths[p]["launches"].get("rle_decode", 0)
                   for _s, p in legs):
            log("auto picked no RLE on either leg: a forced-rle NDS-H pass")
            columnar.set_mode("rle")
            legs.append(("nds_h", "columnar_rle_nds_h"))
            paths["columnar_rle_nds_h"], dsess = run_leg(
                "nds_h", KX, factory_of, dev, pool, record,
                path="columnar_rle_nds_h", raw=paths["nds_h"])
            del dsess
            release(dev)
    finally:
        columnar.set_mode(None)
    # the power totals in turns on this card: mode off (the raw leg),
    # auto (the columnar leg), then auto and mode off once more
    turns = {suite: [paths[suite]["power_total_ms"],
                     paths[path]["power_total_ms"]]
             + [power_pass(suite, factory_of, dev, m)["power_total_ms"]
                for m in ("auto", "off")]
             for suite, path in legs[:2]}
    sweep = [check_kernel(KX, name, kargs, label, dev)
             for name, kargs, label in decode_sweep_cases(dev)]
    paths["decode_sweep"] = {"launches": {}, "kernel_checks": sweep,
                             "main_cases": {}}
    launched = {n: sum(paths[p]["launches"].get(n, 0) for _s, p in legs)
                for n in DECODE_KERNELS}
    missing = [n for n in ("bitpack_decode", "rle_decode")
               if not launched[n]]
    missing += [n for n in COLUMNAR_DS_REQUIRED
                if not paths["columnar_nds"]["launches"].get(n, 0)]
    summary = {"phase": "columnar", "seconds": time.perf_counter() - t0,
               "decode_launches": launched}
    for suite, path in legs:
        on, off = paths[path], paths[suite]
        summary[path] = {
            "power_total_ms": on["power_total_ms"],
            "power_total_ms_mode_off": off["power_total_ms"],
            "power_total_ms_turns_off_auto_auto_off": turns.get(suite),
            "gc_collections": on["gc_collections"],
            "gc_collections_mode_off": off["gc_collections"],
            "device_busy_share": on["profile"]["device_busy_share"],
            "device_busy_share_mode_off": off["profile"]["device_busy_share"],
            "peak_device_bytes": on["peak_device_bytes"],
            "peak_device_bytes_mode_off": off["peak_device_bytes"],
            "bytes_scanned": on["bytes_scanned"],
            "bytes_scanned_mode_off": off["bytes_scanned"],
            "bytes_scanned_raw": on["bytes_scanned_raw"],
            "compression_ratio": on["compression_ratio"],
            "resident_buffer_bytes": on["resident_buffer_bytes"],
            "resident_buffer_bytes_mode_off": off["resident_buffer_bytes"]}
    record["columnar"] = summary
    log(json.dumps(summary))
    if missing:
        raise SmokeError(f"the timed columnar runs launched no {missing}")


# ---------------------------------------------------- distributed phase

def _received(packs: list, j: int):
    """Rank ``j``'s receive buffers of one all-to-all among the ranks
    whose send packs are ``packs`` (in rank order): chunk ``j`` of every
    sender's buffers, in sender order."""
    import torch
    size = len(packs)
    bufs = [torch.cat([pk[0][p].reshape(size, -1)[j] for pk in packs])
            for p in range(len(packs[0][0]))]
    ok = torch.cat([pk[1].reshape(size, -1)[j] for pk in packs])
    return bufs, ok


def _delivered(KX, received: list, rank_of, ok_all, modulus: int,
               div: int, world: int, lost: int, label: str) -> dict:
    """Every valid row arrives once (or was counted as dropped), at the
    rank its key hashes to. Payload 0 is the global row id, payload 1
    the key."""
    import torch
    ids = []
    for j, (bufs, ok) in enumerate(received):
        rid, key = bufs[0][ok], bufs[1][ok]
        dest = KX._exchange_dest_plain(key, None, world, modulus, div)
        if not bool((dest == rank_of(j)).all()):
            raise SmokeError(f"exchange {label}: rank {j} received rows "
                             f"of another rank's keys")
        ids.append(rid)
    ids = torch.cat(ids)
    n_ok = int(ok_all.sum())
    if ids.numel() != n_ok - lost:
        raise SmokeError(f"exchange {label}: {ids.numel()} rows arrived, "
                         f"{n_ok} valid, {lost} dropped")
    if torch.unique(ids).numel() != ids.numel():
        raise SmokeError(f"exchange {label}: a row arrived twice")
    if not bool(ok_all.index_select(0, ids).all()):
        raise SmokeError(f"exchange {label}: a dead row arrived")
    return {"case": label, "arrived": ids.numel(), "valid": n_ok,
            "dropped": lost}


def exchange_sweep(KX, tables: dict, dev) -> tuple:
    """``exchange_pack`` over SF1 lineitem's ``l_orderkey`` (a tenth of
    the rows dead), laid out over 2, 4 and 8 ranks as the executor
    shards it, and over the two stages of a 2 x 2 mesh, at a slack that
    fits and one that overflows. Every rank's pack must equal the plain
    version's exactly (the first rank's call timed); the buckets,
    transposed in this process as the all-to-all moves them, must
    deliver every valid row once (or count it dropped), each at the
    rank its key hashes to. Returns (checks, deliveries)."""
    import numpy as np
    import torch
    from nds_tpu_torch.parallel.dist_exec import shard_of
    li = tables["lineitem"]
    key = li.columns["l_orderkey"].values
    n = len(key)
    rng = np.random.default_rng(31)
    ok = rng.random(n) >= EXCHANGE_DEAD
    cols = [np.arange(n, dtype=np.int64), key,
            li.columns["l_linenumber"].values,
            li.columns["l_extendedprice"].values.astype(np.float64) / 100,
            rng.random(n) < 0.5]
    ok_all = torch.as_tensor(ok).to(dev)
    checks, deliveries = [], []

    def shards(world):
        return [([torch.as_tensor(shard_of(c, r, world)).to(dev)
                  for c in cols],
                 torch.as_tensor(shard_of(ok, r, world)).to(dev))
                for r in range(world)]

    def pack(pays, okr, n_dev, bucket, label, timed, **route):
        args = (pays, okr, n_dev, bucket)
        if timed:
            checks.append(check_kernel(KX, "exchange_pack", args, label, dev,
                                       route))
        got = KX.exchange_pack(*args, **route)
        exp = KX.exchange_pack_plain(*args, **route)
        err = max_abs_err(got, exp)
        if err != 0.0:
            raise SmokeError(f"exchange_pack [{label}] differs from its "
                             f"plain version: max_abs_err={err}")
        return got

    for world in EXCHANGE_DESTS:
        parts = shards(world)
        local = parts[0][1].shape[0]
        for slack in EXCHANGE_SLACKS:
            bucket = max(1, int(-(-local * slack // world)))
            label = f"{n} rows over {world} ranks, slack {slack}"
            packs = [pack(p, o, world, bucket, f"{label}, rank {r}", r == 0,
                          key=p[1])
                     for r, (p, o) in enumerate(parts)]
            lost = sum(int(pk[2]) for pk in packs)
            if (slack < 1) != (lost > 0):
                raise SmokeError(f"exchange {label}: {lost} rows dropped")
            deliveries.append(_delivered(
                KX, [_received(packs, j) for j in range(world)],
                lambda j: j, ok_all, world, 1, world, lost, label))
    # a 2 x 2 mesh: rank r = (host r // 2, lane r % 2)
    H = L = 2
    parts = shards(H * L)
    local = parts[0][1].shape[0]
    for slack in EXCHANGE_SLACKS:
        bucket = max(1, int(-(-local * slack // H)))
        label = f"{n} rows over 2 x 2 ranks, slack {slack}"
        stage1 = [pack(p, o, H, bucket, f"{label}, stage 1, rank {r}",
                       r == 0, key=p[1], modulus=H * L, div=L)
                  for r, (p, o) in enumerate(parts)]
        # stage 1 moves along the host axis: ranks of one lane
        got1 = [_received([stage1[h * L + r % L] for h in range(H)], r // L)
                for r in range(H * L)]
        bucket2 = max(1, int(-(-local * slack // L)))
        stage2 = [pack(b, o, L, bucket2, f"{label}, stage 2, rank {r}",
                       r == 0, key=b[1], modulus=H * L)
                  for r, (b, o) in enumerate(got1)]
        got2 = [_received([stage2[(r // L) * L + ln] for ln in range(L)],
                          r % L) for r in range(H * L)]
        lost = sum(int(pk[2]) for pk in stage1 + stage2)
        if (slack < 1) != (lost > 0):
            raise SmokeError(f"exchange {label}: {lost} rows dropped")
        deliveries.append(_delivered(KX, got2, lambda j: j, ok_all, H * L,
                                     1, H * L, lost, label))
    for d in deliveries:
        log(json.dumps({"phase": "exchange delivery", **d}))
    return checks, deliveries


def run_distributed(KX, dev, pool, record, paths) -> None:
    """The distributed phase: a world of one rank (NCCL on the card)
    and ``make_distributed_factory`` over it. The NDS-H leg at the raw
    leg's scale, its results checked against the oracle frames the raw
    leg kept and its kernels (the exchange's pack among them) against
    their plain versions on their largest calls; the exchange sweep; the
    NDS leg at its cut scale, every kernel checked on its largest call
    there and the results against the CPU oracle."""
    import torch.distributed as dist
    from nds_tpu_torch.parallel.dist_exec import make_distributed_factory
    from nds_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    device = None if dev.type == "cuda" else "cpu"
    mesh = make_mesh(1, device=device)
    world = {"backend": dist.get_backend(), "ranks": mesh.size,
             "rank": mesh.rank}
    log(json.dumps({"phase": "distributed world", **world}))

    def factory_of():
        return make_distributed_factory(mesh=mesh, device=device)

    paths["dist_nds_h"], dsess = run_leg(
        "nds_h", KX, factory_of, dev, pool, record, path="dist_nds_h",
        raw=paths["nds_h"], check_names=KERNELS, required=DIST_REQUIRED,
        same_kernels=False)
    del dsess
    release(dev)
    t1 = time.perf_counter()
    checks, deliveries = exchange_sweep(KX, _ORACLE_TABLES["nds_h"], dev)
    paths["exchange_sweep"] = {"launches": {}, "kernel_checks": checks,
                               "main_cases": {}}
    record["exchange_sweep"] = {"seconds": time.perf_counter() - t1,
                                "kernel_checks": checks,
                                "deliveries": deliveries}
    paths["dist_nds"], dsess = run_leg(
        "nds_dist", KX, factory_of, dev, pool, record, path="dist_nds",
        check_names=KERNELS, required=DIST_REQUIRED)
    del dsess
    release(dev)
    summary = {"phase": "distributed", "world": world,
               "seconds": time.perf_counter() - t0}
    for path, single in (("dist_nds_h", "nds_h"), ("dist_nds", None)):
        leg = paths[path]
        summary[path] = {
            "power_total_ms": leg["power_total_ms"],
            "power_total_ms_single_device": (
                paths[single]["power_total_ms"] if single else None),
            "device_busy_share": leg["profile"]["device_busy_share"],
            "peak_device_bytes": leg["peak_device_bytes"],
            "exchange_launches": leg["launches"].get("exchange_pack", 0),
            "slack_retries": sum(u["slack_retries"] or 0
                                 for u in leg["per_unit"].values())}
    record["distributed"] = summary
    log(json.dumps(summary))


def kernels_line(paths: dict) -> list:
    """One entry per kernel wrapper: launches summed over the timed runs
    of the paths (each read between its own reset and its end), the
    numbers of its largest call on the path that runs it, the largest
    error over every check of it."""
    line = []
    for name, (source, replaces) in KERNELS.items():
        if name in LINE_PATH:
            where = LINE_PATH[name]
            r = paths[where]["main_cases"].get(name)
        else:
            # the columnar path that made the kernel's largest call
            found = [(p["main_cases"][name]["size"], key)
                     for key, p in paths.items()
                     if name in p.get("main_cases", {})]
            where = max(found)[1] if found else "columnar"
            r = paths[where]["main_cases"][name] if found else None
        if r is None:
            raise SmokeError(f"no check of {name} on the {where} path")
        errs = [c["max_abs_err"] for p in paths.values()
                for c in p["kernel_checks"] if c["kernel"] == name]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"].get(name, 0)
                            for p in paths.values()),
            "max_abs_err": max(errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="NDS-H scale factor")
    ap.add_argument("--sf-ds", type=float, default=1.0,
                    help="NDS scale factor")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the full record here as JSON")
    args = ap.parse_args()

    import torch
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[smoke] no CUDA device: the port's main path runs on the "
              "card", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nds_tpu_torch.engine import cuda_build
    from nds_tpu_torch.engine import kernels as KX
    from nds_tpu_torch.engine.device_exec import make_device_factory

    def factory_of():
        return make_device_factory(device=None if dev.type == "cuda"
                                   else args.device)

    sf_ds_dist = min(args.sf_ds, SF_DS_DIST)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "sf": args.sf,
              "sf_ds": args.sf_ds, "sf_ds_dist": sf_ds_dist}
    t_start = time.perf_counter()
    # both legs' data first, then the oracle workers, forked before the
    # card is touched: they inherit the tables and only run numpy
    for suite, sf in (("nds_h", args.sf), ("nds", args.sf_ds),
                      ("nds_dist", sf_ds_dist)):
        t0 = time.perf_counter()
        tables = make_tables(suite, sf)
        _ORACLE_TABLES[suite] = tables
        record[f"{suite}_datagen_s"] = time.perf_counter() - t0
        log(json.dumps({"phase": f"{suite} datagen", "sf": sf,
                        "seconds": record[f"{suite}_datagen_s"],
                        "rows": {t: tables[t].nrows for t in tables}}))
    pool = multiprocessing.get_context("fork").Pool(ORACLE_WORKERS)
    try:
        if dev.type == "cuda":
            t0 = time.perf_counter()
            built = cuda_build.build_all()
            for name in cuda_build.SIGNATURES:
                cuda_build.library(name)
            record["build_s"] = time.perf_counter() - t0
            log(json.dumps({"phase": "build", "seconds": record["build_s"],
                            "built": built}))
        paths = {}
        paths["nds_h"], dsess = run_leg("nds_h", KX, factory_of, dev, pool,
                                        record)
        del dsess
        release(dev)
        run_distributed(KX, dev, pool, record, paths)
        paths["nds"], dsess = run_leg("nds", KX, factory_of, dev, pool,
                                      record)
        paths["window"] = run_window_path(KX, dsess, dev, pool, record)
        # the raw executors go before the columnar legs start, so that
        # raw and encoded buffers are never resident together
        del dsess
        release(dev)
        run_columnar(KX, factory_of, dev, pool, record, paths)
        line = kernels_line(paths)
        record["kernels"] = line
        pool.close()
    finally:
        pool.terminate()
        pool.join()
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        record["total_s"] = time.perf_counter() - t_start
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
    log(json.dumps({"phase": "done", "total_s": record["total_s"]}))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
