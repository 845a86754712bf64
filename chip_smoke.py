#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the NDS-H and NDS power runs on one card.

    python3 chip_smoke.py [--sf 1.0] [--sf-ds 1.0] [--out results/smoke.json]
                          [--parent DIR] [--steps STEP[,STEP]]
    python3 chip_smoke.py --steps power,bench --out results/power.json

Drives ``nds_tpu_torch`` (never ``jax``, never ``nds_tpu``) on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; exits 2 without a CUDA device;
2. generates both legs' data with the port's generators, then forks the
   pool of CPU oracle workers (one per core, at most 8), before the card
   is touched: the workers inherit the tables and run only numpy;
3. builds the CUDA C++ kernels from ``nds_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once); the graph case: each look-back
   layout, ``partition_sort``, a multi-key sort of four words (an
   operand straddling two at an odd bit, each word's digit counts from
   its pack), L2's chain (the pack with its counts, the sort given
   them, the group bounds), K1, K3 and K4 (their builds and probes
   launched as programmatic dependents), K2, K9, K8's mask unpack and
   the compactor (its counts' look-back words, its write pass a dependent
   launch) captured
   in a CUDA graph and replayed three times with new inputs, exact;
4. NDS-H leg at ``--sf`` (default SF1, ``bench.py``'s scale):
   ``Session.for_nds_h(make_device_factory())`` on ``cuda``;
   an untimed pass of the 22 queries, eager, captures each kernel's
   largest call;
   every kernel runs against its plain PyTorch version on those inputs
   and at the main path's join shapes built from the real columns
   (probe 6,001,215 rows at SF1; builds of 1,500,000, 200,000, 25 and 256
   rows; the segmented scan at several group counts) and K1 and K2 on
   adversarial inputs (``join_adversarial_cases``, exact; K2's table
   size held to its plain mirror's for every build size), K3 and the
   compactor on theirs (``semi_compact_case_makers``), K4 and K9 on
   theirs (``minmax_rle_case_makers``) and K8's mask unpack on its
   (``mask_case_makers``); a warm pass that captures each plan's CUDA
   graph after its eager run (``engine/plan_graph.py``: every unit must
   capture, one graph per plan entry; ``capture_pass``); launch counts
   set to 0, the 22 queries timed from their graphs, the counts read; a
   pass under ``torch.profiler`` for the card's busy time; no pass after
   the warm one may capture a graph, build a kernel or load a library;
   the timed pass then runs in turns eagerly (the executor's
   ``use_graphs`` off), eagerly and from graphs again, each turn's rows,
   kernel blocks and launches per kernel equal to the first pass's, and a
   profiled eager pass: both modes' wall, host (the wall clock not covered
   by device work) and device ms, busy share and launches, the warm
   pass's ``compile_ms``, the graph pool's reserved GiB, the peak and the
   pool resets (``plan_graph_record``); every result checked
   against the CPU oracle by the validator's rules, in the worker pool;
   the steps that ran on torch library calls before the port gave them
   hand kernels (the multi-key sort, the sort-merge build and probe, the
   compactor) counted, and their largest calls timed beside the torch
   calls they replaced and held to them exactly, here and on the NDS
   leg; the leg fails if it called ``_lexsort`` or if its profiled pass
   ran any torch sort (cub's radix sort or another) or searchsorted
   kernel;
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
   row count, q78's column 3 at rel tol 0.01001); K6's time per step at
   its largest call (``k6_breakdown``), and K6,
   the scans and their build sort held to their plain versions on
   adversarial inputs of up to 10M rows (``nds_adversarial_cases``) and
   right after an int64 scan whose values read as the sort's count words
   (``lookback_layout_cases``); the sorts' pack, the sorted search in
   every mode and the compactor on adversarial inputs
   (``sort_search_cases``: descending keys, NULLS FIRST and LAST, int64
   keys at iinfo's ends, floats with -0.0, +0.0 and NaN, a key without
   bounds beside bounded ones, several words, every row absent and none,
   empty builds, probes equal to the sentinel, builds at the edges of the
   search's shared-memory index, queries below and above every key and
   counts no multiple of the queries a thread carries), the
   multi-key sort against ``_lexsort`` on them (``sort_chain_checks``),
   and L2's pack and group bounds on adversarial inputs
   (``l2_adversarial_checks``: present counts at the group bounds'
   tile edges, capacities of 1, the group count and n, three key
   layouts, 12,000,007 rows; slices off alignment, 16 fields, int64
   keys); with ``--parent DIR`` (another checkout of this repo, unpacked
   at DIR), the sorts' and the probe's largest calls on the NDS-H and
   NDS legs, the NDS leg's largest "left", "right" and "both" searches,
   L3's build, the largest calls of K1-K4, ``partition_sort``, K6, K5's
   sum, K7's scan and the running max, and L2's pack, sort and group bounds
   at L2's largest call (``l2_steps``) run on that checkout's design
   beside this one's, on the same inputs, in turns (parent, this, this,
   parent), the results held equal (``parent_steps``);
6. window path: whole-partition MIN/MAX and a running SUM under the
   default RANGE frame over ``store_sales`` at the NDS leg's scale (no NDS
   statement takes either form: the only path to
   ``part_reduce_broadcast``), kernels checked, timed with counts read,
   a profiled pass (no torch sort or searchsorted kernel), results
   checked against the oracle;
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
8. bench phase: the port's bench entry (``python -m nds_tpu_torch.bench``,
   what its users run) in a process of its own on both legs at a cut of
   depth (NDS-H SF``BENCH_SMOKE_SF``, NDS SF``BENCH_SMOKE_SF_DS``), its data
   in a temporary directory, within ``BENCH_SMOKE_TIMEOUT_S``: exit 0, 125
   of 125 units, ``platform`` "cuda" and this card in its last line
   (``bench_phase``);
8b. power phase: the port's phase chain as its users run it, each CLI in a
   process of its own, in a temporary directory: ``gen_data`` of NDS-H at
   SF``POWER_SMOKE_SF`` (raw, a chunk per core up to 8), ``transcode`` to
   a parquet warehouse, the power CLI over that warehouse (its default
   ``--input_format parquet``) on the card, then on the CPU oracle
   (``--backend cpu``), then the validate CLI over the two runs' result
   files: every statement completed on ``device`` (on ``cpu`` in the
   oracle's run) with 0 reschedules, every compared one a MATCH
   (``power_phase``, ``power_run``); its ``Power Test Time`` printed
   beside the bench entry's NDS-H total;
8c. throughput phase, over the power phase's warehouse, three runs at
   once: streams 1 and 2 through the NDS-H throughput CLI in subprocess
   mode and in process (``--in_process``), every statement ``Completed``
   on ``device`` with 0 reschedules and the power CLI's result (bit for
   bit, float columns within 1e-9), and the power CLI with ``--backend
   distributed`` (a world of one NCCL rank), every statement ``sharded``
   with 0 reschedules and a MATCH against the oracle
   (``throughput_phase``); and after the
   NDS-H leg's timed passes, ``async_check``: the copies to the host of
   ``execute`` against ``execute_async``, handles in flight resolved in
   both orders, a recapture after every graph is dropped;
9. prints the kernels line (one entry per kernel wrapper: launches summed
   over the timed runs, each kernel's numbers from the path that runs
   it), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

``--steps STEP[,STEP]`` instead only builds the kernels and, for each
named step (a kernel wrapper, or ``l2``: L2's pack, sort and group
bounds), replays its graph cases, holds it to its plain version on its
adversarial cases and times this design beside ``--parent``'s
(``design_steps``, ``time_designs``): a wrapper at each leg's largest call
and at the NDS-H shapes (the compactor also on 6,480,001 seeded rows; the
decodes, which run only under the columnar store, at the largest calls of
each leg under ``columnar.set_mode("auto")`` and at their cases of
``decode_sweep_cases``), the plain version's and the library call's times
and, for K1-K3, the data's shares; ``l2`` on seeded inputs shaped like its
largest NDS call (``l2_padded_inputs``); it prints a summary (no contract
line). The step ``plans`` runs the plan graphs' adversarial cases on NDS
units at ``--sf-ds`` (``plan_cases``: a look-back reset and growth, a
staged temp with other content, a table registered again, scan-view and
memo evictions and an overflow forced, each between replays, every run
against the CPU oracle). The step ``bench`` runs the bench phase at
``--sf`` and ``--sf-ds`` (SF1 both by default, as users run it) after the
other steps. The step ``power`` runs the power phase on both suites at
``--sf`` and ``--sf-ds`` (SF1 both by default): the power CLI on the card
at ``--warmup 0`` (the reference's default: each plan's first run and
capture are inside its timed query) and at ``--warmup 1``, then on the CPU
oracle, each over the suite's parquet warehouse that the port's
``transcode`` wrote, each device run's results validated against the
oracle's; with ``bench`` too, each suite's ``Power Test Time`` is printed
beside the bench entry's power total of the same leg. The step ``load``
times, per suite at ``--sf`` and ``--sf-ds``, the raw reader
(``read_tbl``, best of two reads), the ``transcode`` CLI to parquet and
``load_warehouse`` over its warehouse, holds every table read back equal
to the raw read and prints the seconds and MB/s of each
(``load_phase``). The step ``throughput`` runs the
throughput CLIs at ``--sf`` and ``--sf-ds`` (``throughput_step``: NDS-H
in both modes in turns, NDS in process, each held to the power CLI's
stream 0 on the card, and one attempt at 2 NDS streams in subprocess
mode, recorded as what it does); ``throughput_beyond`` runs that attempt
alone; ``async`` runs ``async_check`` on the NDS-H units at ``--sf``;
``overlap`` times the in-process streams and the captured plans' replays
at 1 and 2 statements in flight (``overlap_step``).

Kernel checks: integer, bool and min/max outputs must equal the plain
version's exactly; a float sum (the segmented scan's "sum" on float
values) within |got - plain| <= 1e-9 * max(1, |plain|), since the two add
in other orders. K5's float sums are held to each group's own sum, taken
apart in float64, within 4096 units of the data's rounding (about 1e-12
for float64) of the group's sum of |x| (``within_group_sum_tol``); and to
the plain version within 1e-9 of the larger of |plain| and the prefix at
the group's bounding rows, since the plain version is the reference's
cumsum differences, whose rounding grows with the prefix
(``within_seg_sum_tol``). Each check gives the kernel's time per call (``ms``:
CUDA events around the call with the card idle at the start event, so
the host's part of the call up to its last launch is in it; median of 7
after 2 warm-ups), its device time (``device_ms``: the same while a spin
kernel holds the card, so the host's part is hidden), the host's time
for one call of the wrapper up to its return (``host_ms``), the plain
version's time, the bytes it must move, the least time the card could
take for them (``bound_ms``) and, where one PyTorch call computes the
same thing, that call's time by both methods (``library_ms``,
``library_device_ms``). Each
profiled pass also lists the operators that take the most host time,
and sums the device time of cub's radix sorts and of each of the port's
own kernels.

Any failed phase raises: the exit code is then non-zero and no result
line is printed. ``--device cpu`` rehearses the script on the CPU, where
the wrappers take their plain versions and the launch check fails.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

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
                           "nds_tpu/engine/kernels.py:420,438; "
                           "nds_tpu/engine/device_exec.py:2139"),
    "partitioned_mn_join": ("nds_tpu_torch/csrc/partitioned_join.cu",
                            "nds_tpu/engine/kernels.py:349,321,310"),
    "partition_sort": ("nds_tpu_torch/csrc/partitioned_join.cu",
                       "nds_tpu/engine/kernels.py:377; "
                       "nds_tpu/engine/device_exec.py:2220,1781"),
    "pack_group_key": ("nds_tpu_torch/csrc/group_key.cu",
                       "nds_tpu/engine/device_exec.py:2207-2218"),
    "pack_sort_key": ("nds_tpu_torch/csrc/sort_key.cu",
                      "nds_tpu/engine/device_exec.py:2611,2456,2396,2255,"
                      "2091,2220"),
    "sorted_search": ("nds_tpu_torch/csrc/sorted_search.cu",
                      "nds_tpu/engine/device_exec.py:293,1785"),
    "compact_perm": ("nds_tpu_torch/csrc/compact.cu",
                     "nds_tpu/engine/device_exec.py:947,2617"),
    "group_bounds": ("nds_tpu_torch/csrc/seg_scan.cu",
                     "nds_tpu/engine/device_exec.py:2221,2228"),
    "running_max": ("nds_tpu_torch/csrc/seg_scan.cu",
                    "nds_tpu/engine/device_exec.py:2464,2485,2487"),
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
              "keyed_minmax_semi", "seg_reduce_at_ends", "pack_group_key",
              "partition_sort", "group_bounds", "pack_sort_key",
              "sorted_search", "compact_perm")
DS_REQUIRED = ("partitioned_mn_join", "partition_sort", "seg_scan",
               "last_of_group", "pack_group_key", "group_bounds",
               "running_max", "pack_sort_key", "sorted_search",
               "compact_perm")
WINDOW_REQUIRED = ("part_reduce_broadcast", "last_of_group", "pack_sort_key",
                   "partition_sort")
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
             "partitioned_mn_join": "nds", "partition_sort": "nds",
             "seg_scan": "nds", "pack_group_key": "nds", "group_bounds": "nds",
             "running_max": "nds", "pack_sort_key": "nds",
             "sorted_search": "nds", "compact_perm": "nds",
             "last_of_group": "nds", "part_reduce_broadcast": "window",
             "exchange_pack": "dist_nds_h"}
# the bit-width sweep of the decode kernels: TPC-H's SF1 lineitem count
SWEEP_ROWS = 6_001_215
# float sums add in other orders in the kernel and its plain version
FLOAT_SUM_RTOL = 1e-9
# the kernels that add floats (a float sum is held to FLOAT_SUM_RTOL)
FLOAT_SUMS = ("seg_scan", "seg_reduce_at_ends")
# K5's float sums against each group's own float64 sum: within this many
# units of the data's rounding (finfo.eps) of the group's sum of |x|. The
# kernel adds a group's tiles one after another, so its error grows with
# the square root of the tiles it spans in practice (about 1e-14 of the
# sum of |x| for 10^5 tiles of float64), and with their count at worst
GROUP_SUM_EPS = 4096
# the groups of more rows are summed apart by torch.sum (a tree); the rest
# by segment_reduce, which adds each group's rows one after another
GROUP_SUM_SEQ_ROWS = 4096
# the distributed NDS leg's largest scale, a cut of depth: each exchange
# of two sharded sides doubles a side's capacity (the reference's
# static-shape contract), so the leg's memory and time grow faster than
# the single-device leg's (on an H100, q67 peaks near 42 GiB at SF0.2 and
# the leg takes about 100 s, a sixth of the whole smoke)
SF_DS_DIST = 0.2
# the bench phase of the full smoke: the port's bench entry
# (``python -m nds_tpu_torch.bench``) on both legs at a cut of depth, under
# a time limit of its own (the rest of the smoke takes 700-900 s of its
# 1,200 on an H100); ``--steps bench`` runs it at ``--sf``/``--sf-ds``
BENCH_SMOKE_SF = 0.1
BENCH_SMOKE_SF_DS = 0.01
BENCH_SMOKE_TIMEOUT_S = 180
BENCH_STEP_TIMEOUT_S = 1500
# the bench's units: 22 NDS-H queries and 103 NDS statements
BENCH_UNITS = 125
# the power phase: the port's phase chain (gen_data, the power CLI, the
# validate CLI) run as its users run it, each CLI in a process of its own;
# ``--steps power`` runs both suites at ``--sf``/``--sf-ds`` (SF1 by
# default), the full smoke NDS-H alone at a cut of depth
POWER_SMOKE_SF = 0.01
POWER_CLI_TIMEOUT_S = 1500
# the one recovered task failure a power run may report: an M:N join
# that outgrew its capacity and ran again at a doubled slack
SLACK_RETRY = "join expansion overflow: retry with slack "

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

# cycles of the spin kernel that keeps the card busy while the host
# enqueues a timed call (about 2 ms on an H100)
SPIN_CYCLES = 4_000_000


def time_ms(fn, dev, reps: int = 7, warm: int = 2,
            spin: bool = False) -> float:
    """Median time of one call: on the card, CUDA events around the
    call, the card idle at the start event, so the time takes in the
    host's part of the call up to its last launch (each run ends in its
    event's synchronize). With ``spin``, a spin kernel
    (``torch.cuda._sleep``) is enqueued before the start event, so that
    the host's part of the call (checks, allocation, the launches)
    overlaps the spin and the events time the device's work alone. The
    host clock on the CPU."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
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


def group_sums(args) -> tuple:
    """(sum, sum of |x|) of each of K5's groups in float64, taken apart
    from the kernel and from its plain version: over each group's rows,
    from its start to the next group's start (none where it starts past
    its end)."""
    import torch
    _op, data, _gid, starts2 = args
    n = data.shape[0]
    nxt = torch.cat([starts2[1:], starts2.new_full((1,), n)])
    end = (nxt - 1).clamp(0, n - 1)
    lengths = torch.where(starts2 > end, 0, end - starts2 + 1)
    x = data.to(torch.float64)
    rows = x[int(starts2[0]):]
    sums = torch.segment_reduce(rows, "sum", lengths=lengths)
    abs_sums = torch.segment_reduce(rows.abs(), "sum", lengths=lengths)
    big = torch.nonzero(lengths > GROUP_SUM_SEQ_ROWS).flatten()
    for g, a, e in zip(big.tolist(), starts2[big].tolist(),
                       end[big].tolist()):
        sums[g] = x[a:e + 1].sum()
        abs_sums[g] = x[a:e + 1].abs().sum()
    empty = lengths == 0
    return sums.masked_fill(empty, 0.0), abs_sums.masked_fill(empty, 0.0)


def within_group_sum_tol(args, got) -> bool:
    """K5's float sums against each group's own float64 sum
    (``group_sums``): |got - sum| <= GROUP_SUM_EPS * eps * sum of |x|, so
    a group with no rows (or only zeros) must read 0 exactly."""
    import torch
    sums, abs_sums = group_sums(args)
    lim = GROUP_SUM_EPS * torch.finfo(got.dtype).eps * abs_sums
    return bool(((got.to(torch.float64) - sums).abs() <= lim).all())


def within_seg_sum_tol(args, got, exp) -> bool:
    """K5's float sums against its plain version, the reference's cumsum
    differences, whose own rounding grows with the prefix at a group's
    bounding rows (the ulp of the global prefix, as the reference's
    ``_seg_sum`` notes), not with the group's sum: |got - exp| <=
    FLOAT_SUM_RTOL * max(1, |exp|, |prefix at the group's last row|,
    |prefix before its first row|)."""
    import torch
    _op, data, _gid, starts2 = args
    n = data.shape[0]
    csum = torch.cumsum(data.to(torch.float64), 0).abs()
    nxt = torch.cat([starts2[1:], starts2.new_full((1,), n)])
    end = (nxt - 1).clamp(0, n - 1)
    before = (starts2 - 1).clamp(0, n - 1)
    exp64 = exp.to(torch.float64)
    scale = torch.maximum(torch.maximum(csum[end], csum[before]),
                          exp64.abs()).clamp_min(1.0)
    d = (got.to(torch.float64) - exp64).abs()
    return bool((d <= FLOAT_SUM_RTOL * scale).all())


def agrees(name: str, args, got, exp) -> tuple:
    """(max_abs_err against the plain version's output ``exp``, whether
    the kernel's output ``got`` holds): exact, except a float sum. K5's
    float sums must be within their tolerance of the groups' own float64
    sums (``within_group_sum_tol``) and of the plain version's
    (``within_seg_sum_tol``); the segmented scan's within FLOAT_SUM_RTOL of
    the plain version's."""
    err = max_abs_err(got, exp)
    if not (name in FLOAT_SUMS and args[0] == "sum"
            and got.dtype.is_floating_point):
        return err, err == 0.0
    if name == "seg_reduce_at_ends":
        return err, (within_group_sum_tol(args, got)
                     and (err == 0.0 or within_seg_sum_tol(args, got, exp)))
    return err, err == 0.0 or within_float_sum_tol(got, exp)


def work_of(name: str, args, out) -> tuple:
    """(bytes the function must move, operations it does): each input
    read once, each output written once, an input that the data does not
    need not at all (the sorts' operands of absent rows, the group
    bounds' keys past the first absent row, K3's build keys of invalid
    rows); the operations are one per row handled, and for the
    small-build probe one lookup per probe row (what the function needs,
    whatever implements it: the one-hot product's (probe x build)
    compares are that formulation's work)."""
    tens = _tensors(list(args))
    moved = nbytes(tens) + nbytes(out)
    rows = sum(a.numel() for a in tens)
    ops = rows
    if name == "matmul_probe_join":
        ops = args[2].numel()
    if name == "partitioned_mn_join":
        # one step per input row and per output slot
        ops = rows + out[0].numel()
    if name == "partition_sort":
        # the occupied (key, row) pairs read once, the sorted blocks
        # written once
        # (and the digit counts, where the caller gives them)
        keys, gidx, counts = tens[:3]
        occupied = int(counts.sum())
        moved = (occupied * (keys.element_size() + gidx.element_size())
                 + nbytes(tens[2:]) + nbytes(out))
        ops = occupied
    if name == "pack_group_key":
        # the row mask and the validities, and a key's value only where
        # the row is present and the key valid (elsewhere it is filled,
        # never read; a field of no bits is never read at all)
        row, arrs, valids, fields = args[:4]
        moved = (nbytes(row) + nbytes(out)
                 + sum(nbytes(v) for v in valids if v is not None))
        for a, v, (_has_valid, _lo, width) in zip(arrs, valids, fields):
            if width:
                ok = row if v is None else row & v
                moved += int(ok.sum()) * a.element_size()
        ops = row.numel()
    if name == "pack_sort_key":
        # the row mask (where a field fills by it), the permutation and the
        # validities once each, a value only where the fill leaves it
        # (elsewhere it is never read), the word once
        from nds_tpu_torch.engine import kernels as KX
        row, arrs, valids, fields = args[:4]
        perm = args[5] if len(args) > 5 else None
        by_row = [bool(f[0] & KX.SORT_USE_ROW) for f in fields]
        moved = (nbytes(out) + nbytes(perm) + (nbytes(row) if any(by_row)
                                               else 0)
                 + sum(nbytes(v) for v in valids if v is not None))
        for a, v, use_row in zip(arrs, valids, by_row):
            ok = row if use_row else None
            if v is not None:
                ok = v if ok is None else ok & v
            moved += (a.numel() if ok is None else int(ok.sum())) \
                * a.element_size()
        ops = arrs[0].numel()
    if name == "group_bounds":
        # the keys up to and including the first absent row (sorted, with
        # presence on top: no row after it needs its key), every output
        # written once (``bounds_bytes``)
        keys, _pbit, G = args[:3]
        moved = bounds_bytes(keys, int(out[0].sum()), G)[0]
    if name == "bitmask_semi":
        # a build key only where its row is valid (no other build row
        # needs its key: the build loads none of an invalid vector)
        bkey, bok = args[:2]
        moved -= (bkey.numel() - int(bok.sum())) * bkey.element_size()
    if name == "keyed_minmax_semi":
        # a build key and value only where the row is valid, as K3's
        bkey, bok, bval = args[:3]
        moved -= (bkey.numel() - int(bok.sum())) * (bkey.element_size()
                                                     + bval.element_size())
    if name in DECODE_KERNELS:
        # a few integer operations per output row
        ops = out.numel()
    if name == "unpack_mask":
        # the words that hold the n rows (the rest are never read)
        moved = 4 * -(-args[1] // 32) + nbytes(out)
    if name == "exchange_pack":
        # a hash, a rank and a copy per row, a store per output slot
        ops = rows + sum(t.numel() for t in _tensors(out))
    return moved, ops


def minmax_table_bytes(args) -> int:
    """The bytes of K4's dense table beside its streamed arrays: the fill
    of its ``dom`` {min, max} slots and one slot read a probe row."""
    _bk, _bo, bval, pkey = args[:4]
    slot = 2 * bval.element_size()
    return args[7] * slot + pkey.numel() * slot


def all_keys_bound(name: str, args, out, ops: int) -> dict:
    """For the kernels whose bound counts only the keys their data needs
    (``group_bounds``, K3), the bound that reads every key, for
    comparison; for K4 the table's bytes and the bound with them added
    (``minmax_table_bytes``), so that its gap splits between the streamed
    arrays and the table; {} for the others."""
    if name == "group_bounds":
        return {"bound_ms_all_keys": bound(
            bounds_bytes(args[0], int(out[0].sum()), args[2])[1], ops)[0]}
    if name == "bitmask_semi":
        return {"bound_ms_all_keys": bound(
            nbytes(list(args)) + nbytes(out), ops)[0]}
    if name == "keyed_minmax_semi":
        table = minmax_table_bytes(args)
        return {"table_bytes": table, "bound_ms_with_table": bound(
            work_of(name, args, out)[0] + table, ops)[0]}
    return {}


def bound(moved: int, ops: int) -> tuple:
    t_bytes = moved / HBM_BYTES_PER_S * 1000
    t_ops = ops / F32_OPS_PER_S * 1000
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same thing, timed as a yardstick
    only (the port never calls it); None where there is none."""
    import torch
    if name == "seg_reduce_at_ends":
        op, data, gid, starts2 = args
        idx = gid.to(torch.int64)
        out = torch.empty(starts2.shape[0], dtype=data.dtype,
                          device=data.device)
        if op == "sum" and data.dtype.is_floating_point:
            # the groups' lengths: a group holds the rows from its start to
            # the next group's start (none where it starts past its end)
            n = data.shape[0]
            nxt = torch.cat([starts2[1:], starts2.new_full((1,), n)])
            end = (nxt - 1).clamp(0, n - 1)
            lengths = torch.where(starts2 > end, 0, end - starts2 + 1)
            return lambda: torch.segment_reduce(data, "sum", lengths=lengths)
        if op == "sum":
            # segment_reduce takes no integers: one index_add_ per group id
            return lambda: out.zero_().index_add_(0, idx, data)
        # grouped min/max by one scatter-reduce over the group ids
        return lambda: out.scatter_reduce_(
            0, idx, data, "amin" if op == "min" else "amax",
            include_self=False)
    if name == "running_max":
        vals = args[0]
        return lambda: torch.cummax(vals, 0)
    if name == "rle_decode":
        # each run's value repeated to the next run's start, the last run
        # to n
        values, starts, n = args
        lengths = torch.diff(starts.to(torch.int64),
                             append=starts.new_full((1,), n).to(torch.int64))
        return lambda: torch.repeat_interleave(values, lengths,
                                               output_size=n)
    if name == "seg_scan" and args[0] == "sum":
        # the unsegmented running sum: the same function where no row
        # resets
        vals = args[1]
        return lambda: torch.cumsum(vals, 0)
    if name == "partition_sort":
        # the batched stable sort of the whole block, its unoccupied
        # slots set to (iinfo.max, 0) beforehand, and the row ids gathered
        keys, gidx, counts = args[:3]
        tail = (torch.arange(keys.shape[1], device=keys.device)[None, :]
                >= counts[:, None])
        kb = keys.masked_fill(tail, torch.iinfo(keys.dtype).max)
        gb = gidx.masked_fill(tail, 0)

        def sort_gather():
            ks, order = torch.sort(kb, dim=1, stable=True)
            return ks, gb.gather(1, order)
        return sort_gather
    if name == "sorted_search":
        ks, q = args[:2]
        mode = args[2] if len(args) > 2 else "left"
        if mode in ("left", "right"):
            return lambda: torch.searchsorted(ks, q, right=mode == "right")
        return None
    if name == "compact_perm":
        # the stable sort of the 0/1 key that the compactor replaced
        row = args[0]
        return lambda: torch.sort((~row).to(torch.int32), stable=True)
    if name == "bitmask_semi":
        # membership of the probe keys in the valid build keys, compacted
        # beforehand (the caller ANDs pok in: ``library_agrees``)
        _bkey, _bok, pkey = args[:3]
        valid = _bkey[_bok]
        return lambda: torch.isin(pkey, valid)
    # K4: none (the min table's scatter_reduce_ alone is a quarter of its
    # function)
    return None


def library_agrees(name: str, args, got, lib_out) -> None:
    """Raises where a library call that computes the kernel's function
    disagrees with the kernel's output ``got``: K3's ``torch.isin`` ANDed
    with ``pok``, and the compactor's stable sort's indices."""
    import torch
    if name == "bitmask_semi":
        same = torch.equal(lib_out & args[3], got)
    elif name == "compact_perm":
        same = torch.equal(lib_out[1].to(torch.int32), got[0])
    else:
        return
    if not same:
        raise SmokeError(f"{name}: the library call differs from the "
                         f"kernel")


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
    err, ok = agrees(name, args, got, exp)
    if not ok:
        raise SmokeError(f"{name} [{label}] differs from its plain "
                         f"version: max_abs_err={err}")
    ms = time_ms(lambda: fn(*args), dev)
    device_ms = time_ms(lambda: fn(*args), dev, spin=True)
    host_ms = host_call_ms(lambda: fn(*args), dev)
    # a plain version that takes seconds keeps the time of its first
    # call, to its synchronize, rather than running again
    plain_ms = (plain_first_s * 1000 if plain_first_s > 1.0 else
                time_ms(lambda: plain(*args), dev, reps=3, warm=1))
    lib = library_call(name, args)
    lib_out = None
    try:
        if lib is not None:
            lib_out = lib()
    except RuntimeError as exc:  # a library call that takes no such input
        log(f"{name} [{label}]: no library call: {exc}")
        lib = None
    if lib is not None:
        library_agrees(name, args, got, lib_out)
    del lib_out
    library_ms = time_ms(lib, dev) if lib is not None else None
    library_device_ms = (time_ms(lib, dev, spin=True) if lib is not None
                         else None)
    moved, ops = work_of(name, list(args) + list(kwargs.values()), got)
    bound_ms, bound_by = bound(moved, ops)
    shapes = [list(a.shape) + [str(a.dtype).replace("torch.", "")]
              for a in _tensors(list(args) + list(kwargs.values()))]
    extra = {}
    extra.update(all_keys_bound(name, args, got, ops))
    rec = {"kernel": name, "case": label, "shapes": shapes, **extra,
           "size": call_size(name, args, kwargs),
           "max_abs_err": err, "ms": ms, "device_ms": device_ms,
           "host_ms": host_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_device_ms": library_device_ms,
           "bytes": moved, "ops": ops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(json.dumps(rec))
    return rec


def k6_breakdown(KX, args, reps: int = 5, warm: int = 1) -> dict:
    """K6's time per step at one call: ``kernels.partitioned_mn_join_steps``
    is a generator that yields each step's name right after it enqueues
    the step, and a CUDA event recorded there closes the step. The start
    event is recorded with the card idle, so the total is the call's time
    as ``ms`` takes it. Median over ``reps`` calls after ``warm``, each
    ending in a synchronize."""
    import torch
    steps = KX.partitioned_mn_join_steps
    runs = []
    for i in range(warm + reps):
        marks = []
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        for name in steps(*args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))
        torch.cuda.synchronize()
        if i < warm:
            continue
        step, prev = {}, start
        for name, e in marks:
            step[name] = step.get(name, 0.0) + prev.elapsed_time(e)
            prev = e
        step["total"] = start.elapsed_time(prev)
        runs.append(step)
    out = {name: statistics.median(r[name] for r in runs)
           for name in runs[0]}
    log(json.dumps({"phase": "K6 step breakdown",
                    "size": call_size("partitioned_mn_join", args),
                    "steps_ms": out}))
    return out


def load_parent(root: str, dev) -> tuple:
    """The design of another checkout of this repo, unpacked at ``root``
    (``git archive <commit> | tar -x -C root``): its ``cuda_build``, which
    builds that checkout's sources into that checkout's ``.build/``, its
    ``kernels`` on those libraries and its ``device_exec`` on those
    kernels, each loaded under a name of its own (built at once on the
    card; on the CPU they run their plain versions). Returns ``(kernels,
    device_exec)``; everything else they import is this checkout's."""
    import importlib.util

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "nds_tpu_torch", "engine", rel))
        mod = importlib.util.module_from_spec(spec)
        # a dataclass resolves its annotations through sys.modules
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod
    pcb = load("parent_cuda_build", "cuda_build.py")
    if dev.type == "cuda":
        pcb.build_all()
    pkx = load("parent_kernels", "kernels.py")
    pkx._lib = lambda name: (pcb, pcb.library(name))
    pdx = load("parent_device_exec", "device_exec.py")
    pdx.KX = pkx
    return pkx, pdx


def lookback_layout_cases(KX, dev) -> list:
    """(kernel, args, label, scan) cases for the look-back scratch: each
    runs right after ``scan``, an int64 segmented sum whose every row
    resets, so that its tiles' stored values are the rows' values, here
    count words (lookback.cuh) of the epochs that the next partition and
    sort launches take. The scan's state and the count words must live
    in words that do not overlap, so a stale word is only ever read in
    the layout it was written in."""
    import numpy as np
    import torch
    rng = np.random.default_rng(29)

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    probe = torch.zeros(1, device=dev)
    key = (probe.device, torch.cuda.current_stream().cuda_stream, "count")
    # the next count launch's epoch, from the counter word on the card
    ent = KX._LOOKBACK.get(key)
    nxt = 1 if ent is None else int(ent[1].item()) >> 32
    n = 1 << 21
    ep = nxt + np.arange(n) % 16
    kind = 1 + np.arange(n) % 2
    words = ((ep.astype(np.int64) << 34) | (kind.astype(np.int64) << 32)
             | rng.integers(1, 1 << 20, n))
    scan_args = ("sum", dt(words), dt(np.ones(n, bool)))
    nparts, cap = 8, 3_000_000
    counts = rng.integers(cap // 2, cap + 1, nparts).astype(np.int32)
    sort_args = (dt(rng.integers(-(1 << 40), 1 << 40, (nparts, cap))),
                 dt(rng.integers(0, 1 << 30, (nparts, cap),
                                 dtype=np.int64).astype(np.int32)),
                 dt(counts))
    nl, nr = 4_000_000, 2_000_000
    pool = rng.integers(-(1 << 40), 1 << 40, 1_000_000)
    k6_args = (dt(rng.choice(pool, nl)), dt(rng.random(nl) < 0.9),
               dt(rng.choice(pool, nr)), dt(rng.random(nr) < 0.9),
               8_000_000, 2.0)
    return [("partition_sort", sort_args,
             f"8 x {cap} int64 after an int64 scan of count words",
             scan_args),
            ("partitioned_mn_join", k6_args,
             f"{nl} x {nr} int64 after an int64 scan of count words",
             scan_args)]


def check_lookback_layouts(KX, dev) -> list:
    """Runs ``lookback_layout_cases``: the scan, then the kernel held to
    its plain version; then the scan's and the count words' buffers on
    this stream must not overlap."""
    import torch
    checks = []
    for name, args, label, scan_args in lookback_layout_cases(KX, dev):
        KX.seg_scan(*scan_args)
        checks.append(check_kernel(KX, name, args, label, dev))
    stream = torch.cuda.current_stream().cuda_stream
    spans = {}
    for (d, st, layout), (buf, *_rest) in KX._LOOKBACK.items():
        if st == stream:
            spans.setdefault(layout, []).append(
                (buf.data_ptr(), buf.data_ptr() + buf.numel() * 8))
    for a0, a1 in spans.get("scan", []):
        for b0, b1 in spans.get("count", []):
            if a0 < b1 and b0 < a1:
                raise SmokeError("the scan state and the count words of "
                                 "the look-back share words")
    return checks


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


def nds_adversarial_cases(dev) -> list:
    """(kernel, args, label) beside the NDS leg's own calls, at up to
    about 10M rows so that each plain version stays near 2 s: K6 with
    valid keys equal to iinfo(int32).max on both sides (they also match
    every unoccupied build slot), with every row hashed into one
    partition, and over int64 keys spread wider than 2^32 (every digit of
    the sort moves); the scans over one segment of all rows, segments
    that span many tiles, and lengths that are no multiple of a tile."""
    import numpy as np
    import torch
    rng = np.random.default_rng(23)

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def pid8(k):
        u = k.astype(np.int64) & 0xFFFFFFFF
        return ((u * 2654435761) & 0xFFFFFFFF) >> 29

    cases = []
    big = np.iinfo(np.int32).max
    nl, nr = 6_000_000, 3_000_000
    lk = rng.integers(0, 1 << 20, nl).astype(np.int32)
    rk = rng.integers(0, 1 << 20, nr).astype(np.int32)
    lk[rng.random(nl) < 0.01] = big
    rk[rng.random(nr) < 0.001] = big
    cases.append(("partitioned_mn_join",
                  (dt(lk), dt(rng.random(nl) < 0.9), dt(rk),
                   dt(rng.random(nr) < 0.9), 12_000_000, 2.0),
                  f"{nl} x {nr} int32, iinfo.max keys on both sides"))
    cand = np.arange(0, 1 << 24, dtype=np.int64)
    hot = cand[pid8(cand) == 3][:1_250_000].astype(np.int32)
    nl, nr = 4_000_000, 2_000_000
    cases.append(("partitioned_mn_join",
                  (dt(rng.choice(hot, nl)), dt(np.ones(nl, bool)),
                   dt(rng.choice(hot, nr)), dt(rng.random(nr) < 0.95),
                   8_000_000, 8.0),
                  f"{nl} x {nr} int32, every row in one partition"))
    pool = rng.integers(-(1 << 40), 1 << 40, 2_000_000, dtype=np.int64)
    nl, nr = 6_000_000, 3_000_000
    cases.append(("partitioned_mn_join",
                  (dt(rng.choice(pool, nl)), dt(rng.random(nl) < 0.9),
                   dt(rng.choice(pool, nr)), dt(rng.random(nr) < 0.9),
                   12_000_000, 2.0),
                  f"{nl} x {nr} int64 over [-2^40, 2^40)"))
    n = 10_000_001
    one = np.zeros(n, bool)
    one[0] = True
    cases.append(("seg_scan",
                  ("sum", dt(rng.integers(-10**6, 10**6, n)), dt(one)),
                  f"n={n} int64 sum, one segment"))
    n = 7_777_777
    vals = rng.normal(size=n)
    vals[rng.integers(0, n, 5)] = np.nan
    cases.append(("seg_scan",
                  ("max", dt(vals), dt(rng.random(n) < 2e-5)),
                  f"n={n} float64 max, segments of about 50,000 rows"))
    n = 9_999_999
    change = rng.random(n) < 1e-5
    change[0] = True
    cases.append(("last_of_group", (dt(change), n),
                  f"n={n}, groups of about 100,000 rows"))
    n = 5_000_003
    part_start = rng.random(n) < 1.6e-5
    part_start[0] = True
    starts = np.nonzero(part_start)[0]
    ends = np.append(starts[1:], n) - 1
    pend = np.repeat(ends, np.diff(np.append(starts, n))).astype(np.int32)
    cases.append(("part_reduce_broadcast",
                  ("min", dt(rng.integers(-2**31, 2**31 - 1, n,
                                          dtype=np.int64).astype(np.int32)),
                   dt(part_start), dt(pend)),
                  f"n={n} int32 min, partitions of about 60,000 rows"))
    return cases


# the sorted packed keys of group_bounds' adversarial cases: presence bit
# and stored type per layout (a 32-bit layout is int32, biased by -2^31)
BOUNDS_LAYOUTS = {"int32, 21 bits": (20, "int32"),
                  "int32, 32 bits biased": (31, "int32"),
                  "int64, 41 bits": (40, "int64")}


def sorted_group_keys(rng, n: int, present: int, layout: str,
                      few_groups: bool):
    """(keys, pbit) as ``partition_sort`` leaves a packed group key:
    ``present`` rows of values below the presence bit (from a span of
    about present / 50 values where ``few_groups``, so that groups span
    tiles, else from the whole width), then the absent rows, their
    presence bit set and the bits below it random, sorted."""
    import numpy as np
    import torch
    pbit, dtype = BOUNDS_LAYOUTS[layout]
    span = max(1, present // 50) if few_groups else 1 << pbit
    packed = np.concatenate([
        np.sort(rng.integers(0, span, present)),
        np.sort(rng.integers(0, 1 << pbit, n - present)) | (1 << pbit)])
    if pbit == 31:
        packed = packed - (1 << 31)
    return torch.as_tensor(packed.astype(dtype)), pbit


def l2_adversarial_cases(KX, dev) -> tuple:
    """(exact cases, timed cases) of L2's two kernels, each (kernel, args,
    label). ``group_bounds``: present counts 0, 1, T - 1, T, T + 1, n - 1
    and n (T its tile) over n = 100,003 rows, in each layout, at group
    capacities 1, the group count and n; and at 12,000,007 rows, 2,099
    present, G = n (L2's largest call cut in depth), in the 32-bit layout
    and in int64. ``pack_group_key``: slices that start off 16-byte
    alignment (each array by another offset), n no multiple of 16, every
    row absent, every row present, 16 fields, and int64 keys; its counts
    are held to the plain version's histogram."""
    import numpy as np
    import torch
    rng = np.random.default_rng(37)
    exact, timed = [], []
    T = KX._lib("seg_scan")[1].nds_group_bounds_tile() if \
        dev.type == "cuda" else 4096
    n = 100_003
    for li, layout in enumerate(BOUNDS_LAYOUTS):
        for pi, p in enumerate((0, 1, T - 1, T, T + 1, n - 1, n)):
            keys, pbit = sorted_group_keys(rng, n, p, layout,
                                           few_groups=(li + pi) % 2 == 0)
            keys = keys.to(dev)
            ng = int(torch.unique(keys[:p]).numel())
            for G in sorted({1, max(ng, 1), n}):
                exact.append(("group_bounds", (keys, pbit, G),
                              f"n={n} {layout}, {p} present, {ng} groups, "
                              f"G={G}"))
    for layout in ("int32, 32 bits biased", "int64, 41 bits"):
        n = 12_000_007
        keys, pbit = sorted_group_keys(rng, n, 2_099, layout, True)
        timed.append(("group_bounds", (keys.to(dev), pbit, n),
                      f"n={n} {layout}, 2099 present, G=n"))

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def sliced(a, off):
        # a contiguous view that starts ``off`` elements into its storage
        return dt(np.concatenate([np.zeros(off, a.dtype), a]))[off:]
    n = 1_000_003
    row = rng.random(n) < 0.3
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    v32 = rng.random(n) < 0.9
    b = rng.random(n) < 0.5
    i64 = rng.integers(-(1 << 40), 1 << 40, n)
    v64 = rng.random(n) < 0.8
    u20 = rng.integers(0, 1 << 20, n)
    cases = [
        ("slices off alignment, n % 16 = 3, an int32 key of 14 bits",
         (sliced(row, 3), [sliced(i32, 5), sliced(b, 1)],
          [sliced(v32, 7), None], [(True, -1000, 11), (False, 0, 1)])),
        ("slices off alignment, an int64 key of 54 bits",
         (sliced(row, 9), [sliced(i64, 1), sliced(i32, 2)],
          [sliced(v64, 11), None], [(True, -(1 << 40), 41),
                                    (False, -1000, 11)])),
        ("every row absent, a 32-bit key",
         (dt(np.zeros(n, bool)), [dt(i32), dt(u20)], [None, None],
          [(False, -1000, 11), (False, 0, 20)])),
        ("every row present, a 32-bit key",
         (dt(np.ones(n, bool)), [dt(i32), dt(u20)], [None, None],
          [(False, -1000, 11), (False, 0, 20)])),
        ("16 fields: bools with validity, an int64 key of 33 bits",
         (dt(row), [dt(rng.random(n) < 0.5) for _ in range(16)],
          [dt(rng.random(n) < 0.9) for _ in range(16)],
          [(True, 0, 1)] * 16)),
    ]
    for label, args in cases:
        bits = 1 + sum(w + int(v) for v, _lo, w in args[3])
        exact.append(("pack_group_key", (*args, bits), f"n={n}, {label}"))
    timed.append(("pack_group_key",
                  (dt(row), [dt(i32), dt(b)], [dt(v32), None],
                   [(True, -1000, 11), (False, 0, 1)], 14),
                  f"n={n}, 30% present, two keys, one nullable"))
    return exact, timed


def exact_check(KX, name: str, args, label: str) -> dict:
    """A kernel against its plain version on one input, exactly, untimed."""
    got = getattr(KX, name)(*args)
    exp = getattr(KX, name + "_plain")(*args)
    err, ok = agrees(name, args, got, exp)
    if not ok:
        raise SmokeError(f"{name} [{label}] differs from its plain "
                         f"version: max_abs_err={err}")
    return {"kernel": name, "case": label, "max_abs_err": err}


def l2_adversarial_checks(KX, dev) -> list:
    """Runs ``l2_adversarial_cases``: the exact ones untimed, the others
    through ``check_kernel``."""
    exact, timed = l2_adversarial_cases(KX, dev)
    out = [exact_check(KX, *c) for c in exact]
    log(json.dumps({"phase": "L2 adversarial cases", "cases": len(out),
                    "max_abs_err": max(c["max_abs_err"] for c in out)}))
    return out + [check_kernel(KX, name, args, label, dev)
                  for name, args, label in timed]


def colliding_keys(rng, n: int, n_build: int, dtype, slot: int):
    """``n`` distinct keys of ``dtype`` ("int32" or "int64") whose first
    slot in K2's hash table for a build of ``n_build`` rows is ``slot``,
    by the plain mirror of the kernel's hash (``matmul_probe_slots``),
    drawn from a seed."""
    import numpy as np
    import torch
    from nds_tpu_torch.engine import kernels as KX
    out: list = []
    info = np.iinfo(dtype)
    while len(out) < n:
        cand = rng.integers(info.min, info.max, 1 << 16, dtype=dtype,
                            endpoint=True)
        got = KX.matmul_probe_slots(torch.from_numpy(cand),
                                    n_build).numpy()
        out += [int(k) for k in cand[got == slot] if int(k) not in out]
    return np.array(out[:n], dtype=dtype)


def join_adversarial_cases(dev) -> list:
    """(kernel, args, label) of K1 and K2, each held exactly to its plain
    version. K1 (``direct_lookup_join``): probe keys below ``lo``, above
    ``lo + dom - 1`` and at both ends and iinfo's; invalid build rows
    (some with a valid row's key) and false ``pok``; probes of 1-17, 511-513
    and 100,003 rows; every array a slice 1-15 elements into its storage;
    int64 keys beyond 2^32 with ``lo`` near them (a key 2^32 above one in
    the domain must miss); ``dom = DIRECT_MAX_DOMAIN``. K2
    (``matmul_probe_join``): builds of 1, 64, 255 and 256 rows; duplicate
    valid keys (the sum of their indices, clamped) and duplicates of which
    some are invalid; keys that share one first slot of the hash
    (``colliding_keys``), probed by members and by other keys of that
    slot; int64 keys equal in their low 32 bits; negative keys; valid
    keys that span as many values as the table has slots and one more;
    every probe row absent; slices."""
    import numpy as np
    import torch
    from nds_tpu_torch.engine import kernels as KX
    rng = np.random.default_rng(41)

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def sliced(a, off):
        # a contiguous view that starts ``off`` elements into its storage
        return dt(np.concatenate([np.zeros(off, a.dtype), a]))[off:]

    def k1_build(nb, lo, dom, kdt, valid=0.8):
        keys = (rng.choice(dom, size=nb, replace=False).astype(np.int64)
                + lo)
        ok = rng.random(nb) < valid
        # invalid rows carry junk: outside the domain, or a valid row's key
        junk = np.where(rng.random(nb) < 0.5,
                        rng.integers(lo - 3 * dom, lo + 4 * dom, nb),
                        rng.permutation(keys))
        return np.where(ok, keys, junk).astype(kdt), ok

    def k1_probe(n, lo, dom, kdt, valid=0.9):
        keys = rng.integers(lo - dom, lo + 2 * dom, n)
        info = np.iinfo(kdt)
        edges = np.array([lo - 1, lo, lo + dom - 1, lo + dom, info.min,
                          info.max], dtype=np.int64)[:n]
        keys[:len(edges)] = edges
        return keys.astype(kdt), rng.random(n) < valid

    cases = []
    lo, dom = -1000, 200_000
    bk, bo = k1_build(50_000, lo, dom, np.int32)
    for n in (1, 2, 7, 15, 16, 17, 511, 512, 513, 100_003):
        pk, po = k1_probe(n, lo, dom, np.int32)
        cases.append(("direct_lookup_join",
                      (dt(bk), dt(bo), dt(pk), dt(po), lo, dom),
                      f"int32, np={n}, keys at and past the domain's ends"))
    n = 1_000_003
    pk, po = k1_probe(n, lo, dom, np.int32)
    for offs in ((1, 3, 5, 7), (4, 2, 9, 15), (0, 0, 3, 0), (0, 0, 0, 1)):
        cases.append(("direct_lookup_join",
                      (sliced(bk, offs[0]), sliced(bo, offs[1]),
                       sliced(pk, offs[2]), sliced(po, offs[3]), lo, dom),
                      f"int32, np={n}, slices off by {offs} elements"))
    lo, dom = (1 << 35) + 17, 3_000_000
    bk, bo = k1_build(1_000_000, lo, dom, np.int64)
    pk, po = k1_probe(n, lo, dom, np.int64)
    # keys 2^32 above and below keys of the domain
    pk[10:20_000] = bk[:19_990] + np.where(rng.random(19_990) < 0.5,
                                           1 << 32, -(1 << 32))
    cases.append(("direct_lookup_join",
                  (dt(bk), dt(bo), dt(pk), dt(po), lo, dom),
                  f"int64 keys near 2^35, np={n}, keys 2^32 off the domain"))
    cases.append(("direct_lookup_join",
                  (sliced(bk, 1), sliced(bo, 13), sliced(pk, 1),
                   sliced(po, 6), lo, dom),
                  f"int64 keys near 2^35, np={n}, slices off alignment"))
    lo, dom = 5, KX.DIRECT_MAX_DOMAIN
    bk, bo = k1_build(1_500_000, lo, dom, np.int32)
    pk, po = k1_probe(3_000_001, lo, dom, np.int32)
    cases.append(("direct_lookup_join",
                  (dt(bk), dt(bo), dt(pk), dt(po), lo, dom),
                  "int32, dom = DIRECT_MAX_DOMAIN"))
    bk, bo = k1_build(1000, 0, 5000, np.int32, valid=0.0)
    pk, po = k1_probe(20_000, 0, 5000, np.int32, valid=0.0)
    cases.append(("direct_lookup_join",
                  (dt(bk), dt(bo), dt(pk), dt(po), 0, 5000),
                  "no valid build row, no valid probe row"))

    def k2(label, bk, bo, pk, po, offs=(0, 0, 0, 0)):
        cases.append(("matmul_probe_join",
                      (sliced(bk, offs[0]), sliced(bo, offs[1]),
                       sliced(pk, offs[2]), sliced(po, offs[3])), label))

    def probe_of(bk, n, spread, kdt, absent=False):
        keys = np.where(rng.random(n) < 0.6, rng.choice(bk, n),
                        rng.integers(-spread, spread, n)).astype(kdt)
        if absent:
            keys = rng.integers(-spread, spread, n).astype(kdt)
            keys = keys[~np.isin(keys, bk)]
        return keys, rng.random(keys.shape[0]) < 0.9

    for nb in (1, 64, 255, 256):
        for kdt, spread in ((np.int32, 1 << 30), (np.int64, 1 << 50)):
            bk = rng.choice(spread, nb, replace=False).astype(kdt)
            bo = rng.random(nb) < 0.85
            pk, po = probe_of(bk, 100_003, spread, kdt)
            k2(f"nb={nb} {np.dtype(kdt).name}, keys over 2^"
               f"{spread.bit_length() - 1}", bk, bo, pk, po)
    for nb, valid in ((256, 1.0), (256, 0.5), (64, 0.7)):
        bk = rng.integers(-20, 20, nb).astype(np.int32)
        pk, po = probe_of(bk, 200_003, 30, np.int32)
        k2(f"nb={nb}, duplicate keys, {valid:.0%} valid", bk,
           rng.random(nb) < valid, pk, po)
        bk = rng.choice(np.arange(-(1 << 40), (1 << 40), 1 << 33), nb)
        pk, po = probe_of(bk, 200_003, 1 << 41, np.int64)
        k2(f"nb={nb}, duplicate int64 keys spread wide, {valid:.0%} valid",
           bk, rng.random(nb) < valid, pk, po)
    for nb, kdt in ((64, np.int32), (256, np.int32), (64, np.int64),
                    (255, np.int64)):
        slot = int(rng.integers(0, 1 << KX.matmul_probe_slot_bits(nb)))
        keys = colliding_keys(rng, nb + 40, nb, np.dtype(kdt).name, slot)
        bk, others = keys[:nb], keys[nb:]
        n = 100_003
        pk = np.where(rng.random(n) < 0.5, rng.choice(bk, n),
                      rng.choice(others, n)).astype(kdt)
        k2(f"nb={nb} {np.dtype(kdt).name}, every key in hash slot {slot}",
           bk, rng.random(nb) < 0.9, pk, rng.random(n) < 0.9)
    low = int(rng.integers(0, 1 << 32))
    for nb in (2, 64, 256):
        keys = np.unique((rng.integers(-(1 << 31), 1 << 31, 2 * nb + 64)
                          << 32) | low)[:2 * nb]
        bk = rng.permutation(keys)[:nb]
        pk = rng.choice(keys, 100_003)
        k2(f"nb={nb} int64 keys equal in their low 32 bits", bk,
           rng.random(nb) < 0.9, pk, rng.random(100_003) < 0.9)
    bk = np.arange(-30, -5, dtype=np.int32)
    pk, po = probe_of(bk, 100_003, 40, np.int32)
    k2("nb=25 negative keys, a span of 25 values", bk,
       rng.random(25) < 0.9, pk, po)
    bk = -rng.choice(1 << 40, 200, replace=False).astype(np.int64) - 1
    pk, po = probe_of(bk, 100_003, 1 << 40, np.int64)
    k2("nb=200 negative int64 keys over 2^40", bk,
       rng.random(200) < 0.9, pk, po)
    slots = 1 << KX.matmul_probe_slot_bits(256)
    for span in (slots, slots + 1):
        bk = np.concatenate([[7, 7 + span - 1],
                             7 + rng.choice(span, 254, replace=False)])
        bk = bk.astype(np.int32)
        pk, po = probe_of(bk, 100_003, 2 * slots, np.int32)
        k2(f"nb=256, valid keys over {span} values ({slots} slots)", bk,
           np.ones(256, bool), pk, po)
    bk = rng.choice(1 << 20, 100, replace=False).astype(np.int32)
    pk, po = probe_of(bk, 100_003, 1 << 20, np.int32, absent=True)
    k2("nb=100, every probe row absent", bk, rng.random(100) < 0.9, pk, po)
    bk = rng.choice(1 << 30, 256, replace=False).astype(np.int64)
    pk, po = probe_of(bk, 300_007, 1 << 30, np.int64)
    k2("nb=256 int64, slices off alignment", bk, rng.random(256) < 0.9, pk,
       po, offs=(1, 5, 1, 11))
    bk = rng.choice(64, 25, replace=False).astype(np.int32)
    pk, po = probe_of(bk, 300_007, 64, np.int32)
    k2("nb=25 int32 keys below 64, slices off alignment", bk,
       rng.random(25) < 0.9, pk, po, offs=(3, 2, 7, 13))
    return cases


def join_adversarial_checks(KX, dev) -> list:
    """Runs ``join_adversarial_cases``, exactly and untimed; on the card
    first holds the plain mirror of K2's table size
    (``matmul_probe_slot_bits``, which ``colliding_keys`` takes) to the
    kernel's for every build size."""
    if dev.type == "cuda":
        lib = KX._lib("small_build_probe")[1]
        bad = [nb for nb in range(1, lib.nds_small_build_max() + 1)
               if lib.nds_small_build_slot_bits(nb)
               != KX.matmul_probe_slot_bits(nb)]
        if bad:
            raise SmokeError(f"K2's table size differs from its plain "
                             f"mirror's for builds of {bad[:5]} rows")
    out = [exact_check(KX, *c) for c in join_adversarial_cases(dev)]
    log(json.dumps({"phase": "K1/K2 adversarial cases", "cases": len(out),
                    "max_abs_err": max(c["max_abs_err"] for c in out)}))
    return out


def case_rng(seed: int, label: str):
    """A numpy generator of one adversarial case, from a seed and the
    case's label, so that a test can build one case alone."""
    import zlib

    import numpy as np
    return np.random.default_rng([seed, zlib.crc32(label.encode())])


def view_on(dev, a, off: int = 0):
    """The numpy array ``a`` on ``dev`` as a contiguous view that starts
    ``off`` elements into its storage."""
    import numpy as np
    import torch
    a = np.ascontiguousarray(a)
    t = torch.as_tensor(np.concatenate([np.zeros(off, a.dtype), a]))
    return t.to(dev)[off:]


# the compactor's tile (csrc/compact.cu: 4,096 rows, 16 bytes a thread) and
# the tiles its count pass takes a block
COMPACT_TILE = 4096
COMPACT_SPAN_TILES = 8


def semi_compact_case_makers() -> list:
    """(kernel, label, make) of K3 (``bitmask_semi``) and L1
    (``compact_perm``): ``make(dev)`` gives the case's args, drawn from a
    seed of its own, so that a test can build one case alone. The card
    holds each kernel exactly to its plain version on them, and
    ``tests/test_torch_semi_compact.py`` each plain version to the JAX
    reference on the CPU. K3: builds dense with duplicates (40 rows a key),
    with most rows invalid (a plan's padded capacity: a few valid rows,
    then invalid ones) and with every row invalid; probe keys below ``lo``,
    above ``lo + dom - 1`` and at iinfo's ends, and build keys there only
    on invalid rows (the executor's domain holds every valid key of both
    sides; the reference would wrap a valid build key outside it into the
    table); the domain's ends as valid build keys; int64 keys beyond 2^32
    with ``lo`` near them (keys 2^32 off the domain's must miss); probes of
    1-17 and 511-513 rows; every array a slice 1-15 elements into its
    storage; ``dom = DIRECT_MAX_DOMAIN``. L1: n = 1, and a tile
    (``COMPACT_TILE``) and a span of the count pass's tiles each less one,
    itself, one more and twice it plus one; every row present, none, a
    third, runs of 300 and runs across the tiles' edges; masks sliced 1-15
    bytes into their storage (the tiles are cut at the mask's 16-byte
    boundaries, so a slice moves their edges); a million rows, and
    5,000,011 (1,221 tiles: more blocks than the card holds at once)."""
    import numpy as np
    from nds_tpu_torch.engine import kernels as KX

    def rng_of(label):
        return case_rng(53, label)

    on = view_on

    def build(rng, nb, lo, dom, kdt, valid, valid_rows=None):
        keys = rng.integers(0, dom, nb) + lo
        ok = rng.random(nb) < valid
        if valid_rows is not None:
            ok[valid_rows:] = False
        if valid > 0:
            keys[:2] = [lo, lo + dom - 1]
            ok[:2] = True
        # invalid rows carry junk: below and above the domain, iinfo's ends,
        # keys 2^32 off the domain's (int64), or a valid row's key
        info = np.iinfo(kdt)
        r = rng.random(nb)
        junk = np.where(r < 0.25, rng.integers(lo - 3 * dom, lo, nb),
                        np.where(r < 0.5, rng.integers(lo + dom,
                                                       lo + 4 * dom, nb),
                                 rng.permutation(keys)))
        junk[r > 0.95] = info.min
        junk[r > 0.97] = info.max
        if kdt == np.int64:
            off = np.where(rng.random(nb) < 0.5, 1 << 32, -(1 << 32))
            junk = np.where((r > 0.5) & (r < 0.7), keys + off, junk)
        return np.where(ok, keys, junk).astype(kdt), ok

    def probe(rng, n, lo, dom, kdt, valid=0.9):
        keys = rng.integers(lo - dom, lo + 2 * dom, n)
        info = np.iinfo(kdt)
        if kdt == np.int64:
            off = np.where(rng.random(n) < 0.5, 1 << 32, -(1 << 32))
            keys = np.where(rng.random(n) < 0.2, keys + off, keys)
        edges = np.array([lo - 1, lo, lo + dom - 1, lo + dom, info.min,
                          info.max], dtype=np.int64)
        keys[:min(n, len(edges))] = edges[:n]
        return keys.astype(kdt), rng.random(n) < valid

    makers = []

    def k3(label, nb, np_, lo, dom, kdt, valid=0.9, valid_rows=None,
           offs=(0, 0, 0, 0)):
        def make(dev):
            rng = rng_of(label)
            bk, bo = build(rng, nb, lo, dom, kdt, valid, valid_rows)
            pk, po = probe(rng, np_, lo, dom, kdt)
            return (on(dev, bk, offs[0]), on(dev, bo, offs[1]),
                    on(dev, pk, offs[2]), on(dev, po, offs[3]), lo, dom)
        makers.append(("bitmask_semi", label, make))

    for n in list(range(1, 18)) + [511, 512, 513]:
        k3(f"int32, dense build of 200003 rows over 5000 keys, np={n}",
           200_003, n, -1000, 5000, np.int32)
    for n in (1, 2, 3, 15, 16, 17, 511, 513):
        k3(f"int64 keys near 2^35, np={n}", 60_001, n, (1 << 35) + 17,
           30_000, np.int64)
    k3("int32, dense build of 200003 rows over 5000 keys, np=100003",
       200_003, 100_003, -1000, 5000, np.int32)
    k3("int32, padded build: 1000003 rows, 3% valid then invalid",
       1_000_003, 300_007, 7, 50_000, np.int32, valid=0.6,
       valid_rows=50_000)
    k3("int64, padded build: 1000003 rows, 1% valid then invalid",
       1_000_003, 300_007, -(1 << 40), 50_000, np.int64, valid=0.2,
       valid_rows=50_000)
    k3("int32, every build row invalid", 100_000, 100_003, 0, 5000,
       np.int32, valid=0.0)
    k3("int64 keys near 2^35, keys 2^32 off the domain, np=1000003",
       500_000, 1_000_003, (1 << 35) + 17, 300_000, np.int64, valid=0.7)
    for offs in ((1, 3, 5, 7), (4, 2, 9, 15), (0, 0, 3, 0), (13, 11, 1, 6)):
        k3(f"int32, slices off by {offs} elements", 200_003, 300_007, -1000,
           20_000, np.int32, offs=offs)
    k3("int64, slices off by (1, 13, 1, 6) elements", 200_003, 300_007,
       (1 << 35) + 17, 20_000, np.int64, offs=(1, 13, 1, 6))
    k3("int32, dom = DIRECT_MAX_DOMAIN", 1_000_000, 1_000_003, 5,
       KX.DIRECT_MAX_DOMAIN, np.int32, valid=0.8)

    def rows_of(rng, n, what):
        i = np.arange(n)
        return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                "a third": rng.random(n) < 1 / 3,
                "runs of 300": (i // 300) % 2 == 0,
                # present within 40 rows of every multiple of 4,096
                "runs across the tiles' edges": (i + 40) % 4096 < 80}[what]

    def l1(label, n, what, off=0):
        def make(dev):
            return (on(dev, rows_of(rng_of(label), n, what), off),)
        makers.append(("compact_perm", label, make))

    l1("n=1, present", 1, "all")
    l1("n=1, absent", 1, "none")
    for tile in (COMPACT_TILE, COMPACT_TILE * COMPACT_SPAN_TILES):
        for n in (tile - 1, tile, tile + 1, 2 * tile + 1):
            for what in ("all", "none", "a third", "runs of 300",
                         "runs across the tiles' edges"):
                l1(f"n={n}, {what} present", n, what)
    for off in (1, 7, 8, 15):
        for n in (COMPACT_TILE + 1, 2 * COMPACT_TILE * COMPACT_SPAN_TILES
                  + 1):
            for what in ("a third", "runs across the tiles' edges"):
                l1(f"n={n}, {what} present, sliced {off} bytes in", n, what,
                   off)
    l1("n=1000003, a third present", 1_000_003, "a third")
    l1("n=1000003, runs across the tiles' edges, sliced 5 bytes in",
       1_000_003, "runs across the tiles' edges", 5)
    l1("n=5000011, runs of 300 present, sliced 9 bytes in", 5_000_011,
       "runs of 300", 9)
    return makers


def maker_checks(makers: list, phase: str, designs: dict, dev) -> list:
    """Runs the cases of ``makers`` (``semi_compact_case_makers``,
    ``minmax_rle_case_makers``), one on the card at a time, exactly and
    untimed, on each design of ``designs`` (name -> a checkout's
    ``kernels``)."""
    KX = designs["this"]
    out = []
    for name, label, make in makers:
        args = make(dev)
        exp = getattr(KX, name + "_plain")(*args)
        for who, kx in designs.items():
            err, ok = agrees(name, args, getattr(kx, name)(*args), exp)
            if not ok:
                raise SmokeError(f"{name} [{label}] on {who} differs from "
                                 f"its plain version: max_abs_err={err}")
            out.append({"kernel": name, "design": who, "case": label,
                        "max_abs_err": err})
        del args, exp
    log(json.dumps({"phase": phase, "cases": len(out),
                    "max_abs_err": max(c["max_abs_err"] for c in out)}))
    return out


# K9's tiles (csrc/columnar_decode.cu: 32 KB of output, 4,096 int64 rows or
# 8,192 int32): the cases put starts at the multiples of the smaller, which
# hold those of the larger, and runs longer than the larger
RLE_TILE = 4096


def minmax_rle_case_makers() -> list:
    """(kernel, label, make) of K4 (``keyed_minmax_semi``) and K9
    (``rle_decode``), in the pattern of ``semi_compact_case_makers``: each
    ``make(dev)`` draws its case from a seed of its own with numpy. The
    card holds each kernel exactly to its plain version on them, and
    ``tests/test_torch_minmax_rle.py`` each plain version to the JAX
    reference on the CPU. K4: keys whose only build value is iinfo.max or
    iinfo.min (the slot's presence is min <= max), values at both ends,
    every build row invalid, no build rows, ``dom = 1``, build and probe
    keys below ``lo`` and at or past ``lo + dom`` (a valid build key below
    ``lo`` in a case of its own), probes mostly with ``pok`` false, keys
    with one value repeated and with two values, clustered and shuffled
    keys, row counts of 1-17 and 511-513, values at another alignment than
    their keys, int32 keys with int64 values and int64 keys (near 2^35)
    with int32 values, ``dom = DIRECT_MAX_DOMAIN``. K9: one run, runs of
    one row, runs longer than a tile, starts on each side of a tile's
    edges, a padded view, runs that start past ``n``, ``n`` below one
    16-byte vector and no multiple of it, runs of about 4 rows over a
    million rows, values at iinfo's ends; int32 and int64 values."""
    import numpy as np
    from nds_tpu_torch.engine import kernels as KX

    def rng_of(label):
        return case_rng(61, label)

    on = view_on
    makers = []

    def values_of(rng, n, vdt, how):
        info = np.iinfo(vdt)
        if how == "ends":
            return rng.choice(np.array([info.min, info.min + 1, -1, 0, 1,
                                        info.max - 1, info.max], vdt), n)
        return rng.integers(info.min, info.max, n, dtype=np.int64
                            if vdt == np.int64 else np.int32,
                            endpoint=True).astype(vdt)

    def k4(label, nb, np_, lo, dom, kdt=np.int32, vdt=np.int32, valid=0.8,
           order="clustered", vals="spread", below=False, pok=0.9,
           offs=(0,) * 6):
        """Build keys over the domain, ``order``: "clustered" (runs of 1-7
        rows a key, sorted, as lineitem by orderkey), "shuffled", "one
        value" (clustered, one value a key) or "two values" (clustered,
        two values a key); invalid rows carry junk keys (below ``lo``, past
        the domain, iinfo's ends) and values; with ``below``, a tenth of
        the valid rows have keys below ``lo``. Probe keys: half the build's
        keys, the rest over and around the domain and at iinfo's ends; a
        probe value is its key's first build value half the time."""
        def make(dev):
            rng = rng_of(label)
            kinfo = np.iinfo(kdt)
            lens = rng.integers(1, 8, nb + 1)
            keys = np.repeat(rng.integers(0, dom, nb + 1), lens)[:nb]
            keys = (rng.permutation(keys) if order == "shuffled"
                    else np.sort(keys))
            v = values_of(rng, nb, vdt, vals)
            if order in ("one value", "two values"):
                per_key = values_of(rng, dom, vdt, vals)
                v = per_key[keys]
                if order == "two values":
                    other = values_of(rng, dom, vdt, vals)[keys]
                    v = np.where(rng.random(nb) < 0.5, v, other)
            keys = keys + lo
            ok = rng.random(nb) < valid
            r = rng.random(nb)
            junk = np.where(r < 0.4, rng.integers(lo - 3 * dom, lo, nb),
                            rng.integers(lo + dom, lo + 4 * dom, nb))
            junk[r > 0.9] = kinfo.min
            junk[r > 0.95] = kinfo.max
            bkey = np.where(ok, keys, junk)
            # valid build keys at or past the domain's end: skipped
            past = ok & (rng.random(nb) < 0.05)
            bkey = np.where(past, rng.integers(lo + dom, lo + 4 * dom, nb),
                            bkey)
            if below:
                bkey = np.where(ok & (rng.random(nb) < 0.1),
                                rng.integers(lo - 3 * dom, lo, nb), bkey)
            bval = np.where(ok, v, values_of(rng, nb, vdt, "ends"))
            pick = rng.integers(0, max(nb, 1), np_)
            pk = np.where((rng.random(np_) < 0.5) & (nb > 0),
                          np.concatenate([keys, [lo]])[pick],
                          rng.integers(lo - dom - 2, lo + 2 * dom + 2, np_))
            edges = np.array([lo - 1, lo, lo + dom - 1, lo + dom, kinfo.min,
                              kinfo.max], dtype=np.int64)
            pk[:min(np_, len(edges))] = edges[:np_]
            pv = np.where((rng.random(np_) < 0.5) & (nb > 0),
                          np.concatenate([bval, [0]]).astype(vdt)[pick],
                          values_of(rng, np_, vdt, vals))
            po = rng.random(np_) < pok
            arrs = (bkey.astype(kdt), ok, bval.astype(vdt), pk.astype(kdt),
                    po, pv.astype(vdt))
            return (*(on(dev, a, o) for a, o in zip(arrs, offs)), lo, dom)
        makers.append(("keyed_minmax_semi", label, make))

    def k4_only_value(label, kdt, vdt, lo):
        """64 keys, each with one valid build row (or none: keys 48-63)
        whose value is iinfo.max, iinfo.min or 7, among invalid rows of
        every key; each key probed with its value, with another, and with
        iinfo.max and iinfo.min."""
        def make(dev):
            info = np.iinfo(vdt)
            rng = rng_of(label)
            dom = 64
            keys = np.arange(48)
            v = np.array([info.max, info.min, 7], vdt)[keys % 3]
            jk = rng.integers(0, dom, 200)
            bkey = np.concatenate([keys, jk]) + lo
            bok = np.concatenate([np.ones(48, bool), np.zeros(200, bool)])
            bval = np.concatenate([v, values_of(rng, 200, vdt, "ends")])
            perm = rng.permutation(len(bkey))
            pk = np.tile(np.arange(dom), 4) + lo
            own = np.concatenate([v, np.full(16, 7, vdt)])
            other = np.where(own == info.min, own + 1, own - 1)
            pv = np.concatenate([own, other, np.full(dom, info.max, vdt),
                                 np.full(dom, info.min, vdt)]).astype(vdt)
            arrs = (bkey[perm].astype(kdt), bok[perm], bval[perm],
                    pk.astype(kdt), np.ones(len(pk), bool), pv)
            return (*(on(dev, a) for a in arrs), lo, dom)
        makers.append(("keyed_minmax_semi", label, make))

    for kdt, vdt, lo in ((np.int32, np.int32, -5), (np.int32, np.int64, 11),
                         (np.int64, np.int64, (1 << 35) + 17)):
        k4_only_value(f"{np.dtype(kdt)} keys, {np.dtype(vdt)} values: keys "
                      f"whose only build value is iinfo.max or iinfo.min",
                      kdt, vdt, lo)
    k4("int32 keys, int64 values at both ends, clustered keys", 200_003,
       200_011, 0, 40_000, vdt=np.int64, vals="ends")
    k4("int64 keys near 2^35, int32 values at both ends", 200_003, 200_011,
       (1 << 35) + 17, 40_000, kdt=np.int64, vals="ends")
    k4("every build row invalid", 100_000, 100_003, 0, 5000, valid=0.0)
    k4("no build rows", 0, 10_007, 0, 5000)
    k4("no build rows, int64 keys and values", 0, 513, -9, 77,
       kdt=np.int64, vdt=np.int64)
    k4("dom = 1", 50_001, 50_003, 3, 1)
    k4("dom = 1, int64 values at both ends", 1001, 1003, -2**31, 1,
       vdt=np.int64, vals="ends")
    k4("build and probe keys below lo and at or past lo + dom", 300_007,
       300_011, -1000, 20_000, valid=0.6)
    k4("valid build keys below lo", 300_007, 300_011, 100, 20_000,
       below=True)
    k4("valid build keys below lo, int64 keys and values", 100_003, 100_007,
       (1 << 35) + 17, 20_000, kdt=np.int64, vdt=np.int64, below=True)
    k4("probe rows mostly with pok false", 200_003, 200_011, 0, 40_000,
       pok=0.1)
    k4("keys with one value repeated", 400_009, 400_013, 5, 100_000,
       order="one value")
    k4("keys with one value repeated, int64 values at both ends", 400_009,
       400_013, 5, 100_000, vdt=np.int64, order="one value", vals="ends")
    k4("keys with two values", 400_009, 400_013, 5, 100_000,
       order="two values")
    k4("keys with two values at both ends, int64 keys and values", 400_009,
       400_013, -(1 << 40), 100_000, kdt=np.int64, vdt=np.int64,
       order="two values", vals="ends")
    k4("clustered keys, 1000003 rows", 1_000_003, 1_000_003, 0, 250_000,
       valid=0.63)
    k4("shuffled keys, 1000003 rows", 1_000_003, 1_000_003, 0, 250_000,
       valid=0.63, order="shuffled")
    for n in list(range(1, 18)) + [511, 512, 513]:
        k4(f"int32 keys and values, nb = np = {n}", n, n, -3, 64)
    for n in (1, 2, 3, 15, 16, 17, 511, 513):
        k4(f"int64 keys and values, nb = np = {n}", n, n, (1 << 35) + 17, 64,
           kdt=np.int64, vdt=np.int64)
    for kdt, vdt, offs in ((np.int32, np.int32, (0, 0, 1, 0, 0, 3)),
                           (np.int32, np.int32, (1, 3, 2, 5, 7, 1)),
                           (np.int32, np.int64, (0, 0, 1, 0, 0, 1)),
                           (np.int32, np.int64, (4, 4, 2, 4, 4, 2)),
                           (np.int64, np.int32, (0, 0, 1, 0, 0, 3)),
                           (np.int64, np.int64, (1, 13, 0, 1, 6, 1))):
        k4(f"{np.dtype(kdt)} keys, {np.dtype(vdt)} values at other "
           f"alignments, slices off by {offs} elements", 200_003, 300_007,
           -1000, 20_000, kdt=kdt, vdt=vdt, offs=offs)
    k4("int32 keys with int64 values, clustered, 1000003 rows", 1_000_003,
       1_000_003, 0, 250_000, vdt=np.int64, valid=0.63)
    k4("int64 keys with int32 values, clustered, 1000003 rows", 1_000_003,
       1_000_003, (1 << 35) + 17, 250_000, kdt=np.int64, valid=0.63)
    k4("dom = DIRECT_MAX_DOMAIN", 1_000_000, 1_000_003, 5,
       KX.DIRECT_MAX_DOMAIN, order="shuffled")

    def k9(label, n, starts, vdt, vals="spread"):
        """``starts``: a function of the case's rng giving the run starts
        (int32, strictly increasing from 0)."""
        def make(dev):
            rng = rng_of(label)
            st = np.asarray(starts(rng), dtype=np.int32)
            return (on(dev, values_of(rng, len(st), vdt, vals)), on(dev, st),
                    n)
        makers.append(("rle_decode", label, make))

    def spread(count, hi):
        # ``count`` distinct starts in [1, hi), with 0 first
        return lambda rng: np.concatenate(
            [[0], np.sort(rng.choice(np.arange(1, hi), count,
                                     replace=False))])

    edges = sorted({e + d for e in (RLE_TILE, 2 * RLE_TILE, 3 * RLE_TILE,
                                    4 * RLE_TILE) for d in (-1, 0, 1)})
    for vdt in (np.int32, np.int64):
        t = np.dtype(vdt).name
        k9(f"one run, n=100003, {t}", 100_003, lambda rng: [0], vdt)
        k9(f"every run one row, n=20011, {t}", 20_011,
           lambda rng: np.arange(20_011), vdt)
        k9(f"runs longer than a tile, n=300007, {t}", 300_007,
           lambda rng: np.concatenate([[0], np.cumsum(
               rng.integers(2 * RLE_TILE + 1, 8 * RLE_TILE, 40))[:-1]]), vdt)
        k9(f"starts on each side of a tile's edges, n={5 * RLE_TILE + 3}, "
           f"{t}", 5 * RLE_TILE + 3, lambda rng: [0] + edges, vdt)
        k9(f"starts on each side of a tile's edges among runs of 3 rows, "
           f"n={5 * RLE_TILE}, {t}", 5 * RLE_TILE,
           lambda rng: sorted(set(range(0, 5 * RLE_TILE, 3)) | set(edges)),
           vdt)
        k9(f"a padded view: the runs of 70001 rows decoded to 131072, {t}",
           131_072, spread(17_000, 70_001), vdt)
        k9(f"runs starting past n: 3000 runs over 90000 rows decoded to "
           f"50000, {t}", 50_000, spread(2_999, 90_000), vdt)
        for n in (1, 2, 3, 5, 6, 7, 9, 4097, 8195):
            k9(f"n={n}, runs of 1-3 rows, {t}", n, spread(
                max(0, min(n - 1, (n + 1) // 2)), max(n, 2)), vdt)
        k9(f"runs of about 4 rows, n=1000003, {t}", 1_000_003,
           spread(250_000, 1_000_003), vdt)
        k9(f"values at iinfo's ends, n=65537, {t}", 65_537,
           spread(9_000, 65_537), vdt, vals="ends")
    return makers


# the mask unpack's tile (csrc/columnar_decode.cu: 512 words, 16,384 rows, a
# block) and its largest columnar call (NDS under "auto")
MASK_TILE_ROWS = 16_384
MASK_LARGEST_ROWS = 11_745_000


def mask_case_makers() -> list:
    """(kernel, label, make) of K8's mask unpack (``unpack_mask``), in the
    pattern of ``semi_compact_case_makers``: each ``make(dev)`` gives
    ``(words, n)``, drawn from a seed of its own with numpy. The card holds
    the kernel exactly to its plain version on them, and
    ``tests/test_torch_unpack_mask.py`` the plain version to the JAX
    reference on the CPU. ``n`` of 0, 1, 15-17, 31-33, 511-513, around a
    tile's edge and the largest columnar call's 11,745,000 (no multiple of
    16 among many); words all zero, all one, alternating bits both ways,
    only the sign bit and random; words sliced 1, 2 and 3 words into their
    storage (not 16-byte aligned, the kernel's one-word loads) beside
    aligned ones; more words than ``n`` needs, with bits set past ``n``."""
    import numpy as np

    makers = []
    fills = {"zero": 0, "one": -1, "0x55555555": 0x55555555,
             "0xAAAAAAAA": 0xAAAAAAAA - (1 << 32),
             "sign bit": -(1 << 31)}

    def mask(label, n, pattern="random", off=0, extra=0):
        """``extra`` words past the ``n`` rows' own, all bits set, and the
        unused bits of the last needed word set too."""
        def make(dev):
            need = -(-n // 32)
            if pattern == "random":
                rng = case_rng(67, label)
                w = rng.integers(-2**31, 2**31, need + extra,
                                 dtype=np.int64).astype(np.int32)
            else:
                w = np.full(need + extra, fills[pattern], np.int32)
            if extra:
                w[need:] = -1
                if n % 32:
                    w[need - 1] |= np.int32(-(1 << (n % 32)))
            return (view_on(dev, w, off), n)
        makers.append(("unpack_mask", label, make))

    edges = (0, 1, 15, 16, 17, 31, 32, 33, 511, 512, 513,
             MASK_TILE_ROWS - 1, MASK_TILE_ROWS, MASK_TILE_ROWS + 15,
             MASK_TILE_ROWS + 16, 3 * MASK_TILE_ROWS + 17, MASK_LARGEST_ROWS)
    for n in edges:
        mask(f"n={n}, random words", n)
    for pattern in fills:
        for n in (33, 513, MASK_TILE_ROWS + 17, 1_000_003):
            mask(f"n={n}, words {pattern}", n, pattern)
    for off in (1, 2, 3):
        for n in (17, 513, MASK_TILE_ROWS + 15, 1_000_003, MASK_LARGEST_ROWS):
            mask(f"n={n}, random words sliced {off} words in", n, off=off)
        mask(f"n=31, words one sliced {off} words in", 31, "one", off)
    for n, extra in ((1, 1), (15, 3), (17, 2), (513, 5),
                     (MASK_TILE_ROWS + 1, 600), (1_000_003, 7)):
        for off in (0, 1):
            mask(f"n={n}, {extra} words more than it needs, bits set past "
                 f"n, sliced {off} words in", n, off=off, extra=extra)
    mask(f"n={MASK_LARGEST_ROWS}, words zero, 4 words more than it needs",
         MASK_LARGEST_ROWS, "zero", extra=4)
    return makers


def adversarial_sort_keys(dev, n: int, seed: int) -> dict:
    """Sort keys of ``n`` rows (row mask, ``SortKey`` list) for the packed
    sort's adversarial cases: descending keys and NULLS FIRST and LAST
    ranks, int32 and int64 keys without bounds at their types' minimum
    and maximum (a descending minimum wraps, as the reference's negation
    does), a bounded key filled by the row mask with values out of its
    bounds on absent rows, floats with -0.0, +0.0, NaN of both signs and
    infinities, a bool, over several words; the same keys with every row
    absent and with none."""
    import numpy as np
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    rng = np.random.default_rng(seed)

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    row = rng.random(n) < 0.7
    valid = dt(rng.random(n) < 0.8)
    i32 = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    i32[::7] = np.iinfo(np.int32).min
    i32[1::7] = np.iinfo(np.int32).max
    i64 = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    i64[::5] = np.iinfo(np.int64).min
    i64[1::5] = np.iinfo(np.int64).max
    f64 = rng.integers(-3, 4, n) / 2.0
    f64[::3] = -0.0
    f64[1::9] = np.nan
    f64[2::9] = -np.nan
    f64[3::11] = np.inf
    f64[4::11] = -np.inf
    small = rng.integers(-7, 8, n).astype(np.int32)
    junk = rng.random(n) < 0.5

    def keys(r):
        # out of its bounds only on absent rows, which the fill hides
        sr = np.where(~r & junk, 1000, small).astype(np.int32)
        r = dt(r)
        return [dx.SortKey(r, invert=True), dx.SortKey(valid),
                dx.SortKey(dt(sr), valid, use_row=True, negate=True,
                           lo=-7, hi=7),
                dx.SortKey(dt(i32), negate=True), dx.SortKey(dt(i64), valid),
                dx.SortKey(dt(f64), valid, negate=True),
                dx.SortKey(dt(f64.astype(np.float32))),
                dx.SortKey(dt(rng.random(n) < 0.5), valid, negate=True),
                dx.SortKey(dt(i64), negate=True)]
    none, every = np.zeros(n, bool), np.ones(n, bool)
    return {"mixed": (dt(row), keys(row)),
            "every row absent": (dt(none), keys(none)),
            "no row absent": (dt(every), keys(every))}


def sort_search_cases(dev) -> list:
    """(kernel, args, label) of the sorts, searches and the compactor
    beside the NDS leg's own calls, at up to about 10M rows:
    ``pack_sort_key`` on every word of ``adversarial_sort_keys``, first
    and through a permutation; ``sorted_search`` in every mode over int32
    and int64 keys with a sentinel tail (iinfo.max, as an invalid build
    row holds it) and probes equal to the sentinel and to iinfo.min, into
    no keys, one, 2,048 and 2,049, 144,067 (NDS's largest probe build)
    and 5,000,000, and at the edges of its shared-memory index
    (``search_index_keys``); ``compact_perm`` with every row absent,
    none, and at lengths no multiple of its tile."""
    import numpy as np
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    rng = np.random.default_rng(31)

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    cases = []
    n = 10_000_019
    perm = dt(rng.permutation(n).astype(np.int32))
    for what, (row, keys) in adversarial_sort_keys(dev, n, 37).items():
        for j, (fields, bits) in enumerate(dx._sort_layout(keys, n)):
            args = dx._word_args(row, keys, fields, bits)
            cases.append(("pack_sort_key", args,
                          f"n={n} {what}, word {j} ({bits} bits)"))
            if what == "mixed":
                cases.append(("pack_sort_key", args + (perm,),
                              f"n={n} {what}, word {j} ({bits} bits), "
                              f"through a permutation"))
    for nk, m, dtype in ((0, 1_000_003, np.int32), (1, 1_000_003, np.int64),
                         (2048, 3_000_017, np.int32),
                         (2049, 3_000_017, np.int64),
                         (144_067, 10_000_019, np.int64),
                         (5_000_000, 10_000_019, np.int32)):
        info = np.iinfo(dtype)
        ks = np.sort(rng.integers(-1000, 1000, nk)).astype(dtype)
        ks[nk - nk // 7:] = info.max
        q = rng.integers(-1100, 1100, m).astype(dtype)
        q[::11] = info.max
        q[1::13] = info.min
        tks, tq = dt(ks), dt(q)
        label = f"{m} {dtype.__name__} queries into {nk} keys"
        for mode in ("left", "right", "both"):
            cases.append(("sorted_search", (tks, tq, mode),
                          f"{label}, {mode}"))
        if nk:
            cases.append(("sorted_search",
                          (tks, tq, "probe",
                           dt(rng.permutation(nk).astype(np.int32)),
                           dt(rng.random(m) < 0.9)), f"{label}, probe"))
            cases.append(("sorted_search", (tks, tq, "probe"),
                          f"{label}, probe with no rows and no mask"))
    # the search's shared-memory index: a build that fits it whole, one
    # just past it and one of a single key, all keys equal, queries below
    # and above every key, query counts no multiple of the queries a
    # thread carries, and queries not 16-byte aligned (the scalar path)
    for dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        cap = search_index_keys(dev, dtype == np.int64)
        for nk in (1, cap, cap + 1):
            ks = np.sort(rng.integers(-1000, 1000, nk)).astype(dtype)
            for m in (5, 3_000_017):
                q = rng.integers(-1100, 1100, m).astype(dtype)
                q[::11] = info.max
                q[1::13] = info.min
                tks, tq = dt(ks), dt(q)
                label = (f"{m} {dtype.__name__} queries into {nk} keys (the "
                         f"index holds {cap})")
                for mode in ("left", "right", "both"):
                    cases.append(("sorted_search", (tks, tq, mode),
                                  f"{label}, {mode}"))
                cases.append(("sorted_search",
                              (tks, tq, "probe",
                               dt(rng.permutation(nk).astype(np.int32)),
                               dt(rng.random(m) < 0.9)), f"{label}, probe"))
        m = 1_000_003
        ks = dt(np.full(cap + 3, 5, dtype))
        q = dt(rng.integers(3, 8, m + 1).astype(dtype))[1:]
        pok = dt(rng.random(m + 1) < 0.9)[1:]
        label = f"{m} unaligned {dtype.__name__} queries into {cap + 3} " \
            f"equal keys"
        for mode in ("left", "right", "both"):
            cases.append(("sorted_search", (ks, q, mode), f"{label}, {mode}"))
        cases.append(("sorted_search",
                      (ks, q, "probe",
                       dt(rng.permutation(cap + 3).astype(np.int32)), pok),
                      f"{label}, probe"))
    for nr, what in ((6_480_001, "a third present"), (6_480_001, "none"),
                     (6_480_001, "all"), (4097, "runs"), (1, "all")):
        row = {"a third present": rng.random(nr) < 1 / 3,
               "none": np.zeros(nr, bool), "all": np.ones(nr, bool),
               "runs": (np.arange(nr) // 300) % 2 == 0}[what]
        cases.append(("compact_perm", (dt(row),), f"n={nr}, {what} "
                      f"present"))
    return cases


def search_index_keys(dev, key64: bool) -> int:
    """The most keys the search kernel's shared-memory index holds
    (``csrc/sorted_search.cu``); on the CPU, where no kernel is built,
    the same numbers."""
    if dev.type != "cuda":
        return (1 << 14) - 1 if key64 else (1 << 15) - 1
    from nds_tpu_torch.engine import kernels as KX
    return KX._lib("sorted_search")[1].nds_search_index_keys(int(key64))


def lexsort_operands(row, keys) -> list:
    """A multi-key sort's operands for ``_lexsort`` on the card, each float
    taken as ``lax.sort``'s comparator takes it (-0.0 as +0.0, every NaN
    as +NaN): torch's sort on the card (cub's radix sort) orders -0.0
    before +0.0 and a NaN with its sign bit set below every number, where
    ``lax.sort``, torch's sort on the CPU and ``pack_sort_key`` do not."""
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    ops = []
    for k in keys:
        v = dx._sort_operand(row, k)
        if v.dtype.is_floating_point:
            zero = torch.zeros((), dtype=v.dtype, device=v.device)
            v = torch.where(v == 0, zero, v)
            v = torch.where(torch.isnan(v), float("nan"), v)
        ops.append(v)
    return ops


def sort_chain_checks(dev) -> list:
    """The executor's multi-key sort (``_sort_perm``: every word packed
    and sorted by ``partition_sort``) against ``_lexsort`` of the same
    operands, on ``adversarial_sort_keys``: the permutations must be
    equal."""
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    out = []
    n = 5_000_011
    for what, (row, keys) in adversarial_sort_keys(dev, n, 41).items():
        got = dx._sort_perm(row, keys, n, dev).to(torch.int64)
        exp = dx._lexsort(lexsort_operands(row, keys), n, dev)
        differ = torch.nonzero(got != exp).flatten()
        rec = {"kernel": "pack_sort_key",
               "case": f"sort chain against _lexsort, n={n}, {what}",
               "words_bits": [b for _f, b in dx._sort_layout(keys, n)],
               "max_abs_err": float("inf") if differ.numel() else 0.0}
        if differ.numel():
            at = int(differ[0])
            rec["first_difference"] = {
                "at": at, "rows": [int(got[at]), int(exp[at])],
                "operands": [[float(o[int(got[at])]), float(o[int(exp[at])])]
                             for o in lexsort_operands(row, keys)]}
        log(json.dumps(rec))
        if differ.numel():
            raise SmokeError(f"the packed sort differs from _lexsort: "
                             f"{rec['case']}: {rec['first_difference']}")
        out.append(rec)
    return out


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
    if name == "sort":
        # the executor's multi-key sort (row mask, keys, rows, device)
        return int(args[2]) * len(args[1])
    return sum(a.numel() for a in _tensors(list(args)
                                           + list((kwargs or {}).values())))


def _mapped(x, fn):
    """``x`` with every tensor in it (in lists, tuples and dicts, the
    executor's columns and sort keys) replaced by ``fn(tensor)``."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        # a sort key of the executor
        return dataclasses.replace(x, **{
            f.name: _mapped(getattr(x, f.name), fn)
            for f in dataclasses.fields(x)})
    if type(x).__name__ == "DVal":
        # an executor column, materialized: its arrays, dictionary, bounds
        return x.with_arrays(fn(x.arr),
                             None if x.valid is None else fn(x.valid))
    if isinstance(x, (list, tuple)):
        return type(x)(_mapped(y, fn) for y in x)
    if isinstance(x, dict):
        return {k: _mapped(v, fn) for k, v in x.items()}
    return x


class Recorder:
    """Wraps functions during an untimed pass: per name, its calls and a
    copy of the inputs of its largest call, kept in host memory so that
    the copies do not crowd the card during the pass (``inputs`` puts
    them back). ``targets`` maps a name to the (owner, attribute) of the
    function to wrap; a call's size is ``call_size``. Calls made while a
    plan is captured into its graph are neither counted nor recorded: the
    plan's eager run just before made the same calls."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.calls: dict = {n: 0 for n in targets}
        # key -> (size, args, kwargs, device of the call)
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

    def inputs(self, key) -> tuple:
        """(args, kwargs) of ``key``'s largest call, on its device."""
        _size, args, kwargs, dev = self.largest[key]
        return (_mapped(args, lambda t: t.to(dev)),
                _mapped(kwargs, lambda t: t.to(dev)))

    def _wrap(self, name, fn):
        from nds_tpu_torch.engine import kernels

        def wrapper(*args, **kwargs):
            if kernels.capturing():
                # a plan's graph capture: its inputs are pool memory that
                # the captured kernels have not written yet
                return fn(*args, **kwargs)
            self.calls[name] += 1
            size = call_size(name, args, kwargs)
            keys = [k for k in (name, variant_of(name, args))
                    if k is not None and (k not in self.largest
                                          or size > self.largest[k][0])]
            if keys:
                tens = _tensors(list(args) + list(kwargs.values()))
                dev = tens[0].device if tens else None
                kept = (size, _mapped(args, _host_copy),
                        _mapped(kwargs, _host_copy), dev)
                for k in keys:
                    self.largest[k] = kept
            return fn(*args, **kwargs)
        return wrapper


def _host_copy(t):
    return t.to("cpu", copy=True)


def variant_of(name: str, args) -> "str | None":
    """The calls of a kernel kept apart from its largest call: K5's sums
    (``_seg_sum``, L2) beside its grouped min/max, each mode of
    ``sorted_search``, and the words ``pack_sort_key`` packs through a
    permutation beside the first of a sort."""
    if name == "seg_reduce_at_ends" and args and args[0] == "sum":
        return "seg_reduce_at_ends[sum]"
    if name == "sorted_search":
        return f"sorted_search[{args[2] if len(args) > 2 else 'left'}]"
    if name == "pack_sort_key" and len(args) > 5 and args[5] is not None:
        return "pack_sort_key[gather]"
    return None


def kernel_targets(KX) -> dict:
    """The kernel wrappers, for a ``Recorder``."""
    return {n: (KX, n) for n in KERNELS}


# the executor's steps that ran on torch library calls before this port
# gave them hand kernels (PERF.md's kernel table: the sorts, L3 and L1).
# The raw legs count each step's calls in their untimed pass (the plans fix
# them: the timed pass makes the same) and time its largest call by the
# route it takes now and by the torch calls it replaced, on the same inputs;
# the two must agree exactly
LIBRARY_STEPS = {
    # name: (row, owner of the function, attribute)
    "sort": ("sorts", "module", "_sort_perm"),
    "build_lookup": ("L3 build", "trace", "_build_lookup"),
    "probe": ("L3 probe", "trace", "_probe"),
    "compact": ("L1", "kernels", "compact_perm"),
}
# L2's group-id sort: the pack of each call that takes the packed key, and
# the operands of each that takes the multi-key sort
GROUP_SORT_STEPS = {"pack_group_key": ("module", "_pack_group_key"),
                    "group_operands": ("module", "_group_operands")}
# the torch route of the multi-key sorts: no card leg may call it
NEVER_CALLED = {"lexsort": ("module", "_lexsort")}


def library_targets() -> dict:
    """The executor's former library steps, the group-id sort's two routes
    and ``_lexsort``, for a ``Recorder``."""
    from nds_tpu_torch.engine import device_exec as dx
    from nds_tpu_torch.engine import kernels as KX
    owners = {"module": dx, "trace": dx._Trace, "kernels": KX}
    out = {name: (owners[where], attr)
           for name, (_row, where, attr) in LIBRARY_STEPS.items()}
    for steps in (GROUP_SORT_STEPS, NEVER_CALLED):
        out.update({name: (owners[where], attr)
                    for name, (where, attr) in steps.items()})
    return out


def _sort_bytes(row, keys, n: int) -> int:
    """The bytes a multi-key sort must move: each operand's values and
    validity and the row mask (where a key fills by it) read once, the
    int32 permutation written once."""
    uses_row = any(k.use_row for k in keys)
    return (sum(nbytes(k.arr) + nbytes(k.valid) for k in keys)
            + (nbytes(row) if uses_row else 0) + 4 * n)


def sort_words(kx, dx, row, keys, n: int) -> list:
    """Per word of a multi-key sort on one design (``kx``, ``dx``: the
    ``kernels`` and ``device_exec`` of a checkout), the most significant
    first: its bits, its key type, its digit passes and those that move
    rows on these keys (``sort_passes``; a word's digits do not depend on
    the permutation it is packed through), and the bytes its pack and its
    sort move by the design's model: the pack reads its operands (and the
    permutation, after the first word) and writes the word; a sort that
    counts its own digits reads the word once more; each pass that moves
    reads and writes the key and the row id."""
    out = []
    for j, (fields, bits) in enumerate(reversed(dx._sort_layout(keys, n))):
        args = dx._word_args(row, keys, fields, bits)
        packed = kx.pack_sort_key(*args)
        # a design whose pack counts the digits returns (word, counts)
        counted = isinstance(packed, tuple)
        word = packed[0] if counted else packed
        moved, passes = sort_passes(word)
        kb = word.element_size()
        pack = (nbytes(args[1]) + nbytes([v for v in args[2] if v is not None])
                + nbytes(args[0]) + (4 * n if j else 0) + kb * n)
        out.append({"bits": bits, "dtype": str(word.dtype).replace(
                        "torch.", ""),
                    "passes": passes, "passes_moved": moved,
                    "pack_bytes": pack,
                    "hist_bytes": 0 if counted else kb * n,
                    "pass_bytes": moved * 2 * n * (kb + 4)})
        del packed, word
    return out[::-1]


def replaced_step(name: str, args, lexsort, dev) -> tuple:
    """(the torch calls a step replaced, on its inputs, as a function;
    the bytes the step must move; its extra record): the successive
    stable sorts of the operands (``_lexsort``), the stable ``torch.sort``
    of the build's sentinel keys, ``torch.searchsorted`` with the probe's
    gathers, the stable ``torch.sort`` of the 0/1 key."""
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    from nds_tpu_torch.engine import kernels as KX
    extra = {}
    if name == "sort":
        row, keys, n, _device = args
        ops = lexsort_operands(row, keys)
        layout = dx._sort_layout(keys, n)
        moved = _sort_bytes(row, keys, n)
        extra["words_bits"] = [b for _f, b in layout]
        extra["words"] = sort_words(KX, dx, row, keys, n)
        # the least significant word alone: the radix sort (given the
        # pack's counts) against one torch.sort of it
        word, hist = KX.pack_sort_key(*dx._word_args(row, keys, *layout[-1]))
        iota = torch.arange(n, dtype=torch.int32, device=dev).view(1, n)
        counts = torch.full((1,), n, dtype=torch.int32, device=dev)
        extra["word_sort_ms"] = time_ms(
            lambda: KX.partition_sort(word.view(1, n), iota, counts, hist),
            dev)
        extra["word_torch_sort_ms"] = time_ms(
            lambda: torch.sort(word, stable=True), dev)
        extra["word_bound_ms"] = 2 * n * (word.element_size() + 4) \
            / HBM_BYTES_PER_S * 1000
        return (lambda: lexsort(ops, n, dev)), moved, extra
    if name == "build_lookup":
        key, ok = args
        sent = torch.iinfo(key.dtype).max

        def old():
            return torch.sort(torch.where(ok, key, torch.full_like(key, sent)),
                              stable=True)
        return old, nbytes(list(args)) + key.numel() * (
            key.element_size() + 4), extra
    if name == "probe":
        ks, order, pkey, pok = args
        n = ks.shape[0]
        ks2, pk2 = dx._promoted(ks, pkey)

        def old():
            pos = torch.searchsorted(ks2, pk2).clamp(0, n - 1)
            hit = (ks2.index_select(0, pos) == pk2) & pok
            return order.index_select(0, pos), hit
        extra["searchsorted_ms"] = time_ms(
            lambda: torch.searchsorted(ks2, pk2), dev)
        return old, nbytes(list(args)) + pkey.numel() * 5, extra
    row = args[0]

    def old():
        return (torch.sort((~row).to(torch.int32), stable=True)[1],
                row.sum())
    return old, nbytes(row) + 4 * row.numel() + 8, extra


def plain_route(KX, fn, args):
    """``fn(*args)`` with every kernel wrapper it calls swapped for its
    plain version, which then runs on the card's tensors."""
    saved = {n: getattr(KX, n) for n in KERNELS}
    try:
        for n in KERNELS:
            setattr(KX, n, getattr(KX, n + "_plain"))
        return fn(*args)
    finally:
        for n, f in saved.items():
            setattr(KX, n, f)


def library_step_checks(lib: Recorder, label: str, dev) -> list:
    """Each former library step's largest call timed on the card (CUDA
    events, median of 7) by its route now (``ms``, ``device_ms``) and by
    the torch calls it replaced (``library_ms``, ``library_device_ms``),
    with the bytes it must move and their bound, and for the sorts and
    L3's build by their plain route (``plain_route``: every kernel the
    step launches swapped for its plain version, ``plain_ms``); the two
    routes' results must be equal."""
    import torch
    from nds_tpu_torch.engine import kernels as KX
    out = []
    lexsort = lib.function("lexsort")
    for name, (row, where, attr) in LIBRARY_STEPS.items():
        if name not in lib.largest:
            continue
        args = lib.inputs(name)[0]
        # a kernel wrapper as the module holds it now: the recorders of the
        # warm pass are gone
        fn = getattr(KX, attr) if where == "kernels" else lib.function(name)
        old, moved, extra = replaced_step(name, args, lexsort, dev)
        got, exp = fn(*args), old()
        same = all(a.shape == b.shape and torch.equal(a.to(torch.int64),
                                                      b.to(torch.int64))
                   for a, b in zip(_tensors(got), _tensors(exp)))
        if not same:
            raise SmokeError(f"{label}: the {name} step differs from the "
                             f"torch calls it replaced at its largest call")
        bound_ms, bound_by = bound(moved, 0)
        shapes = (_tensors(list(args)) if name != "sort" else
                  [t for k in args[1] for t in _tensors([k.arr, k.valid])])
        rec = {"step": name, "row": row, "path": label,
               "calls": lib.calls[name],
               "shapes": [list(t.shape) + [str(t.dtype).replace("torch.", "")]
                          for t in shapes],
               "ms": time_ms(lambda: fn(*args), dev),
               "device_ms": time_ms(lambda: fn(*args), dev, spin=True),
               "library_ms": time_ms(old, dev),
               "library_device_ms": time_ms(old, dev, spin=True),
               "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by,
               **extra}
        if name in ("sort", "build_lookup"):
            rec["plain_ms"] = time_ms(lambda: plain_route(KX, fn, args), dev)
        log(json.dumps(rec))
        out.append(rec)
    return out


def parent_steps(parent, lib: Recorder, rec: Recorder, label: str,
                 dev) -> list:
    """The sorts' and the probe's largest calls of a leg, and on the NDS
    leg its largest "left", "right" and "both" searches; L3's build and the
    largest calls of K1-K4, ``partition_sort``, K6, K5's sum, K7's scan
    and the running max; and L2's pack, sort and group bounds at L2's
    largest call (``l2_steps``), on the design of another checkout (``parent``:
    ``load_parent``'s) beside this one's, on the same inputs: both results
    must be equal; each design timed by
    the call method (``ms``) and by device ms (``device_ms``, a spin
    kernel hiding the host), median of 5 in turns (parent, this, this,
    parent; each the mean of its two turns), beside the bytes the call
    must move and their bound; for the sorts, each design's words
    (``sort_words``)."""
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    from nds_tpu_torch.engine import kernels as KX
    pkx, pdx = parent
    cases = []
    if "sort" in lib.largest:
        cases.append(("sort", lib.inputs("sort")[0], lib.function("sort"),
                      pdx._sort_perm))
    if "probe" in lib.largest:
        cases.append(("probe", lib.inputs("probe")[0],
                      lib.function("probe"), pdx._Trace._probe))
    for mode in (("left", "right", "both") if label == "nds" else ()):
        key = f"sorted_search[{mode}]"
        if key in rec.largest:
            cases.append((key, rec.inputs(key)[0], KX.sorted_search,
                          pkx.sorted_search))
    # the kernels this checkout leaves as they were, beside the parent's
    if "build_lookup" in lib.largest:
        cases.append(("build_lookup", lib.inputs("build_lookup")[0],
                      lib.function("build_lookup"),
                      pdx._Trace._build_lookup))
    for key in ("direct_lookup_join", "matmul_probe_join", "bitmask_semi",
                "keyed_minmax_semi", "partition_sort", "partitioned_mn_join",
                "seg_reduce_at_ends[sum]", "seg_scan", "running_max"):
        if key in rec.largest:
            name = key.split("[")[0]
            cases.append((key, rec.inputs(key)[0], getattr(KX, name),
                          getattr(pkx, name)))
    out = []
    # L2's packed route at its largest call: the pack, the sort and the
    # group bounds on each design
    if "pack_group_key" in lib.largest:
        (row, keyvals, fields, bits), _kw = lib.inputs("pack_group_key")
        G = dx._Trace._group_capacity(row.shape[0], keyvals)
        r = {"step": "l2", "path": label, **l2_steps(
            {"parent": pkx, "this": KX}, row,
            [kv.arr.contiguous() for kv in keyvals],
            [None if kv.valid is None else kv.valid.contiguous()
             for kv in keyvals], fields, bits, G, dev)}
        log(json.dumps({"phase": f"{label} beside the parent design", **r}))
        out.append(r)
        del row, keyvals
    for name, args, fn, pfn in cases:
        got, exp = fn(*args), pfn(*args)
        same = all(a.shape == b.shape and torch.equal(a.to(torch.int64),
                                                      b.to(torch.int64))
                   for a, b in zip(_tensors(got), _tensors(exp)))
        if not same:
            raise SmokeError(f"{label}: the {name} step of the parent "
                             f"checkout's design differs from this one's")
        if name == "sort":
            moved = _sort_bytes(*args[:3])
            shapes = [t for k in args[1] for t in _tensors([k.arr, k.valid])]
        else:
            moved = nbytes(list(args)) + nbytes(got)
            shapes = _tensors(list(args))
        del got, exp
        tm = time_designs({"parent": functools.partial(pfn, *args),
                          "this": functools.partial(fn, *args)}, dev)
        bound_ms, bound_by = bound(moved, 0)
        r = {"step": name, "path": label,
             "shapes": [list(t.shape) + [str(t.dtype).replace("torch.", "")]
                        for t in shapes],
             "ms": tm["this"]["ms"], "device_ms": tm["this"]["device_ms"],
             "parent_ms": tm["parent"]["ms"],
             "parent_device_ms": tm["parent"]["device_ms"],
             "turns": {who: d["turns"] for who, d in tm.items()},
             "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by}
        if name == "sort":
            r["words"] = sort_words(KX, dx, *args[:3])
            r["parent_words"] = sort_words(pkx, pdx, *args[:3])
        log(json.dumps({"phase": f"{label} beside the parent design", **r}))
        out.append(r)
    return out


# the kernels whose time depends on their data's shares (``join_data``):
# the gather joins K1 and K2, and K3
DATA_KERNELS = ("direct_lookup_join", "matmul_probe_join", "bitmask_semi")


def join_data(name: str, args) -> dict:
    """What a K1, K2 or K3 call's time depends on beside its shapes: the
    shares of valid build and probe rows; for K1 and K3 the domain and the
    share of probe keys inside it, and for K3 the distinct valid build keys
    over the domain; for K2 the distinct valid build keys and the span of
    their values."""
    import torch
    bkey, bok, pkey, pok = args[:4]
    out = {"build_valid": float(bok.float().mean()) if bok.numel() else 0.0,
           "probe_valid": float(pok.float().mean()) if pok.numel() else 0.0}
    if name in ("direct_lookup_join", "bitmask_semi"):
        lo, dom = args[4:6]
        pos = pkey.to(torch.int64) - lo
        out.update(lo=lo, dom=dom, probe_in_domain=float(
            ((pos >= 0) & (pos < dom)).float().mean()))
        if name == "bitmask_semi":
            slots = bkey[bok].to(torch.int64) - lo
            slots = slots[(slots >= 0) & (slots < dom)]
            out["distinct_over_dom"] = int(torch.unique(slots).numel()) / dom
    else:
        valid = bkey[bok].to(torch.int64)
        out.update(distinct_keys=int(torch.unique(valid).numel()),
                   span=int(valid.max() - valid.min() + 1)
                   if valid.numel() else 0)
    return out


def time_designs(designs: dict, dev, profile: bool = False) -> dict:
    """design -> its times, for each design (name -> a call of no
    arguments) of one step on the same inputs: by the call method
    (``ms``) and by device ms (``device_ms``), median of 5 each, in turns
    (the designs in order, then in reverse: parent, this, this, parent),
    each the mean of its two turns; with ``profile``, also the device ms
    of each kernel the call launches (``kernel_device_ms``)."""
    names = list(designs)
    turns: dict = {}
    for who in names + names[::-1]:
        f = designs[who]
        turns.setdefault(who, []).append(
            (time_ms(f, dev, reps=5, warm=1),
             time_ms(f, dev, reps=5, warm=1, spin=True)))
    return {who: {"ms": sum(t[0] for t in ts) / len(ts),
                  "device_ms": sum(t[1] for t in ts) / len(ts),
                  "turns": ts,
                  **({"kernels": kernel_device_ms(designs[who], dev)}
                     if profile else {})}
            for who, ts in turns.items()}


# --steps: the checks that hold a step exactly beside its timing, and the
# graph cases that replay it ("l2" is L2's pack, sort and group bounds)
STEP_CHECKS = {"direct_lookup_join": "join", "matmul_probe_join": "join",
               "bitmask_semi": "semi_compact", "compact_perm": "semi_compact",
               "keyed_minmax_semi": "minmax_rle", "rle_decode": "minmax_rle",
               "unpack_mask": "mask", "l2": "l2"}
STEP_GRAPHS = {"l2": ("pack_group_key", "group_bounds"),
               "bitmask_semi": ("bitmask_semi",),
               "compact_perm": ("compact_perm",),
               "keyed_minmax_semi": ("keyed_minmax_semi",),
               "rle_decode": ("rle_decode",)}
# --steps: a seeded call of a step beside the legs' own (the compactor at
# the row count of NDS's largest compactor call and one more, a third of
# the rows present)
STEP_SEEDED_ROWS = 6_480_001


def design_step_row(name: str, args, label: str, designs: dict,
                    dev) -> dict:
    """One call of ``--steps``: each design held exactly to the plain
    version, then timed in turns with each kernel's device ms
    (``time_designs``); beside them the bytes and bound, the plain
    version's time and the library call's (``library_call``, held to the
    kernel where it computes the same thing), and for K1-K3 the data's
    shares (``join_data``)."""
    KX = designs["this"]
    plain = functools.partial(getattr(KX, name + "_plain"), *args)
    t0 = time.perf_counter()
    exp = plain()
    plain_first_s = time.perf_counter() - t0
    calls = {who: functools.partial(getattr(kx, name), *args)
             for who, kx in designs.items()}
    for who, call in calls.items():
        err, ok = agrees(name, args, call(), exp)
        if not ok:
            raise SmokeError(f"{name} [{label}] on {who} differs from its "
                             f"plain version: max_abs_err={err}")
    moved, ops = work_of(name, list(args), exp)
    bound_ms, bound_by = bound(moved, ops)
    all_keys = all_keys_bound(name, args, exp, ops)
    lib = library_call(name, args)
    if lib is not None:
        library_agrees(name, args, exp, lib())
    del exp
    r = {"step": name, "case": label,
         "shapes": [list(t.shape) + [str(t.dtype).replace("torch.", "")]
                    for t in _tensors(list(args))],
         **({"data": join_data(name, args)} if name in DATA_KERNELS
            else {}),
         "bytes": moved, "bound_ms": bound_ms, "bound_by": bound_by,
         **all_keys,
         "plain_ms": (plain_first_s * 1000 if plain_first_s > 1.0 else
                      time_ms(plain, dev, reps=3, warm=1)),
         "library_ms": time_ms(lib, dev) if lib is not None else None,
         "library_device_ms": (time_ms(lib, dev, spin=True)
                               if lib is not None else None),
         "designs": time_designs(calls, dev, profile=True)}
    log(json.dumps(r))
    return r


# the NDS units of ``--steps plans``: three plans over store_sales (q19
# reads store and compares substrings through memoized dictionary
# tables; q3 and q42 scan survivor-reduced views of date_dim and item),
# and q5, a staged statement; q52 and q55 bring new view signatures
PLAN_CASE_UNITS = ("3", "19", "42", "5")
PLAN_EVICTING_UNITS = ("52", "55")


def plan_cases(KX, factory_of, dev, sf: float) -> dict:
    """``--steps plans``: the adversarial cases of the graph per plan, on
    the NDS units of ``PLAN_CASE_UNITS`` at ``sf``. Each unit runs once
    (eager, then captured) and then from its graph around each case, and
    every run's rows must equal the CPU oracle's on the same tables: a
    look-back reset and growth of the executor's stream between two
    replays (``reset_and_grow``); a staged temp registered with other
    content (the main plan's graph goes; the sub-plan's replay registers
    the real result again); a table (store) registered again with half its
    rows, against the oracle on the same half; scan-view and memo
    evictions by the bounds set just under what the executor holds; an
    overflow forced after a replay (the slack doubles, the plan runs
    eagerly and captures again)."""
    from nds_tpu_torch.io.host_table import HostColumn, HostTable
    tables = make_tables("nds", sf)
    units = dict(suite_units("nds"))
    factory = factory_of()
    sess, oracle = suite_session("nds", factory), suite_session("nds")
    for t in tables.values():
        sess.register_table(t)
        oracle.register_table(t)
    ex = factory(sess.tables)
    graphs = ex._graphs
    if graphs is None:
        raise SmokeError("--steps plans: the executor has no plan graphs")
    exp = {u: run_query(oracle, units[u]) for u in PLAN_CASE_UNITS}
    cases = []

    def halved(table, name=None):
        k = max(table.nrows // 2, 1)
        return HostTable(name or table.name, table.schema, {
            c: HostColumn(col.dtype, col.values[:k], col.dictionary,
                          None if col.null_mask is None
                          else col.null_mask[:k])
            for c, col in table.columns.items()})

    def check(case: str, names=PLAN_CASE_UNITS) -> dict:
        c0, r0 = graphs.captures, graphs.replays
        bad = []
        for u in names:
            got = run_query(sess, units[u])
            why = unit_mismatch(got.to_pandas(), exp[u].to_pandas(), u,
                                "nds")
            if why is not None:
                bad.append(f"q{u}: {why}")
        r = {"case": case, "units": list(names),
             "captures": graphs.captures - c0,
             "replays": graphs.replays - r0, "graphs": len(graphs.graphs),
             "mismatches": bad}
        log(json.dumps({"phase": "plan case", **r}))
        if bad:
            raise SmokeError(f"plan case {case!r}: " + "; ".join(bad))
        cases.append(r)
        return r

    if check("first run: eager, then captured")["captures"] < len(
            PLAN_CASE_UNITS):
        raise SmokeError("plan cases: a unit captured no graph")
    if check("replays")["captures"]:
        raise SmokeError("plan cases: a replay captured")
    junk = reset_and_grow(KX, graphs.stream)
    check("look-back reset and growth between two replays")
    del junk
    temp = next(t for _o, split, _m in ex._stage_plans.values()
                for _s, t in split)
    ex._register_staged(temp, halved(ex.tables[temp]))
    check("a staged temp whose content changed", ["5"])
    half = halved(tables["store"])
    sess.register_table(half)
    oracle.register_table(half)
    exp.update({u: run_query(oracle, units[u]) for u in PLAN_CASE_UNITS})
    check("store registered again with half its rows")
    ex.MAX_SCAN_VIEWS = len(ex._scan_views) - 1
    ex.DICT_TABLES_MAX = len(ex._dict_tables) - 1
    for u in PLAN_EVICTING_UNITS:
        run_query(sess, units[u])
    check("scan-view and memo evictions")
    del ex.MAX_SCAN_VIEWS, ex.DICT_TABLES_MAX
    check("the bounds restored")
    if check("replays")["captures"]:
        raise SmokeError("plan cases: a replay captured")
    to_host, seen = ex._to_host, [graphs.replays]

    def overflowed(*args):
        if graphs.replays > seen[0]:
            seen[0] = graphs.replays
            return None
        return to_host(*args)
    ex._to_host = overflowed
    try:
        r = check("an overflow forced after a replay", ["3"])
    finally:
        del ex._to_host
    if r["captures"] != 1 or ex.last_timings["slack_retries"] != 1:
        raise SmokeError(f"plan cases: the forced overflow gave {r}")
    out = {"sf": sf, "cases": cases, "graph_pool_resets": graphs.pool_resets,
           "pool_reserved_gib": (graphs.pool_bytes() or 0) / 2**30}
    del ex, sess, factory
    release(dev)
    return out


def design_steps(steps: list, designs: dict, factory_of, dev, sf: float,
                 sf_ds: float) -> dict:
    """``--steps``: each named step on each design of ``designs`` (name ->
    a checkout's ``kernels`` module: "parent" where ``--parent`` is
    given, then "this"). A step is a kernel wrapper of ``KERNELS``, or
    "l2". First the step's graph cases (``graph_replays``) and its
    adversarial checks (``STEP_CHECKS``), exactly: on this design, and
    K3's, L1's, K4's and K9's on every design. Then a wrapper is timed
    (``design_step_row``: each design, with each kernel's device ms) at
    each leg's largest call (captured in an untimed pass of the NDS-H leg
    at ``sf`` and of the NDS leg at ``sf_ds``; the decodes' in a pass of
    each under ``columnar.set_mode("auto")``), at the NDS-H shapes of
    ``sf1_shape_cases``, for the compactor on ``STEP_SEEDED_ROWS`` seeded
    rows, for K9 and the mask unpack at their cases of
    ``decode_sweep_cases`` (the mask unpack also at its largest call's
    size from words off 16-byte alignment), every
    design held exactly to the plain version first;
    "l2" on seeded inputs shaped like L2's largest NDS call
    (``l2_padded_inputs``, ``l2_steps``)."""
    import numpy as np
    import torch
    KX = designs["this"]
    wrappers = [n for n in steps if n != "l2"]
    bad = [n for n in wrappers if n not in KERNELS]
    if bad:
        raise SmokeError(f"--steps: no step {bad}; a step is a kernel "
                         f"wrapper, l2 or bench")
    out: dict = {"steps": steps}
    if dev.type == "cuda":
        graphs = {g for n in steps for g in STEP_GRAPHS.get(n, (n,))}
        out["graph_replays"] = graph_replays(KX, dev, graphs)
    kinds = {STEP_CHECKS[n] for n in steps if n in STEP_CHECKS}
    if "join" in kinds:
        out["join_adversarial_cases"] = len(join_adversarial_checks(KX,
                                                                    dev))
    if "semi_compact" in kinds:
        out["semi_compact_adversarial_cases"] = len(maker_checks(
            semi_compact_case_makers(), "K3/L1 adversarial cases", designs,
            dev))
    if "minmax_rle" in kinds:
        out["minmax_rle_adversarial_cases"] = len(maker_checks(
            minmax_rle_case_makers(), "K4/K9 adversarial cases", designs,
            dev))
    if "mask" in kinds:
        out["mask_adversarial_cases"] = len(maker_checks(
            mask_case_makers(), "K8 mask adversarial cases", designs, dev))
    if "l2" in kinds:
        out["l2_adversarial_cases"] = len(l2_adversarial_checks(KX, dev))
    rows = []
    if "l2" in steps:
        row, arrs, valids, fields, bits = l2_padded_inputs(dev)
        rows.append({"step": "l2", "case": "L2's largest NDS call's shape",
                     **l2_steps(designs, row, arrs, valids, fields, bits,
                                row.shape[0], dev)})
        del row, arrs
        release(dev)
    from nds_tpu_torch import columnar
    for suite, scale in (("nds_h", sf), ("nds", sf_ds)) if wrappers else ():
        tables = make_tables(suite, scale)
        cases = []
        calls = {}
        # the decodes run only under the columnar store: their calls are
        # captured from the leg under "auto", the others' with it off
        for mode, names in ((None, [n for n in wrappers
                                    if n not in DECODE_KERNELS]),
                            ("auto", [n for n in wrappers
                                      if n in DECODE_KERNELS])):
            if not names:
                continue
            columnar.set_mode(mode)
            try:
                dsess = suite_session(suite, factory_of())
                for t in tables.values():
                    dsess.register_table(t)
                with Recorder({n: (KX, n) for n in names}) as rec:
                    for _unit, stmts in suite_units(suite):
                        run_query(dsess, stmts)
            finally:
                columnar.set_mode(None)
            del dsess
            release(dev)
            calls.update(rec.calls)
            cases += [(n, rec.inputs(n)[0], f"{suite} main path"
                       + (f", columnar {mode}" if mode else ""))
                      for n in names if n in rec.largest]
            del rec
        if suite == "nds_h":
            cases += [c for c in sf1_shape_cases(tables, dev)
                      if c[0] in wrappers]
            if "compact_perm" in wrappers:
                rng = np.random.default_rng(59)
                cases.append(("compact_perm", (torch.as_tensor(
                    rng.random(STEP_SEEDED_ROWS) < 1 / 3).to(dev),),
                    f"n={STEP_SEEDED_ROWS}, a third present, seeded"))
        if suite == "nds":
            cases += [c for c in decode_sweep_cases(dev) if c[0] in wrappers
                      and c[0] in ("rle_decode", "unpack_mask")]
        if suite == "nds" and "unpack_mask" in wrappers:
            # the largest call's size from words that are not 16-byte
            # aligned (the kernel's one-word loads)
            rng = np.random.default_rng(67)
            w = rng.integers(-2**31, 2**31, -(-MASK_LARGEST_ROWS // 32),
                             dtype=np.int64).astype(np.int32)
            cases.append(("unpack_mask", (view_on(dev, w, 1),
                                          MASK_LARGEST_ROWS),
                          f"n={MASK_LARGEST_ROWS}, seeded words sliced one "
                          f"word in"))
        out[f"{suite}_calls"] = calls
        del tables
        for name, args, label in cases:
            rows.append(design_step_row(name, args, label, designs, dev))
        del cases
        release(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["cases"] = rows
    return out


def sort_passes(key) -> tuple:
    """(passes that move rows, passes) of ``partition_sort`` over ``key``:
    8-bit digits of the key's order-preserving bits, and a pass whose
    digit takes one value over every row moves nothing (``digit_plan``
    marks it, and the sort skips it)."""
    import torch
    bits = key.element_size() * 8
    u = key ^ (torch.iinfo(key.dtype).min)
    moved = 0
    for d in range(bits // 8):
        dig = (u >> (8 * d)) & 0xFF
        moved += int(dig.min() != dig.max())
    return moved, bits // 8


def kernel_device_ms(fn, dev, reps: int = 5) -> dict:
    """Device ms per call of each kernel (or copy, or memset) that ``fn``
    launches, by its function's name without namespace or template
    arguments, from ``torch.profiler`` over ``reps`` calls after one
    warm-up (nothing on the CPU)."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.match(r"(?:void )?(?:\(anonymous namespace\)::)?([\w:]+?)"
                     r"(?:<|\(|$)", ev.name)
        name = m.group(1) if m else ev.name[:60]
        out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1000 \
            / reps
    return out


# L2's largest NDS call at SF1 (PERF.md): 187,920,000 rows of
# which 2,099 are present, keys that pack into 32 bits with no validity,
# group capacity n. ``--steps l2`` times the L2 steps on inputs of that
# shape made from a seed: three int32 keys of 11, 10 and 10 bits
L2_ROWS = 187_920_000
L2_PRESENT = 2_099
L2_FIELDS = [(False, 0, 11), (False, 0, 10), (False, 0, 10)]


def l2_padded_inputs(dev) -> tuple:
    """(row, arrs, valids, fields, bits) shaped like L2's largest NDS
    call: L2_PRESENT of L2_ROWS rows present, at places drawn from a
    seed, one int32 key per field of L2_FIELDS with values in its width
    (absent rows hold values too, which the fill hides), no validity."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(31)
    row = torch.zeros(L2_ROWS, dtype=torch.bool, device=dev)
    row[torch.randperm(L2_ROWS, generator=gen,
                       device=dev)[:L2_PRESENT]] = True
    arrs = [torch.randint(0, 1 << w, (L2_ROWS,), generator=gen, device=dev,
                          dtype=torch.int32) for _v, _lo, w in L2_FIELDS]
    bits = 1 + sum(w for _v, _lo, w in L2_FIELDS)
    return row, arrs, [None] * len(L2_FIELDS), L2_FIELDS, bits


def bounds_bytes(keys, present_rows: int, G: int) -> tuple:
    """(bytes by this run's data, bytes reading every key) that
    ``group_bounds`` must move: the keys up to and including the first
    absent row (the keys are sorted, presence on top, so the rows after
    it are absent and need no key), every key in the second count; the
    presence bytes, the int32 group ids, the int64 starts and the count
    written once in both."""
    n = keys.shape[0]
    writes = n + 4 * n + 8 * G + 8
    read = min(n, present_rows + 1) * keys.element_size()
    return read + writes, n * keys.element_size() + writes


def l2_steps(designs: dict, row, arrs, valids, fields, bits: int, G: int,
             dev) -> dict:
    """L2's packed route on each design of ``designs`` (name -> its
    ``kernels`` module): the pack, ``partition_sort`` of the packed key
    (given the pack's digit counts where the design's pack returns them)
    and ``group_bounds``, on the same inputs; every step's results must
    be equal across the designs. Per design and step its times and the
    device ms of each kernel it launches (``time_designs``); per step the
    bytes it must move
    and their bound (for ``group_bounds`` also by the model that reads
    every key)."""
    import torch
    n = row.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=dev).view(1, n)
    cnt = torch.full((1,), n, dtype=torch.int32, device=dev)
    steps, first = {}, None
    for who, kx in designs.items():
        def pack(kx=kx):
            return kx.pack_group_key(row, arrs, valids, fields, bits)
        packed = pack()
        # a design whose pack counts the key's digits returns (key, counts)
        key, counts = packed if isinstance(packed, tuple) else (packed, None)

        def sort(kx=kx, key=key, counts=counts):
            return kx.partition_sort(key.view(1, n), iota, cnt,
                                     *([] if counts is None else [counts]))
        ks, perm = sort()

        def bounds(kx=kx, ks=ks):
            return kx.group_bounds(ks.view(n), bits - 1, G)
        out = (key, ks, perm, *bounds())
        if first is None:
            first = out
        elif not all(a.shape == b.shape and torch.equal(a, b)
                     for a, b in zip(out, first)):
            raise SmokeError(f"L2's steps on the {who} design differ from "
                             f"the {next(iter(designs))} design's")
        steps[who] = {"pack": pack, "sort": sort, "bounds": bounds}
        del out, packed
    key, ks, _perm, present_s, _gid, ngroups, _starts2 = first
    moved_pack, _ops = work_of("pack_group_key",
                               [row, arrs, valids, fields, bits], key)
    moved_bounds, moved_all = bounds_bytes(ks.view(n), int(present_s.sum()),
                                         G)
    moved_sort = 2 * n * (key.element_size() + 4)
    rec = {"rows": n, "present_rows": int(row.sum()), "groups_cap": G,
           "ngroups": int(ngroups), "bits": bits,
           "key_dtype": str(key.dtype).replace("torch.", ""),
           "bytes": {"pack": moved_pack, "sort": moved_sort,
                     "bounds": moved_bounds, "bounds_all_keys": moved_all},
           "bound_ms": {s: b / HBM_BYTES_PER_S * 1000 for s, b in
                        (("pack", moved_pack), ("sort", moved_sort),
                         ("bounds", moved_bounds),
                         ("bounds_all_keys", moved_all))}}
    del first, key, ks, _perm, present_s, _gid, ngroups, _starts2
    timed = {s: time_designs({who: steps[who][s] for who in designs}, dev,
                             profile=True)
             for s in ("pack", "sort", "bounds")}
    rec["designs"] = {who: {s: timed[s][who] for s in timed}
                      for who in designs}
    return rec


def group_sort_record(KX, lib: Recorder, label: str, dev) -> "dict | None":
    """L2's group-id sort at its largest call that packs its keys: the
    pack, ``partition_sort`` of the packed key (given the pack's counts)
    and ``group_bounds``, each timed by both methods with the device ms of
    each kernel it launches (``l2_steps``), beside ``_lexsort`` of the
    reference's operands and ``torch.sort`` of the packed key on the same
    rows; the perms must be equal. Also the calls of each route in the
    untimed pass."""
    import torch
    from nds_tpu_torch.engine import device_exec as dx
    routes = {"packed": lib.calls["pack_group_key"],
              "multi_key_sort": lib.calls["group_operands"]}
    if "pack_group_key" not in lib.largest:
        log(json.dumps({"phase": f"{label} group-id sort", "routes": routes}))
        return {"routes": routes}
    (row, keyvals, fields, bits), _kw = lib.inputs("pack_group_key")
    n = row.shape[0]
    G = dx._Trace._group_capacity(n, keyvals)
    iota = torch.arange(n, dtype=torch.int32, device=dev).view(1, n)
    counts = torch.full((1,), n, dtype=torch.int32, device=dev)
    key, hist = dx._pack_group_key(row, keyvals, fields, bits)
    lexsort = lib.function("lexsort")
    ops = dx._group_operands(row, keyvals)
    _ks, perm = KX.partition_sort(key.view(1, n), iota, counts, hist)
    if not torch.equal(perm.view(n).to(torch.int64), lexsort(ops, n, dev)):
        raise SmokeError(f"{label}: the packed key's sort differs from "
                         f"_lexsort's at L2's largest call")
    del _ks, perm
    moved, passes = sort_passes(key)
    rec = {"step": "group_sort", "path": label, "keys": len(keyvals),
           "routes": routes, "passes_moved": moved, "passes": passes,
           "operands": [list(o.shape) + [str(o.dtype).replace("torch.", "")]
                        for o in ops],
           **l2_steps({"this": KX}, row,
                      [kv.arr.contiguous() for kv in keyvals],
                      [None if kv.valid is None else kv.valid.contiguous()
                       for kv in keyvals], fields, bits, G, dev),
           "torch_sort_ms": time_ms(lambda: torch.sort(key, stable=True),
                                    dev),
           "plain_sort_ms": time_ms(lambda: KX.partition_sort_plain(
               key.view(1, n), iota, counts, hist), dev),
           "lexsort_ms": time_ms(lambda: lexsort(ops, n, dev), dev)}
    log(json.dumps({"phase": f"{label} group-id sort", **rec}))
    return rec


def graph_replay_cases(dev) -> list:
    """(kernel, make inputs, label[, function, plain version]) for the
    graph case: the scan layout (``seg_scan``, K5's sum, ``group_bounds``,
    ``running_max``), K1, K3 and K4 (their builds and probes launched as
    programmatic dependents), K2, K9 and K8's mask unpack, the count layout
    (K6, whose partition takes it, and the compactor, whose write pass is a
    dependent launch), ``partition_sort``, the executor's multi-key sort of
    four words (``_sort_perm``: four packs, each counting its word's
    digits, and four sorts given those counts, against ``_lexsort``), and
    L2's chain (the pack with its counts, the sort given them, the group
    bounds). Each ``make(seed)`` gives a new set of inputs of one shape;
    the function is the kernel's wrapper unless the case names one."""
    import numpy as np
    import torch
    from nds_tpu_torch.engine import device_exec as dx

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    n = 3_000_017
    G = 50_000

    def scan(seed):
        rng = np.random.default_rng(seed)
        return ("sum", dt(rng.integers(-10**9, 10**9, n)),
                dt(rng.random(n) < 1e-4))

    def groups(seed):
        rng = np.random.default_rng(seed)
        cuts = np.sort(rng.choice(np.arange(1, n), G // 2 - 1,
                                  replace=False))
        gid = np.zeros(n, np.int32)
        gid[cuts] = 1
        gid = np.cumsum(gid).astype(np.int32)
        starts2 = np.searchsorted(gid, np.arange(G, dtype=np.int32))
        return ("sum", dt(rng.integers(-10**6, 10**6, n).astype(np.int32)),
                dt(gid), dt(starts2.astype(np.int64)))

    def bounds(seed):
        rng = np.random.default_rng(seed)
        keys = np.sort(rng.integers(0, 1 << 20, n).astype(np.int32))
        keys[rng.random(n) < 0.1] |= 1 << 20  # absent rows, sorted last
        return (dt(np.sort(keys)), 20, G)

    def cummax(seed):
        rng = np.random.default_rng(seed)
        return (dt(np.where(rng.random(n) < 1e-3, np.arange(n), 0)
                   .astype(np.int32)),)

    def k1(seed):
        rng = np.random.default_rng(seed)
        nb, lo, dom = 600_000, 1000, 2_000_000
        bk = rng.choice(dom, nb, replace=False) + lo
        return (dt(bk.astype(np.int32)), dt(rng.random(nb) < 0.9),
                dt(rng.integers(lo - 100, lo + dom + 100, n)
                   .astype(np.int32)), dt(rng.random(n) < 0.9), lo, dom)

    def k2(seed):
        rng = np.random.default_rng(seed)
        bk = rng.choice(1 << 30, 200, replace=False)
        return (dt(bk), dt(rng.random(200) < 0.9),
                dt(np.where(rng.random(n) < 0.5, rng.choice(bk, n),
                            rng.integers(0, 1 << 30, n))),
                dt(rng.random(n) < 0.9))

    def k3(seed):
        # a padded build: many valid rows a key, then only invalid ones
        rng = np.random.default_rng(seed)
        nb, lo, dom = 4_000_000, -50, 700_000
        ok = rng.random(nb) < 0.5
        ok[nb // 4 + seed * 10_000:] = False
        return (dt(rng.integers(lo, lo + dom, nb).astype(np.int32)), dt(ok),
                dt(rng.integers(lo - 100, lo + dom + 100, n)
                   .astype(np.int32)), dt(rng.random(n) < 0.9), lo, dom)

    def l1(seed):
        rng = np.random.default_rng(seed)
        return (dt(rng.random(n) < 0.1 + 0.2 * seed),)

    def k4(seed):
        # lineitem against itself, clustered by key as q21's
        rng = np.random.default_rng(seed)
        dom = 750_000
        keys = dt(np.sort(rng.integers(0, dom, n)).astype(np.int32))
        vals = dt(rng.integers(0, 10_000, n).astype(np.int32))
        return (keys, dt(rng.random(n) < 0.6), vals, keys.clone(),
                dt(rng.random(n) < 0.9), vals.clone(), 0, dom)

    def rle(seed):
        # runs of about 4 rows, decoded 5 rows past the last run's start
        rng = np.random.default_rng(seed)
        runs = 700_001
        starts = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, n), runs - 1, replace=False))]).astype(np.int32)
        return (dt(rng.integers(-2**40, 2**40, runs)), dt(starts), n + 5)

    def mask(seed):
        # 16-byte aligned words, as the executor uploads them; n is no
        # multiple of 16, so the last block writes a row alone
        rng = np.random.default_rng(seed)
        return (dt(rng.integers(-2**31, 2**31, -(-n // 32) + 1)
                   .astype(np.int32)), n)

    def k6(seed):
        rng = np.random.default_rng(seed)
        nl, nr = 2_000_000, 1_000_000
        pool = rng.integers(0, 1 << 30, 400_000).astype(np.int32)
        return (dt(rng.choice(pool, nl)), dt(rng.random(nl) < 0.9),
                dt(rng.choice(pool, nr)), dt(rng.random(nr) < 0.9),
                4_000_000, 2.0)

    def sort(seed):
        rng = np.random.default_rng(seed)
        nparts, cap = 4, 1_000_000
        return (dt(rng.integers(-(1 << 40), 1 << 40, (nparts, cap))),
                dt(rng.integers(0, 1 << 30, (nparts, cap)).astype(np.int32)),
                dt(rng.integers(cap // 2, cap + 1, nparts).astype(np.int32)))

    def chain_keys(row, a, c, b):
        # presence, a descending int32 without bounds, a span of 3 bits
        # filled by the row mask and an int64 without bounds: 100 bits in
        # words of 4, 32, 32 and 32, the int32 straddling the first two
        return [dx.SortKey(row, invert=True), dx.SortKey(a, negate=True),
                dx.SortKey(c, use_row=True, lo=0, hi=7), dx.SortKey(b)]

    def chain(*args):
        return dx._sort_perm(args[0], chain_keys(*args), n, dev)

    def chain_plain(*args):
        return dx._lexsort(lexsort_operands(args[0], chain_keys(*args)), n,
                           dev).to(torch.int32)

    def chain_inputs(seed):
        rng = np.random.default_rng(seed)
        row = rng.random(n) < 0.8
        return (dt(row),
                dt(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                   .astype(np.int32)),
                dt(np.where(row, rng.integers(0, 8, n), 1000)
                   .astype(np.int32)),
                dt(rng.integers(-4, 4, n, dtype=np.int64) << 61))
    # L2's chain: a 32-bit key of a bounded int32 and a nullable one, the
    # pack's counts zeroed in the graph and given to the sort, then the
    # group bounds at a capacity of n
    l2_fields = [(False, 0, 11), (True, 0, 19)]

    def l2_inputs(seed):
        rng = np.random.default_rng(seed)
        return (dt(rng.random(n) < 0.05),
                dt(rng.integers(0, 1 << 11, n).astype(np.int32)),
                dt(rng.integers(0, 1 << 19, n).astype(np.int32)),
                dt(rng.random(n) < 0.9))

    def l2_chain(row, a, b, vb, plain=False):
        def step(name):
            return getattr(dx.KX, name + ("_plain" if plain else ""))
        key, hist = step("pack_group_key")(row, [a, b], [None, vb],
                                           l2_fields, 32)
        ks, perm = step("partition_sort")(
            key.view(1, n),
            torch.arange(n, dtype=torch.int32, device=dev).view(1, n),
            torch.full((1,), n, dtype=torch.int32, device=dev), hist)
        return (key, hist, ks, perm,
                *step("group_bounds")(ks.view(n), 31, n))

    def l2_chain_plain(*args):
        return l2_chain(*args, plain=True)

    words = [b for _p, b in dx._sort_layout(chain_keys(
        torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int64)),
        1)]

    return [("seg_scan", scan, f"n={n} int64 sum"),
            ("seg_reduce_at_ends", groups, f"n={n} G={G} int32 sum"),
            ("group_bounds", bounds, f"n={n} int32 keys, G={G}"),
            ("running_max", cummax, f"n={n} int32"),
            ("direct_lookup_join", k1,
             f"600000 <- {n} int32, dom 2000000: the build and the probe "
             f"launched as programmatic dependents"),
            ("matmul_probe_join", k2, f"200 <- {n} int64"),
            ("bitmask_semi", k3,
             f"4000000 (a quarter of them valid at most) <- {n} int32, dom "
             f"700000: the build and the probe launched as programmatic "
             f"dependents"),
            ("compact_perm", l1,
             f"n={n}, a tenth to seven tenths present: the counts' "
             f"look-back words, the write pass a programmatic dependent"),
            ("keyed_minmax_semi", k4,
             f"{n} <- {n} int32, clustered keys, dom 750000: the build and "
             f"the probe launched as programmatic dependents"),
            ("rle_decode", rle, f"700001 int64 runs into {n + 5} rows"),
            ("unpack_mask", mask, f"{-(-n // 32) + 1} words into {n} rows"),
            ("partitioned_mn_join", k6, "2000000 x 1000000 int32"),
            ("partition_sort", sort, "4 x 1000000 int64"),
            ("pack_sort_key", chain_inputs,
             f"n={n}, the multi-key sort of words of {words} bits, an "
             f"int32 straddling two: pack_sort_key (its counts zeroed in "
             f"the graph) and partition_sort given the counts", chain,
             chain_plain),
            ("pack_group_key", l2_inputs,
             f"n={n}, L2's chain: pack_group_key of a 32-bit key (its counts "
             f"zeroed in the graph), partition_sort given the counts, "
             f"group_bounds at G=n", l2_chain, l2_chain_plain)]


def reset_and_grow(KX, stream) -> list:
    """Every look-back buffer of ``stream`` (where a graph was captured
    that holds it) reset by the host, which must zero it and set its
    counter word back to epoch 1 in place, and then outgrown; fresh memory
    of each old buffer's size is filled with junk, which a graph whose
    buffer had been freed would read. Returns the junk, to be kept until
    the graph has been replayed."""
    import torch
    junk = []
    with torch.cuda.stream(stream):
        for key, (buf, ctr, _used, retired) in list(KX._LOOKBACK.items()):
            if key[1] != stream.cuda_stream:
                continue
            KX._LOOKBACK[key] = (buf, ctr, KX._EPOCH_HOST, retired)
            KX._lookback(*key, buf.numel() + 1)
            if bool(buf.any()) or int(ctr.item()) != KX._EPOCH_FIRST:
                raise SmokeError(f"the look-back {key[2]} reset did not "
                                 f"reach the captured buffer")
            junk.append(torch.full_like(buf, -1))
    stream.synchronize()
    return junk


def graph_replays(KX, dev, names=None) -> list:
    """The graph case: each kernel of ``graph_replay_cases`` run once on a
    side stream (its look-back buffers are made there, outside the
    capture), captured in a ``torch.cuda.CUDAGraph`` on that stream, and
    the graph replayed three times with new inputs copied into the
    captured ones in between, the third after the host has reset and
    outgrown its look-back buffers (``reset_and_grow``); each replay's
    outputs must equal the plain version on its inputs (a float sum within
    its tolerance, ``agrees``). With epochs passed from the host, the
    second replay would take the first's tile words as published; with a
    buffer freed at its growth, the third would read another tensor's
    memory."""
    import torch
    out = []
    for name, make, label, *fns in graph_replay_cases(dev):
        if names is not None and name not in names:
            continue
        fn, plain = fns or (getattr(KX, name), getattr(KX, name + "_plain"))
        static = make(0)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*static)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = fn(*static)
        errs = []
        junk = []
        for seed in (1, 2, 3):
            if seed == 3:
                junk = reset_and_grow(KX, stream)
            new = make(seed)
            for a, b in zip(static, new):
                if isinstance(a, torch.Tensor):
                    a.copy_(b)
            graph.replay()
            torch.cuda.synchronize()
            exp = plain(*new)
            err, ok = agrees(name, new, got, exp)
            if not ok:
                raise SmokeError(f"{name} [{label}] replay {seed} of its "
                                 f"graph differs from its plain version: "
                                 f"max_abs_err={err}")
            errs.append(err)
        rec = {"kernel": name, "case": f"graph, 3 replays (the last after "
               f"a reset and a growth of its buffers), {label}",
               "max_abs_err": max(errs)}
        log(json.dumps({"phase": "graph replay", **rec}))
        out.append(rec)
        del graph, got, static, junk
    return out


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    import re
    from nds_tpu_torch.engine.cuda_build import CSRC
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(?:void\s+)?(\w+)\s*\(")
    return {m for f in CSRC.glob("*.cu") for m in pat.findall(f.read_text())}


def kernel_families(by_name: dict) -> dict:
    """From {kernel name: (ms, launches)}: cub's radix-sort kernels summed
    (what a large torch.sort runs), torch's other sort kernels (a small
    torch.sort sorts in place in one block) and its searchsorted kernels,
    and each of the port's own kernels summed over its instantiations."""
    import re
    ours = port_kernel_names()
    cub, port = [0.0, 0], {}
    other_sorts, searches = [0.0, 0], [0.0, 0]
    for name, (ms, cnt) in by_name.items():
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
        mine = bool(m and m.group(1) in ours)
        if "DeviceRadixSort" in name:
            cub[0] += ms
            cub[1] += cnt
        elif ("sort" in name.lower() and "searchsorted" not in name
              and not mine):
            other_sorts[0] += ms
            other_sorts[1] += cnt
        if "searchsorted" in name:
            searches[0] += ms
            searches[1] += cnt
        if mine:
            tot = port.setdefault(m.group(1), [0.0, 0])
            tot[0] += ms
            tot[1] += cnt
    # torch.cummax / cummin (what the windows' running max ran on before
    # running_max)
    scan_idx = [(ms, cnt) for name, (ms, cnt) in by_name.items()
                if "scan_innermost_dim_with_indices" in name
                or "cummax" in name]
    return {"cub_radix_sort": {"ms": cub[0], "launches": cub[1]},
            "torch_sort_kernels": {"ms": other_sorts[0],
                                   "launches": other_sorts[1]},
            "searchsorted_kernels": {"ms": searches[0],
                                     "launches": searches[1]},
            "cummax_kernels": {"ms": sum(m for m, _c in scan_idx),
                               "launches": sum(c for _m, c in scan_idx)},
            "port_kernels": {k: {"ms": v[0], "launches": v[1]}
                             for k, v in sorted(port.items())}}


def no_library_sorts(profile: dict, path: str, dev) -> None:
    """A profiled pass of the card's legs runs no torch sort (cub's radix
    sort or another) and no torch searchsorted: the sorts, the sort-merge
    build and probe and the compactor are the port's kernels."""
    if dev.type != "cuda":
        return
    ran = {fam: profile[fam]["launches"]
           for fam in ("cub_radix_sort", "torch_sort_kernels",
                       "searchsorted_kernels")
           if profile[fam]["launches"]}
    if ran:
        raise SmokeError(f"the profiled {path} pass ran torch's sort or "
                         f"search kernels: {ran}")


def busy_ms(work) -> float:
    """ms of the union of the intervals ``(start_us, ms, name)`` of
    ``work``, sorted by start."""
    total, end = 0.0, None
    for t, ms, _n in work:
        e = t + ms * 1000
        if end is None or t >= end:
            total += ms
            end = e
        elif e > end:
            total += (e - end) / 1000
            end = e
    return total


def profile_pass(dsess, units, dev, per_unit, label) -> dict:
    """One more pass of the units under torch.profiler. Each unit ends in
    its device->host copy, so the device work a unit launched runs inside
    its host range: per unit, the time the card spent in kernels and
    copies that started in that range, as the union of their intervals
    (a kernel launched as a programmatic dependent starts before the one
    it waits for ends; the plain sum of their spans is kept beside it as
    ``device_span_sum_ms``). The busy share is that device time over the
    timed pass's wall clock (the profiler slows the host, not the card);
    the kernels that hold the card longest are listed by name, each by
    the sum of its spans."""
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
    by_unit, span_sum = {}, {}
    import bisect
    for name, (s0, e0) in ranges.items():
        lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_left(starts,
                                                                    e0)
        span_sum[name] = sum(ms for _t, ms, _n in work[lo:hi])
        by_unit[name] = busy_ms(work[lo:hi])
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
    out = {"device_ms": device_ms,
           "device_span_sum_ms": sum(span_sum.values()),
           "timed_wall_ms": wall_ms,
           "profiled_wall_ms": sum((e - s) / 1000
                                   for s, e in ranges.values()),
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "device_launches": len(work),
           "top_device_kernels": [{"kernel": k[:160], "ms": ms, "count": c}
                                  for k, (ms, c) in top],
           **kernel_families(by_name),
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
                          "compile_ms": lt.get("compile_ms"),
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
    for key in list(rec.largest):
        name = key.split("[")[0]
        if name in only:
            case = f"{label} main path" + (f", {key[len(name) + 1:-1]}"
                                           if key != name else "")
            args, kwargs = rec.inputs(key)
            out[key] = check_kernel(KX, name, args, case, dev, kwargs)
            del args, kwargs
    return out


def resident_bytes(ex) -> int:
    """Bytes of the executor's pooled scan buffers on the card."""
    return sum(t.numel() * t.element_size() for t in ex._buffers.values())


def rules_of(suite: str) -> str:
    """The validator rules of a suite's results ("nds_dist" is NDS)."""
    return "nds_h" if suite == "nds_h" else "nds"


def capture_pass(dsess, ex, units, dev, path) -> dict:
    """On the card, the warm pass of the plan graphs: each unit once,
    which captures its plans' graphs (each plan's first run from graphs:
    eager, then captured); per unit its captures and ``compile_ms``."""
    import torch
    graphs = ex._graphs
    if graphs is None:
        return {}
    out = {}
    t0 = time.perf_counter()
    for name, stmts in units:
        c0 = graphs.captures
        run_query(dsess, stmts)
        out[name] = {"captures": graphs.captures - c0,
                     "compile_ms": ex.last_timings.get("compile_ms", 0.0)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"phase": f"{path} capture pass",
                    "seconds": time.perf_counter() - t0,
                    "captures": graphs.captures,
                    "compile_ms": sum(u["compile_ms"] for u in out.values()),
                    "cache_releases": graphs.cache_releases}))
    return out


def graph_state(ex) -> dict:
    """The executor's graph counts and the kernels built and loaded so
    far, to hold a later pass to."""
    from nds_tpu_torch.engine import cuda_build
    g = ex._graphs
    return {"captures": g.captures if g is not None else 0,
            "replays": g.replays if g is not None else 0,
            "built": dict(cuda_build.BUILD_SECONDS),
            "loaded": sorted(n for n in cuda_build.SIGNATURES
                             if cuda_build.is_loaded(n))}


def plan_graph_record(KX, dsess, ex, units, dev, path, timed, launches,
                      profile, before, warm_graphs,
                      eager_turns: bool) -> dict:
    """The plan graphs of a leg run from graphs: every unit's capture pass
    captured (one graph per plan and per staged sub-plan: as many graphs
    as plan entries), and the timed and profiled passes captured nothing,
    built no kernel and loaded no library. With ``eager_turns``, the
    timed pass runs three more times in turns, eagerly (the executor's
    ``use_graphs`` off), eagerly, from graphs: each turn's rows must equal
    the first pass's, and its kernel blocks and launches per kernel too;
    then a profiled eager pass. Returns both modes' wall, host (the wall
    clock not covered by device work), device ms and busy share and
    launches, the capture pass's total ``compile_ms``, the graph pool's
    reserved bytes, the peak, the pool resets and the allocator cache
    releases of captures that ran short of memory. An eager turn runs
    each plan from the graphs' pool (``PlanGraphs.pool_run``)."""
    import torch
    graphs = ex._graphs
    per_unit, results = timed
    bad = [f"{path} {n}: its capture pass captured no graph"
           for n, w in warm_graphs.items() if w["captures"] < 1]
    if len(graphs.graphs) != len(ex._entries):
        bad.append(f"{path}: {len(graphs.graphs)} graphs for "
                   f"{len(ex._entries)} plan entries")
    wall = sum(u["wall_ms"] for u in per_unit.values())
    modes = {"graphs": {"wall_ms": [wall], "launches": launches,
                        "device_ms": profile["device_ms"],
                        "device_launches": profile["device_launches"]}}
    turns = []
    if eager_turns:
        for mode in ("eager", "eager", "graphs"):
            ex.use_graphs = mode == "graphs"
            KX.reset_launches()
            pu, res = timed_pass(dsess, ex, units, dev)
            got = KX.launch_counts()
            turns.append(mode)
            m = modes.setdefault(mode, {"wall_ms": [], "launches": got})
            m["wall_ms"].append(sum(u["wall_ms"] for u in pu.values()))
            if got != launches:
                bad.append(f"{path} {mode} turn: launches {got} != the "
                           f"graph pass's {launches}")
            for name, _ in units:
                why = unit_mismatch(res[name].to_pandas(),
                                    results[name].to_pandas(), name,
                                    rules_of(path))
                if why is None and pu[name]["kernels"] != per_unit[name][
                        "kernels"]:
                    why = (f"kernel block {pu[name]['kernels']} != "
                           f"{per_unit[name]['kernels']}")
                if why is not None:
                    bad.append(f"{path} {name} ({mode} turn): {why}")
            if mode == "eager" and "device_ms" not in m:
                prof = profile_pass(dsess, units, dev, pu, f"{path} eager")
                m["device_ms"] = prof["device_ms"]
                m["device_launches"] = prof["device_launches"]
                m["top_host_ops"] = prof["top_host_ops"][:6]
        ex.use_graphs = True
    after = graph_state(ex)
    for k in ("captures", "built", "loaded"):
        if after[k] != before[k]:
            bad.append(f"{path}: the passes after the warm pass changed "
                       f"{k}: {before[k]} -> {after[k]}")
    for m in modes.values():
        m["host_ms"] = m["wall_ms"][0] - m["device_ms"]
        m["busy_share"] = m["device_ms"] / m["wall_ms"][0]
        m["kernel_launches"] = sum(m.pop("launches").values())
    pool = graphs.pool_bytes()
    out = {"turns": ["graphs"] + turns, "modes": modes,
           "graphs": len(graphs.graphs), "plan_entries": len(ex._entries),
           "captures": after["captures"],
           "replays": after["replays"] - before["replays"],
           "compile_ms": sum(w["compile_ms"] for w in warm_graphs.values()),
           "pool_reserved_gib": None if pool is None else pool / 2**30,
           "max_memory_allocated_gib": (torch.cuda.max_memory_allocated()
                                        / 2**30 if dev.type == "cuda"
                                        else None),
           "graph_pool_resets": graphs.pool_resets,
           "cache_releases": graphs.cache_releases, "mismatches": bad}
    log(json.dumps({"phase": f"{path} plan graphs", **out}))
    if bad:
        raise SmokeError("; ".join(bad))
    return out


def run_leg(suite, KX, factory_of, dev, pool, record, path=None,
            raw=None, check_names=None, required=None,
            same_kernels=True, parent=None) -> tuple:
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
    default). ``parent``: another checkout's design (``load_parent``),
    timed beside this one's on the single-device legs
    (``parent_steps``)."""
    import torch
    path = path or suite
    tables = _ORACLE_TABLES[suite]
    factory = factory_of()
    dsess = suite_session(suite, factory)
    for t in tables.values():
        dsess.register_table(t)
    units = suite_units(suite)

    # untimed pass: uploads, host-side planning, captured kernel inputs;
    # each unit's time and peak device memory logged as it ends. It runs
    # eagerly, so that the kernel checks below share the card with no
    # graph pool; the warm pass after them captures the plans' graphs
    ex = factory(dsess.tables)
    graphs = ex._graphs
    ex.use_graphs = False
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
    ex.use_graphs = True
    warm_s = time.perf_counter() - t0
    log(json.dumps({"phase": f"{path} warm pass", "seconds": warm_s,
                    "kernel_calls": rec.calls}))
    # a columnar run makes the raw run's K1-K7 calls on the same inputs
    # (the decode is exact), checked there: here only the decodes
    if check_names is None:
        check_names = KERNELS if raw is None else DECODE_KERNELS
    main_cases = kernel_checks(KX, rec, path, dev, check_names)
    checks = list(main_cases.values())
    # K6's steps at its largest call on the single-device NDS leg, and
    # its build sort held to its plain version on that call's blocks
    breakdown = None
    if path == "nds" and "partitioned_mn_join" in rec.largest:
        k6_args = rec.inputs("partitioned_mn_join")[0]
        if dev.type == "cuda":
            breakdown = {"kernel": k6_breakdown(KX, k6_args)}
        with Recorder({"partition_sort": (KX, "partition_sort")}) as srt:
            KX.partitioned_mn_join(*k6_args)
        # on the CPU K6's plain version sorts with torch.sort instead
        if "partition_sort" in srt.largest:
            checks.append(check_kernel(KX, "partition_sort",
                                       srt.inputs("partition_sort")[0],
                                       "K6's largest call", dev))
        elif dev.type == "cuda":
            raise SmokeError("K6's largest call made no partition_sort "
                             "call")
    beside_parent = (parent_steps(parent, lib, rec, path, dev)
                     if parent is not None and path in ("nds_h", "nds")
                     else None)
    called = [n for n, c in rec.calls.items() if c > 0]
    del rec
    if dev.type == "cuda" and lib.calls["lexsort"]:
        raise SmokeError(f"the {path} leg called _lexsort "
                         f"{lib.calls['lexsort']} times: its sorts are the "
                         f"packed sort's")
    # the former library steps (the sorts, L1, L3) on the single-device legs
    library_steps = (library_step_checks(lib, path, dev)
                     if path in ("nds_h", "nds") else [])
    group_sort = (group_sort_record(KX, lib, path, dev)
                  if path in ("nds_h", "nds") else None)
    del lib
    if suite == "nds_h" and raw is None:
        for name, kargs, label in sf1_shape_cases(tables, dev):
            checks.append(check_kernel(KX, name, kargs, label, dev))
        checks += join_adversarial_checks(KX, dev)
        checks += maker_checks(semi_compact_case_makers(),
                               "K3/L1 adversarial cases", {"this": KX}, dev)
        checks += maker_checks(minmax_rle_case_makers(),
                               "K4/K9 adversarial cases", {"this": KX}, dev)
        checks += maker_checks(mask_case_makers(),
                               "K8 mask adversarial cases", {"this": KX}, dev)
    if path == "nds":
        for name, kargs, label in (nds_adversarial_cases(dev)
                                   + sort_search_cases(dev)):
            checks.append(check_kernel(KX, name, kargs, label, dev))
        checks += sort_chain_checks(dev)
        checks += l2_adversarial_checks(KX, dev)
        if dev.type == "cuda":
            checks += check_lookback_layouts(KX, dev)

    checks_s = time.perf_counter() - t0 - warm_s
    warm_graphs = capture_pass(dsess, ex, units, dev, path)

    # the timed run: counts at 0, every unit once, counts read
    if factory(dsess.tables) is not ex:
        raise SmokeError(f"the {path} factory made a second executor")
    before = graph_state(ex)
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
    plan_graphs = None
    if graphs is not None:
        plan_graphs = plan_graph_record(
            KX, dsess, ex, units, dev, path, (per_unit, results), launches,
            profile, before, warm_graphs,
            eager_turns=path in ("nds_h", "nds"))

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
    # one digest of every unit's kernel block, to hold a later run to
    kernels_digest = hashlib.sha256(json.dumps(
        [(name, per_unit[name]["kernels"]) for name, _ in units],
        sort_keys=True, default=str).encode()).hexdigest()[:16]
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
           "library_steps": library_steps, "k6_breakdown": breakdown,
           "parent_steps": beside_parent,
           "group_sort": group_sort, "kernels_digest": kernels_digest,
           "warm_peak_device_bytes": warm_peaks,
           "plan_graphs": plan_graphs,
           "mismatches": bad}
    record[path] = leg
    log(json.dumps({"phase": f"{path} main path",
                    "units": len(units), "power_total_ms": power_ms,
                    "launches": launches, "peak_device_bytes": peak,
                    "resident_buffer_bytes": resident,
                    "bytes_scanned": scanned, "kernels_digest": kernels_digest,
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
    cummax = profile.get("cummax_kernels", {}).get("launches", 0)
    if suite != "nds_h" and dev.type == "cuda" and cummax:
        raise SmokeError(f"the profiled {path} pass ran {cummax} torch "
                         f"cummax kernels: the windows' running max is "
                         f"running_max's")
    if path in ("nds_h", "nds"):
        no_library_sorts(profile, path, dev)
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
    profile = profile_pass(dsess, units, dev, per_unit, "window")
    bad, _s = oracle_check(pool, "nds", units, results, per_unit,
                           rules="window")
    for name, _ in units:
        per_unit[name]["result"] = results[name].to_pandas().to_dict(
            orient="list")
        log(json.dumps({"suite": "window", "unit": name, **{
            k: v for k, v in per_unit[name].items() if k != "result"}}))
    out = {"launches": launches, "per_unit": per_unit, "profile": profile,
           "kernel_checks": list(main_cases.values()), "mismatches": bad}
    record["window"] = out
    log(json.dumps({"phase": "window path", "launches": launches,
                    "mismatches": len(bad)}))
    if bad:
        raise SmokeError("; ".join(bad))
    missing = [n for n in WINDOW_REQUIRED if launches.get(n, 0) <= 0]
    if missing:
        raise SmokeError(f"the window path launched no {missing}")
    no_library_sorts(profile, "window", dev)
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


def bench_phase(card: str, dev, sf: float, sf_ds: float,
                timeout_s: float) -> dict:
    """The port's bench entry, ``python -m nds_tpu_torch.bench``, run as
    its users run it, in a process of its own on this checkout: both legs
    at NDS-H ``sf`` and NDS ``sf_ds``, its data root in a new temporary
    directory, on ``dev``'s type (``BENCH_DEVICE``). Its last line must
    show every one of the 125 units completed, on the platform asked for
    and, on the card, this card (``device``, as nvidia-smi gives it), and
    it must exit 0 within ``timeout_s`` (past it, the bench is sent
    SIGTERM, which prints its partial line, then killed). Returns the
    record: the last line, exit code, seconds and the stderr's tail."""
    import shutil
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    data = tempfile.mkdtemp(prefix="nds_bench_")
    env = {**os.environ, "BENCH_DATA": data, "BENCH_SF": f"{sf:g}",
           "BENCH_NDS_SF": f"{sf_ds:g}", "BENCH_LEGS": "nds_h,nds",
           "BENCH_DEVICE": dev.type}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "nds_tpu_torch.bench"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    timed_out = False
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    finally:
        shutil.rmtree(data, ignore_errors=True)
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except ValueError:
        last = None
    rec = {"phase": "bench", "sf": sf, "sf_ds": sf_ds, "seconds": seconds,
           "timeout_s": timeout_s, "rc": proc.returncode,
           "timed_out": timed_out, "last_line": last,
           "stderr_tail": err[-6000:]}
    summary = {k: rec[k] for k in ("phase", "sf", "sf_ds", "seconds", "rc",
                                   "timed_out")}
    if isinstance(last, dict):
        summary.update({k: last.get(k) for k in (
            "metric", "value", "vs_baseline", "queries_completed",
            "queries_total", "platform", "device")})
        summary["legs"] = {m: {k: leg.get(k) for k in (
            "value", "vs_baseline", "queries_completed")}
            for m, leg in (last.get("legs") or {}).items()}
    log(json.dumps(summary))
    why = []
    if timed_out:
        why.append(f"no end within {timeout_s} s")
    if proc.returncode != 0:
        why.append(f"exit {proc.returncode}")
    if not isinstance(last, dict):
        why.append("no JSON last line")
    else:
        if not (last.get("queries_completed") == last.get("queries_total")
                == BENCH_UNITS):
            why.append(f"{last.get('queries_completed')} of "
                       f"{last.get('queries_total')} units completed, "
                       f"{BENCH_UNITS} expected")
        if last.get("platform") != dev.type:
            why.append(f"platform {last.get('platform')!r}")
        if dev.type == "cuda" and last.get("device") != card:
            why.append(f"device {last.get('device')!r}, not {card!r}")
    if why:
        raise SmokeError(f"the bench entry failed: {'; '.join(why)}; "
                         f"stderr ends: {err[-2000:]}")
    return rec


def _cli(args: list, timeout_s: float) -> dict:
    """``python -m <args>`` from this checkout; its exit code, seconds,
    stdout and the stderr's tail."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise SmokeError(f"{args[0]}: no end within {timeout_s} s") from e
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "stdout": proc.stdout, "stderr_tail": proc.stderr[-4000:]}


# the placement every statement of a power CLI run must report, by its
# ``--backend``: the fast rung of the backend's universe
BACKEND_PLACEMENT = {"gpu": "device", "distributed": "sharded", "cpu": "cpu"}


def expected_placement(extra: list) -> str:
    """The placement a power CLI run with the arguments ``extra`` must
    put every statement on: its ``--placement`` pin, else its
    ``--backend``'s fast placement (``gpu``, the card, by default)."""
    if "--placement" in extra:
        return extra[extra.index("--placement") + 1]
    backend = (extra[extra.index("--backend") + 1] if "--backend" in extra
               else "gpu")
    return BACKEND_PLACEMENT[backend]


def power_run(mod: str, wh: str, stream: str, units: list, out: str,
              extra: list, timeout_s: float) -> dict:
    """One run of the power CLI (``python -m <mod>.power``) over a parquet
    warehouse (its default ``--input_format``): its time log's ``Power
    Test Time``, the sum of its ``CreateTempView`` rows (the warehouse's
    load), its largest query, the statuses and kernel blocks of its
    summaries (one digest over the stream, as ``run_leg`` takes one over
    its units) and its captures' ``compile_ms``. Every statement must
    complete; one that completed after a slack retry
    (``CompletedWithTaskFailures``) counts apart and makes the CLI exit
    1, as the reference's does. Every statement that reached an executor
    must report the run's placement (``expected_placement``) with 0
    reschedules: the pipeline walks a statement that runs the card out
    of memory down to the CPU oracle, whose result would pass every
    other check."""
    from nds_tpu_torch.utils.timelog import TimeLog
    tlog, jsons = os.path.join(out, "time.csv"), os.path.join(out, "json")
    run = _cli([f"{mod}.power", wh, stream, tlog,
                "--json_summary_folder", jsons, "--output_prefix",
                os.path.join(out, "out"), *extra], timeout_s)
    rec = {"args": extra, "rc": run["rc"], "seconds": run["seconds"]}
    if not os.path.exists(tlog):
        raise SmokeError(f"{mod}.power {extra}: exit {run['rc']}, no time "
                         f"log; stderr ends: {run['stderr_tail'][-2000:]}")
    rows = {q: ms for _a, q, ms in TimeLog.read(tlog)}
    summaries = {}
    for f in os.listdir(jsons):
        with open(os.path.join(jsons, f)) as fh:
            summary = json.load(fh)
        summaries[summary["query"]] = summary
    statuses = {q: (summaries.get(q) or {}).get("queryStatus", ["absent"])[-1]
                for q in units}
    retried = sorted(q for q, st in statuses.items()
                     if st == "CompletedWithTaskFailures"
                     and all(e.startswith(SLACK_RETRY)
                             for e in summaries[q]["exceptions"]))
    query_ms = {q: rows[q] for q in units if q in rows}
    largest = max(query_ms, key=query_ms.get) if query_ms else None
    rec.update({
        # the loop's whole wall clock, warmup passes included (as the
        # reference bills it), and the sum of the timed brackets alone
        "power_test_ms": rows.get("Power Test Time"),
        "queries_ms": sum(query_ms.values()),
        "total_ms": rows.get("Total Time"),
        "load_ms": sum(ms for q, ms in rows.items()
                       if q.startswith("CreateTempView ")),
        "largest": [largest, query_ms.get(largest)],
        "completed": sum(st == "Completed" for st in statuses.values()),
        "retried": retried, "statements": len(units),
        "kernels_digest": hashlib.sha256(json.dumps(
            [(q, (summaries.get(q) or {}).get("kernels")) for q in units],
            sort_keys=True, default=str).encode()).hexdigest()[:16],
        "kernel_blocks": sum("kernels" in (summaries.get(q) or {})
                             for q in units),
        "compile_ms": sum((summaries.get(q) or {}).get(
            "engineTimings", {}).get("compile_ms", 0.0) for q in units),
        # each statement's result digest and where the execution
        # pipeline placed it
        "digests": {q: (summaries.get(q) or {}).get("result_digest")
                    for q in units},
        "placements": {q: [(summaries.get(q) or {}).get(k) for k in (
            "placement", "reschedules", "retries")] for q in units},
        "placement": expected_placement(extra),
        "stderr_tail": run["stderr_tail"][-1500:]})
    # a statement that reaches no executor (a view's CREATE or DROP) has
    # no placement, and no result
    rec["misplaced"] = {
        q: p for q, p in rec["placements"].items()
        if (p[0] is not None or rec["digests"][q] is not None)
        and (p[0] != rec["placement"] or p[1])}
    bad = [f"{q} {st}" for q, st in statuses.items()
           if st != "Completed" and q not in retried]
    if bad or rec["completed"] + len(retried) != len(units):
        raise SmokeError(f"{mod}.power {extra}: {bad[:5]}; stderr ends: "
                         f"{run['stderr_tail'][-2000:]}")
    if rec["misplaced"]:
        raise SmokeError(
            f"{mod}.power {extra}: statements not on {rec['placement']} "
            f"or rescheduled ([placement, reschedules, retries]): "
            f"{dict(list(rec['misplaced'].items())[:8])}")
    if run["rc"] != (1 if retried else 0):
        raise SmokeError(f"{mod}.power {extra}: exit {run['rc']} with "
                         f"{len(retried)} slack retries; stderr ends: "
                         f"{run['stderr_tail'][-2000:]}")
    return rec


def load_chain(mod: str, sf: float, tmp: str, timeout_s: float) -> dict:
    """The load phase as users run it, each CLI in a process of its own:
    ``<mod>.gen_data`` (raw, ``parallel`` the machine's cores, at most 8)
    into ``tmp``, then ``<mod>.transcode`` of that raw data to a parquet
    warehouse. Returns the two directories, each CLI's seconds and the
    load report's ``Total conversion time``."""
    from nds_tpu_torch.utils.loadreport import get_load_time
    suite = mod.rsplit(".", 1)[1]
    raw = os.path.join(tmp, f"raw_{suite}")
    wh = os.path.join(tmp, f"wh_{suite}")
    report = os.path.join(tmp, f"load_{suite}.txt")
    parallel = min(8, os.cpu_count() or 1)
    gen = _cli([f"{mod}.gen_data", f"{sf:g}", str(parallel), raw], timeout_s)
    if gen["rc"]:
        raise SmokeError(f"{mod}.gen_data: exit {gen['rc']}; "
                         f"{gen['stderr_tail'][-2000:]}")
    tc = _cli([f"{mod}.transcode", raw, wh, report], timeout_s)
    if tc["rc"]:
        raise SmokeError(f"{mod}.transcode: exit {tc['rc']}; "
                         f"{tc['stderr_tail'][-2000:]}")
    return {"raw": raw, "wh": wh, "parallel": parallel,
            "gen_data_s": gen["seconds"], "transcode_cli_s": tc["seconds"],
            "transcode_s": get_load_time(report)}


def validate_run(mod: str, ref_out: str, out: str, stream: str,
                 timeout_s: float) -> dict:
    """The validate CLI over two power runs' result files
    (``--ignore_ordering``): its exit code, seconds, the statements it
    called a MATCH and how many it skipped."""
    v = _cli([f"{mod}.validate", ref_out, out, stream, "--ignore_ordering"],
             timeout_s)
    lines = v["stdout"].splitlines()
    matched = [ln.split("Comparing Query: ", 1)[1].split(" -> ")[0]
               for ln in lines if ln.endswith("-> MATCH ===")]
    return {"rc": v["rc"], "seconds": v["seconds"], "match": len(matched),
            "matched": matched,
            "skipped": sum(ln.startswith("=== Skipping") for ln in lines)}


def power_phase(dev, legs: dict, warmups=(0, 1),
                timeout_s: float = POWER_CLI_TIMEOUT_S,
                tmp: "str | None" = None, streams_n: int = 1) -> dict:
    """The port's phase chain per suite (``legs``: {suite: scale factor}),
    as its users run it, in a temporary directory: ``gen_data`` and
    ``transcode`` to parquet (``load_chain``), stream 0, the power CLI
    over that warehouse on the device engine once per ``warmups`` entry
    (``--warmup 0``, the reference's default, bills each plan's first run
    and capture to its timed query), on the CPU oracle (``--backend
    cpu``), then the validate CLI over each device run's result files and
    the oracle's: every compared statement a MATCH, exit 0. The device
    runs' kernel blocks must agree. Prints one line per suite. With
    ``tmp`` (a directory the caller owns and removes), the warehouse, the
    ``streams_n`` stream files (stream 0 is the one run) and the runs'
    result directories stay there, named in each suite's record
    (``wh``, ``streams``, ``out``), for the throughput phase."""
    import shutil
    import tempfile
    owned = tmp is None
    if owned:
        tmp = tempfile.mkdtemp(prefix="nds_power_")
    out = {}
    try:
        for suite, sf in legs.items():
            mod = f"nds_tpu_torch.{suite}"
            load = load_chain(mod, sf, tmp, timeout_s)
            wh = load["wh"]
            streams = importlib.import_module(f"{mod}.streams")
            paths = streams.generate_query_streams(
                os.path.join(tmp, f"streams_{suite}"), streams_n)
            stream = paths[0]
            units = list(streams.parse_query_stream(stream))
            device = [] if dev.type == "cuda" else ["--device", dev.type]
            runs = {f"gpu_warmup{w}": power_run(
                mod, wh, stream, units, os.path.join(tmp, f"{suite}_{w}"),
                device + ["--warmup", str(w)], timeout_s) for w in warmups}
            runs["cpu"] = power_run(mod, wh, stream, units,
                                    os.path.join(tmp, f"{suite}_cpu"),
                                    ["--backend", "cpu"], timeout_s)
            checks = {f"gpu_warmup{w}": validate_run(
                mod, os.path.join(tmp, f"{suite}_cpu", "out"),
                os.path.join(tmp, f"{suite}_{w}", "out"), stream, timeout_s)
                for w in warmups}
            rec = {"sf": sf, **{k: v for k, v in load.items()
                                if k not in ("raw", "wh")},
                   "statements": len(units), "runs": runs, "validate": checks}
            if not owned:
                rec.update(wh=wh, streams=paths, out={
                    **{f"gpu_warmup{w}": os.path.join(tmp, f"{suite}_{w}",
                                                      "out")
                       for w in warmups},
                    "cpu": os.path.join(tmp, f"{suite}_cpu", "out")})
            log(json.dumps({"phase": "power", "suite": suite, "sf": sf,
                            "gen_data_s": load["gen_data_s"],
                            "transcode_s": load["transcode_s"],
                            **{k: {f: r[f] for f in (
                                "power_test_ms", "queries_ms", "load_ms",
                                "largest",
                                "completed", "retried", "statements",
                                "kernels_digest", "seconds")}
                               for k, r in runs.items()},
                            "validate": {k: {f: c[f] for f in (
                                "rc", "match", "skipped")}
                                for k, c in checks.items()}}))
            why = [f"{k}: exit {c['rc']}, {c['match']} MATCH of "
                   f"{len(units) - c['skipped']}"
                   for k, c in checks.items()
                   if c["rc"] or c["match"] != len(units) - c["skipped"]]
            digests = {r["kernels_digest"] for k, r in runs.items()
                       if k != "cpu"}
            if len(digests) != 1 or not all(
                    runs[k]["kernel_blocks"] for k in runs if k != "cpu"):
                why.append(f"the device runs' kernel blocks differ or are "
                           f"absent: {digests}")
            if why:
                raise SmokeError(f"power phase, {suite}: {'; '.join(why)}")
            out[suite] = rec
    finally:
        if owned:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def power_beside_bench(power: dict, bench: dict) -> None:
    """Print each suite's Power Test Time beside the bench entry's power
    total of the same leg from the same call (the loop's own cost)."""
    legs = ((bench or {}).get("last_line") or {}).get("legs") or {}
    for suite, rec in power.items():
        bench_s = {m: leg.get("value") for m, leg in legs.items()
                   if m.startswith(f"{suite}_sf")}
        log(json.dumps({"phase": "power beside bench", "suite": suite,
                        "sf": rec["sf"],
                        "power_test_ms": {k: r["power_test_ms"]
                                          for k, r in rec["runs"].items()},
                        "queries_ms": {k: r["queries_ms"]
                                       for k, r in rec["runs"].items()},
                        "bench_power_total_s": bench_s}))


# ``--steps throughput`` and the full smoke's throughput phase: the
# throughput CLIs as users run them, each in a session of its own
# (``_group_run``), every stream's statements held to the power CLI's
# digests of the same statements
THROUGHPUT_STREAMS = 2
# the full smoke's phase: NDS-H over the power phase's SF0.01 warehouse
THROUGHPUT_SMOKE_TIMEOUT_S = 300
# the 2-stream NDS run in subprocess mode at SF1: each stream process
# holds a CUDA context and a graph pool of its own (NDS's pool alone was
# 51.71 GiB at SF1 on an 80 GB card), so it is an attempt, recorded as
# what it does, never called a device run
THROUGHPUT_BEYOND_TIMEOUT_S = 900


def _group_run(cmd: list, timeout_s: float) -> dict:
    """``cmd`` from this checkout in a session of its own, so that past
    ``timeout_s`` its whole process group (a throughput CLI's stream
    subprocesses too) is killed; its exit code, seconds, stdout and
    stderr."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    timed_out = False
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        timed_out = True
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    finally:
        # no stream subprocess outlives its CLI
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
    return {"rc": proc.returncode, "timed_out": timed_out,
            "seconds": time.perf_counter() - t0, "stdout": out,
            "stderr": err}


def _memory_lines(text: str) -> list:
    """The ``[memory]`` records (``obs/memwatch.process_record``) a port
    process printed."""
    return [json.loads(ln.split("[memory] ", 1)[1])
            for ln in text.splitlines() if ln.startswith("[memory] ")]


def throughput_run(mod: str, wh: str, streams: list, out: str, mode: str,
                   extra: list, timeout_s: float,
                   cmd: "list | None" = None) -> dict:
    """One run of ``python -m <mod>.throughput`` over ``streams``
    (``mode``: ``subprocess`` or ``in_process``; ``cmd``, a program that
    runs them as that mode does, writing into ``out`` and saving results
    under ``out/results``, in its place): its exit code, its
    ``Throughput Time``, and per stream the time log's ``Power Test
    Time`` and each statement's status, placement, reschedules, retries
    and result digest (from the stream's per-query summaries in
    subprocess mode, from its query journal in process), in the time
    log's order; each process's ``[memory]`` record (peak allocated and
    reserved GiB, graph pool GiB)."""
    from nds_tpu_torch.utils.timelog import TimeLog
    streams_mod = importlib.import_module(f"{mod}.streams")
    if cmd is None:
        cmd = [sys.executable, "-m", f"{mod}.throughput", wh, *streams,
               "--out_dir", out, "--output_prefix",
               os.path.join(out, "results"), *extra]
        if mode == "in_process":
            cmd.append("--in_process")
    run = _group_run(cmd, timeout_s)
    found = re.search(r"Throughput Time: ([0-9.]+) s", run["stdout"])
    rec = {"mode": mode, "rc": run["rc"], "timed_out": run["timed_out"],
           "seconds": run["seconds"], "results": os.path.join(out, "results"),
           "elapse_s": float(found.group(1)) if found else None,
           "streams": {}, "stderr_tail": run["stderr"][-3000:]}
    if mode == "in_process":
        rec["memory"] = _memory_lines(run["stderr"])
    for sp in streams:
        name = os.path.splitext(os.path.basename(sp))[0]
        tlog = os.path.join(out, f"{name}_time.csv")
        rows = ([(q, ms) for _a, q, ms in TimeLog.read(tlog)]
                if os.path.exists(tlog) else [])
        stmts = {}
        if mode == "in_process":
            path = os.path.join(out, f"{name}_queries.json")
            entries = (json.load(open(path))["queries"]
                       if os.path.exists(path) else {})
            for q, e in entries.items():
                stmts[q] = {"status": e.get("status"), "error": None,
                            "placement": e.get("placement"),
                            "reschedules": e.get("reschedules"),
                            "retries": e.get("retries"),
                            "digest": e.get("result_digest"),
                            "slack_retried": False}
        else:
            jdir = os.path.join(out, f"{name}_json")
            for f in sorted(os.listdir(jdir)) if os.path.isdir(jdir) else []:
                with open(os.path.join(jdir, f)) as fh:
                    summary = json.load(fh)
                status = summary["queryStatus"][-1]
                stmts[summary["query"]] = {
                    "status": status,
                    "error": ((summary.get("exceptions") or [None])[0]
                              or "")[:300] or None,
                    "placement": summary.get("placement"),
                    "reschedules": summary.get("reschedules"),
                    "retries": summary.get("retries"),
                    "digest": summary.get("result_digest"),
                    "slack_retried": (
                        status == "CompletedWithTaskFailures"
                        and all(e.startswith(SLACK_RETRY)
                                for e in summary["exceptions"]))}
            log_path = os.path.join(out, f"{name}.log")
            text = open(log_path).read() if os.path.exists(log_path) else ""
            rec["streams_memory"] = {**rec.get("streams_memory", {}),
                                     name: _memory_lines(text)}
            # the first tracebacks of the stream's failed statements
            errors = re.findall(r"ERROR BEGIN\n(.*?)ERROR END", text, re.S)
            rec.setdefault("stream_errors", {})[name] = {
                "count": len(errors),
                "first": [e[-2500:] for e in errors[:3]]}
            rec.setdefault("rescheduled_lines", {})[name] = [
                ln for ln in text.splitlines()
                if ln.startswith("RESCHEDULED")][:20]
        order = [q for q, _ms in rows
                 if q not in ("Power Test Time", "Total Time")
                 and not q.startswith("CreateTempView ")]
        rec["streams"][name] = {
            "expected": list(streams_mod.parse_query_stream(sp)),
            "order": order,
            "power_test_ms": dict(rows).get("Power Test Time"),
            "statements": {q: stmts.get(q) for q in order},
            "counts": dict(Counter(st["status"] for st in stmts.values())),
            "placed": dict(Counter(str(st["placement"])
                                   for st in stmts.values())),
            "reschedules": sum(st["reschedules"] or 0
                               for st in stmts.values()),
            "retries": sum(st["retries"] or 0 for st in stmts.values())}
    return rec


def float_equal(ref_out: str, out: str, q: str) -> bool:
    """Statement ``q``'s results under two result directories hold a
    float column and agree row for row within ``FLOAT_SUM_RTOL``, the
    other columns exactly (``validate_core.frames_equal``)."""
    from nds_tpu_torch.io.result_io import read_result
    from nds_tpu_torch.utils.validate_core import frames_equal
    a = read_result(os.path.join(ref_out, q))
    b = read_result(os.path.join(out, q))
    return (any(a[c].dtype.kind == "f" for c in a.columns)
            and frames_equal(a, b, epsilon=FLOAT_SUM_RTOL) is None)


def throughput_faults(rec: dict, placement: str, digests: dict,
                      matched: list, power_out: str) -> list:
    """Why a device run's throughput record fails: no end, an exit code
    other than 0 (1 where every statement that did not complete cleanly
    was a slack retry, as the power CLI exits), a stream whose statements
    are not its stream file's in order, a statement not ``Completed``
    (or slack-retried), not placed at ``placement`` or rescheduled, or
    whose result differs from the power CLI's of the same statement
    (under ``power_out``; where the validate CLI called that result a
    MATCH): its digest must be equal, or, for a result with a float
    column, its values within ``FLOAT_SUM_RTOL`` (the card's float sums
    add partial sums in the order their tiles publish them, so their last
    bits may differ from run to run). Such statements are listed in
    ``rec["float_order"]``."""
    why = []
    rec["float_order"] = {}
    if rec["timed_out"]:
        why.append("no end in time")
    retried = any(st and st["slack_retried"]
                  for s in rec["streams"].values()
                  for st in s["statements"].values())
    if rec["rc"] not in ((0, 1) if retried else (0,)):
        why.append(f"exit {rec['rc']}")
    if rec["elapse_s"] is None:
        why.append("no Throughput Time")
    for name, s in rec["streams"].items():
        if s["order"] != s["expected"]:
            why.append(f"{name}: statements {s['order'][:4]}... are not "
                       f"its stream's {s['expected'][:4]}...")
        for q, st in s["statements"].items():
            if st is None:
                why.append(f"{name}/{q}: no record")
                continue
            if st["status"] != "Completed" and not st["slack_retried"]:
                why.append(f"{name}/{q}: {st['status']}")
            # a statement that reaches no executor (a view's CREATE or
            # DROP) has no placement, and no result
            if ((st["placement"] is not None or st["digest"] is not None)
                    and (st["placement"] != placement
                         or st["reschedules"])):
                why.append(f"{name}/{q}: placed {st['placement']}, "
                           f"{st['reschedules']} reschedules")
            if (q in matched and st["digest"] and digests.get(q)
                    and st["digest"] != digests[q]):
                if float_equal(power_out, os.path.join(rec["results"],
                                                       name), q):
                    rec["float_order"].setdefault(name, []).append(q)
                else:
                    why.append(f"{name}/{q}: digest {st['digest']} "
                               f"against the power CLI's {digests[q]}")
    return why[:20]


def _throughput_line(suite: str, rec: dict) -> None:
    log(json.dumps({"phase": "throughput", "suite": suite,
                    **{k: rec.get(k) for k in (
                        "mode", "rc", "timed_out", "seconds", "elapse_s",
                        "memory", "streams_memory", "beyond_card",
                        "float_order")},
                    "streams": {n: {k: s[k] for k in (
                        "power_test_ms", "counts", "placed", "reschedules",
                        "retries")} for n, s in rec["streams"].items()},
                    # the failed statements' errors, by their first words
                    "errors": {n: dict(Counter(
                        (st["error"] or "")[:160]
                        for st in s["statements"].values()
                        if st and st["status"] == "Failed"))
                        for n, s in rec["streams"].items()}}))


def stream0_on_card(prep: dict, tmp: str, device: list,
                    timeout_s: float, out: dict) -> dict:
    """Stream 0 of each suite of ``prep`` ({suite: (module, warehouse,
    stream paths, statements)}) through the power CLI on the card
    (``--warmup 0``) and on the CPU oracle (in the background, every
    suite at once), then the validate CLI over the two: every compared
    result a MATCH. Returns each suite's card run; ``out[suite]`` gets
    the numbers and the statements called a MATCH (``matched``)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(prep)) as pool:
        oracles = {suite: pool.submit(
            power_run, mod, wh, paths[0], units,
            os.path.join(tmp, f"{suite}_cpu"), ["--backend", "cpu"],
            timeout_s) for suite, (mod, wh, paths, units) in prep.items()}
        power = {suite: power_run(
            mod, wh, paths[0], units, os.path.join(tmp, f"{suite}_gpu"),
            device + ["--warmup", "0"], timeout_s)
            for suite, (mod, wh, paths, units) in prep.items()}
        oracles = {suite: f.result() for suite, f in oracles.items()}
    for suite, (mod, wh, paths, units) in prep.items():
        v = validate_run(mod, os.path.join(tmp, f"{suite}_cpu", "out"),
                         os.path.join(tmp, f"{suite}_gpu", "out"),
                         paths[0], timeout_s)
        out[suite].update(power={k: power[suite][k] for k in (
            "power_test_ms", "load_ms", "completed", "retried",
            "seconds")}, oracle_ms=oracles[suite]["power_test_ms"],
            validate={k: v[k] for k in ("rc", "match", "skipped")})
        log(json.dumps({"phase": "throughput power", "suite": suite,
                        **out[suite]}))
        if v["rc"] or v["match"] != len(units) - v["skipped"]:
            raise SmokeError(f"throughput step, {suite}: the power CLI's "
                             f"stream 0 on the card: {v['match']} MATCH of "
                             f"{len(units) - v['skipped']}")
        out[suite]["matched"] = v["matched"]
    return power


def throughput_step(dev, legs: dict,
                    timeout_s: float = POWER_CLI_TIMEOUT_S,
                    beyond_only: bool = False) -> dict:
    """``--steps throughput``: per suite (``legs``: {suite: scale
    factor}), in a temporary directory, ``gen_data`` and ``transcode`` to
    parquet (``load_chain``) and 1 + ``THROUGHPUT_STREAMS`` streams. Stream
    0 runs through the power CLI on the card (``--warmup 0``) and on the
    CPU oracle (in the background, both suites at once), and the validate
    CLI compares the two. Streams 1 and 2 (the qualification parameters:
    the same statements as stream 0 in another order) then run through
    the throughput CLI: NDS-H in subprocess and in-process modes in turns
    (subprocess, in-process, in-process, subprocess), NDS in process,
    each a device run that ``throughput_faults`` must pass; then one
    attempt at NDS in subprocess mode, recorded as what it does (exit
    code, statuses, placements, reschedules, each process's memory)
    within ``THROUGHPUT_BEYOND_TIMEOUT_S``. Prints one line a run. With
    ``beyond_only`` (``--steps throughput_beyond``) only the warehouses,
    the streams and that attempt."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="nds_tput_")
    device = [] if dev.type == "cuda" else ["--device", dev.type]
    out = {"runs": []}
    try:
        prep = {}
        for suite, sf in legs.items():
            mod = f"nds_tpu_torch.{suite}"
            load = load_chain(mod, sf, tmp, timeout_s)
            streams = importlib.import_module(f"{mod}.streams")
            paths = streams.generate_query_streams(
                os.path.join(tmp, f"streams_{suite}"), 1 + THROUGHPUT_STREAMS)
            units = list(streams.parse_query_stream(paths[0]))
            prep[suite] = (mod, load["wh"], paths, units)
            out[suite] = {"sf": sf, **{k: v for k, v in load.items()
                                       if k not in ("raw", "wh")}}
        plan = [("nds_h", m, False) for m in ("subprocess", "in_process",
                                              "in_process", "subprocess")]
        plan += [("nds", "in_process", False), ("nds", "subprocess", True)]
        plan = [p for p in plan if p[0] in prep and (p[2] or not beyond_only)]
        power = ({} if beyond_only
                 else stream0_on_card(prep, tmp, device, timeout_s, out))
        for i, (suite, mode, beyond) in enumerate(plan):
            mod, wh, paths, _units = prep[suite]
            rec = throughput_run(
                mod, wh, paths[1:], os.path.join(tmp, f"tput_{i}"), mode,
                device, THROUGHPUT_BEYOND_TIMEOUT_S if beyond else timeout_s)
            rec.update(suite=suite, beyond_card=beyond)
            out["runs"].append(rec)
            if beyond:
                _throughput_line(suite, rec)
                continue
            why = throughput_faults(rec, "device", power[suite]["digests"],
                                    out[suite]["matched"],
                                    os.path.join(tmp, f"{suite}_gpu", "out"))
            _throughput_line(suite, rec)
            if why:
                raise SmokeError(f"throughput step, {suite} {mode}: "
                                 f"{'; '.join(why)}; stderr ends: "
                                 f"{rec['stderr_tail'][-1500:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def throughput_phase(dev, power: dict, tmp: str,
                     timeout_s: float = THROUGHPUT_SMOKE_TIMEOUT_S) -> dict:
    """The full smoke's throughput phase over the power phase's NDS-H
    warehouse (``power``: its record of NDS-H, made with ``tmp``), its
    three runs at once (a check, not a measurement: ``--steps
    throughput`` times the modes apart): streams 1 and 2 through the
    throughput CLI in subprocess mode and in process, each a device run
    that ``throughput_faults`` must pass against the power CLI's stream 0
    on the card, and the power CLI over stream 0 with ``--backend
    distributed`` (a world of one rank, NCCL on the card): every
    statement ``Completed`` and placed ``sharded`` with 0 reschedules
    (``power_run``), every compared result a MATCH against the power
    phase's CPU oracle."""
    from concurrent.futures import ThreadPoolExecutor
    mod = "nds_tpu_torch.nds_h"
    device = [] if dev.type == "cuda" else ["--device", dev.type]
    wh, paths = power["wh"], power["streams"]
    digests = power["runs"]["gpu_warmup0"]["digests"]
    matched = power["validate"]["gpu_warmup0"]["matched"]
    units = list(importlib.import_module(
        f"{mod}.streams").parse_query_stream(paths[0]))
    out = {"runs": []}
    with ThreadPoolExecutor(3) as pool:
        runs = {mode: pool.submit(
            throughput_run, mod, wh, paths[1:],
            os.path.join(tmp, f"tput_{mode}"), mode, device, timeout_s)
            for mode in ("subprocess", "in_process")}
        dist = pool.submit(power_run, mod, wh, paths[0], units,
                           os.path.join(tmp, "dist"),
                           device + ["--backend", "distributed"], timeout_s)
        runs = {mode: f.result() for mode, f in runs.items()}
        dist = dist.result()
    for mode, rec in runs.items():
        rec.update(suite="nds_h", beyond_card=False)
        out["runs"].append(rec)
        why = throughput_faults(rec, "device", digests, matched,
                                power["out"]["gpu_warmup0"])
        _throughput_line("nds_h", rec)
        if why:
            raise SmokeError(f"throughput phase, {mode}: {'; '.join(why)}; "
                             f"stderr ends: {rec['stderr_tail'][-1500:]}")
    v = validate_run(mod, power["out"]["cpu"],
                     os.path.join(tmp, "dist", "out"), paths[0], timeout_s)
    out["distributed"] = {k: dist[k] for k in (
        "power_test_ms", "completed", "retried", "seconds", "placement")}
    out["distributed"].update(validate={k: v[k] for k in (
        "rc", "match", "skipped")})
    log(json.dumps({"phase": "throughput distributed power",
                    **out["distributed"]}))
    if v["rc"] or v["match"] != len(units) - v["skipped"]:
        raise SmokeError(f"throughput phase, the power CLI with --backend "
                         f"distributed: {v['match']} MATCH of "
                         f"{len(units) - v['skipped']}")
    return out


# ``--steps overlap``: the in-process streams with each number of
# statements in flight (``engine.concurrent_tasks``), in turns
OVERLAP_DEPTHS = (1, 2, 2, 1)
# a turn's program: the throughput CLI's ``--in_process`` run with
# ``engine.concurrent_tasks`` set (the CLI takes no property file)
OVERLAP_CHILD = """
import importlib, os, sys
from nds_tpu_torch.nds.throughput import run_streams_inprocess
from nds_tpu_torch.utils.config import EngineConfig
suite, depth, device, wh, out, *streams = sys.argv[1:]
elapse, failures = run_streams_inprocess(
    wh, streams, out, suite=importlib.import_module(
        f"nds_tpu_torch.{suite}.power").SUITE,
    config=EngineConfig(overrides={"engine.concurrent_tasks": depth,
                                   "engine.device": device}),
    output_prefix=os.path.join(out, "results"))
print(f"Throughput Time: {elapse} s over {len(streams)} streams")
sys.exit(1 if any(failures) else 0)
"""
# passes over the captured one-statement units in a replay turn
OVERLAP_PASSES = 3


def same_result(got, exp) -> "str | None":
    """None where ``got`` equals ``exp`` bit for bit (their digests);
    ``float`` where they differ but hold a float column whose values
    agree within ``FLOAT_SUM_RTOL`` (``validate_core.frames_equal``; the
    card's float sums may round differently from run to run); else
    ``differs``."""
    from nds_tpu_torch.io.result_io import result_digest
    from nds_tpu_torch.utils.validate_core import frames_equal
    if result_digest(got) == result_digest(exp):
        return None
    if any(getattr(c, "dtype", None) is not None and c.dtype.kind == "f"
           for c in exp.cols) and frames_equal(
               got.to_pandas(), exp.to_pandas(),
               epsilon=FLOAT_SUM_RTOL) is None:
        return "float"
    return "differs"


def replay_passes(sess, units: list, depth: int, passes: int) -> tuple:
    """``passes`` passes over ``units`` ((name, SQL) of one-statement
    units whose plans are captured) through ``Session.sql_async`` with
    ``depth`` statements in flight, as the in-process streams dispatch
    them: the wall ms (from a synchronized card to one), the last pass's
    results and the placements of every statement."""
    import torch
    inflight, results, placed = [], {}, Counter()

    def finish():
        name, h = inflight.pop(0)
        results[name] = h.result()
        placed[str((getattr(h, "sched", None) or {}).get("placement"))] += 1

    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    for _ in range(passes):
        for name, sql in units:
            inflight.append((name, sess.sql_async(sql)))
            while len(inflight) >= depth:
                finish()
    while inflight:
        finish()
    sync()
    return (time.perf_counter() - t0) * 1000, results, dict(placed)


def overlap_step(dev, legs: dict,
                 timeout_s: float = POWER_CLI_TIMEOUT_S) -> dict:
    """``--steps overlap``: what dispatching ahead (``execute_async``,
    ``engine.concurrent_tasks``) buys. Per suite (``legs``: {suite: scale
    factor}), in a temporary directory, the parquet warehouse
    (``load_chain``) and streams 1 and 2; the in-process throughput run
    (``OVERLAP_CHILD``, a process a turn) at each depth of
    ``OVERLAP_DEPTHS`` in turns, each a device run that
    ``throughput_faults`` must pass with every stream's results equal to
    the first turn's stream 1 (bit for bit, float columns within
    ``FLOAT_SUM_RTOL``); then, in this process over the same warehouse
    through the pipeline (``make_session``), the suite's one-statement
    power units run twice (each plan's first run and capture, then a
    replay) and replayed ``OVERLAP_PASSES`` times a turn at each depth
    (``replay_passes``), every statement placed ``device`` and every
    result equal to the first turn's (``same_result``). Prints one line a
    suite."""
    from nds_tpu_torch.utils import power_core
    from nds_tpu_torch.utils.config import EngineConfig
    tmp = tempfile.mkdtemp(prefix="nds_overlap_")
    out = {}
    try:
        for suite, sf in legs.items():
            mod = f"nds_tpu_torch.{suite}"
            load = load_chain(mod, sf, tmp, timeout_s)
            paths = importlib.import_module(
                f"{mod}.streams").generate_query_streams(
                    os.path.join(tmp, f"streams_{suite}"),
                    1 + THROUGHPUT_STREAMS)[1:]
            first = os.path.splitext(os.path.basename(paths[0]))[0]
            rec = out[suite] = {"sf": sf, "turns": [], "replays": []}
            digests, ref_out = None, None
            for i, depth in enumerate(OVERLAP_DEPTHS):
                run_dir = os.path.join(tmp, f"{suite}_{i}")
                run = throughput_run(
                    mod, load["wh"], paths, run_dir, "in_process", [],
                    timeout_s, [sys.executable, "-c", OVERLAP_CHILD, suite,
                                str(depth), dev.type, load["wh"], run_dir,
                                *paths])
                if digests is None:
                    digests = {q: st["digest"] for q, st in run["streams"][
                        first]["statements"].items() if st}
                    ref_out = os.path.join(run["results"], first)
                why = throughput_faults(run, "device", digests,
                                        list(digests), ref_out)
                rec["turns"].append({
                    "depth": depth, "rc": run["rc"],
                    "elapse_s": run["elapse_s"], "seconds": run["seconds"],
                    "power_test_ms": {n: st["power_test_ms"]
                                      for n, st in run["streams"].items()},
                    "memory": run.get("memory"),
                    "float_order": run["float_order"]})
                if why:
                    raise SmokeError(f"overlap step, {suite} depth {depth}: "
                                     f"{'; '.join(why)}; stderr ends: "
                                     f"{run['stderr_tail'][-1500:]}")
            suite_obj = importlib.import_module(f"{mod}.power").SUITE
            config = EngineConfig(overrides={"engine.device": dev.type})
            sess = power_core.make_session(suite_obj, config)
            power_core.load_warehouse(
                suite_obj, sess, load["wh"], "parquet",
                schemas=power_core.suite_schemas(suite_obj, config))
            units = [(n, st[0]) for n, st in suite_units(suite)
                     if len(st) == 1]
            for _ in range(2):
                for _n, sql in units:
                    sess.sql(sql)
            exp = None
            for depth in OVERLAP_DEPTHS:
                ms, got, placed = replay_passes(sess, units, depth,
                                                OVERLAP_PASSES)
                if exp is None:
                    exp = got
                differ = {n: same_result(got[n], exp[n]) for n in exp}
                rec["replays"].append({
                    "depth": depth, "ms": ms, "placed": placed,
                    "float_order": sorted(n for n, d in differ.items()
                                          if d == "float")})
                bad = sorted(n for n, d in differ.items() if d == "differs")
                if bad or set(placed) != {"device"}:
                    raise SmokeError(f"overlap step, {suite} replays at "
                                     f"depth {depth}: placed {placed}, "
                                     f"results differ {bad}")
            rec["units"] = len(units)
            del sess
            release(dev)
            log(json.dumps({"phase": "overlap", "suite": suite, **rec}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _host_copies(calls: list, dev) -> dict:
    """{name: copies from the card to the host} that each ``fn()`` of
    ``calls`` ((name, fn) pairs, run in turn) makes: the ``Memcpy DtoH``
    device events under one ``torch.profiler`` session that start inside
    the call's host range (each call ends with its result on the host).
    0 each off the card."""
    if dev.type != "cuda":
        for _name, fn in calls:
            fn()
        return {name: 0 for name, _fn in calls}
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in calls:
            with record_function(f"call:{name}"):
                fn()
        torch.cuda.synchronize()
    ranges, starts = {}, []
    for ev in prof.events():
        on_dev = ev.device_type == DeviceType.CUDA
        if ev.name.startswith("call:") and not on_dev:
            ranges[ev.name[5:]] = (ev.time_range.start, ev.time_range.end)
        elif on_dev and "DtoH" in ev.name:
            starts.append(ev.time_range.start)
    return {name: sum(1 for t in starts if s0 <= t < e0)
            for name, (s0, e0) in ranges.items()}


def async_check(dsess, units, dev) -> dict:
    """The device executor's ``execute_async`` on the plans
    of a leg's one-statement units, after their graphs are captured
    (a replay queues its copies to the host into pinned buffers of its
    own dispatch). Per unit: the copies to the host of one ``execute``
    and of one ``execute_async(...).result()`` (``_host_copies``, each
    way in one profiled pass over the units), which must be as many; two
    handles of the unit's plan in flight, resolved
    in both orders; and two handles of this unit's plan and the next
    one's in flight, resolved in both orders; then, with every graph
    dropped, two plans captured again (into a new pool) and replayed.
    Every result must equal ``execute``'s: bit for bit (its digest), or, where it holds a float
    column, within ``FLOAT_SUM_RTOL`` (``validate_core.frames_equal``;
    the card's float sums may round differently from run to run, which
    two ``execute`` calls show: ``unstable``)."""
    from nds_tpu_torch.io.result_io import result_digest
    t0 = time.perf_counter()
    ex = dsess._executor_factory(dsess.tables)
    plans = []
    for name, stmts in units:
        if len(stmts) == 1:
            key = (stmts[0], dsess._views_signature())
            plans.append((name, dsess._planned_for(key, stmts[0])))
    exp = {name: ex.execute(p) for name, p in plans}
    digests = {name: result_digest(r) for name, r in exp.items()}
    floats = {name for name, r in exp.items()
              if any(getattr(c, "dtype", None) is not None
                     and c.dtype.kind == "f" for c in r.cols)}
    unstable = sorted(name for name, p in plans
                      if result_digest(ex.execute(p)) != digests[name])
    copies, bad, float_order = {}, set(), set()

    def same(name, got):
        differ = same_result(got, exp[name])
        if differ == "float":
            float_order.add(name)
        elif differ:
            bad.add(name)

    held = {}
    sync = _host_copies([(name, functools.partial(ex.execute, p))
                         for name, p in plans], dev)
    dispatched = _host_copies([(name, functools.partial(
        lambda n, p: held.__setitem__(n, ex.execute_async(p).result()),
        name, p)) for name, p in plans], dev)
    for name, _p in plans:
        same(name, held[name])
        copies[name] = (sync.get(name), dispatched.get(name))
    for i, (name, p) in enumerate(plans):
        for order in ((0, 1), (1, 0)):
            hs = [ex.execute_async(p), ex.execute_async(p)]
            for j in order:
                same(name, hs[j].result())
        other, q = plans[(i + 1) % len(plans)]
        for order in ((0, 1), (1, 0)):
            hs = [(name, ex.execute_async(p)), (other, ex.execute_async(q))]
            for j in order:
                same(hs[j][0], hs[j][1].result())
    # every graph dropped, then a capture and a replay of two plans: the
    # captures take a new pool (torch's pinned-host allocator fails a
    # capture into a pool none of whose graphs is alive)
    graphs, recapture = getattr(ex, "_graphs", None), None
    if graphs is not None:
        pool = graphs.pool
        for key in list(graphs.graphs):
            graphs.drop(key)
        for name, p in plans[:2]:
            for _ in range(2):
                same(name, ex.execute(p))
        recapture = {"new_pool": graphs.pool is not pool,
                     "graphs": len(graphs.graphs)}
        if not recapture["new_pool"] or recapture["graphs"] != 2:
            bad.add("recapture")
    differ = {n: c for n, c in copies.items()
              if c[0] != c[1] or c[0] is None}
    rec = {"plans": len(plans), "results": 7 * len(plans) + 4,
           "recapture": recapture,
           "copies_execute": sum(c[0] for c in copies.values()),
           "copies_async": sum(c[1] for c in copies.values()),
           "copies_differ": differ, "float_results": sorted(floats),
           "unstable": unstable, "float_order": sorted(float_order),
           "digests_differ": sorted(bad),
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"phase": "async dispatch", **rec}))
    if differ or bad:
        raise SmokeError(f"execute_async: copies to the host differ "
                         f"{differ}, results differ {sorted(bad)}")
    return rec


def async_step(dev, factory_of, sf: float) -> dict:
    """``--steps async``: the NDS-H units at ``sf`` run twice on the
    device engine (each plan's first run and capture, then a replay),
    then ``async_check``."""
    dsess = suite_session("nds_h", factory_of())
    for t in make_tables("nds_h", sf).values():
        dsess.register_table(t)
    units = suite_units("nds_h")
    for _ in range(2):
        for _name, stmts in units:
            run_query(dsess, stmts)
    return async_check(dsess, units, dev)


def same_table(a, b) -> bool:
    """The same values, dictionaries and null masks, column by column."""
    import numpy as np

    def same(x, y):
        return (x is None) == (y is None) and (
            x is None or (x.dtype == y.dtype and np.array_equal(x, y)))
    return list(a.columns) == list(b.columns) and all(
        same(a.columns[c].values, b.columns[c].values)
        and same(a.columns[c].dictionary, b.columns[c].dictionary)
        and same(a.columns[c].null_mask, b.columns[c].null_mask)
        for c in a.columns)


def in_warehouse_order(table, part_col: "str | None"):
    """``table`` (a raw read) with its rows in the order a partitioned
    fact's warehouse holds them: ``transcode`` writes one file per 30-day
    band of ``part_col`` (NULL keys under ``__HIVE_DEFAULT_PARTITION__``),
    each band's rows in their raw order, and ``load_warehouse`` reads
    the files in the order of their paths, so in the order of the band
    labels as strings."""
    import numpy as np
    from nds_tpu_torch.io.host_table import HostColumn, HostTable
    if part_col is None or not table.nrows:
        return table
    col = table.columns[part_col]
    band = (col.values // 30 if col.null_mask is None
            else np.where(col.null_mask, col.values // 30, -1))
    bands = np.unique(band)
    labels = np.array(["__HIVE_DEFAULT_PARTITION__" if b < 0
                       else str(int(b) * 30) for b in bands])
    rank = np.empty(len(bands), dtype=np.int64)
    rank[np.argsort(labels, kind="stable")] = np.arange(len(bands))
    order = np.argsort(rank[np.searchsorted(bands, band)], kind="stable")
    return HostTable(table.name, table.schema, {
        n: HostColumn(c.dtype, c.values[order], c.dictionary,
                      None if c.null_mask is None else c.null_mask[order])
        for n, c in table.columns.items()})


def load_phase(legs: dict, timeout_s: float = POWER_CLI_TIMEOUT_S) -> dict:
    """The load phase per suite (``legs``: {suite: scale factor}) in a
    temporary directory: ``gen_data`` and ``transcode`` to parquet
    (``load_chain``, the transcode's seconds from its load report), then
    every table read from the raw text by ``read_tbl`` (twice, the best
    kept; the files warm in the page cache from their writing) and from
    the parquet warehouse by ``load_warehouse`` (twice, the best kept).
    Every table read back must equal its raw read, a partitioned fact's
    rows taken in the warehouse's order (``in_warehouse_order``). Prints
    one line per suite: seconds and MB/s (of raw text) of each step, and
    the raw reader's slowest tables."""
    import shutil
    import tempfile
    from nds_tpu_torch.io import csv_io
    from nds_tpu_torch.utils import power_core
    from nds_tpu_torch.utils.config import EngineConfig
    tmp = tempfile.mkdtemp(prefix="nds_load_")
    out = {}
    try:
        for suite, sf in legs.items():
            mod = f"nds_tpu_torch.{suite}"
            load = load_chain(mod, sf, tmp, timeout_s)
            power = importlib.import_module(f"{mod}.power")
            schemas = power_core.suite_schemas(power.SUITE, EngineConfig())
            raw_s, text_bytes, tables = {}, 0, {}
            for name, schema in schemas.items():
                tdir = os.path.join(load["raw"], name)
                paths = (sorted(os.path.join(tdir, f)
                                for f in os.listdir(tdir)
                                if not f.startswith("."))
                         if os.path.isdir(tdir) else
                         [os.path.join(load["raw"],
                                       f"{name}{power.SUITE.raw_ext}")])
                text_bytes += sum(os.path.getsize(p) for p in paths)
                for _ in range(2):
                    t0 = time.perf_counter()
                    tables[name] = csv_io.read_tbl(paths, name, schema)
                    secs = time.perf_counter() - t0
                    raw_s[name] = min(secs, raw_s.get(name, secs))
            parquet_s = None
            for _ in range(2):
                sess = power.SUITE.session_for(None)
                t0 = time.perf_counter()
                power_core.load_warehouse(power.SUITE, sess, load["wh"],
                                          "parquet", schemas=schemas)
                secs = time.perf_counter() - t0
                parquet_s = min(secs, parquet_s or secs)
            parts = getattr(importlib.import_module(f"{mod}.transcode"),
                            "TABLE_PARTITIONING", {})
            differ = [n for n in schemas if not same_table(
                sess.tables[n], in_warehouse_order(tables[n], parts.get(n)))]
            del sess, tables
            rec = {"sf": sf, **{k: v for k, v in load.items()
                                if k not in ("raw", "wh")},
                   "text_bytes": text_bytes,
                   "read_tbl_s": sum(raw_s.values()),
                   "load_parquet_s": parquet_s,
                   "slowest": sorted(raw_s.items(), key=lambda kv: -kv[1])[:4],
                   "tables": raw_s}
            for k in ("read_tbl_s", "transcode_s", "load_parquet_s"):
                rec[k[:-2] + "_MBps"] = text_bytes / 1e6 / rec[k]
            log(json.dumps({"phase": "load", "suite": suite,
                            **{k: v for k, v in rec.items()
                               if k != "tables"}}))
            if differ:
                raise SmokeError(f"load phase, {suite}: the parquet "
                                 f"warehouse's tables differ from the raw "
                                 f"reads: {differ}")
            out[suite] = rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"]})
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
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="another checkout of this repo (git archive), "
                    "whose sorts and searches are timed beside this one's")
    ap.add_argument("--steps", default=None, metavar="STEP[,STEP]",
                    help="only check and time the named steps (kernel "
                    "wrappers, or l2: L2's pack, sort and group bounds) on "
                    "this design and --parent's beside it; with plans, "
                    "run the plan graphs' adversarial cases at --sf-ds; "
                    "with bench, run the port's bench entry at --sf and "
                    "--sf-ds; with power, the port's gen_data, transcode, "
                    "power and validate CLIs at --sf and --sf-ds; with "
                    "load, the raw read, the transcode and the parquet "
                    "read-back at --sf and --sf-ds; with throughput, the "
                    "throughput CLIs at --sf and --sf-ds (throughput_beyond: "
                    "the 2-stream NDS subprocess attempt alone); with "
                    "async, execute_async on the NDS-H units at --sf; with "
                    "overlap, the in-process streams and replays at 1 and "
                    "2 statements in flight at --sf and --sf-ds; then exit")
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

    if args.steps:
        if dev.type == "cuda":
            cuda_build.build_all()
        designs = {"this": KX}
        if args.parent:
            designs = {"parent": load_parent(args.parent, dev)[0], "this": KX}
        steps = args.steps.split(",")
        kernel_steps = [n for n in steps if n not in (
            "bench", "plans", "power", "load", "throughput",
            "throughput_beyond", "async", "overlap")]
        rec = {"card": card, "phase": "steps", "cases": []}
        if kernel_steps:
            rec.update(design_steps(kernel_steps, designs, factory_of, dev,
                                    args.sf, args.sf_ds))
            release(dev)
        if "plans" in steps:
            rec["plans"] = plan_cases(KX, factory_of, dev, args.sf_ds)
        if "power" in steps:
            rec["power"] = power_phase(dev, {"nds_h": args.sf,
                                             "nds": args.sf_ds})
        if "load" in steps:
            rec["load"] = load_phase({"nds_h": args.sf, "nds": args.sf_ds})
        if "async" in steps:
            rec["async"] = async_step(dev, factory_of, args.sf)
            release(dev)
        if "overlap" in steps:
            rec["overlap"] = overlap_step(dev, {"nds_h": args.sf,
                                               "nds": args.sf_ds})
        if "throughput" in steps:
            rec["throughput"] = throughput_step(
                dev, {"nds_h": args.sf, "nds": args.sf_ds})
        elif "throughput_beyond" in steps:
            rec["throughput"] = throughput_step(dev, {"nds": args.sf_ds},
                                                beyond_only=True)
        if "bench" in steps:
            rec["bench"] = bench_phase(card, dev, args.sf, args.sf_ds,
                                       BENCH_STEP_TIMEOUT_S)
        if "power" in rec:
            power_beside_bench(rec["power"], rec.get("bench"))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
        print(json.dumps([{"step": r["step"], "case": r["case"],
                           "bound_ms": r["bound_ms"],
                           **{who: d["device_ms"] if "device_ms" in d else
                              {st: x["device_ms"] for st, x in d.items()}
                              for who, d in r["designs"].items()}}
                          for r in rec["cases"]]
                         + ([{"plans": [[c["case"], c["captures"],
                                          c["replays"]]
                                         for c in rec["plans"]["cases"]]}]
                            if "plans" in rec else [])
                         + ([rec["bench"]["last_line"]] if "bench" in rec
                            else [])
                         + ([{"power": {
                             suite: {k: r["power_test_ms"]
                                     for k, r in p["runs"].items()}
                             for suite, p in rec["power"].items()}}]
                            if "power" in rec else [])
                         + ([{"load": {
                             suite: {k: l[k] for k in (
                                 "read_tbl_s", "transcode_s",
                                 "load_parquet_s")}
                             for suite, l in rec["load"].items()}}]
                            if "load" in rec else [])
                         + ([{"async": {k: rec["async"][k] for k in (
                             "plans", "copies_execute", "copies_async")}}]
                            if "async" in rec else [])
                         + ([{"throughput": [
                             [r["suite"], r["mode"], r["rc"], r["elapse_s"],
                              {n: st["power_test_ms"]
                               for n, st in r["streams"].items()}]
                             for r in rec["throughput"]["runs"]]}]
                            if "throughput" in rec else [])
                         + ([{"overlap": {
                             suite: {"turns": [[t["depth"], t["elapse_s"]]
                                               for t in o["turns"]],
                                     "replay_ms": [[r["depth"], r["ms"]]
                                                   for r in o["replays"]]}
                             for suite, o in rec["overlap"].items()}}]
                            if "overlap" in rec else [])))
        return 0

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
        parent = None
        if args.parent:
            t0 = time.perf_counter()
            parent = load_parent(args.parent, dev)
            log(json.dumps({"phase": "parent build", "root": args.parent,
                            "seconds": time.perf_counter() - t0}))
        paths = {}
        if dev.type == "cuda":
            replays = graph_replays(KX, dev)
            record["graph_replays"] = replays
            paths["graph_replays"] = {"launches": {}, "kernel_checks": replays,
                                      "main_cases": {}}
        paths["nds_h"], dsess = run_leg("nds_h", KX, factory_of, dev, pool,
                                        record, parent=parent)
        record["async"] = async_check(dsess, suite_units("nds_h"), dev)
        del dsess
        release(dev)
        run_distributed(KX, dev, pool, record, paths)
        paths["nds"], dsess = run_leg("nds", KX, factory_of, dev, pool,
                                      record, parent=parent)
        paths["window"] = run_window_path(KX, dsess, dev, pool, record)
        # the raw executors go before the columnar legs start, so that
        # raw and encoded buffers are never resident together
        del dsess
        release(dev)
        run_columnar(KX, factory_of, dev, pool, record, paths)
        release(dev)
        record["bench"] = bench_phase(card, dev, BENCH_SMOKE_SF,
                                      BENCH_SMOKE_SF_DS,
                                      BENCH_SMOKE_TIMEOUT_S)
        tmp = tempfile.mkdtemp(prefix="nds_power_")
        try:
            record["power"] = power_phase(
                dev, {"nds_h": POWER_SMOKE_SF}, warmups=(0,), tmp=tmp,
                streams_n=1 + THROUGHPUT_STREAMS)
            power_beside_bench(record["power"], record["bench"])
            record["throughput"] = throughput_phase(
                dev, record["power"]["nds_h"], tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
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
