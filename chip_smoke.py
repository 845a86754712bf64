#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the NDS-H power run on one card.

    python3 chip_smoke.py [--sf 1.0] [--out chiprun_out/smoke.json]

Drives ``nds_tpu_torch`` (never ``jax``, never ``nds_tpu``) on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; exits 2 without a CUDA device;
2. builds the five CUDA C++ kernels from ``nds_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once);
3. generates NDS-H data at ``--sf`` (default SF1, ``bench.py``'s scale)
   with the port's generator and registers it in
   ``Session.for_nds_h(make_device_factory())`` on ``cuda`` and in the
   CPU oracle's session;
4. kernel phase: every kernel against its plain PyTorch version on the
   card, on the inputs the main path handed it in an untimed pass of the
   22 queries (captured at each kernel's largest call) and at the SF1
   shapes of the main path's joins built from the real columns (probe
   6,001,215 rows; builds of 1,500,000, 200,000, 25 and 256 rows; the
   segmented scan over 6,001,215 rows at several group counts). Results
   must be exactly equal. Each line gives the kernel's time (CUDA events,
   median after warm-up), the plain version's, the bytes it must move, the
   least time the card could take for them (``bound_ms``) and, where one
   PyTorch call computes the same thing, that call's time;
5. main path: launch counts set to 0, the 22 queries run once more and
   timed, the counts read; then one more pass under ``torch.profiler``
   gives the card's busy time per query and the kernels that hold it
   longest; every result is checked against the CPU oracle by the
   validator's rules, and every kernel's launch count required above 0;
6. prints the kernels line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises: the exit code is then non-zero and no result
line is printed. ``--device cpu`` rehearses the script on the CPU, where
the wrappers take their plain versions and the launch check fails.
"""

from __future__ import annotations

import argparse
import json
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


def work_of(name: str, args, out) -> tuple:
    """(bytes the function must move, operations it does): each input
    read once, each output written once; the operations are one per
    row handled, and one compare per (probe row, build row) pair for
    the small-build probe."""
    tens = [a for a in args if hasattr(a, "numel")]
    moved = nbytes(tens) + nbytes(out)
    rows = sum(a.numel() for a in tens)
    ops = rows
    if name == "matmul_probe_join":
        ops = args[2].numel() * args[0].numel()
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
    if name == "keyed_minmax_semi":
        bkey, bok, bval, _pk, _po, _pv, lo, dom = args
        idx = torch.where(bok, bkey.to(torch.int64) - lo,
                          torch.full_like(bkey, dom, dtype=torch.int64))
        tbl = torch.empty(dom + 1, dtype=bval.dtype, device=bval.device)
        return lambda: tbl.fill_(torch.iinfo(bval.dtype).max).scatter_reduce_(
            0, idx, bval, "amin", include_self=True)
    return None


def check_kernel(KX, name: str, args, label: str, dev) -> dict:
    """Kernel vs its plain version on the same inputs: exact equality
    required; times and bound of this call."""
    fn = getattr(KX, name)
    plain = getattr(KX, name + "_plain")
    got = fn(*args)
    exp = plain(*args)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    if err != 0.0:
        raise SmokeError(f"{name} [{label}] differs from its plain "
                         f"version: max_abs_err={err}")
    ms = time_ms(lambda: fn(*args), dev)
    plain_ms = time_ms(lambda: plain(*args), dev, reps=3, warm=1)
    lib = library_call(name, args)
    library_ms = time_ms(lib, dev) if lib is not None else None
    moved, ops = work_of(name, args, got)
    bound_ms, bound_by = bound(moved, ops)
    shapes = [list(a.shape) + [str(a.dtype).replace("torch.", "")]
              for a in args if hasattr(a, "shape")]
    rec = {"kernel": name, "case": label, "shapes": shapes,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bytes": moved, "ops": ops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(json.dumps(rec))
    return rec


# ------------------------------------------------------------------ data

def make_tables(sf: float) -> dict:
    from nds_tpu_torch.datagen import tpch
    from nds_tpu_torch.io.host_table import from_arrays
    from nds_tpu_torch.nds_h.schema import get_schemas
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], tpch.gen_table(t, sf))
            for t in schemas}


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


# ------------------------------------------------------------- main path

def run_query(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    return result


class Recorder:
    """Wraps the kernel wrappers during the untimed pass to keep, per
    kernel, a copy of the inputs of its largest call."""

    def __init__(self, KX):
        self.KX = KX
        self.orig = {n: getattr(KX, n) for n in KERNELS}
        self.largest: dict = {}
        self.calls: dict = {n: 0 for n in KERNELS}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.KX, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.KX, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*args):
            self.calls[name] += 1
            size = sum(a.numel() for a in args if hasattr(a, "numel"))
            cur = self.largest.get(name)
            if cur is None or size > cur[0]:
                self.largest[name] = (size, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args))
            return fn(*args)
        return wrapper


def profile_pass(dsess, qids, dev, per_query) -> dict:
    """One more pass of the 22 queries under torch.profiler. Each query
    ends in its device->host copy, so the device work a query launched
    runs inside its host range: per query, the time the card spent in
    kernels and copies that started in that range. The busy share is
    that device time over the timed pass's wall clock (the profiler
    slows the host, not the card); the kernels that hold the card
    longest are listed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from nds_tpu_torch.nds_h import streams
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for qn in qids:
            with record_function(f"query{qn}"):
                run_query(dsess, streams.statements(qn))
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ranges, work = {}, []
    for ev in prof.events():
        on_dev = ev.device_type == DeviceType.CUDA
        name = ev.name
        if name.startswith("query") and name[5:].isdigit():
            if not on_dev:
                ranges[int(name[5:])] = (ev.time_range.start,
                                         ev.time_range.end)
            continue
        if on_dev:
            work.append((ev.time_range.start,
                         ev.time_range.elapsed_us() / 1000, name))
    by_query = {qn: sum(ms for t, ms, _ in work if s <= t < e)
                for qn, (s, e) in ranges.items()}
    by_name: dict = {}
    for _t, ms, name in work:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    device_ms = sum(by_query.values())
    wall_ms = sum(per_query[q]["wall_ms"] for q in qids)
    out = {"device_ms": device_ms, "timed_wall_ms": wall_ms,
           "profiled_wall_ms": sum((e - s) / 1000
                                   for s, e in ranges.values()),
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "device_launches": len(work),
           "top_device_kernels": [{"kernel": k[:160], "ms": ms, "count": c}
                                  for k, (ms, c) in top]}
    for qn in qids:
        per_query[qn]["profiled_device_ms"] = by_query.get(qn)
    log(json.dumps({"phase": "profile", **out}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
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
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.nds_h import streams
    from nds_tpu_torch.utils.validate_core import frames_equal

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "sf": args.sf}
    t_start = time.perf_counter()
    if dev.type == "cuda":
        t0 = time.perf_counter()
        built = cuda_build.build_all()
        for name in cuda_build.SIGNATURES:
            cuda_build.library(name)
        record["build_s"] = time.perf_counter() - t0
        log(json.dumps({"phase": "build", "seconds": record["build_s"],
                        "built": built}))

    t0 = time.perf_counter()
    tables = make_tables(args.sf)
    record["datagen_s"] = time.perf_counter() - t0
    log(json.dumps({"phase": "datagen", "sf": args.sf,
                    "seconds": record["datagen_s"],
                    "rows": {t: tables[t].nrows for t in tables}}))

    factory = make_device_factory(device=None if dev.type == "cuda"
                                  else args.device)
    dsess = Session.for_nds_h(factory)
    csess = Session.for_nds_h()
    for t in tables.values():
        dsess.register_table(t)
        csess.register_table(t)
    qids = list(range(1, 23))

    # untimed pass: uploads, host-side planning, captured kernel inputs
    t0 = time.perf_counter()
    with Recorder(KX) as rec:
        for qn in qids:
            run_query(dsess, streams.statements(qn))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    record["warm_pass_s"] = time.perf_counter() - t0
    log(json.dumps({"phase": "warm pass", "seconds": record["warm_pass_s"],
                    "kernel_calls": rec.calls}))

    # kernel phase: captured main-path inputs, then the SF1 join shapes
    main_cases = {}
    checks = []
    for name in KERNELS:
        if name not in rec.largest:
            raise SmokeError(f"the main path never called {name}")
        r = check_kernel(KX, name, rec.largest[name][1], "main path", dev)
        main_cases[name] = r
        checks.append(r)
    del rec
    for name, kargs, label in sf1_shape_cases(tables, dev):
        checks.append(check_kernel(KX, name, kargs, label, dev))
    record["kernel_checks"] = checks

    # main path: counts at 0, the 22 queries timed, then read
    KX.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    per_query = {}
    results = {}
    ex = factory(dsess.tables)
    for qn in qids:
        t0 = time.perf_counter()
        res = run_query(dsess, streams.statements(qn))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        results[qn] = res
        lt = ex.last_timings
        per_query[qn] = {"wall_ms": ms,
                         "execute_ms": lt.get("execute_ms"),
                         "materialize_ms": lt.get("materialize_ms"),
                         "slack_retries": lt.get("slack_retries"),
                         "kernels": lt.get("__kernels"),
                         "rows": len(res.to_pandas())}
    launches = KX.launch_counts()
    power_ms = sum(q["wall_ms"] for q in per_query.values())
    record["launches"] = launches
    record["power_total_ms"] = power_ms
    if dev.type == "cuda":
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()

    record["profile"] = profile_pass(dsess, qids, dev, per_query)

    # oracle check
    t0 = time.perf_counter()
    bad = []
    for qn in qids:
        t1 = time.perf_counter()
        exp = run_query(csess, streams.statements(qn))
        per_query[qn]["cpu_oracle_ms"] = (time.perf_counter() - t1) * 1000
        why = frames_equal(results[qn].to_pandas(), exp.to_pandas())
        per_query[qn]["match"] = why is None
        if why is not None:
            bad.append(f"q{qn}: {why}")
        log(json.dumps({"query": qn, **per_query[qn]}))
    record["oracle_s"] = time.perf_counter() - t0
    record["per_query"] = per_query
    log(json.dumps({"phase": "main path", "sf": args.sf,
                    "power_total_ms": power_ms, "launches": launches,
                    "peak_device_bytes": record.get("peak_device_bytes"),
                    "oracle_s": record["oracle_s"],
                    "total_s": time.perf_counter() - t_start}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, default=str)
    if bad:
        raise SmokeError("results differ from the CPU oracle: "
                         + "; ".join(bad))
    missing = [n for n in KERNELS if launches.get(n, 0) <= 0]
    if missing:
        raise SmokeError(f"the timed main path launched no {missing}")

    kernels_line = []
    for name, (source, replaces) in KERNELS.items():
        r = main_cases[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
