"""Parity of the port's NDS kernels (K6, K7) with the JAX package's.

Each case makes its inputs from a seed with numpy and runs them through
``nds_tpu.engine.kernels`` on jax CPU (x64) and through the port's
wrapper in ``nds_tpu_torch.engine.kernels`` on torch CPU, which takes
the plain PyTorch version there.

- ``partitioned_mn_join`` (K6): ``lidx``, ``ridx``, ``present`` and
  ``overflow`` exactly equal, slot for slot, over int32 and packed int64
  keys, invalid rows, a hot key that overflows its partition (small
  ``part_slack``), output capacity too small for the matches (small
  ``K``), and sides shorter than 16 rows.
- ``seg_scan`` (K7) for "sum", "min" and "max" over int32, int64 and
  float64, with resets at the edges, everywhere and nowhere; and
  ``part_reduce_broadcast`` and ``last_of_group`` on the same inputs.
  Integers and min/max are exactly equal. A float64 sum is held to
  rtol 1e-12: the plain version's Hillis-Steele doubling associates the
  additions in another order than ``lax.associative_scan``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nds_tpu.engine import kernels as REF
from nds_tpu_torch.engine import kernels as KX

jax.config.update("jax_enable_x64", True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rng(*parts):
    """A generator seeded from the case's name, the same in every
    process."""
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _assert_same(got, exp):
    exp = np.asarray(exp)
    assert got.dtype == torch.from_numpy(np.empty(0, exp.dtype)).dtype, (
        got.dtype, exp.dtype)
    np.testing.assert_array_equal(got.numpy(), exp)


# ------------------------------------------------------------------ K6

def _keys(rng, n, dom, dtype, base):
    return (rng.integers(0, dom, n) + base).astype(dtype)


K6_CASES = {
    # name: (seed, nl, nr, key domain, dtype, key base, K, part_slack,
    #        left valid fraction, right valid fraction)
    "int32": (1, 700, 500, 300, np.int32, 0, 2000, 2.0, 1.0, 1.0),
    "int32_invalid_rows": (2, 600, 650, 90, np.int32, -40, 3000, 2.0,
                           0.8, 0.7),
    "int64_packed": (3, 500, 400, 150, np.int64, 3 << 40, 2500, 2.0,
                     0.9, 0.9),
    "int64_negative": (4, 300, 300, 60, np.int64, -(1 << 35), 4000, 2.0,
                       0.95, 0.9),
    "partition_overflow": (5, 400, 400, 4, np.int32, 7, 20000, 0.3,
                           1.0, 1.0),
    "output_overflow": (6, 500, 500, 20, np.int32, 0, 300, 2.0, 1.0, 1.0),
    "left_short": (7, 9, 400, 30, np.int32, 0, 800, 2.0, 1.0, 0.9),
    "right_short": (8, 400, 5, 30, np.int64, 1 << 33, 800, 2.0, 0.9, 1.0),
    "both_short": (9, 3, 2, 2, np.int32, 0, 4, 2.0, 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_partitioned_mn_join_matches_reference(case):
    seed, nl, nr, dom, kdt, base, K, slack, lvf, rvf = K6_CASES[case]
    rng = np.random.default_rng(seed)
    lkey = _keys(rng, nl, dom, kdt, base)
    rkey = _keys(rng, nr, dom, kdt, base)
    lok = rng.random(nl) < lvf
    rok = rng.random(nr) < rvf
    exp = REF.partitioned_mn_join(lkey, lok, rkey, rok, K, slack)
    got = KX.partitioned_mn_join(_t(lkey), _t(lok), _t(rkey), _t(rok), K,
                                 slack)
    assert len(got) == 4
    for g, e in zip(got, exp):
        _assert_same(g, e)
    if case.endswith("overflow"):
        assert int(got[3]) > 0


# ------------------------------------------------------------------ K7

_JAX_OPS = {"sum": lambda a, b: a + b, "min": jnp.minimum,
            "max": jnp.maximum}

N_SCAN = 3000


def _flags(rng, pattern: str, n: int = N_SCAN):
    if pattern == "none":
        return np.zeros(n, dtype=bool)
    if pattern == "all":
        return np.ones(n, dtype=bool)
    f = rng.random(n) < 0.02
    # a reset on the last row, none on the first, and runs of both
    f[0], f[-1] = False, True
    f[100:140] = True
    f[500:900] = False
    return f


def _vals(rng, dtype, n: int = N_SCAN):
    if dtype == np.float64:
        v = rng.normal(scale=1e3, size=n)
        v[7] = -0.0
        return v
    lo, hi = (-1000, 1000) if dtype == np.int32 else (-10**15, 10**15)
    return rng.integers(lo, hi, n).astype(dtype)


def _check(got, exp, dtype, op):
    if dtype == np.float64 and op == "sum":
        # another association order than lax.associative_scan's
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=1e-12, atol=0)
    else:
        _assert_same(got, exp)


SCAN_DTYPES = {"int32": np.int32, "int64": np.int64, "float64": np.float64}
PATTERNS = ("edges", "all", "none")


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dtype", sorted(SCAN_DTYPES))
@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_seg_scan_matches_reference(op, dtype, pattern):
    dt = SCAN_DTYPES[dtype]
    rng = _rng("scan", op, dtype, pattern)
    vals = _vals(rng, dt)
    flags = _flags(rng, pattern)
    exp = REF.seg_scan(_JAX_OPS[op], jnp.asarray(vals), jnp.asarray(flags))
    got = KX.seg_scan(op, _t(vals), _t(flags))
    _check(got, exp, dt, op)


def test_seg_scan_int32_sum_wraps_as_reference():
    # int32 counts stay int32 in both: a sum past 2^31 wraps alike
    vals = np.full(N_SCAN, 2**30, dtype=np.int32)
    flags = np.zeros(N_SCAN, dtype=bool)
    exp = REF.seg_scan(_JAX_OPS["sum"], jnp.asarray(vals),
                       jnp.asarray(flags))
    got = KX.seg_scan("sum", _t(vals), _t(flags))
    _assert_same(got, exp)


def _pend(part_start):
    """Each row's partition end, as the executor derives it."""
    n = part_start.shape[0]
    starts = np.nonzero(part_start)[0]
    nxt = np.full(n, n, dtype=np.int64)
    for s in starts:
        nxt[:s] = np.where(nxt[:s] > s, s, nxt[:s])
    return np.clip(nxt - 1, 0, n - 1).astype(np.int32)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dtype", sorted(SCAN_DTYPES))
@pytest.mark.parametrize("op", ("min", "max"))
def test_part_reduce_broadcast_matches_reference(op, dtype, pattern):
    dt = SCAN_DTYPES[dtype]
    rng = _rng("prb", op, dtype, pattern)
    vals = _vals(rng, dt)
    part_start = _flags(rng, pattern)
    part_start[0] = True
    pend = _pend(part_start)
    exp = REF.part_reduce_broadcast(_JAX_OPS[op], jnp.asarray(vals),
                                    jnp.asarray(part_start),
                                    jnp.asarray(pend))
    got = KX.part_reduce_broadcast(op, _t(vals), _t(part_start), _t(pend))
    _check(got, exp, dt, op)


@pytest.mark.parametrize("pattern", PATTERNS + ("first_only",))
@pytest.mark.parametrize("n", (1, 2, 1025, N_SCAN))
def test_last_of_group_matches_reference(pattern, n):
    rng = _rng("log", pattern, n)
    change = _flags(rng, pattern if pattern != "first_only" else "none",
                    N_SCAN)[:n].copy()
    if pattern == "first_only":
        change[0] = True
    exp = REF.last_of_group(jnp.asarray(change), n)
    got = KX.last_of_group(_t(change), n)
    _assert_same(got, exp)


def test_new_wrappers_count_no_launch_on_cpu():
    """The plain versions run for CPU tensors and count nothing."""
    KX.reset_launches()
    f = torch.tensor([True, False, False, True])
    v = torch.arange(4, dtype=torch.int64)
    KX.seg_scan("sum", v, f)
    KX.part_reduce_broadcast("max", v, f, torch.tensor([2, 2, 2, 3]))
    KX.last_of_group(f, 4)
    KX.partitioned_mn_join(v, f, v, f, 8, 2.0)
    assert all(c == 0 for c in KX.launch_counts().values())
    for name in ("seg_scan", "part_reduce_broadcast", "last_of_group",
                 "partitioned_mn_join"):
        assert name in KX.LAUNCHES


_META_CALLS = {
    "partitioned_mn_join": lambda k, ok: KX.partitioned_mn_join(
        k, ok, k, ok, 8, 2.0),
    "seg_scan": lambda k, ok: KX.seg_scan("sum", k, ok),
    "part_reduce_broadcast": lambda k, ok: KX.part_reduce_broadcast(
        "max", k, ok, k),
    "last_of_group": lambda k, ok: KX.last_of_group(ok, 4),
}


@pytest.mark.parametrize("name", sorted(_META_CALLS))
def test_nds_wrappers_refuse_other_devices(name):
    """A tensor neither on the CPU nor on CUDA reaches no plain version
    and no kernel: the wrapper raises."""
    k = torch.zeros(4, dtype=torch.int32, device="meta")
    ok = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        _META_CALLS[name](k, ok)
