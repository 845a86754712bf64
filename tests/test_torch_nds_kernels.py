"""Parity of the port's NDS kernels (K6, K7) with the JAX package's.

Each case makes its inputs from a seed with numpy and runs them through
``nds_tpu.engine.kernels`` on jax CPU (x64) and through the port's
wrapper in ``nds_tpu_torch.engine.kernels`` on torch CPU, which takes
the plain PyTorch version there.

- ``partitioned_mn_join`` (K6): ``lidx``, ``ridx``, ``present`` and
  ``overflow`` exactly equal, slot for slot, over int32 and packed int64
  keys, invalid rows, a hot key that overflows its partition (small
  ``part_slack``), output capacity too small for the matches (small
  ``K``), sides shorter than 16 rows, valid keys equal to
  ``iinfo(key).max`` on both sides (they match the unoccupied slots too),
  every row in one partition, an int64 key range wider than 2^32 and
  empty partitions.
- ``partition_sort`` (K6's build sort): its plain version equals the
  stable sort of the whole block with its row ids gathered
  (``torch.sort`` + ``gather``, and the JAX version's ``lax.sort``) on
  the radix-scattered blocks of every K6 case.
- ``seg_scan`` (K7) for "sum", "min" and "max" over int32, int64 and
  float64, with resets at the edges, everywhere and nowhere; and
  ``part_reduce_broadcast`` and ``last_of_group`` on the same inputs.
  Integers and min/max are exactly equal. A float64 sum is held to
  rtol 1e-12: the plain version's Hillis-Steele doubling associates the
  additions in another order than ``lax.associative_scan``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

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

def _pid8(keys):
    """Each key's partition of 8, as both packages hash it."""
    u = keys.astype(np.int64) & 0xFFFFFFFF
    return ((u * 2654435761) & 0xFFFFFFFF) >> 29


def _pool(dom, dtype, base, gen):
    """``dom`` distinct keys to draw from: ``pids=a,b`` the first keys
    from ``base`` up whose partition of 8 is one of those; ``wide``
    keys spread over 2^40 on either side of ``base``."""
    if gen == "wide":
        return np.linspace(base - (1 << 40), base + (1 << 40), dom,
                           dtype=np.int64).astype(dtype)
    want = [int(x) for x in gen[5:].split(",")]
    cand = base + np.arange(64 * dom, dtype=np.int64)
    return cand[np.isin(_pid8(cand), want)][:dom].astype(dtype)


def _keys(rng, n, dom, dtype, base, gen="uniform"):
    if gen == "uniform":
        return (rng.integers(0, dom, n) + base).astype(dtype)
    return rng.choice(_pool(dom, dtype, base, gen), n)


_I32_MAX = np.iinfo(np.int32).max
_I64_MAX = np.iinfo(np.int64).max

K6_CASES = {
    # name: (seed, nl, nr, key domain, dtype, key base, K, part_slack,
    #        left valid fraction, right valid fraction[, key generator])
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
    # keys up to iinfo.max: a valid max key also matches every unoccupied
    # build slot, whose sentinel is the same value
    "int32_sentinel_keys": (10, 300, 250, 6, np.int32, _I32_MAX - 5, 40000,
                            2.0, 0.9, 0.9),
    "int64_sentinel_keys": (11, 260, 300, 5, np.int64, _I64_MAX - 4, 40000,
                            2.0, 0.95, 0.85),
    "one_partition": (12, 300, 200, 40, np.int32, 1000, 3000, 8.0, 1.0,
                      1.0, "pids=5"),
    "int64_wide_range": (13, 500, 450, 64, np.int64, 1 << 36, 6000, 2.0,
                         0.9, 0.9, "wide"),
    "empty_partitions": (14, 400, 350, 30, np.int64, -(1 << 33), 8000, 2.0,
                         1.0, 0.9, "pids=0,3,4"),
}


def _k6_inputs(case):
    seed, nl, nr, dom, kdt, base, K, slack, lvf, rvf, *gen = K6_CASES[case]
    gen = gen[0] if gen else "uniform"
    rng = np.random.default_rng(seed)
    lkey = _keys(rng, nl, dom, kdt, base, gen)
    rkey = _keys(rng, nr, dom, kdt, base, gen)
    lok = rng.random(nl) < lvf
    rok = rng.random(nr) < rvf
    return lkey, lok, rkey, rok, K, slack


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_partitioned_mn_join_matches_reference(case):
    lkey, lok, rkey, rok, K, slack = _k6_inputs(case)
    exp = REF.partitioned_mn_join(lkey, lok, rkey, rok, K, slack)
    got = KX.partitioned_mn_join(_t(lkey), _t(lok), _t(rkey), _t(rok), K,
                                 slack)
    assert len(got) == 4
    for g, e in zip(got, exp):
        _assert_same(g, e)
    if case.endswith("overflow"):
        assert int(got[3]) > 0


def test_k6_cases_hold_what_they_name():
    lkey, lok, rkey, rok, _K, _s = _k6_inputs("int32_sentinel_keys")
    assert (lkey[lok] == _I32_MAX).any() and (rkey[rok] == _I32_MAX).any()
    lkey, lok, rkey, rok, _K, _s = _k6_inputs("int64_sentinel_keys")
    assert (lkey[lok] == _I64_MAX).any() and (rkey[rok] == _I64_MAX).any()
    lkey, *_ = _k6_inputs("one_partition")
    assert set(_pid8(lkey)) == {5}
    lkey, *_ = _k6_inputs("int64_wide_range")
    assert int(lkey.max()) - int(lkey.min()) > 1 << 32
    lkey, _lok, rkey, *_ = _k6_inputs("empty_partitions")
    assert set(_pid8(lkey)) | set(_pid8(rkey)) == {0, 3, 4}


@pytest.mark.parametrize("side", ("left", "right"))
@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_partition_sort_plain_is_the_block_sort(case, side):
    """The build sort's plain version, given the radix-scattered blocks
    and each partition's occupied count, equals the stable sort of the
    whole block with its row ids gathered: torch.sort + gather here, and
    the JAX version's lax.sort([keys, gidx], num_keys=1)."""
    lkey, lok, rkey, rok, _K, slack = _k6_inputs(case)
    key, ok = (lkey, lok) if side == "left" else (rkey, rok)
    nparts = KX.NPART
    log2r = nparts.bit_length() - 1
    cap = KX._part_caps(len(lkey), len(rkey), slack, nparts)[
        0 if side == "left" else 1]
    keys, gidx, occ, _over = KX._radix_scatter_plain(_t(key), _t(ok),
                                                     nparts, cap, log2r)
    counts = occ.sum(1).to(torch.int32)
    assert bool((occ == (torch.arange(cap)[None, :]
                         < counts[:, None])).all())
    got_k, got_g = KX.partition_sort(keys, gidx, counts)
    exp_k, order = torch.sort(keys, dim=1, stable=True)
    _assert_same(got_k, exp_k.numpy())
    _assert_same(got_g, gidx.gather(1, order).numpy())
    rk, rg, _rok, _rover = REF._radix_scatter(jnp.asarray(key),
                                               jnp.asarray(ok), nparts, cap,
                                               log2r)
    jk, jg = jax.lax.sort([rk, rg], num_keys=1, is_stable=True)
    _assert_same(got_k, jk)
    _assert_same(got_g, jg)


def test_partition_sort_plain_leaves_its_inputs():
    keys = torch.tensor([[5, 3, 9, 7], [2, 2, 1, 0]], dtype=torch.int32)
    gidx = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    counts = torch.tensor([3, 2], dtype=torch.int32)
    k0, g0 = keys.clone(), gidx.clone()
    ks, gs = KX.partition_sort(keys, gidx, counts)
    assert torch.equal(keys, k0) and torch.equal(gidx, g0)
    big = torch.iinfo(torch.int32).max
    assert ks.tolist() == [[3, 5, 9, big], [2, 2, big, big]]
    assert gs.tolist() == [[1, 0, 2, 0], [4, 5, 0, 0]]


def test_lookback_state_epochs_and_growth(monkeypatch):
    """The look-back state: the epochs live in the counter word on the
    card (epoch 1 above a tile counter of 0 when the buffer is made), and
    the host only counts the epochs its calls draw. A larger need gives a
    new zeroed buffer and a counter word at epoch 1, and keeps the old
    ones alive, since a captured graph may hold them. A count that would
    pass the host's half of the range zeroes every buffer of the entry and
    sets every counter word back to epoch 1, in place, so that a graph
    sees it; the other half is left to the epochs that graph replays
    draw."""
    monkeypatch.setattr(KX, "_LOOKBACK", {})
    dev = torch.device("cpu")
    key = (dev, 0, "count")
    buf, ctr = KX._lookback(dev, 0, "count", 100, 4)
    assert buf.numel() >= 100 and not bool(buf.any())
    assert ctr.shape == (1,) and int(ctr) == KX._EPOCH_FIRST == 1 << 32
    assert KX._LOOKBACK[key][2] == 4
    buf2, ctr2 = KX._lookback(dev, 0, "count", 100)
    assert buf2 is buf and ctr2 is ctr and KX._LOOKBACK[key][2] == 5
    # the kernels move the counter word on; the host never writes it
    ctr.fill_(7 << 32)
    buf.fill_(7)
    big, ctr3 = KX._lookback(dev, 0, "count", buf.numel() + 1)
    assert big.numel() >= 2 * buf.numel() and not bool(big.any())
    assert int(ctr3) == KX._EPOCH_FIRST
    _b, _c, used, retired = KX._LOOKBACK[key]
    assert used == 6 and len(retired) == 1
    assert retired[0][0] is buf and retired[0][1] is ctr
    assert int(ctr) == 7 << 32 and bool(buf.all())
    KX._LOOKBACK[key] = (big, ctr3, KX._EPOCH_HOST - 2, retired)
    big.fill_(7)
    ctr3.fill_(9 << 32)
    again, ctr4 = KX._lookback(dev, 0, "count", 10, 4)
    assert again is big and ctr4 is ctr3
    assert not bool(big.any()) and not bool(buf.any())
    assert int(ctr3) == int(ctr) == KX._EPOCH_FIRST
    assert KX._LOOKBACK[key][2] == 4
    KX._LOOKBACK[key] = (big, ctr3, KX._EPOCH_HOST - 1, retired)
    big.fill_(7)
    assert KX._lookback(dev, 0, "count", 10)[0] is big and bool(big.all())
    assert KX._lookback(dev, 0, "count", 10)[0] is big
    assert not bool(big.any()) and KX._LOOKBACK[key][2] == 1
    assert KX._EPOCH_HOST * 2 == KX._EPOCH_END == 1 << 29


def test_lookback_state_is_never_made_in_a_capture(monkeypatch):
    """A capture may not make, grow or zero a buffer (that would put a
    memset into the graph): ``_lookback`` raises there, and serves a
    buffer made before."""
    monkeypatch.setattr(KX, "_LOOKBACK", {})
    dev = torch.device("cpu")
    buf, ctr = KX._lookback(dev, 0, "scan", 64)
    monkeypatch.setattr(KX, "_capturing", lambda d: True)
    assert KX._lookback(dev, 0, "scan", 64)[0] is buf
    with pytest.raises(RuntimeError, match="capture"):
        KX._lookback(dev, 0, "scan", buf.numel() + 1)
    with pytest.raises(RuntimeError, match="capture"):
        KX._lookback(dev, 1, "scan", 64)
    key = (dev, 0, "scan")
    KX._LOOKBACK[key] = (buf, ctr, KX._EPOCH_HOST, ())
    with pytest.raises(RuntimeError, match="capture"):
        KX._lookback(dev, 0, "scan", 64)


def test_lookback_layouts_and_streams_never_share_words(monkeypatch):
    """The scan's tile state and the count words of the partition and
    the sort are laid out differently, so they never share a buffer, a
    counter word or an epoch count; nor do two streams of one device. A
    word is then only read in the layout, and by the stream, that wrote
    it."""
    monkeypatch.setattr(KX, "_LOOKBACK", {})
    dev = torch.device("cpu")
    got = {}
    for stream in (0, 1):
        for layout in ("scan", "count"):
            got[stream, layout] = KX._lookback(dev, stream, layout, 64, 3)
    bufs = [b for b, _c in got.values()]
    ctrs = [c for _b, c in got.values()]
    assert len({b.data_ptr() for b in bufs}) == 4
    assert len({c.data_ptr() for c in ctrs}) == 4
    assert all(int(c) == KX._EPOCH_FIRST for c in ctrs)
    # a launch of one layout leaves the other's count where it was
    KX._lookback(dev, 0, "scan", 64)
    KX._lookback(dev, 0, "scan", 64)
    used = {k: v[2] for k, v in KX._LOOKBACK.items()}
    assert used == {(dev, 0, "scan"): 5, (dev, 0, "count"): 3,
                    (dev, 1, "scan"): 3, (dev, 1, "count"): 3}
    with pytest.raises(ValueError, match="layout"):
        KX._lookback(dev, 0, "words", 64)


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
    KX.partition_sort(v.reshape(2, 2), v.reshape(2, 2).to(torch.int32),
                      torch.tensor([2, 1], dtype=torch.int32))
    assert all(c == 0 for c in KX.launch_counts().values())
    for name in ("seg_scan", "part_reduce_broadcast", "last_of_group",
                 "partitioned_mn_join", "partition_sort"):
        assert name in KX.LAUNCHES


_META_CALLS = {
    "partitioned_mn_join": lambda k, ok: KX.partitioned_mn_join(
        k, ok, k, ok, 8, 2.0),
    "partition_sort": lambda k, ok: KX.partition_sort(
        k.reshape(2, 2), k.reshape(2, 2), k[:2]),
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
