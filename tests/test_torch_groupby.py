"""The port's group-by (L2) on the CPU: the packed group key, its radix
sort and ``group_bounds``, segment sums through K5, and the windows'
running max.

``DeviceExecutor._group_ids`` packs presence, each key's validity and
its value into one integer where the keys' bounds allow
(``device_exec._pack_layout``), with the counts of its 8-bit digits, and
sorts it with ``partition_sort`` given those counts; ``group_bounds``
reads the group ids off the sorted key. Every case here
holds that route to the successive stable sorts it replaces
(``_lexsort``) exactly, perm included, and both to the reference
``nds_tpu`` ``_group_ids`` on jax CPU (x64) for the same arrays, made
from numpy with a fixed seed. On torch CPU the wrappers run their plain
versions, so this checks the pack, the plain versions and the executor's
use of them; the CUDA kernels are held to the plain versions on the card
by ``chip_smoke.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nds_tpu.datagen import tpch
from nds_tpu.engine import device_exec as RDX
from nds_tpu.io.host_table import from_arrays
from nds_tpu.nds_h.schema import get_schemas
from nds_tpu_torch.engine import device_exec as DX
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_reference
from nds_tpu_torch.nds_h import streams


def _rng(*parts):
    return np.random.default_rng(zlib.crc32("/".join(map(str,
                                                         parts)).encode()))


def _trace():
    """A trace with only what ``_group_ids`` reads (its device)."""
    tr = DX._Trace.__new__(DX._Trace)
    tr.dev = torch.device("cpu")
    return tr


# ------------------------------------------------------------------ cases

def _key(rng, n, kind, nulls=0.0):
    """(values, valid or None, sdict, lo, hi) of one group key column."""
    valid = rng.random(n) >= nulls if nulls else None
    if kind == "bool":
        return rng.random(n) < 0.5, valid, None, None, None
    if kind == "dict":
        sdict = np.array([f"s{i}" for i in range(7)], dtype=object)
        codes = rng.integers(0, 7, n).astype(np.int32)
        return codes, valid, sdict, None, None
    if kind == "float":
        return rng.integers(0, 5, n) / 4.0, valid, None, None, None
    lo, hi, dtype = kind
    vals = rng.integers(lo, hi + 1, n).astype(dtype)
    return vals, valid, None, lo, hi


# (name, rows, share present, [key kinds], null share per key, route)
CASES = {
    "null_keys": (300, 0.8, [(3, 50, np.int32), (-5, 5, np.int32)],
                  [0.2, 0.0], "packed"),
    "fill_outside_bounds": (300, 0.7, [(10, 20, np.int32),
                                       (-40, -30, np.int64)],
                            [0.3, 0.3], "packed"),
    "absent_mixed_validity": (400, 0.3, [(0, 6, np.int32)], [0.5],
                              "packed"),
    "dict_codes": (300, 0.9, ["dict", (1, 3, np.int32)], [0.1, 0.0],
                   "packed"),
    "bool_keys": (200, 0.9, ["bool", (0, 2, np.int32)], [0.2, 0.1],
                  "packed"),
    "two_keys": (500, 0.95, [(0, 30, np.int32), (100, 900, np.int64)],
                 [0.0, 0.0], "packed"),
    "three_keys": (500, 0.9, [(0, 3, np.int32), (-2, 2, np.int32),
                              (0, 9, np.int32)], [0.1, 0.0, 0.05],
                   "packed"),
    "int32_layout_full": (300, 0.9, [(0, (1 << 29) - 1, np.int32)],
                          [0.0], "packed"),
    "int32_layout_32_bits": (400, 0.7, [(-(1 << 20), (1 << 20) - 1,
                                         np.int32), (0, 511, np.int32)],
                             [0.2, 0.0], "packed"),
    "int64_layout": (300, 0.9, [(-(1 << 40), 1 << 20, np.int64),
                                (0, 1000, np.int32)], [0.1, 0.0],
                     "packed"),
    "int64_narrow_span": (300, 0.9, [(3_000_000_000, 3_000_001_000,
                                      np.int64)], [0.1], "packed"),
    "over_63_bits": (300, 0.9, [(-(1 << 40), 1 << 40, np.int64),
                                (0, (1 << 30) - 1, np.int64)],
                     [0.0, 0.0], "lexsort"),
    "float_key": (200, 0.9, ["float", (0, 3, np.int32)], [0.1, 0.0],
                  "lexsort"),
    "no_present_row": (100, 0.0, [(0, 5, np.int32), "bool"], [0.3, 0.3],
                       "packed"),
    "one_row": (1, 1.0, [(0, 5, np.int32)], [0.0], "packed"),
    # a plan's static capacity: few rows present, the rest padding
    "capacity_padded": (20_000, 0.01, [(0, 300, np.int32),
                                       (-60, 60, np.int64)], [0.0, 0.2],
                        "packed"),
    "all_present": (3_000, 1.0, [(0, 40, np.int32), "bool"], [0.1, 0.0],
                    "packed"),
    # an int share: exactly that many rows present
    "single_present_row": (5_000, 1, [(0, 9, np.int32), (-3, 3, np.int32)],
                           [0.0, 0.5], "packed"),
}


def _case(name):
    n, share, kinds, nulls, route = CASES[name]
    rng = _rng("group", name)
    if isinstance(share, int):
        row = np.zeros(n, bool)
        row[rng.choice(n, share, replace=False)] = True
    else:
        row = rng.random(n) < share
    keys = [_key(rng, n, k, z) for k, z in zip(kinds, nulls)]
    # rows outside their key's bounds where not present or NULL: the fill
    # must hide them
    for vals, valid, _sd, lo, hi in keys:
        if lo is not None and vals.dtype != bool:
            bad = ~row if valid is None else (~row | ~valid)
            vals[bad & (rng.random(n) < 0.5)] = hi + 7
    return row, keys, route


def _port_inputs(row, keys):
    ctx = DX.DCtx(len(row), torch.as_tensor(row))
    kvs = [DX.DVal(torch.as_tensor(v),
                   None if ok is None else torch.as_tensor(ok), sd, lo, hi)
           for v, ok, sd, lo, hi in keys]
    return ctx, kvs


def _capacity(n, keys):
    return DX._Trace._group_capacity(n, _port_inputs(np.ones(n, bool),
                                                     keys)[1])


def _lexsort_perm(row, keys, n, device):
    """``_sort_perm``'s plain cross-check: the successive stable sorts of
    the operands."""
    return DX._lexsort([DX._sort_operand(row, k) for k in keys], n, device)


def _group_ids(row, keys, G, route):
    ctx, kvs = _port_inputs(row, keys)
    tr = _trace()
    if route == "lexsort":
        orig = DX._pack_layout, DX._sort_perm
        DX._pack_layout = lambda keyvals, n: None
        DX._sort_perm = _lexsort_perm
        try:
            return tr._group_ids(ctx, kvs, G)
        finally:
            DX._pack_layout, DX._sort_perm = orig
    return tr._group_ids(ctx, kvs, G)


def _same(a, b):
    a = torch.as_tensor(np.array(a))
    b = torch.as_tensor(np.array(b))
    assert a.shape == b.shape, (a.shape, b.shape)
    assert torch.equal(a.to(torch.int64), b.to(torch.int64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_route_equals_the_successive_sorts(name, monkeypatch):
    """(a) perm, gid, presence, group count and group starts of the
    packed route equal ``_lexsort``'s route exactly, and the route taken
    is the one the bounds decide."""
    row, keys, route = _case(name)
    n = len(row)
    G = _capacity(n, keys)
    calls = []
    real = KX.group_bounds
    monkeypatch.setattr(KX, "group_bounds",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _group_ids(row, keys, G, "packed")
    assert bool(calls) == (route == "packed"), name
    exp = _group_ids(row, keys, G, "lexsort")
    for a, b in zip(got, exp):
        _same(a, b)
    perm, gid, present_s, ngroups, starts2 = got
    assert gid.dtype == torch.int32 and present_s.dtype == torch.bool
    assert starts2.dtype == torch.int64 and starts2.shape == (G,)
    if route == "packed":
        assert perm.dtype == torch.int32
    if name == "no_present_row":
        assert int(ngroups) == 0 and int(starts2[0]) == 0
        assert bool((gid == 0).all()) and bool((starts2[1:] == n).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_ids_match_the_reference(name):
    """(b) the port's group ids against ``nds_tpu``'s ``_group_ids`` on
    jax CPU for the same arrays: perm, gid (clipped to the group capacity,
    as the callers clip it), presence, the group count, the first-row
    flags and the group starts."""
    row, keys, _route = _case(name)
    n = len(row)
    G = _capacity(n, keys)
    perm, gid, present_s, ngroups, starts2 = _group_ids(row, keys, G,
                                                        "packed")
    rctx = RDX.DCtx(n, jnp.asarray(row))
    rkv = [RDX.DVal(jnp.asarray(v), None if ok is None else jnp.asarray(ok),
                    sd, lo, hi) for v, ok, sd, lo, hi in keys]
    rperm, rgid, rfirst, rpresent, rng_ = RDX._Trace._group_ids(None, rctx,
                                                                 rkv)
    rgid = jnp.minimum(rgid, G - 1)
    _same(perm, rperm)
    _same(gid, rgid)
    _same(present_s, rpresent)
    assert int(ngroups) == int(rng_)
    _same(starts2, RDX._ss(rgid, jnp.arange(G, dtype=rgid.dtype)))
    # the first-row flags: a present row whose sorted key differs from the
    # row before's (row 0 always)
    layout = DX._pack_layout(_port_inputs(row, keys)[1], n)
    if layout is not None:
        ctx, kvs = _port_inputs(row, keys)
        ks, _ = torch.sort(DX._pack_group_key(ctx.row, kvs, *layout)[0],
                           stable=True)
        _same(present_s & torch.cat([torch.ones(1, dtype=torch.bool),
                                     ks[1:] != ks[:-1]]), rfirst)


def test_pack_layout_is_a_host_decision_from_bounds():
    """The layout: presence on top, then per key its validity bit and the
    span of its filled values, which takes in the fill 0; int32 up to 32
    bits (32 biased by -2^31), int64 up to 63, and no layout past that,
    for floats, or for a key without bounds."""
    def kv(dtype, lo=None, hi=None, valid=False, sdict=None):
        return DX.DVal(torch.zeros(4, dtype=dtype),
                       torch.ones(4, dtype=torch.bool) if valid else None,
                       sdict, lo, hi)
    assert DX._pack_layout([kv(torch.int32, 10, 20)], 4) == (
        [(False, 0, 5)], 6)
    assert DX._pack_layout([kv(torch.int32, -3, -1, True)], 4) == (
        [(True, -3, 2)], 4)
    assert DX._pack_layout([kv(torch.bool, valid=True)], 4) == (
        [(True, 0, 1)], 3)
    sd = np.array(["a", "b", "c"], dtype=object)
    assert DX._pack_layout([kv(torch.int32, sdict=sd)], 4) == (
        [(False, 0, 2)], 3)
    assert DX._pack_layout([kv(torch.int32, 5, 5)], 4) == (
        [(False, 0, 3)], 4)
    assert DX._pack_layout([kv(torch.int64, 0, (1 << 62) - 1)], 4) == (
        [(False, 0, 62)], 63)
    assert DX._pack_layout([kv(torch.int64, 0, 1 << 62)], 4) is None
    assert DX._pack_layout([kv(torch.int32)], 4) is None
    assert DX._pack_layout([kv(torch.float64, 0, 1)], 4) is None
    assert DX._pack_layout([kv(torch.int32, 0, 1)], 2**31) is None
    key, _counts = DX._pack_group_key(
        torch.tensor([True, False, True, True]),
        [DX.DVal(torch.tensor([12, 11, 20, 99]),
                 torch.tensor([True, True, True, False]), None, 10, 20)],
        [(True, 0, 5)], 7)
    assert key.dtype == torch.int32
    assert key.tolist() == [12, (1 << 6) | 0, 20, 1 << 5]
    top = (1 << 31) - 1
    assert DX._pack_layout([kv(torch.int64, 0, top)], 4) == (
        [(False, 0, 31)], 32)
    key, _counts = DX._pack_group_key(
        torch.tensor([True, False, True]),
        [DX.DVal(torch.tensor([5, 0, top]), None, None, 0, top)],
        [(False, 0, 31)], 32)
    assert key.dtype == torch.int32
    assert key.tolist() == [5 - (1 << 31), 0, -1]


# ------------------------------------------------------------ segment sums

def _groups(rng, n, G, ngroups):
    """Sorted gids of ``ngroups`` groups over n rows, the rows past the
    last present row in the last group, and the starts of G groups."""
    cuts = np.sort(rng.choice(np.arange(1, n), ngroups - 1, replace=False))
    gid = np.zeros(n, np.int32)
    gid[cuts] = 1
    gid = np.cumsum(gid).astype(np.int32)
    starts2 = np.searchsorted(gid, np.arange(G, dtype=np.int32))
    return gid, starts2.astype(np.int64)


SUM_CASES = {"int32": np.int32, "int64": np.int64, "float64": np.float64}


@pytest.mark.parametrize("G,ngroups", [(1, 1), (40, 40), (64, 17),
                                       (300, 3)])
@pytest.mark.parametrize("dtype", sorted(SUM_CASES))
def test_seg_sum_matches_the_reference(dtype, G, ngroups):
    """(c) K5's sum (its plain version, which the executor's ``_seg_sum``
    takes on the CPU) against the reference ``_seg_sum``, empty trailing
    groups included: integers exact, floats within 1e-9 relative. The
    kernel's own formulation, the segmented scan read at each group's end
    and 0 for a group with no rows, gives the same sums."""
    rng = _rng("segsum", dtype, G, ngroups)
    n = 500
    dt = SUM_CASES[dtype]
    gid, starts2 = _groups(rng, n, G, ngroups)
    if dt == np.float64:
        data = rng.normal(scale=1e3, size=n)
    else:
        data = rng.integers(-1000, 1000, n).astype(dt)
    exp = np.asarray(RDX._Trace._seg_sum(jnp.asarray(data),
                                         jnp.asarray(starts2), G))
    got = KX.seg_reduce_at_ends("sum", torch.as_tensor(data),
                                torch.as_tensor(gid),
                                torch.as_tensor(starts2))
    assert got.dtype == torch.as_tensor(data).dtype and got.shape == (G,)
    assert not bool(got[ngroups:].any())
    first = np.concatenate([[True], gid[1:] != gid[:-1]])
    run = KX.seg_scan_plain("sum", torch.as_tensor(data),
                            torch.as_tensor(first))
    nxt = np.append(starts2[1:], n)
    end = np.clip(nxt - 1, 0, n - 1)
    scan_at_ends = np.where(starts2 > end, 0, run.numpy()[end])
    if dt == np.float64:
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(scan_at_ends, exp, rtol=1e-9, atol=1e-9)
    else:
        _same(got, exp)
        _same(scan_at_ends, exp)


def test_seg_sum_of_no_group_is_every_row():
    """With no present row gid is 0 everywhere and starts2 = [0, n, ...]:
    group 0 holds every row (each carries 0 in the executor), the rest
    are empty."""
    n, G = 50, 4
    data = torch.arange(n, dtype=torch.int64)
    gid = torch.zeros(n, dtype=torch.int32)
    starts2 = torch.tensor([0, n, n, n])
    got = KX.seg_reduce_at_ends("sum", data, gid, starts2)
    exp = np.asarray(RDX._Trace._seg_sum(jnp.asarray(data.numpy()),
                                         jnp.asarray(starts2.numpy()), G))
    _same(got, exp)
    assert got.tolist() == [n * (n - 1) // 2, 0, 0, 0]


# -------------------------------------------------------------- running max

@pytest.mark.parametrize("pattern", ("starts", "ranks", "negative"))
@pytest.mark.parametrize("dtype", (np.int32, np.int64))
def test_running_max_matches_lax_cummax(dtype, pattern):
    """(d) the windows' running max (its plain version) against
    ``lax.cummax``: exact."""
    rng = _rng("cummax", dtype, pattern)
    n = 3000
    iota = np.arange(n, dtype=dtype)
    if pattern == "starts":
        vals = np.where(rng.random(n) < 0.01, iota, 0).astype(dtype)
    elif pattern == "ranks":
        vals = np.cumsum(rng.random(n) < 0.3).astype(dtype)
        vals = np.where(rng.random(n) < 0.05, vals, 0).astype(dtype)
    else:
        vals = rng.integers(-10**6, 10**6, n).astype(dtype)
    exp = np.asarray(lax.cummax(jnp.asarray(vals)))
    got = KX.running_max(torch.as_tensor(vals))
    assert got.dtype == torch.as_tensor(vals).dtype
    _same(got, exp)
    _same(KX.running_max_plain(torch.as_tensor(vals)), exp)


# ----------------------------------------------------------- the wrappers

def test_group_wrappers_count_no_launch_on_cpu():
    """The plain versions run for CPU tensors and count nothing; on
    another device type the wrappers refuse."""
    KX.reset_launches()
    keys = torch.tensor([0, 0, 3, 5, 5, 1 << 4], dtype=torch.int32)
    present, gid, ng, starts2 = KX.group_bounds(keys, 4, 4)
    assert present.tolist() == [True] * 5 + [False]
    assert gid.tolist() == [0, 0, 1, 2, 2, 2]
    assert int(ng) == 3 and starts2.tolist() == [0, 2, 3, 6]
    # gid clipped to G - 1 = 1: groups 1 and 2 share its start
    _p, gid2, _n, starts2b = KX.group_bounds(keys, 4, 2)
    assert gid2.tolist() == [0, 0, 1, 1, 1, 1] and starts2b.tolist() == [0, 2]
    # a 32-bit key, biased by -2^31: the present rows are the negative ones
    key32 = torch.tensor([-2**31, -2**31, -5, 0, 3], dtype=torch.int32)
    present, gid3, ng, starts3 = KX.group_bounds(key32, 31, 3)
    assert present.tolist() == [True] * 3 + [False] * 2
    assert gid3.tolist() == [0, 0, 1, 1, 1]
    assert int(ng) == 2 and starts3.tolist() == [0, 2, 5]
    assert KX.running_max(torch.tensor([3, 1, 4, 1, 5])).tolist() == [
        3, 3, 4, 4, 5]
    KX.seg_reduce_at_ends("sum", torch.ones(6, dtype=torch.int32), gid,
                          starts2)
    assert all(c == 0 for c in KX.launch_counts().values())
    row = torch.tensor([True, True, False, True])
    key, counts = KX.pack_group_key(row, [torch.tensor([3, -1, 7, 0])],
                                    [torch.tensor([True, True, True, False])],
                                    [(True, -1, 3)], 5)
    assert key.dtype == torch.int32
    assert key.tolist() == [4, 0, (1 << 4) | 1, (1 << 3) | 1]
    # the counts of the order-preserving digits (sign bit flipped)
    assert counts.dtype == torch.int32 and counts.shape == (4 * 256,)
    assert counts[:256].nonzero().flatten().tolist() == [0, 4, 9, 17]
    assert counts[256:].tolist() == [4] + [0] * 255 + [4] + [0] * 255 + (
        [0] * 128 + [4] + [0] * 127)
    assert all(c == 0 for c in KX.launch_counts().values())
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KX.group_bounds(meta, 4, 2)
    with pytest.raises(ValueError, match="no kernel"):
        KX.pack_group_key(meta.bool(), [meta], [None], [(False, 0, 3)], 4)
    with pytest.raises(ValueError, match="no kernel"):
        KX.running_max(meta)


# ------------------------------------------------- the pack's digit counts

# (fields, bits) of a packed key: up to 31 bits in int32, exactly 32 (int32,
# biased by -2^31), and int64
PACK_LAYOUTS = {
    "int32_27_bits": ([(True, -3, 5), (False, 0, 20)], 27),
    "int32_32_bits_biased": ([(False, -1000, 11), (False, 0, 20)], 32),
    "int64_53_bits": ([(True, -(1 << 40), 41), (False, 0, 10)], 53),
}


def _packed(layout, n=4_000):
    """A packed key of ``layout`` over ``n`` rows, 60% present, values
    in each field's span, validity where the field has a bit."""
    fields, bits = PACK_LAYOUTS[layout]
    rng = _rng("pack", layout)
    row = torch.as_tensor(rng.random(n) < 0.6)
    arrs, valids = [], []
    for has_valid, lo, width in fields:
        hi = lo + (1 << width) - 1
        arrs.append(torch.as_tensor(rng.integers(lo, hi + 1, n)))
        valids.append(torch.as_tensor(rng.random(n) < 0.8) if has_valid
                      else None)
    return KX.pack_group_key(row, arrs, valids, fields, bits)


def _digit_histogram(key):
    """The counts of each 8-bit digit of the key's order-preserving
    unsigned bits, in numpy."""
    k = key.numpy()
    u = (k.view(np.uint32) ^ np.uint32(1 << 31) if k.dtype == np.int32
         else k.view(np.uint64) ^ np.uint64(1 << 63)).astype(np.uint64)
    return np.concatenate([
        np.bincount(((u >> np.uint64(8 * d)) & np.uint64(0xFF)).astype(
            np.int64), minlength=256) for d in range(k.itemsize)])


@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS))
def test_pack_counts_are_the_histogram_of_the_key_digits(layout):
    """The pack's counts equal a histogram of its key's order-preserving
    8-bit digits: 4 passes for an int32 key (a 32-bit one biased by
    -2^31), 8 for int64, each pass counting every row."""
    key, counts = _packed(layout)
    passes = 8 if PACK_LAYOUTS[layout][1] > 32 else 4
    assert key.dtype == (torch.int64 if passes == 8 else torch.int32)
    assert counts.dtype == torch.int32 and counts.shape == (passes * 256,)
    np.testing.assert_array_equal(counts.numpy(), _digit_histogram(key))
    assert (counts.view(passes, 256).sum(1) == key.shape[0]).all()


@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS))
def test_partition_sort_given_the_pack_counts_sorts_alike(layout):
    """``partition_sort`` given the pack's counts (which digits move) gives
    the same keys and rows as without them."""
    key, counts = _packed(layout)
    n = key.shape[0]
    iota = torch.arange(n, dtype=torch.int32).view(1, n)
    cnt = torch.full((1,), n, dtype=torch.int32)
    got = KX.partition_sort_plain(key.view(1, n), iota, cnt, counts)
    exp = KX.partition_sort_plain(key.view(1, n), iota, cnt)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    _s, order = torch.sort(key, stable=True)
    assert torch.equal(got[1].view(n).to(torch.int64), order)


def test_packed_route_hands_the_pack_counts_to_the_sort(monkeypatch):
    """The packed route passes the pack's counts to ``partition_sort``
    (so the sort takes no histogram pass of its own), one call a
    group-by."""
    row, keys, _route = _case("capacity_padded")
    n = len(row)
    seen = []
    real_pack, real_sort = KX.pack_group_key, KX.partition_sort

    def pack(*a, **k):
        out = real_pack(*a, **k)
        seen.append(("pack", out[1]))
        return out

    def sort(keys_, gidx, counts, hist=None):
        seen.append(("sort", hist))
        return real_sort(keys_, gidx, counts, hist)

    monkeypatch.setattr(KX, "pack_group_key", pack)
    monkeypatch.setattr(KX, "partition_sort", sort)
    _group_ids(row, keys, _capacity(n, keys), "packed")
    assert [s for s, _h in seen] == ["pack", "sort"]
    assert seen[1][1] is seen[0][1]


# ------------------------------------------------------ the executor's path

QUERIES = (1, 3, 13, 18)


@pytest.fixture(scope="module")
def nds_h_session():
    schemas = get_schemas()
    port = Session.for_nds_h(make_device_factory(device="cpu"))
    for t in schemas:
        port.register_table(from_reference(
            from_arrays(t, schemas[t], tpch.gen_table(t, 0.002))))
    return port


def _run(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    return result.to_pandas()


@pytest.mark.parametrize("qn", QUERIES)
def test_nds_h_grouped_aggregates_take_the_packed_route(qn, nds_h_session,
                                                        monkeypatch):
    """Every grouped aggregate of these NDS-H queries packs its keys and
    sorts them with ``partition_sort`` (no multi-key sort from
    ``_group_ids``); the rows equal those of the route that sorts the
    operands by successive stable sorts (``_lexsort``) exactly."""
    seen = {"bounds": 0, "sorts": 0}
    real_bounds, real_sort = KX.group_bounds, DX._sort_perm

    def bounds(*a, **k):
        seen["bounds"] += 1
        return real_bounds(*a, **k)

    def sort_perm(*a, **k):
        seen["sorts"] += 1
        return real_sort(*a, **k)

    monkeypatch.setattr(KX, "group_bounds", bounds)
    monkeypatch.setattr(DX, "_sort_perm", sort_perm)
    stmts = streams.statements(qn)
    got = _run(nds_h_session, stmts)
    packed, other_sorts = seen["bounds"], seen["sorts"]
    assert packed >= 1, qn
    monkeypatch.setattr(DX, "_pack_layout", lambda keyvals, n: None)

    def lexsort_perm(*a, **k):
        seen["sorts"] += 1
        return _lexsort_perm(*a, **k)

    monkeypatch.setattr(DX, "_sort_perm", lexsort_perm)
    seen["sorts"] = 0
    exp = _run(nds_h_session, stmts)
    # the successive sorts' route: one multi-key sort per group-id sort
    # more
    assert seen["bounds"] == packed
    assert seen["sorts"] == other_sorts + packed, qn
    assert list(got.columns) == list(exp.columns)
    assert got.equals(exp), qn
