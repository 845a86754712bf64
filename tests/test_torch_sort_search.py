"""The port's sorts, searches and result compactor on the CPU.

Every multi-key sort of the executor (ORDER BY, the windows,
count-distinct, the ``<>`` residual and the group-bys whose keys do not
pack into one word) lays its operands out as order-preserving words on
the host (``device_exec._sort_layout``), packs each word
(``kernels.pack_sort_key``) and sorts the words stably from the least
significant up (``partition_sort``, the row ids as payload). The
sort-merge build is ``partition_sort`` of the sentinel keys, every
searchsorted and the probe are ``kernels.sorted_search``, and the result
compactor is ``kernels.compact_perm``.

Here, on torch CPU, the wrappers run their plain versions. Each case
holds them, with inputs made from numpy with a fixed seed, to the
reference ``nds_tpu`` on jax CPU (x64) exactly: the packed sort's
permutation to ``lax.sort(ops + [iota], num_keys=len(ops),
is_stable=True)`` and to the successive stable sorts (``_lexsort``) it
replaces, the searches to the reference's ``_ss`` and ``_probe``, the
compactor to its ``_compact``; and the executor's rows and ``kernels``
blocks to the reference ``DeviceExecutor``'s. The CUDA kernels are held
to the plain versions on the card by ``chip_smoke.py``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nds_tpu.datagen import tpch
from nds_tpu.engine import device_exec as RDX
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds_h.schema import get_schemas
from nds_tpu_torch.engine import device_exec as DX
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine.device_exec import make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_arrays, from_reference
from nds_tpu_torch.nds_h import streams

from tests.test_kernels import _build_sessions, _data
from tests.test_torch_nds_jax_engine import _assert_same_rows, _port_catalog

CPU = torch.device("cpu")


def _rng(*parts):
    return np.random.default_rng(zlib.crc32("/".join(map(str,
                                                         parts)).encode()))


# ------------------------------------------------------- the packed sort

def _ints(rng, n, dtype, lo, hi, extremes):
    vals = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
    if extremes:
        info = np.iinfo(dtype)
        at = rng.random(n)
        vals[at < 0.1] = info.min
        vals[(at >= 0.1) & (at < 0.2)] = info.max
        vals[(at >= 0.2) & (at < 0.25)] = 0
    return vals.astype(dtype)


def _floats(rng, n, dtype):
    vals = rng.integers(-3, 4, n).astype(dtype) / 2
    at = rng.random(n)
    vals[at < 0.1] = -0.0
    vals[(at >= 0.1) & (at < 0.2)] = 0.0
    vals[(at >= 0.2) & (at < 0.3)] = np.nan
    vals[(at >= 0.3) & (at < 0.33)] = -np.nan
    vals[(at >= 0.33) & (at < 0.36)] = np.inf
    vals[(at >= 0.36) & (at < 0.39)] = -np.inf
    return vals


def _operand(rng, n, row, spec):
    """(SortKey, the reference's operand as numpy) for one operand spec:
    ("presence",), ("rank", nulls_first), ("int", dtype, lo, hi, bounded,
    desc, nulls, use_row), ("bool", desc, nulls) or ("float", dtype,
    desc, nulls). An int key filled by the row mask holds values out of
    its bounds on absent rows (the fill hides them); one that is not
    holds its bounds on every slot, or takes none."""
    kind = spec[0]
    if kind == "presence":
        return (DX.SortKey(torch.as_tensor(row), invert=True),
                np.where(row, 0, 1).astype(np.int32))
    if kind == "rank":
        valid = rng.random(n) >= 0.3
        ref = (np.where(valid, 1, 0) if spec[1]
               else np.where(valid, 0, 1)).astype(np.int32)
        return DX.SortKey(torch.as_tensor(valid), invert=not spec[1]), ref
    if kind == "int":
        _k, dtype, lo, hi, bounded, desc, nulls, use_row = spec
        vals = _ints(rng, n, dtype, lo, hi, extremes=not bounded)
        if use_row and bounded:
            vals[~row & (rng.random(n) < 0.5)] = hi + 11
    elif kind == "bool":
        _k, desc, nulls = spec
        vals, use_row, bounded, lo, hi = rng.random(n) < 0.5, False, True, 0, 1
    else:
        _k, dtype, desc, nulls = spec
        vals, use_row, bounded = _floats(rng, n, dtype), False, False
    valid = rng.random(n) >= nulls if nulls else None
    key = DX.SortKey(torch.as_tensor(vals),
                     None if valid is None else torch.as_tensor(valid),
                     use_row=use_row, negate=desc,
                     lo=lo if bounded else None, hi=hi if bounded else None)
    ref = vals.astype(np.int32) if vals.dtype == bool else vals.copy()
    if desc:
        ref = -ref
    ok = np.ones(n, bool) if valid is None else valid.copy()
    if use_row:
        ok &= row
    ref = np.where(ok, ref, np.zeros((), ref.dtype)).astype(ref.dtype)
    return key, ref


I32, I64 = np.int32, np.int64
P = ("presence",)
SORT_CASES = {
    # name: (rows, share present, operand specs, words of at most 32 bits)
    "asc_bounded_int32": (300, 0.8, [P, ("int", I32, 0, 100, True, False,
                                         0.0, True)], 1),
    "desc_nulls_first": (300, 0.9, [P, ("rank", True),
                                    ("int", I32, -50, 50, True, True, 0.2,
                                     False)], 1),
    "desc_nulls_last_int64": (300, 0.9, [P, ("rank", False),
                                         ("int", I64, -(1 << 40), 1 << 40,
                                          True, True, 0.2, False)], 2),
    "unbounded_int32_extremes": (400, 0.9, [P, ("int", I32, -5, 5, False,
                                                False, 0.1, False),
                                            ("int", I32, -5, 5, False, True,
                                             0.0, False)], 3),
    "unbounded_int64_extremes": (400, 0.9, [P, ("int", I64, -5, 5, False,
                                                True, 0.1, False),
                                            ("int", I64, -5, 5, False,
                                             False, 0.0, False)], 5),
    "bool_keys": (200, 0.9, [P, ("bool", False, 0.0), ("rank", False),
                             ("bool", True, 0.3)], 1),
    "float64_zeros_nan": (400, 0.9, [P, ("float", np.float64, False, 0.1),
                                     ("float", np.float64, True, 0.1)], 5),
    "float32_zeros_nan": (400, 0.9, [P, ("float", np.float32, True, 0.1),
                                     ("int", I32, 0, 9, True, False, 0.0,
                                      True)], 2),
    "unbounded_next_to_bounded": (400, 0.8, [
        P, ("int", I32, 3, 9, True, False, 0.1, True),
        ("int", I64, -9, 9, False, True, 0.0, False),
        ("int", I32, -7, 7, True, True, 0.0, False)], 3),
    "seventeen_fields": (300, 0.9, [P] + [("bool", i % 2 == 0, 0.0)
                                          for i in range(16)], 2),
    "fill_hides_out_of_bounds": (300, 0.5, [P, ("int", I32, 10, 20, True,
                                                False, 0.3, True),
                                            ("int", I64, -40, -30, True,
                                             False, 0.3, True)], 1),
    "no_present_row": (100, 0.0, [P, ("rank", True),
                                  ("int", I32, -3, 3, False, True, 0.2,
                                   False)], 2),
    "one_row": (1, 1.0, [P, ("float", np.float64, True, 0.0)], 3),
    "zero_width_key": (100, 0.9, [P, ("int", I32, 0, 0, True, False, 0.0,
                                      True), ("int", I32, 0, 3, True, True,
                                              0.0, False)], 1),
}


def _sort_case(name):
    n, share, specs, words = SORT_CASES[name]
    rng = _rng("sort", name)
    row = rng.random(n) < share
    pairs = [_operand(rng, n, row, s) for s in specs]
    return row, [k for k, _r in pairs], [r for _k, r in pairs], words


@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_packed_sort_equals_lax_sort_and_lexsort(name):
    """``_sort_perm`` (``pack_sort_key_plain`` + ``partition_sort_plain``)
    gives the permutation of the reference's multi-operand stable
    ``lax.sort`` and of ``_lexsort`` exactly, in the number of words the
    layout decides."""
    row, keys, ref_ops, words = _sort_case(name)
    n = len(row)
    assert len(DX._sort_layout(keys, n)) == words, name
    got = DX._sort_perm(torch.as_tensor(row), keys, n, CPU)
    assert got.dtype == torch.int32 and got.shape == (n,)
    ops = [DX._sort_operand(torch.as_tensor(row), k) for k in keys]
    for op, ref in zip(ops, ref_ops):
        np.testing.assert_array_equal(op.numpy(), ref)
    lex = DX._lexsort(ops, n, CPU)
    sorted_ops = lax.sort([jnp.asarray(r) for r in ref_ops]
                          + [jnp.arange(n, dtype=jnp.int32)],
                          num_keys=len(ref_ops), is_stable=True)
    exp = np.asarray(sorted_ops[-1])
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(lex.numpy(), exp)


def test_pack_sort_key_words():
    """The word's bits: pieces from the top down, a 32-bit word biased by
    -2^31, floats in lax.sort's order (-0.0 = +0.0, every NaN one value
    above +inf) across the two words of a float64, a descending int64 at
    its minimum wrapping as the reference's negation does, the gather
    through a permutation, and the word's digit counts beside it."""
    row = torch.tensor([True, False, True, True])
    w, counts = KX.pack_sort_key(
        row, [row, torch.tensor([3, 9, -1, 0], dtype=torch.int32)],
        [None, torch.tensor([True, True, True, False])],
        [(KX.SORT_INVERT, KX.SORT_SPAN, 0, 1, 0),
         (KX.SORT_USE_ROW | KX.SORT_NEGATE, KX.SORT_SPAN, -3, 3, 0)], 4)
    assert w.dtype == torch.int32
    # -3 - (-3) = 0, absent and NULL rows filled with 0 -> 3, -(-1) -> 4
    assert w.tolist() == [0, 8 | 3, 4, 3]
    assert counts.dtype == torch.int32 and counts.shape == (4 * 256,)
    np.testing.assert_array_equal(
        counts.view(4, 256).numpy(),
        [np.bincount([0, 11, 4, 3], minlength=256), np.eye(256)[0] * 4,
         np.eye(256)[0] * 4, np.eye(256)[0x80] * 4])
    w, _c = KX.pack_sort_key(None, [torch.tensor([0, -1, 5],
                                                 dtype=torch.int32)],
                             [None], [(0, KX.SORT_INT, 0, 32, 0)], 32)
    assert w.tolist() == [0, -1, 5]
    x = torch.tensor([-0.0, 0.0, float("nan"), -float("nan"), float("inf"),
                      -1.5, 2.0], dtype=torch.float64)
    hi, _c = KX.pack_sort_key(None, [x], [None],
                              [(0, KX.SORT_FLOAT, 0, 32, 32)], 32)
    lo, _c = KX.pack_sort_key(None, [x], [None],
                              [(0, KX.SORT_FLOAT, 0, 32, 0)], 32)
    w = hi.long() * 2**32 + (lo.long() + 2**31)
    assert w[0] == w[1] and w[2] == w[3] and w[2] > w[4]
    assert w[5] < w[0] < w[6] < w[4]
    lo64 = torch.tensor([np.iinfo(np.int64).min, -1, 0], dtype=torch.int64)
    hi, _c = KX.pack_sort_key(None, [lo64], [None],
                              [(KX.SORT_NEGATE, KX.SORT_INT, 0, 32, 32)], 32)
    lo, _c = KX.pack_sort_key(None, [lo64], [None],
                              [(KX.SORT_NEGATE, KX.SORT_INT, 0, 32, 0)], 32)
    # -min wraps to min, the smallest, as in the reference
    assert (hi.long() * 2**32 + (lo.long() + 2**31)).tolist() == [
        np.iinfo(np.int64).min, 1, 0]
    perm = torch.tensor([2, 0, 1], dtype=torch.int32)
    vals = torch.tensor([7, 8, 9], dtype=torch.int32)
    assert KX.pack_sort_key(None, [vals], [None],
                            [(0, KX.SORT_SPAN, 0, 4, 0)], 4,
                            perm)[0].tolist() == [9, 7, 8]


# ---------------------------------------------------------- the layout

def _dv(dtype, lo=None, hi=None, valid=False, sdict=None):
    return DX.DVal(torch.zeros(4, dtype=dtype),
                   torch.ones(4, dtype=torch.bool) if valid else None,
                   sdict, lo, hi)


def _fields(keys):
    return [[f[1:] for f in fields] for fields, _b in
            DX._sort_layout(keys, 4)]


def _bits(keys):
    return [b for _f, b in DX._sort_layout(keys, 4)]


def test_sort_layout_is_a_host_decision_from_bounds():
    """A key filled on the absent rows (a group-by's, a window
    partition's) takes its span; an ORDER BY or window order key, whose
    absent rows keep their values, takes its full width whatever its
    bounds; floats their full width in float order; a descending key at
    its type's minimum its full width; words of at most 32 bits and
    ``SORT_MAX_FIELDS`` pieces, a wider field straddling two; no sort of
    2^31 - 1 rows or more."""
    row = torch.ones(4, dtype=torch.bool)
    span, full, flt = KX.SORT_SPAN, KX.SORT_INT, KX.SORT_FLOAT
    assert _fields(DX._group_sort_keys(row, [_dv(torch.int32, 10, 20)])) \
        == [[(span, 0, 1, 0), (span, 0, 5, 0)]]
    assert _fields(DX._group_sort_keys(row, [
        _dv(torch.int32, 5, 9, valid=True)])) == [
        [(span, 0, 1, 0), (span, 0, 1, 0), (span, 0, 4, 0)]]
    assert _fields(DX._order_keys(_dv(torch.int32, 10, 20), True, False)) \
        == [[(full, 0, 32, 0)]]
    assert _fields(DX._order_keys(_dv(torch.int64, 0, 5, valid=True), False,
                                  True)) == [[(span, 0, 1, 0)],
                                             [(full, 0, 32, 0)]]
    assert _fields(DX._order_keys(_dv(torch.int64, 0, 1 << 40, valid=True),
                                  False, True)) == [
        [(span, 0, 1, 0)], [(full, 0, 32, 32)], [(full, 0, 32, 0)]]
    assert _fields(DX._order_keys(_dv(torch.float64, 0, 1), True,
                                  False)) == [[(flt, 0, 32, 32)],
                                              [(flt, 0, 32, 0)]]
    assert _fields(DX._order_keys(_dv(torch.bool), False, False)) == [
        [(span, -1, 1, 0)]]
    i32 = np.iinfo(np.int32)
    assert _fields([DX.SortKey(torch.zeros(4, dtype=torch.int32),
                               negate=True, lo=int(i32.min), hi=0)]) == [
        [(full, 0, 32, 0)]]
    assert _fields([DX.SortKey(torch.zeros(4, dtype=torch.int32),
                               negate=True, lo=-5, hi=3)]) == [
        [(span, -3, 4, 0)]]
    assert _fields([DX.SortKey(torch.zeros(4, dtype=torch.int32),
                               lo=int(i32.min) + 1, hi=int(i32.max) - 1)]) \
        == [[(full, 0, 32, 0)]]
    assert _fields([DX.SortKey(torch.zeros(4, dtype=torch.int64), lo=0,
                               hi=0)]) == []
    bools = [DX.SortKey(row) for _ in range(KX.SORT_MAX_FIELDS + 1)]
    assert [len(f) for f in _fields(bools)] == [1, KX.SORT_MAX_FIELDS]
    wide = [DX.SortKey(torch.zeros(4, dtype=torch.int32), lo=0,
                       hi=(1 << 30) - 1)] * 3
    assert _bits(wide) == [30, 30, 30]
    with pytest.raises(DX.DeviceExecError):
        DX._sort_layout(bools, 2**31 - 1)


def test_order_keys_never_pack_absent_rows_into_their_bounds():
    """An ORDER BY key whose absent rows hold values outside its bounds:
    ``_run_sort``'s keys still sort as ``_lexsort`` does, and bounds taken
    on trust would not."""
    rng = _rng("absent", "order")
    n = 200
    row = rng.random(n) < 0.6
    vals = rng.integers(0, 11, n).astype(np.int32)
    vals[~row] = rng.choice([-1000, 1000, 77], (~row).sum())
    dv = DX.DVal(torch.as_tensor(vals), None, None, 0, 10)
    trow = torch.as_tensor(row)
    keys = [DX.SortKey(trow, invert=True)] + DX._order_keys(dv, False, False)
    ops = [DX._sort_operand(trow, k) for k in keys]
    exp = DX._lexsort(ops, n, CPU)
    assert torch.equal(DX._sort_perm(trow, keys, n, CPU).long(), exp)
    trusted = keys[:1] + [DX.SortKey(dv.arr, negate=True, lo=0, hi=10)]
    assert not torch.equal(DX._sort_perm(trow, trusted, n, CPU).long(), exp)


# -------------------------------------------------------------- searches

def _search_case(rng, n, m, dtype):
    info = np.iinfo(dtype)
    ks = np.sort(rng.integers(-50, 50, n)).astype(dtype)
    ks[n - n // 5:] = info.max          # the build's sentinel tail
    q = rng.integers(-60, 60, m).astype(dtype)
    q[rng.random(m) < 0.1] = info.max   # probes equal to the sentinel
    q[rng.random(m) < 0.05] = info.min
    return ks, q


SEARCH_SIZES = [(0, 40), (1, 40), (7, 100), (300, 500), (2100, 3000)]


@pytest.mark.parametrize("dtype", (np.int32, np.int64))
@pytest.mark.parametrize("n,m", SEARCH_SIZES)
def test_sorted_search_matches_reference_ss(n, m, dtype):
    """left, right and both against the reference's ``_ss`` (jnp's
    searchsorted), empty builds included."""
    rng = _rng("search", n, m, dtype)
    ks, q = _search_case(rng, n, m, dtype)
    tks, tq = torch.as_tensor(ks), torch.as_tensor(q)
    for side in ("left", "right"):
        got = KX.sorted_search(tks, tq, side)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(RDX._ss(jnp.asarray(ks), jnp.asarray(q),
                                            side=side)))
    lo, hi = DX._ss(tks, tq, "both")
    np.testing.assert_array_equal(lo.numpy(), KX.sorted_search(tks, tq).numpy())
    np.testing.assert_array_equal(hi.numpy(),
                                  KX.sorted_search(tks, tq, "right").numpy())


@pytest.mark.parametrize("dtype", (np.int32, np.int64))
@pytest.mark.parametrize("n,m", SEARCH_SIZES[1:])
def test_probe_matches_reference_probe(n, m, dtype):
    """The probe (build and probe of the sort-merge join) against the
    reference's ``_build_lookup`` and ``_probe``: the sorted keys, the
    build rows, each probe's row and hit; invalid build rows at the
    sentinel, which a probe key equal to it matches, as in the
    reference. And the set operations' probe, with no rows and no mask."""
    rng = _rng("probe", n, m, dtype)
    _ks, q = _search_case(rng, n, m, dtype)
    bkey = rng.integers(-50, 50, n).astype(dtype)
    bok = rng.random(n) < 0.8
    pok = rng.random(m) < 0.9
    rks, rorder = RDX._Trace._build_lookup(jnp.asarray(bkey),
                                           jnp.asarray(bok))
    ks, order = DX._Trace._build_lookup(torch.as_tensor(bkey),
                                        torch.as_tensor(bok))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(ks.numpy(), np.asarray(rks))
    np.testing.assert_array_equal(order.numpy(), np.asarray(rorder))
    ridx, rhit = RDX._Trace._probe(rks, rorder, jnp.asarray(q),
                                   jnp.asarray(pok))
    idx, hit = DX._Trace._probe(ks, order, torch.as_tensor(q),
                                torch.as_tensor(pok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(rhit))
    none, hit2 = KX.sorted_search(ks, torch.as_tensor(q), "probe")
    pos = np.clip(np.asarray(RDX._ss(rks, jnp.asarray(q))), 0, n - 1)
    assert none is None
    np.testing.assert_array_equal(hit2.numpy(), np.asarray(rks)[pos] == q)


# ------------------------------------------------------------- compactor

@pytest.mark.parametrize("pattern", ("random", "all_absent", "none_absent",
                                     "one_row", "runs"))
def test_compact_perm_matches_reference_compact(pattern):
    """``compact_perm`` against the reference's ``_compact`` (the stable
    sort of the 0/1 key): its permutation, read off a gathered iota
    column, and the present count."""
    rng = _rng("compact", pattern)
    n = 1 if pattern == "one_row" else 5000
    row = {"random": rng.random(n) < 0.3, "all_absent": np.zeros(n, bool),
           "none_absent": np.ones(n, bool), "one_row": np.ones(1, bool),
           "runs": (np.arange(n) // 700) % 2 == 0}[pattern]
    rctx = RDX.DCtx(n, jnp.asarray(row))
    rctx.cols[("t", "i")] = RDX.DVal(jnp.arange(n, dtype=jnp.int32))
    out = RDX._Trace._compact(None, rctx)
    exp = np.asarray(out.cols[("t", "i")].arr)
    perm, count = KX.compact_perm(torch.as_tensor(row))
    assert perm.dtype == torch.int32 and count.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), exp)
    assert int(count) == int(row.sum())
    np.testing.assert_array_equal(row[perm.numpy()], np.asarray(out.row))


# ----------------------------------------------------------- the wrappers

def test_sort_search_wrappers_count_no_launch_on_cpu():
    """The plain versions run for CPU tensors and count nothing; on
    another device type the wrappers refuse."""
    KX.reset_launches()
    row = torch.tensor([True, False, True])
    vals = torch.tensor([5, 1, 3], dtype=torch.int32)
    perm = DX._sort_perm(row, [DX.SortKey(row, invert=True),
                               DX.SortKey(vals, negate=True)], 3, CPU)
    assert perm.tolist() == [0, 2, 1]
    assert KX.sorted_search(vals.sort()[0], vals).tolist() == [2, 0, 1]
    assert KX.compact_perm(row)[0].tolist() == [0, 2, 1]
    ks, order = DX._Trace._build_lookup(vals, row)
    assert ks.tolist() == [3, 5, 2**31 - 1] and order.tolist() == [2, 0, 1]
    assert all(c == 0 for c in KX.launch_counts().values())
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KX.pack_sort_key(None, [meta], [None], [(0, KX.SORT_INT, 0, 32, 0)],
                         32)
    with pytest.raises(ValueError, match="no kernel"):
        KX.sorted_search(meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        KX.compact_perm(meta.bool())


# ------------------------------------------------------ the executor's path

FACT_FORMS = {
    "order_by_desc_nulls": (
        "select f_id, f_val, f_dim from fact order by f_val desc nulls "
        "first, f_dim nulls last, f_id desc"),
    "order_by_float": (
        "select f_id, f_qty / 7.0 r from fact order by r desc, f_id "
        "limit 50"),
    "window_ranks": (
        "select f_id, rank() over (partition by f_tiny order by f_val desc) "
        "rk, dense_rank() over (partition by f_dim order by f_qty) dr, "
        "row_number() over (partition by f_key order by f_val nulls first, "
        "f_id desc) rn from fact order by f_id"),
    "count_distinct": (
        "select count(distinct f_val) c, count(distinct f_key) k from fact"),
    "count_distinct_grouped": (
        "select f_tiny, count(distinct f_val) c, count(distinct f_dim) d "
        "from fact group by f_tiny order by f_tiny"),
    "limit_unordered": "select f_id, f_qty from fact where f_qty > 50 "
                       "limit 20",
}


@pytest.fixture(scope="module")
def fact_sessions():
    cpu, dev = _build_sessions()
    cat = _port_catalog()
    data = _data()
    port = Session(cat, make_device_factory(device="cpu"))
    for t in cat.schemas:
        port.register_table(from_arrays(t, cat.schemas[t], data[t]))
    return cpu, dev, port


def _kernels(session):
    ex = session._executor_factory(session.tables)
    return dict(ex.last_timings.get("__kernels") or {})


def _no_lexsort(*_a, **_k):
    raise AssertionError("the executor called _lexsort")


@pytest.mark.parametrize("form", sorted(FACT_FORMS))
def test_executor_sorts_match_the_jax_engine(form, fact_sessions,
                                             monkeypatch):
    """ORDER BY (descending, NULLS FIRST/LAST, a float key), the windows'
    sort, count-distinct (global and grouped) and the compactor before an
    unordered LIMIT: the rows and the ``kernels`` block equal the
    reference ``DeviceExecutor``'s, through the packed sort and the
    compactor, never ``_lexsort``. (The CPU oracle orders NULL sort keys
    otherwise in two of these forms; the device executors are the
    reference here.)"""
    _cpu, dev, port = fact_sessions
    sql = FACT_FORMS[form]
    calls = {"pack_sort_key": 0, "compact_perm": 0}
    for name in calls:
        real = getattr(KX, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(KX, name, counted)
    monkeypatch.setattr(DX, "_lexsort", _no_lexsort)
    got = port.sql(sql).to_pandas()
    got_k = _kernels(port)
    exp = dev.sql(sql).to_pandas()
    _assert_same_rows(got, exp, form)
    assert got_k == _kernels(dev)
    want = "compact_perm" if form == "limit_unordered" else "pack_sort_key"
    assert calls[want] > 0, calls


NDS_H_QUERIES = (13, 16, 21)


@pytest.fixture(scope="module")
def nds_h_sessions():
    schemas = get_schemas()
    ref = RefSession.for_nds_h(ref_factory())
    port = Session.for_nds_h(make_device_factory(device="cpu"))
    for t in schemas:
        table = ref_from_arrays(t, schemas[t], tpch.gen_table(t, 0.002))
        ref.register_table(table)
        port.register_table(from_reference(table))
    return ref, port


def _run(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    return result.to_pandas(), _kernels(session)


@pytest.mark.parametrize("qn", NDS_H_QUERIES)
def test_nds_h_sorts_and_probes_match_the_jax_engine(qn, nds_h_sessions,
                                                     monkeypatch):
    """q13 (the left expanding join's build and probe), q16 (count
    distinct per group, ORDER BY a descending count) and q21 (the ``<>``
    semi-join, ORDER BY a descending count): rows and ``kernels`` blocks
    equal the reference ``DeviceExecutor``'s, through the packed sort and
    ``sorted_search``, never ``_lexsort``."""
    ref, port = nds_h_sessions
    calls = {"pack_sort_key": 0, "sorted_search": 0}
    for name in calls:
        real = getattr(KX, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(KX, name, counted)
    monkeypatch.setattr(DX, "_lexsort", _no_lexsort)
    stmts = streams.statements(qn)
    got, got_k = _run(port, stmts)
    exp, exp_k = _run(ref, stmts)
    _assert_same_rows(got, exp, f"q{qn}")
    assert got_k == exp_k
    assert calls["pack_sort_key"] > 0, qn
    if qn != 21:
        assert calls["sorted_search"] > 0, qn
