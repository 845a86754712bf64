"""The port's compressed columnar store against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
``nds_tpu.columnar`` runs on jax CPU, ``nds_tpu_torch.columnar`` on torch
CPU, where the decode wrappers take their plain versions (the CUDA
kernels are held against those on the card by ``chip_smoke.py``). The
columnar mode is process-global in each package; every test sets both to
the same mode and resets them.

- Decode: the port's ``decode`` equals ``nds_tpu.columnar.device.decode``
  exactly, with the spec's dtype, for every bit width (1, 2, 4, 8, 16,
  32), int32 and int64, a bias that fits int32 and one that does not, a
  row count that is not a multiple of the fields per word, a packed and
  a raw mask, and RLE over a padded view and over a single run.
- Encodings: the same ``EncSpec`` and byte-identical host buffers from
  ``plan_values``/``plan_padded``/``encode_values`` for the catalog of
  ``tests/test_columnar.py`` and the NDS-H and NDS tables at SF0.01,
  under every mode.
- Executor: ``tests/test_columnar.py``'s ``QUERIES`` under every mode,
  the 22 NDS-H queries at SF0.01 under ``auto`` and ``rle``, and a
  subset of NDS statements under ``auto`` (all 103 under ``-m slow``):
  rows, ``__kernels`` blocks, ``bytes_scanned``, ``bytes_scanned_raw``
  and ``compression_ratio`` equal the JAX ``DeviceExecutor``'s. Rows
  compare exactly for integers, decimals, dates and strings, and to the
  validator's epsilon (rtol and atol 1e-5) for float columns, whose sums
  the two engines add in other orders; the port's rows under a mode
  equal its own rows with the mode off exactly.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import contextlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from nds_tpu import columnar as ref_columnar
from nds_tpu.columnar import device as ref_cdev
from nds_tpu.columnar import encodings as RE
from nds_tpu.datagen import tpcds as ref_tpcds
from nds_tpu.datagen import tpch as ref_tpch
from nds_tpu.engine.device_exec import make_device_factory as ref_factory
from nds_tpu.engine.session import Session as RefSession
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.nds.schema import get_schemas as ref_ds_schemas
from nds_tpu.nds_h.schema import get_schemas as ref_h_schemas
from nds_tpu_torch import columnar
from nds_tpu_torch.columnar import device as cdev
from nds_tpu_torch.columnar import encodings as E
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine import types as T
from nds_tpu_torch.engine.device_exec import DVal, make_device_factory
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.io.host_table import from_reference
from nds_tpu_torch.nds import streams as ds_streams
from nds_tpu_torch.nds.schema import get_schemas as ds_schemas
from nds_tpu_torch.nds_h import streams as h_streams
from nds_tpu_torch.nds_h.schema import get_schemas as h_schemas
from nds_tpu_torch.sql.planner import CatalogInfo

from tests.test_columnar import QUERIES, _tables

MODES = ("off", "auto", "dict", "bitpack", "rle")
SF = 0.01
FLOAT_TOL = 1e-5   # the validator's epsilon
SEED = 20261017


@contextlib.contextmanager
def both_modes(mode):
    """Both packages under one columnar mode, reset after."""
    ref_columnar.set_mode(mode)
    columnar.set_mode(mode)
    try:
        yield
    finally:
        ref_columnar.set_mode(None)
        columnar.set_mode(None)


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    ref_columnar.set_mode(None)
    columnar.set_mode(None)
    columnar.set_dict_union_cap(None)


# --------------------------------------------------------------- decode

KEY = "t.c"


def _ref_decode(spec, host):
    bufs = {KEY + sfx: jnp.asarray(a) for sfx, a in host.items()}
    vals, valid = ref_cdev.decode(spec, bufs, KEY)
    return np.asarray(vals), None if valid is None else np.asarray(valid)


def _port_decode(spec, host):
    bufs = {KEY + sfx: torch.from_numpy(np.ascontiguousarray(a))
            for sfx, a in host.items()}
    return cdev.decode(spec, bufs, KEY)


def _assert_decode_equal(spec, host):
    exp, exp_valid = _ref_decode(spec, host)
    got, got_valid = _port_decode(spec, host)
    assert got.dtype == cdev.torch_dtype(spec), (got.dtype, spec)
    assert str(got.numpy().dtype) == spec.dtype == str(exp.dtype)
    assert got.shape == (spec.rows,)
    np.testing.assert_array_equal(got.numpy(), exp)
    if exp_valid is None:
        assert got_valid is None
    else:
        assert got_valid.dtype == torch.bool
        assert str(exp_valid.dtype) == "bool"
        np.testing.assert_array_equal(got_valid.numpy(), exp_valid)
    return got


# biases per (dtype, case): "fits" takes the int32 path of the
# reference's decode, "wide" its int64 path
BIASES = {("int32", "fits"): -12345, ("int32", "wide"): 2**31 - 1,
          ("int64", "fits"): 7, ("int64", "wide"): -(2**40) - 3}


@pytest.mark.parametrize("case", ["fits", "wide"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32])
def test_bitpack_decode_matches_jax(bits, dtype, case):
    """Random words (every bit pattern, so the sign bit of each word is
    set about half the time and every field takes its whole range) for a
    row count that leaves the last word part full; then a column
    encoded by the reference's host encoder decodes back to itself."""
    rng = np.random.default_rng(SEED + bits)
    lo = BIASES[(dtype, case)]
    n = 997
    per = 1 if bits == 32 else 32 // bits
    nwords = n if bits == 32 else -(-n // per)
    words = rng.integers(-2**31, 2**31, nwords, dtype=np.int64).astype(
        np.int32)
    spec = RE.EncSpec("bitpack", n, dtype, bits=bits, lo=lo)
    if bits < 32:
        assert n % per or per == 1
    _assert_decode_equal(spec, {"": words})
    # round trip through the encoder, within the dtype's range
    span = (1 << min(bits, 31)) - 1
    top = min(lo + span, np.iinfo(dtype).max)
    vals = rng.integers(lo, top, n, endpoint=True).astype(dtype)
    host = RE.encode_values(spec, vals)
    got = _assert_decode_equal(spec, host)
    np.testing.assert_array_equal(got.numpy(), vals)


@pytest.mark.parametrize("packed", [True, False])
def test_mask_decode_matches_jax(packed):
    """A packed mask (1 bit per row, the "raw" mask-only spec and a
    bitpacked column's) and a raw bool mask."""
    rng = np.random.default_rng(SEED)
    n = 1000 + 13
    mask = rng.random(n) > 0.3
    fvals = rng.random(n)
    ivals = rng.integers(0, 200, n).astype(np.int32)
    specs = [(RE.EncSpec("raw", n, "float64", mask_packed=packed), fvals),
             (RE.EncSpec("bitpack", n, "int32", bits=8, lo=0,
                         mask_packed=packed), ivals)]
    for spec, vals in specs:
        host = RE.encode_values(spec, vals, mask)
        assert host["#v"].dtype == (np.int32 if packed else bool)
        _, valid = _port_decode(spec, host)
        _assert_decode_equal(spec, host)
        np.testing.assert_array_equal(valid.numpy(), mask)


def test_unpack_mask_matches_jax():
    rng = np.random.default_rng(SEED + 1)
    for n in (1, 31, 32, 33, 1000):
        words = rng.integers(-2**31, 2**31, -(-n // 32),
                             dtype=np.int64).astype(np.int32)
        got = KX.unpack_mask(torch.from_numpy(words), n)
        exp = np.asarray(ref_cdev.unpack_mask(jnp.asarray(words), n))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), exp)


def _runs(rng, n, dtype, mean_len):
    """A sorted column of about n / mean_len runs."""
    steps = (rng.random(n) < 1.0 / mean_len).astype(np.int64)
    steps[0] = 0
    return (np.cumsum(steps * rng.integers(1, 5, n)) - 3).astype(dtype)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("layout", ["padded", "single_run", "full"])
def test_rle_decode_matches_jax(layout, dtype):
    """RLE over a padded view (runs from the live prefix, the last run
    carried over the pad, as ``plan_padded`` + ``encode_values(nrows=)``
    make it), over one run, and over a whole column."""
    rng = np.random.default_rng(SEED + len(layout))
    if layout == "single_run":
        vals = np.full(777, 42, dtype=dtype)
        nrows = len(vals)
    else:
        vals = _runs(rng, 1500, dtype, 4.0)
        nrows = 1100 if layout == "padded" else len(vals)
    if layout == "padded":
        vals = np.concatenate([vals[:nrows],
                               np.zeros(2048 - nrows, dtype=dtype)])
    live = vals[:nrows]
    runs = RE._runs_of(live)
    spec = RE.EncSpec("rle", len(vals), dtype, runs=runs)
    host = RE.encode_values(spec, vals, None, nrows=nrows)
    assert len(host[""]) == runs and host["#x"].dtype == np.int32
    got = _assert_decode_equal(spec, host)
    np.testing.assert_array_equal(got.numpy()[:nrows], live)
    # the pad takes the last run's value
    assert (got.numpy()[nrows:] == live[-1]).all()


def test_decode_wrappers_count_no_launch_on_the_cpu():
    KX.reset_launches()
    words = torch.zeros(4, dtype=torch.int32)
    KX.bitpack_decode(words, 30, 4, 0, torch.int64)
    KX.unpack_mask(words, 100)
    KX.rle_decode(torch.ones(2, dtype=torch.int64),
                  torch.tensor([0, 3], dtype=torch.int32), 9)
    assert all(KX.LAUNCHES[n] == 0 for n in
               ("bitpack_decode", "unpack_mask", "rle_decode"))


def test_decode_wrappers_refuse_other_devices():
    w = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        KX.bitpack_decode(w, 8, 8, 0, torch.int32)
    with pytest.raises(ValueError):
        KX.unpack_mask(w, 8)
    with pytest.raises(ValueError):
        KX.rle_decode(w, w, 8)


def test_decode_raises_on_a_dtype_other_than_the_spec():
    spec = E.EncSpec("raw", 4, "int64", mask_packed=True)
    bufs = {KEY: torch.zeros(4, dtype=torch.int32),
            KEY + "#v": torch.zeros(1, dtype=torch.int32)}
    with pytest.raises(cdev.DecodeError):
        cdev.decode(spec, bufs, KEY)


# ------------------------------------------------------------ encodings

def _spec_equal(got, exp, what):
    assert (got is None) == (exp is None), (what, got, exp)
    if exp is not None:
        assert RE.spec_to_json(exp) == E.spec_to_json(got), what


def _host_equal(got: dict, exp: dict, what):
    assert sorted(got) == sorted(exp), what
    for sfx in exp:
        assert got[sfx].dtype == exp[sfx].dtype, (what, sfx)
        assert got[sfx].shape == exp[sfx].shape, (what, sfx)
        assert got[sfx].tobytes() == exp[sfx].tobytes(), (what, sfx)


def _check_table_encodings(ref_table, port_table, mode, rng):
    ref_columnar.set_mode(mode)
    columnar.set_mode(mode)
    for name, rc in ref_table.columns.items():
        pc = port_table.columns[name]
        what = (mode, ref_table.name, name)
        exp = RE.plan_values(rc.values, rc.null_mask,
                             is_string=rc.is_string)
        got = E.plan_values(pc.values, pc.null_mask,
                            is_string=pc.is_string)
        _spec_equal(got, exp, what)
        _spec_equal(E.column_spec(pc), RE.column_spec(rc), what)
        if exp is not None:
            _host_equal(E.encode_column(got, pc), RE.encode_column(exp, rc),
                        what)
        # a survivor-reduced view: a random third of the rows, padded
        # to a power of two
        n = len(rc.values)
        if n < 4:
            continue
        idx = np.sort(rng.choice(n, size=max(n // 3, 2), replace=False))
        cap = 1 << (len(idx) - 1).bit_length()
        vals = np.concatenate([rc.values[idx],
                               np.zeros(cap - len(idx),
                                        dtype=rc.values.dtype)])
        nulls = (None if rc.null_mask is None else np.concatenate(
            [rc.null_mask[idx], np.zeros(cap - len(idx), dtype=bool)]))
        exp = RE.plan_padded(vals, nulls, len(idx), is_string=rc.is_string)
        got = E.plan_padded(vals, nulls, len(idx), is_string=pc.is_string)
        _spec_equal(got, exp, what + ("padded",))
        if exp is not None:
            _host_equal(
                E.encode_values(got, vals, nulls, nrows=len(idx)),
                RE.encode_values(exp, vals, nulls, nrows=len(idx)),
                what + ("padded",))
    assert E.table_compression(port_table) == RE.table_compression(
        ref_table)


def _port_schema(ref_schema):
    def conv(t):
        r = repr(t)
        if r.startswith("varchar"):
            return T.varchar(int(r[len("varchar("):-1]))
        return {"int32": T.INT32, "int64": T.INT64, "date": T.DATE}[r]
    return T.Schema.of(*[(f.name, conv(f.dtype), f.nullable)
                         for f in ref_schema])


def catalog_tables():
    """``tests/test_columnar.py``'s catalog in both packages: (reference
    catalog, reference tables, port catalog, port tables)."""
    cat, tables = _tables()
    schemas = {t: _port_schema(s) for t, s in cat.schemas.items()}
    pcat = CatalogInfo(schemas, cat.primary_keys, cat.sizes)
    return cat, tables, pcat, {t: from_reference(tab, schemas)
                               for t, tab in tables.items()}


def _suite_tables(suite):
    if suite == "nds_h":
        schemas, gen, port_schemas = ref_h_schemas(), ref_tpch, h_schemas()
    else:
        schemas, gen, port_schemas = ref_ds_schemas(), ref_tpcds, \
            ds_schemas()
    ref = {t: ref_from_arrays(t, schemas[t], gen.gen_table(t, SF))
           for t in schemas}
    return ref, {t: from_reference(tab, port_schemas)
                 for t, tab in ref.items()}


@pytest.fixture(scope="module")
def suite_tables():
    return {"catalog": catalog_tables()[1::2], "nds_h":
            _suite_tables("nds_h"), "nds": _suite_tables("nds")}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("suite", ["catalog", "nds_h", "nds"])
def test_encodings_match_jax_package(suite, mode, suite_tables):
    ref, port = suite_tables[suite]
    rng = np.random.default_rng(SEED)
    for t in ref:
        _check_table_encodings(ref[t], port[t], mode, rng)


# ------------------------------------------------------------- executor

def _assert_rows(got: pd.DataFrame, exp: pd.DataFrame, what: str):
    """The same rows in the same order: exactly for integers, decimals,
    dates, strings and bools; floats to the validator's epsilon."""
    assert list(got.columns) == list(exp.columns), what
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    for i in range(exp.shape[1]):
        g, e = got.iloc[:, i], exp.iloc[:, i]
        assert list(g.isna()) == list(e.isna()), f"{what} col {i} nulls"
        g, e = g[~g.isna()], e[~e.isna()]
        if g.dtype.kind == "f" or e.dtype.kind == "f":
            np.testing.assert_allclose(
                g.to_numpy(dtype=float), e.to_numpy(dtype=float),
                rtol=FLOAT_TOL, atol=FLOAT_TOL, err_msg=f"{what} col {i}")
        else:
            assert list(g.astype(str)) == list(e.astype(str)), (
                f"{what} col {i}")


BYTE_KEYS = ("bytes_scanned", "bytes_scanned_raw", "compression_ratio")


def _timings(session):
    return dict(session._executor_factory(session.tables).last_timings)


def _bill(t: dict) -> tuple:
    """(kernel block, byte counts) of one statement's timings."""
    return (dict(t.get("__kernels") or {}),
            {k: t.get(k) for k in BYTE_KEYS})


def _run_stmts(session, stmts):
    result = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            result = r
    return result.to_pandas(), _bill(_timings(session))


@pytest.mark.parametrize("mode", MODES)
def test_queries_every_mode_match_jax_and_mode_off(mode):
    cat, tables, pcat, ptables = catalog_tables()
    with both_modes("off"):
        base = Session(pcat, make_device_factory(device="cpu"))
        for t in ptables.values():
            base.register_table(t)
        base_rows = [base.sql(q).to_pandas() for q in QUERIES]
    with both_modes(mode):
        ref = RefSession(cat, ref_factory())
        port = Session(pcat, make_device_factory(device="cpu"))
        for t in tables.values():
            ref.register_table(t)
        for t in ptables.values():
            port.register_table(t)
        for i, q in enumerate(QUERIES):
            exp, exp_bill = _run_stmts(ref, [q])
            got, got_bill = _run_stmts(port, [q])
            what = f"{mode} query #{i}"
            assert got.equals(base_rows[i]), what
            _assert_rows(got, exp, what)
            assert got_bill == exp_bill, (what, got_bill, exp_bill)
            assert got_bill[1]["bytes_scanned"] is not None
            if mode == "off":
                assert got_bill[1]["bytes_scanned_raw"] is None


def test_device_bytes_actually_drop():
    _cat, _tables_, pcat, ptables = catalog_tables()
    bills = {}
    for mode in ("off", "auto"):
        with both_modes(mode):
            s = Session(pcat, make_device_factory(device="cpu"))
            for t in ptables.values():
                s.register_table(t)
            s.sql(QUERIES[0])
            bills[mode] = _timings(s)
    off, on = bills["off"], bills["auto"]
    assert on["bytes_scanned"] <= off["bytes_scanned"] / 2
    assert on["compression_ratio"] > 2.0
    assert on["bytes_scanned_raw"] == off["bytes_scanned"]
    assert "compression_ratio" not in off
    assert "bytes_scanned_raw" not in off


def _leg_sessions(suite, mode):
    """(reference, port) sessions of one suite at SF0.01, each with an
    executor of its own for ``mode``."""
    ref_tables, port_tables = _suite_tables(suite)
    if suite == "nds_h":
        ref = RefSession.for_nds_h(ref_factory())
        port = Session.for_nds_h(make_device_factory(device="cpu"))
    else:
        ref = RefSession.for_nds(ref_factory())
        port = Session.for_nds(make_device_factory(device="cpu"))
    for t in ref_tables.values():
        ref.register_table(t)
    for t in port_tables.values():
        port.register_table(t)
    return ref, port


@pytest.fixture(scope="module")
def leg_sessions():
    made: dict = {}

    def get(suite, mode):
        if (suite, mode) not in made:
            made[(suite, mode)] = _leg_sessions(suite, mode)
        return made[(suite, mode)]
    return get


@pytest.mark.parametrize("qn", range(1, 23))
@pytest.mark.parametrize("mode", ["auto", "rle"])
def test_nds_h_query_matches_jax_engine(mode, qn, leg_sessions):
    ref, port = leg_sessions("nds_h", mode)
    stmts = h_streams.statements(qn)
    with both_modes(mode):
        exp, exp_bill = _run_stmts(ref, stmts)
        got, got_bill = _run_stmts(port, stmts)
    _assert_rows(got, exp, f"{mode} q{qn}")
    assert got_bill == exp_bill, (mode, qn, got_bill, exp_bill)
    assert got_bill[1]["compression_ratio"] is not None


def test_nds_h_auto_reaches_every_decode(leg_sessions):
    """Under ``auto`` the NDS-H leg uploads bit-packed and RLE columns,
    and the kernel choices are those of the mode-off run."""
    _ref, port = leg_sessions("nds_h", "auto")
    _ref_off, port_off = leg_sessions("nds_h", "off")
    kinds = set()
    for qn in (1, 3, 5, 18):
        stmts = h_streams.statements(qn)
        with both_modes("auto"):
            _, (kernels, _b) = _run_stmts(port, stmts)
        ex = port._executor_factory(port.tables)
        kinds |= {s.kind for s in ex._enc_specs.values()}
        with both_modes("off"):
            _, (kernels_off, _b) = _run_stmts(port_off, stmts)
        assert kernels == kernels_off, qn
    assert {"bitpack", "rle"} <= kinds, kinds


NDS_UNITS = dict(ds_streams.power_units())
# q5: staged (UNION ALL over three channels, ROLLUP); q6: a scalar
# subplan; q12: a window; q38: INTERSECT under DISTINCT; q96: a star
# join of store_sales. Their nullable columns upload packed masks
NDS_SUBSET = ["5", "6", "12", "38", "96"]


@pytest.mark.parametrize("unit", NDS_SUBSET)
def test_nds_statement_auto_matches_jax_engine(unit, leg_sessions):
    ref, port = leg_sessions("nds", "auto")
    with both_modes("auto"):
        exp, exp_bill = _run_stmts(ref, NDS_UNITS[unit])
        got, got_bill = _run_stmts(port, NDS_UNITS[unit])
        timings = _timings(port)
    _assert_rows(got, exp, f"q{unit}")
    assert got_bill == exp_bill, (unit, got_bill, exp_bill)
    if unit == "5":
        assert timings.get("staged_programs", 0) > 0
    ex = port._executor_factory(port.tables)
    assert any(s.mask_packed for s in ex._enc_specs.values())


@pytest.mark.slow
@pytest.mark.parametrize("unit", list(NDS_UNITS))
def test_all_nds_statements_auto_match_jax_engine(unit, leg_sessions):
    ref, port = leg_sessions("nds", "auto")
    with both_modes("auto"):
        exp, exp_bill = _run_stmts(ref, NDS_UNITS[unit])
        got, got_bill = _run_stmts(port, NDS_UNITS[unit])
    from tests.test_torch_nds import assert_unit_matches
    assert_unit_matches(got, exp, unit)
    assert got_bill == exp_bill, (unit, got_bill, exp_bill)


# ------------------------------------------------- executor internals

def test_encoded_scan_column_decodes_values_and_mask_apart():
    rng = np.random.default_rng(SEED)
    n = 300
    mask = rng.random(n) > 0.2
    vals = rng.integers(0, 50, n).astype(np.int32)
    spec = E.EncSpec("bitpack", n, "int32", bits=8, lo=0, mask_packed=True)
    bufs = {KEY + sfx: torch.from_numpy(a)
            for sfx, a in E.encode_values(spec, vals, mask).items()}
    calls = {"bitpack_decode": 0, "unpack_mask": 0}
    wrapped = {name: getattr(KX, name) for name in calls}

    def counting(name):
        def call(*args):
            calls[name] += 1
            return wrapped[name](*args)
        return call
    try:
        for name in calls:
            setattr(KX, name, counting(name))
        dv = DVal.encoded(spec, bufs, KEY)
        assert calls == {"bitpack_decode": 0, "unpack_mask": 0}
        np.testing.assert_array_equal(dv.valid.numpy(), mask)
        assert calls == {"bitpack_decode": 0, "unpack_mask": 1}
        np.testing.assert_array_equal(dv.arr.numpy(), vals)
        dv.arr, dv.valid
        assert calls == {"bitpack_decode": 1, "unpack_mask": 1}
        head = DVal.encoded(spec, bufs, KEY).head(10)
        np.testing.assert_array_equal(head.arr.numpy(), vals[:10])
    finally:
        for name, fn in wrapped.items():
            setattr(KX, name, fn)


def test_dropping_a_table_drops_its_specs():
    _cat, _t, pcat, ptables = catalog_tables()
    with both_modes("auto"):
        s = Session(pcat, make_device_factory(device="cpu"))
        for t in ptables.values():
            s.register_table(t)
        s.sql(QUERIES[0])
        ex = s._executor_factory(s.tables)
        assert any(k.startswith("fact.") for k in ex._enc_specs)
        ex._drop_table_state("fact")
        for d in (ex._buffers, ex._enc_specs, ex._raw_nbytes):
            assert not any(k.startswith(("fact.", "fact@")) for k in d)
        # the table uploads again, with its specs, at the next run
        again = s.sql(QUERIES[0]).to_pandas()
        assert any(k.startswith("fact.") for k in ex._enc_specs)
    with both_modes("off"):
        s2 = Session(pcat, make_device_factory(device="cpu"))
        for t in ptables.values():
            s2.register_table(t)
        assert again.equals(s2.sql(QUERIES[0]).to_pandas())


def test_dict_union_cap_bounds_the_union_memo_only():
    ex = make_device_factory(device="cpu")({})
    dicts = [np.array([f"s{i}", f"s{i + 1}"], dtype=object)
             for i in range(6)]
    for i in range(5):
        ex.dict_table(("like", i), (), lambda: i)
    columnar.set_dict_union_cap(2)
    for i in range(5):
        ex.dict_union(dicts[i], dicts[i + 1], lambda: i)
        assert len(ex._union_cache) <= 2
    assert len(ex._dict_tables) == 5
    # a hit returns the memoized value, pinned to its dictionaries
    assert ex.dict_union(dicts[4], dicts[5], lambda: "new") == 4
    columnar.set_dict_union_cap(None)
    assert columnar.dict_union_cap() == columnar.DEFAULT_DICT_UNION_CAP


def test_mode_and_env_names_are_the_reference_s(monkeypatch):
    assert columnar.MODES == ref_columnar.MODES
    assert columnar.ENV_MODE == ref_columnar.ENV_MODE
    assert columnar.ENV_UNION_CAP == ref_columnar.ENV_UNION_CAP
    for env, exp in (("", "off"), ("1", "auto"), ("rle", "rle"),
                     ("typo", "off")):
        monkeypatch.setenv("NDS_TPU_COLUMNAR", env)
        assert columnar.mode() == ref_columnar.mode() == exp
        assert columnar.fingerprint_token() == \
            ref_columnar.fingerprint_token()
    monkeypatch.setenv("NDS_TPU_DICT_UNION_CAP", "0")
    assert columnar.dict_union_cap() == ref_columnar.dict_union_cap() == 1
    columnar.configure_from({"columnar.encode": "bitpack",
                             "columnar.dict_union_cap": 9})
    assert (columnar.mode(), columnar.dict_union_cap()) == ("bitpack", 9)
    columnar.configure_from({})
    assert columnar.mode() == "off"
