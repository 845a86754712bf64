"""The port's delta layer (``nds_tpu_torch/columnar/delta.py``,
``io/snapshots.py``) against the JAX package's.

The reference test's synthetic table and canonical mutation
(``tests/test_delta.py``), built from the same numpy seeds, go through
both packages: ``append_segment``, ``apply_delete``, ``live_mask``,
``visible_rows``, ``delta_report``, ``content_digest`` and
``deleted_digest`` must equal the reference's, and so must the
effective tables' arrays. Also: the ``persist_pending`` ->
``load_versioned`` round trip (the port reads back the reference's
persisted files and the reference the port's), the torn-commit window,
the digest checks on load, ``SnapshotLog`` rollback, and
``host_table.from_reference`` carrying delta state.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import json
import os

import numpy as np
import pytest

from nds_tpu.cache import fingerprint as ref_fingerprint
from nds_tpu.columnar import delta as ref_delta
from nds_tpu.engine import types as RT
from nds_tpu.io.host_table import from_arrays as ref_from_arrays
from nds_tpu.io.snapshots import SnapshotLog as RefSnapshotLog
from nds_tpu_torch.columnar import delta
from nds_tpu_torch.engine import types as T
from nds_tpu_torch.io import csv_io, integrity
from nds_tpu_torch.io.host_table import from_arrays, from_reference
from nds_tpu_torch.io.snapshots import SnapshotLog

SCHEMA = T.Schema.of(
    ("d_id", T.INT64, False),
    ("d_qty", T.INT32, True),        # carries a null mask
    ("d_tag", T.varchar(8), True))   # dict-encoded, later segs grow it
REF_SCHEMA = RT.Schema.of(
    ("d_id", RT.INT64, False),
    ("d_qty", RT.INT32, True),
    ("d_tag", RT.varchar(8), True))

BASE_ROWS = 20


def _arrays(start=0, n=BASE_ROWS, tag_mod=5):
    """The reference test's ``_tbl`` arrays, same seed."""
    rng = np.random.default_rng(1000 + start + n)
    ids = np.arange(start, start + n, dtype=np.int64)
    qty = rng.integers(0, 100, n).astype(np.int32)
    tags = np.array([f"tag{i % tag_mod}" for i in range(start, start + n)],
                    dtype=object)
    return {"d_id": ids,
            "d_qty": qty, "d_qty#null": rng.random(n) > 0.2,
            "d_tag": tags, "d_tag#null": rng.random(n) > 0.1}


def _tbl(name="dtab", **kw):
    return from_arrays(name, SCHEMA, _arrays(**kw))


def _ref_tbl(name="dtab", **kw):
    return ref_from_arrays(name, REF_SCHEMA, _arrays(**kw))


DELETED = [1, 3, 5, 21, 25]


def _mutate(mod, table, seg):
    """The canonical mutation: append 7 rows (3 of them with dictionary-
    new tags), then delete 5 of the merged physical rows."""
    t2 = mod.append_segment(table, seg, seg_id="seg-a")
    keep = np.ones(t2.nrows, dtype=bool)
    keep[DELETED] = False
    return t2, mod.apply_delete(t2, keep)


def _pair():
    port = _mutate(delta, _tbl(), _tbl(start=100, n=7, tag_mod=9))
    ref = _mutate(ref_delta, _ref_tbl(),
                  _ref_tbl(start=100, n=7, tag_mod=9))
    return port, ref


def _assert_same_arrays(a, b):
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        ca, cb = a.columns[name], b.columns[name]
        np.testing.assert_array_equal(ca.values, cb.values)
        assert ca.values.dtype == cb.values.dtype
        assert (ca.null_mask is None) == (cb.null_mask is None)
        if ca.null_mask is not None:
            np.testing.assert_array_equal(ca.null_mask, cb.null_mask)
        assert (ca.dictionary is None) == (cb.dictionary is None)
        if ca.dictionary is not None:
            assert list(ca.dictionary) == list(cb.dictionary)


class TestAgainstReference:
    def test_base_digest_equals_reference(self):
        assert (delta.table_digest(_tbl())
                == ref_fingerprint.table_digest(_ref_tbl()))

    def test_append_equals_reference(self):
        (p2, _p3), (r2, _r3) = _pair()
        _assert_same_arrays(p2, r2)
        ps, rs = delta.state_of(p2), ref_delta.state_of(r2)
        assert ps.base_digest == rs.base_digest
        assert [(s.seg_id, s.rows, s.digest) for s in ps.segments] == [
            (s.seg_id, s.rows, s.digest) for s in rs.segments]
        assert ps.col_stats == rs.col_stats
        assert ps.content_digest() == rs.content_digest()
        # the merged-stats encoding spec seeded on every column
        from nds_tpu.columnar import encodings as ref_enc
        from nds_tpu_torch.columnar import encodings
        for name in p2.columns:
            got = encodings.column_spec(p2.columns[name])
            want = ref_enc.column_spec(r2.columns[name])
            assert (None if got is None else encodings.spec_to_json(got)) \
                == (None if want is None else ref_enc.spec_to_json(want))

    @pytest.mark.parametrize("fn", [
        "live_mask", "visible_rows", "delta_report", "segment_count",
        "content_digest", "deleted_digest", "deleted_count"])
    def test_delete_equals_reference(self, fn):
        (_p2, p3), (_r2, r3) = _pair()
        if fn in ("content_digest", "deleted_digest", "deleted_count"):
            got = getattr(delta.state_of(p3), fn)()
            want = getattr(ref_delta.state_of(r3), fn)()
        else:
            got = getattr(delta, fn)(p3)
            want = getattr(ref_delta, fn)(r3)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
        assert delta.table_digest(p3) == ref_fingerprint.table_digest(r3)

    def test_physical_equals_reference(self):
        (_p2, p3), (_r2, r3) = _pair()
        _assert_same_arrays(delta.physical(p3), ref_delta.physical(r3))
        assert delta.physical(p3) is delta.physical(p3)

    def test_delete_shares_column_objects(self):
        (p2, p3), _ref = _pair()
        for f in SCHEMA:
            assert p3.columns[f.name] is p2.columns[f.name]

    def test_appending_a_dictionary_subset_keeps_base_codes(self):
        base = _tbl()
        t2 = delta.append_segment(base, _tbl(start=0, n=7), seg_id="s")
        r2 = ref_delta.append_segment(_ref_tbl(), _ref_tbl(start=0, n=7),
                                      seg_id="s")
        assert t2.columns["d_tag"].dictionary is \
            base.columns["d_tag"].dictionary
        _assert_same_arrays(t2, r2)
        assert (delta.state_of(t2).content_digest()
                == ref_delta.state_of(r2).content_digest())


# --------------------------------------------------------- persistence

def _seed_warehouse(root):
    """Baseline-only warehouse: one parquet file under <wh>/dtab/."""
    wh = str(root / "wh")
    tdir = os.path.join(wh, "dtab")
    os.makedirs(tdir)
    csv_io.write_table(_tbl(), os.path.join(tdir, "part-0.parquet"),
                       "parquet")
    return wh


def _load_current(wh):
    paths = SnapshotLog(wh).current(["dtab"])["dtab"]
    return paths, delta.load_versioned("dtab", SCHEMA, paths, "parquet")


def _persist_mutation(wh, commit):
    """Replay the canonical mutation against the warehouse's current
    version and persist it into _v1; append the manifest entry only when
    ``commit`` (False models a crash inside the torn window)."""
    log = SnapshotLog(wh)
    _paths, base = _load_current(wh)
    _t2, t3 = _mutate(delta, base, _tbl(start=100, n=7, tag_mod=9))
    files = delta.persist_pending(t3, log.version_dir("dtab", 1),
                                  note="LF_TEST")
    assert files and os.path.basename(files[0]) == delta.OPS_NAME
    if commit:
        log.commit_delta("dtab", [os.path.relpath(p, wh) for p in files],
                         note="LF_TEST")
    return t3, files


class TestPersistence:
    def test_round_trip_equals_writer_and_reference(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        t3, _files = _persist_mutation(wh, commit=True)
        paths, eff = _load_current(wh)
        assert delta.has_delta_paths(paths)
        assert (delta.state_of(eff).content_digest()
                == delta.state_of(t3).content_digest())
        _assert_same_arrays(eff, t3)
        np.testing.assert_array_equal(delta.live_mask(eff),
                                      delta.live_mask(t3))
        # the reference reads the port's lineage to the same table
        rpaths = RefSnapshotLog(wh).current(["dtab"])["dtab"]
        assert rpaths == paths
        ref = ref_delta.load_versioned("dtab", REF_SCHEMA, rpaths,
                                       "parquet")
        _assert_same_arrays(eff, ref)
        assert (ref_delta.state_of(ref).content_digest()
                == delta.state_of(eff).content_digest())

    def test_reads_the_references_lineage(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        log = RefSnapshotLog(wh)
        rpaths = log.current(["dtab"])["dtab"]
        base = ref_delta.load_versioned("dtab", REF_SCHEMA, rpaths,
                                        "parquet")
        _r2, r3 = _mutate(ref_delta, base,
                          _ref_tbl(start=100, n=7, tag_mod=9))
        files = ref_delta.persist_pending(r3, log.version_dir("dtab", 1),
                                          note="LF_TEST")
        log.commit_delta("dtab", [os.path.relpath(p, wh) for p in files],
                         note="LF_TEST")
        _paths, eff = _load_current(wh)
        _assert_same_arrays(eff, r3)
        assert (delta.state_of(eff).content_digest()
                == ref_delta.state_of(r3).content_digest())

    def test_ops_file_equals_reference_shape(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        _t3, files = _persist_mutation(wh, commit=True)
        with open(files[0]) as f:
            doc = json.load(f)
        assert integrity.check_crc(doc)
        assert [op["kind"] for op in doc["ops"]] == ["insert", "delete"]
        assert doc["ops"][1]["deleted"] == len(DELETED)

    def test_torn_commit_serves_previous_version(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        _paths0, base0 = _load_current(wh)
        d0 = delta.table_digest(base0)
        _t3, files = _persist_mutation(wh, commit=False)
        assert all(os.path.exists(p) for p in files)
        paths, reloaded = _load_current(wh)
        assert not delta.has_delta_paths(paths)
        assert reloaded.nrows == BASE_ROWS
        assert delta.visible_rows(reloaded) == BASE_ROWS
        assert delta.table_digest(reloaded) == d0

    def test_recovery_commit_publishes_without_rewriting(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        t3, files = _persist_mutation(wh, commit=False)
        mtimes = {p: os.path.getmtime(p) for p in files}
        log = SnapshotLog(wh)
        assert not log.has_note("LF_TEST")
        log.commit_delta("dtab", [os.path.relpath(p, wh) for p in files],
                         note="LF_TEST")
        assert SnapshotLog(wh).has_note("LF_TEST")
        _paths, eff = _load_current(wh)
        assert delta.visible_rows(eff) == BASE_ROWS + 7 - len(DELETED)
        assert (delta.state_of(eff).content_digest()
                == delta.state_of(t3).content_digest())
        assert mtimes == {p: os.path.getmtime(p) for p in files}

    @pytest.mark.parametrize("damage", ["segment", "ops", "mask"])
    def test_corruption_raises_on_load(self, tmp_path, damage,
                                       monkeypatch):
        monkeypatch.setattr(integrity, "_verify_override", True)
        wh = _seed_warehouse(tmp_path)
        _persist_mutation(wh, commit=True)
        vdir = os.path.join(wh, "dtab", "_v1")
        if damage == "segment":
            path = os.path.join(vdir, "delta-0.parquet")
            blob = bytearray(open(path, "rb").read())
            blob[len(blob) // 2] ^= 0xFF
            open(path, "wb").write(bytes(blob))
        elif damage == "ops":
            path = os.path.join(vdir, delta.OPS_NAME)
            with open(path) as f:
                doc = json.load(f)
            doc["note"] = "tampered"  # stale crc stamp
            with open(path, "w") as f:
                json.dump(doc, f)
        else:
            [mask] = [f for f in os.listdir(vdir) if f.endswith(".npz")]
            path = os.path.join(vdir, mask)
            blob = open(path, "rb").read()
            open(path, "wb").write(blob[:len(blob) // 2])
        for _ in range(2):
            with pytest.raises(integrity.CorruptArtifact):
                _load_current(wh)

    def test_rollback_to_baseline_restores_the_table(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        _paths0, base0 = _load_current(wh)
        d0 = delta.table_digest(base0)
        _persist_mutation(wh, commit=True)
        log = SnapshotLog(wh)
        assert log.rollback_to_timestamp(0.0) is None
        paths, reloaded = _load_current(wh)
        assert not delta.has_delta_paths(paths)
        assert delta.table_digest(reloaded) == d0
        assert SnapshotLog(wh).entries == []
        # the reference's log reads the port's manifest the same way
        assert RefSnapshotLog(wh).entries == []

    def test_snapshot_versions_and_notes(self, tmp_path):
        wh = _seed_warehouse(tmp_path)
        log = SnapshotLog(wh)
        assert log.current(["dtab"]) == {
            "dtab": [os.path.join(wh, "dtab", "part-0.parquet")]}
        v1 = log.commit({"dtab": ["dtab/part-0.parquet"]}, note="a")
        v2 = log.commit({"dtab": ["dtab/part-0.parquet"]}, note="b")
        assert (v1, v2) == (1, 2)
        assert log.has_note("a") and not log.has_note("c")
        ts = SnapshotLog(wh).entries[0]["timestamp"]
        assert SnapshotLog(wh).rollback_to_timestamp(ts) == 1
        assert [e["note"] for e in RefSnapshotLog(wh).entries] == ["a"]


def test_torn_manifest_falls_back_to_baseline(tmp_path, capsys):
    wh = _seed_warehouse(tmp_path)
    SnapshotLog(wh).commit({"dtab": ["dtab/part-0.parquet"]}, note="a")
    path = os.path.join(wh, "_snapshots.json")
    blob = open(path).read()
    open(path, "w").write(blob[:len(blob) // 2])
    assert SnapshotLog(wh).entries == []
    assert "torn/corrupt" in capsys.readouterr().out


def test_from_reference_carries_delta_state():
    (_p2, p3), (_r2, r3) = _pair()
    got = from_reference(r3, {"dtab": SCHEMA})
    _assert_same_arrays(got, p3)
    st, want = delta.state_of(got), delta.state_of(p3)
    assert st.content_digest() == want.content_digest()
    assert delta.delta_report(got) == delta.delta_report(p3)
    np.testing.assert_array_equal(delta.live_mask(got), delta.live_mask(p3))
    # an unpersisted segment's table comes across as a port table
    seg = st.segments[0].table
    assert seg is not None and type(seg).__module__.startswith(
        "nds_tpu_torch.")
    # a further mutation on the port's side composes like the writer's
    keep = np.ones(got.nrows, dtype=bool)
    keep[0] = False
    ref_keep = ref_delta.apply_delete(r3, keep)
    assert (delta.state_of(delta.apply_delete(got, keep)).content_digest()
            == ref_delta.state_of(ref_keep).content_digest())
