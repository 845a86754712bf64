"""The port's distributed engine on four gloo ranks of the CPU.

Once per module, four processes join one ``torch.distributed`` world
(gloo, a free localhost port, a 60 s process-group timeout) through the
launch environment of ``nds_tpu_torch.parallel.multihost``, and each runs
this file as a script: the port only, never jax or ``nds_tpu``. Every
rank writes what it computed to a file for the test to check; a rank
that fails, or a world that does not finish in time, fails the test
(the ranks are killed). The ranks run:

- all 22 NDS-H queries at SF0.01 through ``Session.for_nds_h(
  make_distributed_factory(n_devices=4, shard_threshold=1000))``, as
  ``tests/test_distributed.py`` runs the reference: the rows must equal
  the reference's CPU oracle (``nds_tpu``'s ``Session`` and its
  ``CpuExecutor`` over the reference generator's tables) under the
  validator's rules, on every rank,
  and each query's ``kernels`` block must equal the JAX
  ``DistributedExecutor``'s on 4 virtual devices (six queries that
  cover a join of two sharded sides, grouped-aggregate exchanges, global
  psum/pmax, a left join and semi-joins; all 22 under ``-m slow``);
- a few of those queries on a 2 x 2 (host, lane) mesh, where every
  exchange takes its hierarchical form;
- a grouped aggregate over a skewed key at a slack of 0.5, whose
  exchange overflows: every rank retries, and the rows are right;
- the port's ``exchange``, ``exchange_by_dest`` and
  ``exchange_hierarchical`` over gloo, held bit for bit to the JAX
  functions under ``shard_map`` on the same shards;
- NDS statements that reach partitioned joins, windows, set operations
  and staged sub-plans (all 103 under ``-m slow``, in a world of two
  ranks of their own), against the reference's CPU oracle under the NDS
  validator's rules.

A fifth process runs a world of one on the CPU through the same entry
point (``make_distributed_factory(n_devices=1, device="cpu")``, no
launch environment). The ranks run the port's plain versions.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

WORLD = 4
SF = 0.01
THRESHOLD = 1000
TIMEOUT_S = 60
HIER_QUERIES = [1, 3, 13, 18]
# the tier-1 kernel-block subset: q3 joins two sharded sides (customer,
# orders, lineitem), q1 and q18 exchange for grouped aggregates, q6 and
# q15 reduce globally (psum, pmax), q13 is a left join, q18 a semi-join
KERNEL_QUERIES = [1, 3, 6, 13, 15, 18]
# q4: partitioned joins and staged sub-plans; q5, q77: staged unions and
# ROLLUP; q12, q51: windows; q38, q87: INTERSECT, EXCEPT; q6: a scalar
# subplan. q72, the other partitioned-join statement of the single-rank
# subset, reaches 30M-slot capacities on 4 ranks (each exchange of two
# sharded sides doubles a side's capacity, as in the reference): it runs
# with the rest under -m slow.
NDS_SUBSET = ["4", "5", "77", "12", "51", "38", "87", "6"]
# a rank's address-space cap: a statement whose capacities outgrow it
# fails that rank instead of the machine
RANK_MEMORY_BYTES = 8 << 30
# the skewed fact table of the overflow check
SKEW_ROWS = 4096


# ------------------------------------------------------------ the ranks

def _nds_h_tables():
    from nds_tpu_torch.datagen import tpch
    from nds_tpu_torch.io.host_table import from_arrays
    from nds_tpu_torch.nds_h.schema import get_schemas
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], tpch.gen_table(t, SF))
            for t in schemas}


def _nds_tables():
    from nds_tpu_torch.datagen import tpcds
    from nds_tpu_torch.io.host_table import from_arrays
    from nds_tpu_torch.nds.schema import get_schemas
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], tpcds.gen_table(t, SF))
            for t in schemas}


def _run_units(session, units) -> dict:
    """{unit: (result frame, kernel block, slack retries)}."""
    out = {}
    for name, stmts in units:
        res = None
        for s in stmts:
            r = session.sql(s)
            if r is not None:
                res = r
        ex = session._executor_factory(session.tables)
        lt = ex.last_timings
        out[name] = (res.to_pandas(), dict(lt.get("__kernels") or {}),
                     lt.get("slack_retries"))
    return out


def _session(suite, factory, tables):
    from nds_tpu_torch.engine.session import Session
    s = (Session.for_nds_h(factory) if suite == "nds_h"
         else Session.for_nds(factory))
    for t in tables.values():
        s.register_table(t)
    return s


def _nds_h_units(qns):
    from nds_tpu_torch.nds_h import streams
    return [(str(q), streams.statements(q)) for q in qns]


def _nds_units(names):
    from nds_tpu_torch.nds import streams
    units = dict(streams.power_units())
    return [(n, units[n]) for n in names]


def skew_catalog(pkg: str = "nds_tpu_torch"):
    """A fact table whose group key is 7 on two rows of five: at a slack
    of 0.5 the rank that owns key 7 overflows its bucket, and it takes
    two doublings to fit. ``pkg`` names the package whose catalog and
    table types hold it: the port's on the ranks, ``nds_tpu`` for the
    oracle."""
    import importlib
    types = importlib.import_module(f"{pkg}.engine.types")
    from_arrays = importlib.import_module(f"{pkg}.io.host_table").from_arrays
    CatalogInfo = importlib.import_module(f"{pkg}.sql.planner").CatalogInfo
    INT32, INT64, Schema = types.INT32, types.INT64, types.Schema
    schema = Schema.of(("f_id", INT32, False), ("f_key", INT32, False),
                       ("f_val", INT64, False))
    rng = np.random.default_rng(17)
    key = np.where(rng.random(SKEW_ROWS) < 0.4, 7,
                   rng.integers(0, 50, SKEW_ROWS)).astype(np.int32)
    arrays = {"f_id": np.arange(SKEW_ROWS, dtype=np.int32), "f_key": key,
              "f_val": rng.integers(0, 1000, SKEW_ROWS).astype(np.int64)}
    cat = CatalogInfo({"fact": schema}, {"fact": ["f_id"]},
                      {"fact": SKEW_ROWS})
    return cat, from_arrays("fact", schema, arrays)


SKEW_SQL = ("select f_key, count(*) c, sum(f_val) s from fact "
            "group by f_key order by f_key")


def exchange_inputs(world: int):
    """Seeded shards of the gloo exchange checks: keys with the high bit
    set, dead rows, and int32, int64, float64 and bool payloads."""
    rng = np.random.default_rng(23)
    n = world * 120
    key = (rng.integers(0, 2**62, n, dtype=np.int64)
           | np.int64(-(2**63)) * (rng.random(n) < 0.5))
    ok = rng.random(n) >= 0.1
    dest = np.where(rng.random(n) < 0.4, 0,
                    rng.integers(0, world, n)).astype(np.int32)
    pays = [rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(-2**62, 2**62, n).astype(np.int64),
            rng.standard_normal(n), rng.random(n) < 0.5]
    return key, ok, dest, pays


EXCHANGE_SLACK = {"flat": 2.0, "by_dest": 1.0, "hierarchical": 1.5}


def _exchanges(rank: int, world: int, mesh2) -> dict:
    import torch
    from nds_tpu_torch.parallel import exchange as PX
    from nds_tpu_torch.parallel.mesh import DATA_AXIS, HOST_AXIS, make_mesh
    key, ok, dest, pays = exchange_inputs(world)
    local = key.shape[0] // world
    sl = slice(rank * local, (rank + 1) * local)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[sl]))

    axis = make_mesh(world, device="cpu").axis(DATA_AXIS)
    ps = [t(p) for p in pays]
    runs = {
        "flat": PX.exchange(ps, t(key), t(ok), world,
                            EXCHANGE_SLACK["flat"], axis),
        "by_dest": PX.exchange_by_dest(ps, t(dest), t(ok), world,
                                       EXCHANGE_SLACK["by_dest"], axis),
        "hierarchical": PX.exchange_hierarchical(
            ps, t(key), t(ok), 2, world // 2,
            EXCHANGE_SLACK["hierarchical"], mesh2.axis(HOST_AXIS),
            mesh2.axis(DATA_AXIS)),
    }
    return {name: ([o.numpy() for o in outs], out_ok.numpy(), int(over))
            for name, (outs, out_ok, over) in runs.items()}


def rank_main(job: str, rank: int, world: int, out: str) -> None:
    import resource
    resource.setrlimit(resource.RLIMIT_AS,
                       (RANK_MEMORY_BYTES, RANK_MEMORY_BYTES))
    import torch
    torch.set_num_threads(1)
    from nds_tpu_torch.parallel import multihost
    from nds_tpu_torch.parallel.dist_exec import make_distributed_factory
    from nds_tpu_torch.parallel.mesh import make_multihost_mesh
    if world > 1:
        assert multihost.maybe_initialize(device="cpu")
    assert multihost.is_primary() == (rank == 0)
    res: dict = {}
    if job == "tier1":
        tables = _nds_h_tables()
        fac = make_distributed_factory(n_devices=world, device="cpu",
                                       shard_threshold=THRESHOLD)
        res["nds_h"] = _run_units(_session("nds_h", fac, tables),
                                  _nds_h_units(range(1, 23)))
        mesh2 = make_multihost_mesh(2, world // 2, device="cpu")
        fac2 = make_distributed_factory(mesh=mesh2, device="cpu",
                                        shard_threshold=THRESHOLD)
        res["hierarchical"] = _run_units(_session("nds_h", fac2, tables),
                                         _nds_h_units(HIER_QUERIES))
        from nds_tpu_torch.engine.session import Session
        cat, fact = skew_catalog()
        skew = Session(cat, make_distributed_factory(
            n_devices=world, device="cpu", shard_threshold=1000,
            slack=0.5))
        skew.register_table(fact)
        res["overflow"] = _run_units(skew, [("skew", [SKEW_SQL])])
        res["exchange"] = _exchanges(rank, world, mesh2)
        fac3 = make_distributed_factory(n_devices=world, device="cpu",
                                        shard_threshold=THRESHOLD)
        res["nds"] = _run_units(_session("nds", fac3, _nds_tables()),
                                _nds_units(NDS_SUBSET))
    elif job == "nds_all":
        from nds_tpu_torch.nds import streams
        fac = make_distributed_factory(n_devices=world, device="cpu",
                                       shard_threshold=THRESHOLD)
        res["nds"] = _run_units(_session("nds", fac, _nds_tables()),
                                streams.power_units())
    elif job == "one":
        fac = make_distributed_factory(n_devices=1, device="cpu",
                                       shard_threshold=THRESHOLD)
        ex = fac({})
        res["world"] = (ex.n_dev, ex.rank, ex.mesh.shape)
        res["nds_h"] = _run_units(_session("nds_h", fac, _nds_h_tables()),
                                  _nds_h_units(HIER_QUERIES))
    with open(out, "wb") as f:
        pickle.dump(res, f)


# ------------------------------------------------------------- the test

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(job: str, world: int, tmp: pathlib.Path, env_world: bool,
            limit_s: float) -> list:
    """Run ``job`` on ``world`` ranks; every rank's results, in rank
    order. Kills the ranks and fails on a timeout or a failed rank."""
    port = _free_port()
    procs, outs = [], []
    for rank in range(world):
        env = dict(os.environ)
        env.pop("NDS_TPU_COORDINATOR", None)
        env.update(NDS_TPU_DIST_TIMEOUT_S=str(TIMEOUT_S),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        if env_world:
            env.update(NDS_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       NDS_TPU_NUM_PROCESSES=str(world),
                       NDS_TPU_PROCESS_ID=str(rank))
        out = tmp / f"{job}-rank{rank}.pkl"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, job, str(rank), str(world), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=limit_s)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{job}: the ranks did not finish in {limit_s} s")
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {rank}:\n{log[-6000:]}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _launch("tier1", WORLD, tmp_path_factory.mktemp("dist"), True,
                   limit_s=600)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    return _launch("one", 1, tmp_path_factory.mktemp("one"), False,
                   limit_s=300)[0]


@pytest.fixture(scope="module")
def oracle():
    """The reference's CPU oracle, ``nds_tpu``'s ``Session`` and its
    ``CpuExecutor``, over the reference generator's SF0.01 tables (the
    ranks run the port's copy of that generator): NDS-H and NDS."""
    from nds_tpu.datagen import tpcds, tpch
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.io.host_table import from_arrays
    from nds_tpu.nds.schema import get_schemas as nds_schemas
    from nds_tpu.nds_h.schema import get_schemas as nds_h_schemas
    out = {}
    for suite, make, gen, schemas in (
            ("nds_h", RefSession.for_nds_h, tpch, nds_h_schemas()),
            ("nds", RefSession.for_nds, tpcds, nds_schemas())):
        sess = make()
        for t in schemas:
            sess.register_table(from_arrays(t, schemas[t],
                                            gen.gen_table(t, SF)))
        out[suite] = sess
    return out


def _ref_nds_h_stmts(qn):
    from nds_tpu.nds_h import streams as ref_streams
    return ref_streams.statements(qn)


def _oracle_frame(session, stmts):
    res = None
    for s in stmts:
        r = session.sql(s)
        if r is not None:
            res = r
    return res.to_pandas()


def _check_unit(results, part, unit, exp, rules="nds_h"):
    from nds_tpu_torch.nds.validate import unit_differs
    from nds_tpu_torch.utils.validate_core import frames_equal
    for rank, res in enumerate(results):
        got = res[part][unit][0]
        why = (unit_differs(got, exp, unit) if rules == "nds"
               else frames_equal(got, exp))
        assert why is None, f"{part} {unit} rank {rank}: {why}"


@pytest.mark.parametrize("qn", range(1, 23))
def test_nds_h_query_matches_oracle(qn, ranks, oracle):
    _check_unit(ranks, "nds_h", str(qn),
                _oracle_frame(oracle["nds_h"], _ref_nds_h_stmts(qn)))


@pytest.fixture(scope="module")
def jax_dist_session():
    """The JAX DistributedExecutor on 4 virtual CPU devices, over the
    reference generator's data (the port's generator is its copy)."""
    from nds_tpu.datagen import tpch
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.io.host_table import from_arrays
    from nds_tpu.nds_h.schema import get_schemas
    from nds_tpu.parallel.dist_exec import (
        make_distributed_factory as ref_factory,
    )
    schemas = get_schemas()
    sess = RefSession.for_nds_h(ref_factory(n_devices=WORLD,
                                            shard_threshold=THRESHOLD))
    for t in schemas:
        sess.register_table(from_arrays(t, schemas[t],
                                        tpch.gen_table(t, SF)))
    return sess


@pytest.mark.parametrize("qn", [
    q if q in KERNEL_QUERIES else pytest.param(q, marks=pytest.mark.slow)
    for q in range(1, 23)])
def test_kernel_block_matches_jax_distributed(qn, ranks, jax_dist_session):
    from nds_tpu.nds_h import streams as ref_streams
    for s in ref_streams.statements(qn):
        jax_dist_session.sql(s)
    ex = jax_dist_session._executor_factory(jax_dist_session.tables)
    exp = dict(ex.last_timings.get("__kernels") or {})
    for rank, res in enumerate(ranks):
        got = res["nds_h"][str(qn)][1]
        assert got == exp, f"q{qn} rank {rank}: {got} vs JAX {exp}"


@pytest.mark.parametrize("qn", HIER_QUERIES)
def test_hierarchical_mesh_matches_oracle(qn, ranks, oracle):
    _check_unit(ranks, "hierarchical", str(qn),
                _oracle_frame(oracle["nds_h"], _ref_nds_h_stmts(qn)))


def test_overflow_retries_on_every_rank(ranks):
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu_torch.utils.validate_core import frames_equal
    cat, fact = skew_catalog("nds_tpu")
    cpu = RefSession(cat)
    cpu.register_table(fact)
    exp = cpu.sql(SKEW_SQL).to_pandas()
    for rank, res in enumerate(ranks):
        got, _kernels, retries = res["overflow"]["skew"]
        assert retries and retries >= 1, f"rank {rank} did not retry"
        assert frames_equal(got, exp) is None, f"rank {rank}"
    assert len({res["overflow"]["skew"][2] for res in ranks}) == 1


def _jax_exchanges(world: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from nds_tpu.parallel import exchange as REF
    from nds_tpu.parallel.dist_exec import shard_map
    from nds_tpu.parallel.mesh import (
        DATA_AXIS, HOST_AXIS, make_mesh, make_multihost_mesh,
    )
    key, ok, dest, pays = exchange_inputs(world)
    m = len(pays)
    out = {}
    for name in ("flat", "by_dest"):
        slack = EXCHANGE_SLACK[name]

        def fn(k, o, *ps, name=name, slack=slack):
            f = REF.exchange if name == "flat" else REF.exchange_by_dest
            outs, oko, over = f(list(ps), k, o, world, slack)
            return (*outs, oko, over.reshape(1))

        spec = PS(DATA_AXIS)
        f = shard_map(fn, mesh=make_mesh(world), in_specs=(spec,) * (2 + m),
                      out_specs=(spec,) * (m + 2))
        route = key if name == "flat" else dest
        out[name] = [np.asarray(r) for r in jax.jit(f)(
            jnp.asarray(route), jnp.asarray(ok),
            *[jnp.asarray(p) for p in pays])]
    H, D = 2, world // 2
    both = PS((HOST_AXIS, DATA_AXIS))
    per = key.shape[0] // world

    def hfn(k, o, *ps):
        outs, oko, over = REF.exchange_hierarchical(
            [p.reshape(-1) for p in ps], k.reshape(-1), o.reshape(-1), H, D,
            slack=EXCHANGE_SLACK["hierarchical"])
        c = oko.shape[0]
        return (*[x.reshape(1, c) for x in outs], oko.reshape(1, c),
                jnp.reshape(over, (1, 1)))

    f = shard_map(hfn, mesh=make_multihost_mesh(H, D),
                  in_specs=(both,) * (2 + m), out_specs=(both,) * (m + 2))
    out["hierarchical"] = [np.asarray(r).reshape(-1) for r in jax.jit(f)(
        jnp.asarray(key).reshape(world, per),
        jnp.asarray(ok).reshape(world, per),
        *[jnp.asarray(p).reshape(world, per) for p in pays])]
    return out


@pytest.mark.parametrize("name", ["flat", "by_dest", "hierarchical"])
def test_gloo_exchange_matches_jax(name, ranks):
    exp = _jax_exchanges(WORLD)[name]
    outs = [np.concatenate([r["exchange"][name][0][i] for r in ranks])
            for i in range(len(exp) - 2)]
    got = outs + [np.concatenate([r["exchange"][name][1] for r in ranks]),
                  np.array([r["exchange"][name][2] for r in ranks])]
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g.dtype == e.dtype and g.shape == e.shape, (name, i)
        np.testing.assert_array_equal(g.view(np.uint8), e.view(np.uint8),
                                      err_msg=f"{name} output {i}")
    if name == "by_dest":
        assert exp[-1].sum() > 0, "the by_dest check must overflow"


@pytest.mark.parametrize("unit", NDS_SUBSET)
def test_nds_statement_matches_oracle(unit, ranks, oracle):
    (_name, stmts), = _nds_units([unit])
    _check_unit(ranks, "nds", unit, _oracle_frame(oracle["nds"], stmts),
                rules="nds")


def test_nds_subset_reaches_the_nds_paths(ranks):
    seen: dict = {}
    for _frame, kernels, _r in ranks[0]["nds"].values():
        for k, v in kernels.items():
            seen[k] = seen.get(k, 0) + v
    assert seen.get("join.partitioned", 0) > 0, seen


# all 103 statements run on two ranks: on four, q72's exchange overflows,
# and its retry at a doubled slack doubles every exchanged capacity of its
# join chain again, past a rank's memory cap
NDS_ALL_WORLD = 2


@pytest.fixture(scope="module")
def nds_all_ranks(tmp_path_factory):
    return _launch("nds_all", NDS_ALL_WORLD, tmp_path_factory.mktemp("nds"),
                   True, limit_s=3000)


def _all_nds_units():
    from nds_tpu_torch.nds import streams
    return [name for name, _ in streams.power_units()]


@pytest.mark.slow
@pytest.mark.parametrize("unit", _all_nds_units())
def test_all_nds_statements_match_oracle(unit, nds_all_ranks, oracle):
    (_name, stmts), = _nds_units([unit])
    _check_unit(nds_all_ranks, "nds", unit,
                _oracle_frame(oracle["nds"], stmts), rules="nds")


def test_exchanges_ship_only_the_columns_read_above():
    """q3's lineitem scan: the exchange above it ships the columns that
    the join, the aggregate and the result read, not the filter-only
    ``l_shipdate``."""
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.parallel.dist_exec import needed_above
    from nds_tpu_torch.sql import plan as P
    (_name, stmts), = _nds_h_units([3])
    planned = Session.for_nds_h().plan(stmts[0])
    need = needed_above(planned)
    scans = [n for n in P.walk_plan(planned.root)
             if isinstance(n, P.Scan) and n.table == "lineitem"]
    assert len(scans) == 1
    scan = scans[0]
    cols = {name for b, name in need[id(scan)] if b == scan.binding}
    assert {"l_orderkey", "l_extendedprice", "l_discount"} <= cols
    assert "l_shipdate" in {name for name, _ in scan.output}
    assert "l_shipdate" not in cols
    root = planned.root
    assert need[id(root)] == {(root.binding, n) for n, _ in root.output}


def test_world_of_one_on_the_cpu(world_of_one, oracle):
    assert world_of_one["world"] == (1, 0, (1,))
    for qn in HIER_QUERIES:
        _check_unit([world_of_one], "nds_h", str(qn),
                    _oracle_frame(oracle["nds_h"], _ref_nds_h_stmts(qn)))


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
