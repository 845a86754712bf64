"""The port's hash-partition exchange against the JAX package's, exactly.

``nds_tpu_torch.parallel.exchange`` (``exchange``, ``exchange_by_dest``,
``exchange_hierarchical``) packs its send buffers with
``kernels.exchange_pack``, which takes its plain version on CPU tensors.
Here every rank of a 4-, 8- or 2 x 2-rank mesh runs in a thread of this
process with its own shard, and the all-to-all is an in-process
transpose of the buckets (``ThreadAxis``): chunk ``j`` of rank ``i``'s
send buffer becomes chunk ``i`` of rank ``j``'s receive buffer, as
``lax.all_to_all(x, axis, 0, 0)`` does. The same shards go through
``nds_tpu.parallel.exchange`` under ``shard_map`` on 4 and 8 virtual CPU
devices and on a 2 x 2 (host, lane) mesh. Every output buffer, ``out_ok``
and the overflow count must be equal bit for bit, with dead rows, a slack
that overflows, keys with the high bit set, and int32, int64, float64 and
bool payloads.

``dist_exec.shard_of`` must give each rank the very rows (and null-mask
rows) that the reference ``DistributedExecutor`` places on that device.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nds_tpu.parallel import exchange as REF
from nds_tpu.parallel.dist_exec import shard_map
from nds_tpu.parallel.mesh import (
    DATA_AXIS, HOST_AXIS, make_mesh, make_multihost_mesh,
)
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.parallel import exchange as PX
from nds_tpu_torch.parallel.dist_exec import shard_of


class _Hub:
    """The rendezvous of one axis' threads."""

    def __init__(self, size: int):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class ThreadAxis:
    """An ``AxisGroup`` whose ranks are threads of this process: the
    all-to-all is a transpose of the buckets through a shared hub."""

    def __init__(self, hub: _Hub, index: int):
        self.hub = hub
        self.size = hub.size
        self.index = index

    def all_to_all(self, t):
        hub = self.hub
        hub.slots[self.index] = t
        hub.barrier.wait()
        out = torch.cat([hub.slots[i].reshape(self.size, -1)[self.index]
                         for i in range(self.size)])
        hub.barrier.wait()
        return out


def _on_ranks(n: int, fn, hubs):
    """fn(rank) for every rank, each in a thread; their results in rank
    order. A failing rank breaks the hubs' barriers so that no thread
    waits forever."""
    out = [None] * n
    errors = []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            for hub in hubs:
                hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


def _gathered(out, n_pays: int):
    """Per-rank (outs, out_ok, overflow) as the global arrays shard_map
    returns: buffers and out_ok concatenated in rank order, one overflow
    per rank."""
    outs = [np.concatenate([o[0][i].numpy() for o in out])
            for i in range(n_pays)]
    return outs + [np.concatenate([o[1].numpy() for o in out]),
                   np.array([int(o[2]) for o in out])]


# ---------------------------------------------------------------- inputs

def _inputs(seed: int, n: int, keyspace: str, dead: float):
    rng = np.random.default_rng(seed)
    if keyspace == "high_bit":
        # every key sets bit 63 or bit 62: a signed % or shift would err
        key = (rng.integers(0, 2**62, n, dtype=np.int64)
               | np.int64(-(2**63)) * (rng.random(n) < 0.5)
               | np.int64(2**62) * (rng.random(n) < 0.5))
    elif keyspace == "skewed":
        # one key holds about half of the rows: its destination overflows
        key = np.where(rng.random(n) < 0.5, 7,
                       rng.integers(0, 1000, n)).astype(np.int64)
    else:
        key = rng.integers(0, 5000, n).astype(np.int64)
    ok = rng.random(n) >= dead
    pays = [rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(-2**62, 2**62, n).astype(np.int64),
            rng.standard_normal(n),
            rng.random(n) < 0.5]
    return key, ok, pays


def _jax_flat(n_dev, key, ok, pays, slack, dest=None):
    mesh = make_mesh(n_dev)
    spec = P(DATA_AXIS)
    m = len(pays)

    def fn(k, o, *ps):
        if dest is None:
            outs, oko, over = REF.exchange(list(ps), k, o, n_dev, slack)
        else:
            outs, oko, over = REF.exchange_by_dest(list(ps), k, o, n_dev,
                                                   slack)
        return (*outs, oko, over.reshape(1))

    f = shard_map(fn, mesh=mesh, in_specs=(spec,) * (2 + m),
                  out_specs=(spec,) * (m + 2))
    route = key if dest is None else dest
    res = jax.jit(f)(jnp.asarray(route), jnp.asarray(ok),
                     *[jnp.asarray(p) for p in pays])
    return [np.asarray(r) for r in res]


def _port_flat(n_dev, key, ok, pays, slack, dest=None):
    local = key.shape[0] // n_dev
    hub = _Hub(n_dev)

    def rank(r):
        sl = slice(r * local, (r + 1) * local)
        axis = ThreadAxis(hub, r)
        ps = [torch.from_numpy(p[sl].copy()) for p in pays]
        o = torch.from_numpy(ok[sl].copy())
        if dest is None:
            return PX.exchange(ps, torch.from_numpy(key[sl].copy()), o,
                               n_dev, slack, axis=axis)
        return PX.exchange_by_dest(ps, torch.from_numpy(dest[sl].copy()), o,
                                   n_dev, slack, axis=axis)

    return _gathered(_on_ranks(n_dev, rank, [hub]), len(pays))


def _assert_same(got, exp, what):
    assert len(got) == len(exp), what
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g.dtype == e.dtype, f"{what} output {i}: {g.dtype} {e.dtype}"
        assert g.shape == e.shape, f"{what} output {i}: {g.shape} {e.shape}"
        # bitwise: floats must keep their bits through the pack
        np.testing.assert_array_equal(g.view(np.uint8), e.view(np.uint8),
                                      err_msg=f"{what} output {i}")


FLAT_CASES = [
    # (n_dev, rows per rank, keyspace, dead share, slack)
    (4, 96, "uniform", 0.1, 2.0),
    (4, 96, "high_bit", 0.3, 2.0),
    (4, 96, "skewed", 0.1, 1.0),
    (8, 64, "uniform", 0.0, 2.0),
    (8, 64, "high_bit", 0.1, 1.5),
    (8, 64, "skewed", 0.2, 0.75),
]


@pytest.mark.parametrize("case", FLAT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_exchange_matches_jax(case):
    n_dev, local, keyspace, dead, slack = case
    key, ok, pays = _inputs(n_dev * 1000 + local, n_dev * local, keyspace,
                            dead)
    exp = _jax_flat(n_dev, key, ok, pays, slack)
    got = _port_flat(n_dev, key, ok, pays, slack)
    _assert_same(got, exp, f"exchange {case}")
    if keyspace == "skewed":
        assert exp[-1].sum() > 0, "the skewed case must overflow"


@pytest.mark.parametrize("n_dev", [4, 8])
def test_exchange_by_dest_matches_jax(n_dev):
    n = n_dev * 80
    key, ok, pays = _inputs(n_dev, n, "uniform", 0.15)
    rng = np.random.default_rng(n_dev + 5)
    # a destination that favours rank 0, so that a slack of 1 overflows
    dest = np.where(rng.random(n) < 0.4, 0,
                    rng.integers(0, n_dev, n)).astype(np.int32)
    for slack in (2.0, 1.0):
        exp = _jax_flat(n_dev, key, ok, pays, slack, dest=dest)
        got = _port_flat(n_dev, key, ok, pays, slack, dest=dest)
        _assert_same(got, exp, f"exchange_by_dest n_dev={n_dev} "
                               f"slack={slack}")
    assert exp[-1].sum() > 0


def _jax_hier(H, D, key, ok, pays, slack):
    mesh = make_multihost_mesh(H, D)
    both = P((HOST_AXIS, DATA_AXIS))
    m = len(pays)
    per = key.shape[0] // (H * D)

    def fn(k, o, *ps):
        k, o = k.reshape(-1), o.reshape(-1)
        outs, oko, over = REF.exchange_hierarchical(
            [p.reshape(-1) for p in ps], k, o, H, D, slack=slack)
        c = oko.shape[0]
        return (*[x.reshape(1, c) for x in outs], oko.reshape(1, c),
                jnp.reshape(over, (1, 1)))

    f = shard_map(fn, mesh=mesh, in_specs=(both,) * (2 + m),
                  out_specs=(both,) * (m + 2))
    res = jax.jit(f)(jnp.asarray(key).reshape(H * D, per),
                     jnp.asarray(ok).reshape(H * D, per),
                     *[jnp.asarray(p).reshape(H * D, per) for p in pays])
    return [np.asarray(r).reshape(-1) for r in res]


def _port_hier(H, D, key, ok, pays, slack, key_index=None):
    per = key.shape[0] // (H * D)
    host_hubs = [_Hub(H) for _ in range(D)]
    lane_hubs = [_Hub(D) for _ in range(H)]

    def rank(r):
        h, d = divmod(r, D)
        sl = slice(r * per, (r + 1) * per)
        ps = [torch.from_numpy(p[sl].copy()) for p in pays]
        k = torch.from_numpy(key[sl].copy())
        if key_index is not None:
            ps = ps + [k]
        outs, oko, over = PX.exchange_hierarchical(
            ps, k, torch.from_numpy(ok[sl].copy()), H, D, slack,
            host_axis=ThreadAxis(host_hubs[d], h),
            lane_axis=ThreadAxis(lane_hubs[h], d),
            key_index=None if key_index is None else len(ps) - 1)
        return outs[:len(pays)], oko, over

    return _gathered(_on_ranks(H * D, rank, host_hubs + lane_hubs),
                     len(pays))


@pytest.mark.parametrize("case", [("uniform", 0.1, 2.0, None),
                                  ("high_bit", 0.2, 3.0, "carried"),
                                  ("skewed", 0.1, 1.0, None)],
                         ids=lambda c: "-".join(map(str, c)))
def test_exchange_hierarchical_matches_jax(case):
    keyspace, dead, slack, carried = case
    H, D, per = 2, 2, 128
    key, ok, pays = _inputs(99, H * D * per, keyspace, dead)
    exp = _jax_hier(H, D, key, ok, pays, slack)
    got = _port_hier(H, D, key, ok, pays, slack,
                     key_index=None if carried is None else -1)
    _assert_same(got, exp, f"exchange_hierarchical {case}")
    if keyspace == "skewed":
        assert exp[-1].sum() > 0


def test_mix64_and_unsigned_mod_match_jax():
    """splitmix64 in int64 bits and the exact unsigned modulus, over keys
    at the edges of the int64 range."""
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        np.array([0, 1, -1, 2**63 - 1, -(2**63), 2**62, -(2**62)],
                 dtype=np.int64),
        rng.integers(-(2**63), 2**63 - 1, 500, dtype=np.int64)])
    exp = np.asarray(REF._mix64(jnp.asarray(keys)))
    got = KX.mix64_plain(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, exp)
    for m in (1, 2, 3, 4, 7, 8, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            KX._umod_plain(torch.from_numpy(exp.view(np.int64).copy()),
                           m).numpy(),
            (exp % np.uint64(m)).astype(np.int64))


def test_pack_counts_no_launch_on_the_cpu_and_refuses_other_devices():
    key, ok, pays = _inputs(1, 64, "uniform", 0.1)
    KX.reset_launches()
    got = KX.exchange_pack([torch.from_numpy(p) for p in pays],
                           torch.from_numpy(ok), 4, 40,
                           key=torch.from_numpy(key))
    exp = KX.exchange_pack_plain([torch.from_numpy(p) for p in pays],
                                 torch.from_numpy(ok), 4, 40,
                                 key=torch.from_numpy(key))
    for a, b in zip(got[0] + [got[1], got[2]], exp[0] + [exp[1], exp[2]]):
        assert torch.equal(a, b)
    assert KX.launch_counts()["exchange_pack"] == 0
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        KX.exchange_pack([meta], torch.zeros(4, dtype=torch.bool,
                                             device="meta"), 2, 4, key=meta)
    with pytest.raises(ValueError):
        KX.exchange_pack([], torch.from_numpy(ok), 2, 4)


# ------------------------------------------------------------ shard layout

def _ref_tables():
    from nds_tpu.datagen import tpch
    from nds_tpu.io.host_table import from_arrays
    from nds_tpu.nds_h.schema import get_schemas
    schemas = get_schemas()
    return {t: from_arrays(t, schemas[t], tpch.gen_table(t, 0.002))
            for t in ("orders", "customer", "nation")}


@pytest.mark.parametrize("n_dev", [4, 8])
def test_shard_of_matches_reference_device_shards(n_dev):
    from nds_tpu.io.host_table import HostColumn, HostTable
    from nds_tpu.parallel.dist_exec import DistributedExecutor
    tables = _ref_tables()
    # a nullable column of a length no mesh divides
    o = tables["orders"]
    n = o.nrows - 3
    rng = np.random.default_rng(n_dev)
    cols = {name: HostColumn(c.dtype, c.values[:n], c.dictionary,
                             null_mask=rng.random(n) >= 0.2)
            for name, c in o.columns.items()}
    tables["nulls"] = HostTable("nulls", o.schema, cols)
    ex = DistributedExecutor(tables, n_devices=n_dev, shard_threshold=100,
                             multiprocess=True)
    order = {d: i for i, d in enumerate(ex.mesh.devices.reshape(-1))}
    checked = 0
    for table in ("orders", "customer", "nulls"):
        assert ex._is_sharded(table)
        t = tables[table]
        for name in list(t.columns)[:3]:
            bufs = {}
            ex._upload(bufs, table, name)
            col = t.columns[name]
            for sfx, host in (("", col.values), ("#v", col.null_mask)):
                key = f"{table}.{name}{sfx}"
                if host is None:
                    assert key not in bufs
                    continue
                for shard in bufs[key].addressable_shards:
                    r = order[shard.device]
                    got = shard_of(host, r, n_dev)
                    exp = np.asarray(shard.data)
                    assert got.dtype == exp.dtype
                    np.testing.assert_array_equal(got, exp)
                    checked += 1
    assert checked >= 3 * 3 * n_dev
