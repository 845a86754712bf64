"""Parity of the port's five kernels with the JAX package's on the CPU.

Each case makes its inputs from a seed with numpy, runs them through
``nds_tpu.engine.kernels.<fn>`` on jax CPU (x64, as the reference's own
kernel tests run) and through the port's dispatching wrapper in
``nds_tpu_torch.engine.kernels`` on torch CPU, which takes the plain
PyTorch version there. Results must be exactly equal: ints and bools
bit for bit, and min/max floats too (a min or a max is exact).

The inputs keep the kernels' contract as the executors call them: the
key domain ``[lo, lo + dom)`` covers every valid build key (it comes
from host bounds of both sides), probe keys may fall anywhere, and
direct/matmul builds are unique among valid rows. Where the JAX
function's behaviour on duplicates is defined by its arithmetic
(``matmul_probe_join``'s sums, the min/max tables), duplicates are
cases too.
"""

import jax
import numpy as np
import pytest
import torch

from nds_tpu.engine import kernels as REF
from nds_tpu_torch.engine import kernels as KX

jax.config.update("jax_enable_x64", True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unique_build(rng, nb, lo, dom, kdt, valid_frac=0.8):
    keys = rng.choice(dom, size=nb, replace=False).astype(np.int64) + lo
    ok = rng.random(nb) < valid_frac
    # invalid rows carry arbitrary keys, in or out of the domain
    junk = rng.integers(lo - 3 * dom, lo + 4 * dom, size=nb)
    keys = np.where(ok, keys, junk)
    return keys.astype(kdt), ok


def _probe(rng, n, lo, dom, kdt):
    # below lo, inside, and at or above lo + dom
    keys = rng.integers(lo - dom, lo + 2 * dom, size=n).astype(kdt)
    keys[:3] = np.array([lo - 1, lo + dom, lo + dom - 1]).astype(kdt)
    ok = rng.random(n) < 0.9
    return keys, ok


DOMAIN_CASES = {
    # name: (seed, nb, n_probe, lo, dom, key dtype, build valid fraction)
    "int32": (1, 40, 300, 5, 64, np.int32, 0.8),
    "int64_wide": (2, 50, 300, 10**10, 200, np.int64, 0.8),
    "negative_keys": (3, 30, 200, -120, 90, np.int32, 0.8),
    "dom_1": (4, 1, 50, 7, 1, np.int64, 1.0),
    "empty_valid_build": (5, 20, 100, 0, 40, np.int32, 0.0),
    "all_valid_dense": (6, 128, 500, 1, 128, np.int32, 1.0),
}


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_direct_lookup_join_matches_reference(case):
    seed, nb, npr, lo, dom, kdt, vf = DOMAIN_CASES[case]
    rng = np.random.default_rng(seed)
    bkey, bok = _unique_build(rng, nb, lo, dom, kdt, vf)
    pkey, pok = _probe(rng, npr, lo, dom, kdt)
    r_ridx, r_hit = REF.direct_lookup_join(bkey, bok, pkey, pok, lo, dom)
    ridx, hit = KX.direct_lookup_join(_t(bkey), _t(bok), _t(pkey), _t(pok),
                                      lo, dom)
    assert ridx.dtype == torch.int32 and hit.dtype == torch.bool
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(r_ridx))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_bitmask_semi_matches_reference(case):
    seed, nb, npr, lo, dom, kdt, vf = DOMAIN_CASES[case]
    rng = np.random.default_rng(seed + 100)
    bkey, bok = _unique_build(rng, nb, lo, dom, kdt, vf)
    # membership tolerates duplicate build keys
    bkey = np.concatenate([bkey, bkey[: nb // 2]])
    bok = np.concatenate([bok, bok[: nb // 2]])
    pkey, pok = _probe(rng, npr, lo, dom, kdt)
    ref = REF.bitmask_semi(bkey, bok, pkey, pok, lo, dom)
    got = KX.bitmask_semi(_t(bkey), _t(bok), _t(pkey), _t(pok), lo, dom)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


MATMUL_CASES = {
    # name: (seed, nb, n_probe, key dtype, duplicate keys)
    "build_1": (11, 1, 200, np.int32, False),
    "build_64": (12, 64, 400, np.int32, False),
    "build_256": (13, 256, 600, np.int64, False),
    "build_256_int32": (14, 256, 300, np.int32, False),
    "negative_keys": (15, 25, 200, np.int64, False),
    "duplicate_keys": (16, 40, 300, np.int32, True),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_matmul_probe_join_matches_reference(case):
    seed, nb, npr, kdt, dup = MATMUL_CASES[case]
    rng = np.random.default_rng(seed)
    lo = -50 if case == "negative_keys" else 0
    bkey = (rng.choice(4 * nb, size=nb, replace=False) + lo).astype(kdt)
    if dup:
        bkey[nb // 2:] = bkey[: nb - nb // 2]
    bok = rng.random(nb) < 0.85
    pkey = (rng.integers(0, 5 * nb, size=npr) + lo).astype(kdt)
    pok = rng.random(npr) < 0.9
    r_ridx, r_hit = REF.matmul_probe_join(bkey, bok, pkey, pok)
    ridx, hit = KX.matmul_probe_join(_t(bkey), _t(bok), _t(pkey), _t(pok))
    assert ridx.dtype == torch.int32 and hit.dtype == torch.bool
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(r_ridx))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))


MINMAX_CASES = {
    # name: (seed, nb, n_probe, lo, dom, key dtype, value dtype)
    "int32_int32": (21, 200, 300, 1, 50, np.int32, np.int32),
    "int32_int64": (22, 200, 300, 1, 50, np.int32, np.int64),
    "int64_int64": (23, 150, 300, 10**9, 40, np.int64, np.int64),
    "int64_int32": (24, 150, 300, -30, 40, np.int64, np.int32),
    "dom_1": (25, 10, 60, 3, 1, np.int32, np.int32),
    "empty_valid_build": (26, 40, 80, 0, 20, np.int32, np.int64),
}


@pytest.mark.parametrize("case", sorted(MINMAX_CASES))
def test_keyed_minmax_semi_matches_reference(case):
    seed, nb, npr, lo, dom, kdt, vdt = MINMAX_CASES[case]
    rng = np.random.default_rng(seed)
    # duplicate keys are the point: several build rows per key, some
    # with one value only, so [min, max] == [v, v] happens
    bkey = (rng.integers(0, dom, size=nb) + lo).astype(kdt)
    bok = rng.random(nb) < (0.0 if case == "empty_valid_build" else 0.8)
    bval = rng.integers(-3, 4, size=nb).astype(vdt)
    single = (bkey - lo) % 3 == 0
    bval = np.where(single, (bkey - lo).astype(vdt), bval).astype(vdt)
    pkey, pok = _probe(rng, npr, lo, dom, kdt)
    pval = rng.integers(-3, 4, size=npr).astype(vdt)
    pval[: npr // 3] = (pkey[: npr // 3].astype(np.int64) - lo).astype(vdt)
    ref = REF.keyed_minmax_semi(bkey, bok, bval, pkey, pok, pval, lo, dom)
    got = KX.keyed_minmax_semi(_t(bkey), _t(bok), _t(bval), _t(pkey),
                               _t(pok), _t(pval), lo, dom)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _grouped_rows(rng, n, sizes, G, vdt, op):
    """Rows as ``_agg_grouped`` hands them to the kernel: present rows
    first in sorted group order, the tail (absent rows) carrying the
    op's identity and the last group's id, ``starts2`` = first sorted
    row per group slot (n for the padding slots past the last group)."""
    present = int(sum(sizes))
    gid = np.concatenate([np.full(s, g, dtype=np.int32)
                          for g, s in enumerate(sizes)]
                         + [np.full(n - present, len(sizes) - 1,
                                    dtype=np.int32)])
    gid = np.minimum(gid, G - 1).astype(np.int32)
    if np.issubdtype(vdt, np.floating):
        vals = rng.normal(0, 100, size=n).astype(vdt)
        ident = np.inf if op == "min" else -np.inf
    else:
        info = np.iinfo(vdt)
        vals = rng.integers(-1000, 1000, size=n).astype(vdt)
        ident = info.max if op == "min" else info.min
    data = np.where(np.arange(n) < present, vals, ident).astype(vdt)
    starts2 = np.searchsorted(gid, np.arange(G, dtype=np.int32))
    return data, gid, starts2


SCAN_CASES = {
    # name: (seed, n, group sizes, G, value dtype, op)
    "one_group_max": (31, 300, [300], 1, np.int64, "max"),
    "one_group_padded": (32, 300, [250], 8, np.int32, "min"),
    "singletons_min": (33, 257, [1] * 257, 257, np.int64, "min"),
    "singletons_f64_max": (34, 129, [1] * 100, 129, np.float64, "max"),
    "mixed_f64_min": (35, 3000, [1, 7, 1024, 3, 500, 1, 900], 12,
                      np.float64, "min"),
    "mixed_int32_max": (36, 2100, [1023, 1, 1025, 50], 6, np.int32, "max"),
    "mixed_int64_min_tail": (37, 5000, [17] * 200, 260, np.int64, "min"),
    "f32_max": (38, 700, [300, 300], 4, np.float32, "max"),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_seg_reduce_at_ends_matches_reference(case):
    import jax.numpy as jnp
    seed, n, sizes, G, vdt, op = SCAN_CASES[case]
    rng = np.random.default_rng(seed)
    data, gid, starts2 = _grouped_rows(rng, n, sizes, G, vdt, op)
    jop = jnp.minimum if op == "min" else jnp.maximum
    # jitted: op-by-op dispatch of the associative scan takes seconds
    ref = np.asarray(jax.jit(REF.seg_reduce_at_ends, static_argnums=0)(
        jop, jnp.asarray(data), jnp.asarray(gid), jnp.asarray(starts2)))
    got = KX.seg_reduce_at_ends(op, _t(data), _t(gid), _t(starts2))
    assert got.dtype == _t(data).dtype and got.shape == (G,)
    # every slot, the padding slots past the last group included
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(41)
    bkey, bok = _unique_build(rng, 20, 0, 32, np.int32)
    pkey, pok = _probe(rng, 50, 0, 32, np.int32)
    KX.reset_launches()
    got = KX.direct_lookup_join(_t(bkey), _t(bok), _t(pkey), _t(pok), 0, 32)
    plain = KX.direct_lookup_join_plain(_t(bkey), _t(bok), _t(pkey),
                                        _t(pok), 0, 32)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert set(KX.launch_counts()) == {
        "direct_lookup_join", "matmul_probe_join", "bitmask_semi",
        "keyed_minmax_semi", "seg_reduce_at_ends", "partitioned_mn_join",
        "partition_sort", "seg_scan", "part_reduce_broadcast",
        "last_of_group", "running_max", "pack_group_key", "group_bounds",
        "pack_sort_key", "sorted_search", "compact_perm",
        "bitpack_decode", "unpack_mask", "rle_decode", "exchange_pack"}
    assert all(v == 0 for v in KX.launch_counts().values())
