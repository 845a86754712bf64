"""The gather joins K1 (``direct_lookup_join``) and K2
(``matmul_probe_join``) of the port on the CPU.

Their plain versions are held exactly to ``nds_tpu.engine.kernels`` on
inputs made from a seed with numpy: K1 with int64 keys beyond the int32
range and ``lo`` near them, K2 with int64 keys that differ only above bit
32 and with builds of 1 and 256 rows whose duplicate keys are partly
invalid. Beside them, the host's part of K2's design on the card: the
plain mirror of K2's hash (which ``chip_smoke.py`` uses to make keys that
collide in the kernel's table) against the hash computed another way,
and the smoke's profiled device time, the union of kernel spans that
overlap where K1's launches are dependent. The kernels themselves are
held to the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from nds_tpu.engine import kernels as REF
from nds_tpu_torch.engine import kernels as KX

jax.config.update("jax_enable_x64", True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, ref):
    ridx, hit = got
    r_ridx, r_hit = ref
    assert ridx.dtype == torch.int32 and hit.dtype == torch.bool
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(r_ridx))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))


WIDE_K1 = {
    # name: (seed, lo, dom, n_build, n_probe)
    "lo_2^33": (1, (1 << 33) + 5, 500, 200, 400),
    "lo_below_-2^40": (2, -(1 << 40) - 77, 300, 120, 300),
    "lo_iinfo_edge": (3, np.iinfo(np.int64).max - 1000, 900, 300, 500),
}


@pytest.mark.parametrize("case", sorted(WIDE_K1))
def test_direct_lookup_join_keys_beyond_int32(case):
    """int64 keys far outside the int32 range, ``lo`` near them: probe
    keys 2^32 above or below a key of the domain (equal to it in the low
    32 bits) must miss, and the domain's ends must hold."""
    seed, lo, dom, nb, npr = WIDE_K1[case]
    rng = np.random.default_rng(seed)
    bkey = rng.choice(dom, nb, replace=False).astype(np.int64) + lo
    bok = rng.random(nb) < 0.8
    bkey = np.where(bok, bkey, bkey[::-1])  # invalid rows: valid rows' keys
    inside = rng.integers(0, dom, npr) + lo
    shifted = inside + np.where(rng.random(npr) < 0.5, 1 << 32, -(1 << 32))
    pkey = np.where(rng.random(npr) < 0.5, inside,
                    np.clip(shifted, None, np.iinfo(np.int64).max))
    pkey[:4] = [lo - 1, lo, lo + dom - 1, lo + dom]
    pok = rng.random(npr) < 0.9
    _same(KX.direct_lookup_join(_t(bkey), _t(bok), _t(pkey), _t(pok), lo,
                                dom),
          REF.direct_lookup_join(bkey, bok, pkey, pok, lo, dom))


@pytest.mark.parametrize("hi_bits", [1, 8, 31])
def test_matmul_probe_join_int64_keys_equal_below_bit_32(hi_bits):
    """Build and probe keys that share their low 32 bits and differ only
    above bit 32: each probe row matches the build row of its full key or
    none."""
    rng = np.random.default_rng(hi_bits)
    low = int(rng.integers(0, 1 << 32))
    his = rng.choice(1 << hi_bits, min(2 << hi_bits, 96) // 2, replace=False)
    keys = (his.astype(np.int64) << 32) | low
    nb = max(1, len(keys) // 2)
    bkey, bok = keys[:nb], rng.random(nb) < 0.85
    pkey = rng.choice(keys, 300)
    pok = rng.random(300) < 0.9
    _same(KX.matmul_probe_join(_t(bkey), _t(bok), _t(pkey), _t(pok)),
          REF.matmul_probe_join(bkey, bok, pkey, pok))


DUP_K2 = {
    # name: (seed, n_build, distinct keys, valid fraction, key dtype)
    "nb1_valid": (11, 1, 1, 1.0, np.int32),
    "nb1_invalid": (12, 1, 1, 0.0, np.int64),
    "nb256_dups_half_valid": (13, 256, 40, 0.5, np.int32),
    "nb256_dups_int64": (14, 256, 100, 0.7, np.int64),
    "nb256_one_key": (15, 256, 1, 0.3, np.int32),
}


@pytest.mark.parametrize("case", sorted(DUP_K2))
def test_matmul_probe_join_duplicates_partly_invalid(case):
    """Duplicate valid build keys give the sum of their indices, clamped
    to [0, n_build); invalid duplicates add nothing."""
    seed, nb, distinct, valid, kdt = DUP_K2[case]
    rng = np.random.default_rng(seed)
    pool = rng.choice(1 << 40, distinct, replace=False) - (1 << 39)
    bkey = rng.choice(pool, nb).astype(kdt)
    bok = rng.random(nb) < valid
    pkey = np.concatenate([rng.choice(pool, 200).astype(kdt),
                           rng.integers(-50, 50, 100).astype(kdt)])
    pok = rng.random(300) < 0.9
    _same(KX.matmul_probe_join(_t(bkey), _t(bok), _t(pkey), _t(pok)),
          REF.matmul_probe_join(bkey, bok, pkey, pok))


def _slots_numpy(keys, nb):
    """K2's hash computed in uint64 arithmetic, apart from the mirror."""
    bits = 4
    while (1 << bits) < 4 * nb:
        bits += 1
    u = keys.astype(np.int64).view(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    x = u & m32
    if keys.dtype == np.int64:
        x = x ^ (((u >> np.uint64(32)) * np.uint64(0x85EBCA6B)) & m32)
    return ((x * np.uint64(0x9E3779B1)) & m32) >> np.uint64(32 - bits)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("nb", [1, 25, 64, 255, 256])
def test_matmul_probe_slots_mirror_the_hash(dtype, nb):
    """The plain mirror of K2's hash equals the hash computed in uint64
    arithmetic, over keys at iinfo's ends, negative keys and keys equal in
    their low 32 bits; the table has the least power of two >= 4 x nb
    slots, at least 16."""
    rng = np.random.default_rng(nb)
    info = np.iinfo(dtype)
    keys = np.concatenate([
        np.array([info.min, info.max, 0, -1, 1], dtype=dtype),
        rng.integers(info.min, info.max, 4000, dtype=dtype, endpoint=True)])
    if dtype == "int64":
        keys = np.concatenate([keys, (rng.integers(-(1 << 31), 1 << 31, 100)
                                      << 32) | 12345])
    got = KX.matmul_probe_slots(_t(keys), nb).numpy()
    np.testing.assert_array_equal(got, _slots_numpy(keys, nb).astype(np.int64))
    bits = KX.matmul_probe_slot_bits(nb)
    assert 1 << bits >= 4 * nb and bits >= 4
    assert bits == 4 or 1 << (bits - 1) < 4 * nb


@pytest.mark.parametrize("dtype,nb", [("int32", 64), ("int32", 256),
                                      ("int64", 64), ("int64", 255)])
def test_colliding_keys_share_one_slot(dtype, nb):
    """The keys the smoke makes to collide in K2's table are distinct and
    all start at the one slot, by the hash computed apart from the
    mirror."""
    rng = np.random.default_rng(7)
    keys = chip_smoke.colliding_keys(rng, nb + 40, nb, dtype, 5)
    assert keys.dtype == np.dtype(dtype) and len(set(keys.tolist())) == nb + 40
    assert set(_slots_numpy(keys, nb).tolist()) == {5}
    # and K2's plain version on them is the reference's
    bkey, pkey = keys[:nb // 2], rng.choice(keys, 200)
    bok, pok = rng.random(len(bkey)) < 0.9, rng.random(200) < 0.9
    _same(KX.matmul_probe_join(_t(bkey), _t(bok), _t(pkey), _t(pok)),
          REF.matmul_probe_join(bkey, bok, pkey, pok))


def test_cpu_joins_count_no_launch():
    """On CPU tensors K1 and K2 take their plain versions, count no
    launch and keep no state."""
    KX.reset_launches()
    before = dict(KX._LOOKBACK)
    rng = np.random.default_rng(3)
    bkey = rng.choice(100, 30, replace=False).astype(np.int32)
    bok, pkey = np.ones(30, bool), rng.integers(-5, 105, 50).astype(np.int32)
    pok = np.ones(50, bool)
    KX.direct_lookup_join(_t(bkey), _t(bok), _t(pkey), _t(pok), 0, 100)
    KX.matmul_probe_join(_t(bkey), _t(bok), _t(pkey), _t(pok))
    assert KX._LOOKBACK == before
    assert KX.LAUNCHES["direct_lookup_join"] == 0
    assert KX.LAUNCHES["matmul_probe_join"] == 0


BUSY_CASES = {
    # name: (intervals as (start us, ms), expected ms of their union)
    "apart": ([(0, 0.5), (1000, 0.25)], 0.75),
    "touching": ([(0, 0.5), (500, 0.5)], 1.0),
    # a dependent launch starts before the kernel it waits for ends
    "overlapping": ([(0, 1.0), (600, 1.0), (3000, 0.1)], 1.7),
    "nested": ([(0, 2.0), (100, 0.1), (300, 0.5)], 2.0),
    "empty": ([], 0.0),
}


@pytest.mark.parametrize("case", sorted(BUSY_CASES))
def test_profiled_device_time_counts_overlapping_kernels_once(case):
    # K1's build and probe run as programmatic dependents, so their
    # profiled spans overlap the kernel before each; the smoke's device
    # time is the union of the spans, not their sum
    spans, want = BUSY_CASES[case]
    work = [(t, ms, f"k{i}") for i, (t, ms) in enumerate(spans)]
    assert chip_smoke.busy_ms(work) == pytest.approx(want)
