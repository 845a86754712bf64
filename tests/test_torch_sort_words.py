"""The multi-key sort's words of at most 32 bits, on the CPU.

``device_exec._sort_layout`` cuts the operands' order-preserving bits,
taken as one string, into int32 words (the fewest digit passes, then the
fewest words, then the fewest operands split), so that an operand may
straddle two words; ``kernels.pack_sort_key`` writes each word with the
counts of its 8-bit digits, and ``partition_sort`` takes those counts in
place of its own histogram pass. Here the wrappers run their plain
versions: the layout is held to its rule (against an exhaustive search
of the cuts), the permutation of straddled and adversarial keys to the
reference's ``lax.sort(ops + [iota], num_keys=len(ops), is_stable=True)``
and to ``_lexsort``, the counts to numpy's ``bincount`` of each digit,
and the sort given the counts to the sort without them. The CUDA kernels
are held to the plain versions on the card by ``chip_smoke.py``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nds_tpu_torch.engine import device_exec as DX
from nds_tpu_torch.engine import kernels as KX

from tests.test_torch_sort_search import I32, I64, P, _operand

CPU = torch.device("cpu")


def _rng(*parts):
    return np.random.default_rng(zlib.crc32("/".join(map(str,
                                                         parts)).encode()))


def _passes(bits):
    return sum(-(-b // 8) for b in bits)


# ------------------------------------------------------------ the layout

def test_layout_of_presence_and_four_int32_keys():
    """NDS's largest sort: presence and four int32 keys without bounds,
    129 bits, take five words of 1 and 4 x 32 bits (17 passes), none
    split and none over 32 bits."""
    row = torch.ones(4, dtype=torch.bool)
    keys = [DX.SortKey(row, invert=True)] + [
        DX.SortKey(torch.zeros(4, dtype=torch.int32)) for _ in range(4)]
    layout = DX._sort_layout(keys, 4)
    assert [b for _f, b in layout] == [1, 32, 32, 32, 32]
    assert [[p[0] for p in pieces] for pieces, _b in layout] == [
        [0], [1], [2], [3], [4]]
    assert all(p[4] == 0 for pieces, _b in layout for p in pieces)


def _cost(widths, cuts):
    """(passes, words, fields split) of cutting fields of ``widths`` bits
    at ``cuts`` (the words' ends, from the top)."""
    starts = np.cumsum([0] + list(widths))
    bits = np.diff([0] + list(cuts))
    split = sum(1 for a, b in zip(starts[:-1], starts[1:])
                if any(a < c < b for c in cuts))
    return _passes(bits), len(cuts), split


WIDTH_CASES = {
    # name: the fields' widths, the most significant first
    "presence_and_int64": (1, 64),
    "two_int32_and_spans": (1, 3, 32, 5, 32),
    "float64_between_spans": (2, 64, 7),
    "spans_of_30": (30, 30, 30),
    "many_small": (3, 5, 7, 1, 9, 11, 2, 6),
    "int32_and_span_of_40": (32, 40),
    "one_bit": (1,),
    "odd_widths": (17, 17, 17, 17),
}


@pytest.mark.parametrize("name", sorted(WIDTH_CASES))
def test_layout_takes_the_least_cost_cuts(name):
    """``_sort_cuts`` against every way to cut the string into the fewest
    words of at most 32 bits: no cut set has fewer passes, and none with
    as few passes and words splits fewer fields."""
    widths = WIDTH_CASES[name]
    total = sum(widths)
    cuts = DX._sort_cuts(widths, KX.SORT_MAX_FIELDS)
    bits = np.diff([0] + list(cuts))
    assert cuts[-1] == total and all(1 <= b <= 32 for b in bits)
    got = _cost(widths, cuts)
    assert got[0] == -(-total // 8) and got[1] == -(-total // 32)
    k = -(-total // 32)
    best = min(_cost(widths, c + (total,))
               for c in itertools.combinations(range(1, total), k - 1)
               if all(b <= 32 for b in np.diff([0, *c, total])))
    assert got == best


def test_layout_caps_the_pieces_of_a_word():
    """Seventeen one-bit fields: no word holds more than
    ``SORT_MAX_FIELDS`` pieces."""
    cuts = DX._sort_cuts((1,) * 17, KX.SORT_MAX_FIELDS)
    assert np.diff([0] + list(cuts)).tolist() == [1, 16]
    assert DX._sort_cuts((1,) * 17, 4) == (1, 5, 9, 13, 17)


# ------------------------------------------------- straddled, adversarial

STRADDLE_CASES = {
    # name: (rows, share present, operand specs)
    "int64_full_width_asc": (500, 0.8, [P, ("int", I64, -5, 5, False,
                                            False, 0.1, False)]),
    "int64_full_width_desc_minimum": (500, 0.9, [
        P, ("int", I64, -5, 5, False, True, 0.0, False),
        ("int", I32, -5, 5, False, True, 0.0, False)]),
    "float64_zeros_nans": (500, 0.9, [P, ("rank", False),
                                      ("float", np.float64, True, 0.1)]),
    "float64_asc_then_float32": (500, 0.9, [
        P, ("float", np.float64, False, 0.0),
        ("float", np.float32, True, 0.2)]),
    "span_of_40_bits": (500, 0.7, [P, ("int", I64, -(1 << 39), 1 << 39,
                                       True, False, 0.2, True)]),
    "int32_unaligned": (500, 0.8, [P, ("int", I32, 0, 5, True, False, 0.0,
                                       True),
                                   ("int", I32, -5, 5, False, True, 0.0,
                                    False),
                                   ("int", I64, -5, 5, False, False, 0.1,
                                    False)]),
}


def _case(name):
    n, share, specs = STRADDLE_CASES[name]
    rng = _rng("straddle", name)
    row = rng.random(n) < share
    pairs = [_operand(rng, n, row, s) for s in specs]
    return row, [k for k, _r in pairs], [r for _k, r in pairs]


@pytest.mark.parametrize("name", sorted(STRADDLE_CASES))
def test_straddled_fields_sort_as_lax_sort_and_lexsort(name):
    """A full-width int64 (its minimum negated), a float64 (-0.0, NaNs of
    both signs), a span of 40 bits and an int32 cut at an odd bit: each
    straddles two words, and ``_sort_perm``'s permutation equals the
    reference's stable ``lax.sort`` and ``_lexsort`` exactly."""
    row, keys, ref_ops = _case(name)
    n = len(row)
    layout = DX._sort_layout(keys, n)
    assert all(b <= 32 for _p, b in layout)
    owners = [p[0] for pieces, _b in layout for p in pieces]
    assert len(owners) > len(set(owners)), "no operand straddles"
    got = DX._sort_perm(torch.as_tensor(row), keys, n, CPU)
    ops = [DX._sort_operand(torch.as_tensor(row), k) for k in keys]
    for op, ref in zip(ops, ref_ops):
        np.testing.assert_array_equal(op.numpy(), ref)
    sorted_ops = lax.sort([jnp.asarray(r) for r in ref_ops]
                          + [jnp.arange(n, dtype=jnp.int32)],
                          num_keys=len(ref_ops), is_stable=True)
    exp = np.asarray(sorted_ops[-1])
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(DX._lexsort(ops, n, CPU).numpy(), exp)


def test_adversarial_keys_at_their_extremes():
    """-0.0 beside +0.0, NaNs of both signs, infinities, and the int32 and
    int64 minimums negated (which wrap to themselves, as the reference's
    negation does), all in one sort."""
    n = 64
    f = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5]
                 * 8)
    i32 = np.full(n, np.iinfo(np.int32).min, np.int32)
    i32[1::2] = np.arange(32) - 16
    i64 = np.full(n, np.iinfo(np.int64).min, np.int64)
    i64[::3] = np.iinfo(np.int64).max
    i64[1::3] = -7
    keys = [DX.SortKey(torch.as_tensor(f), negate=True),
            DX.SortKey(torch.as_tensor(i32), negate=True),
            DX.SortKey(torch.as_tensor(i64), negate=True),
            DX.SortKey(torch.as_tensor(f.astype(np.float32)))]
    row = torch.ones(n, dtype=torch.bool)
    ops = [DX._sort_operand(row, k) for k in keys]
    # lax.sort's comparator takes -0.0 as +0.0, every NaN as one above +inf
    ref = [o.numpy() for o in ops]
    sorted_ops = lax.sort([jnp.asarray(r) for r in ref]
                          + [jnp.arange(n, dtype=jnp.int32)],
                          num_keys=len(ref), is_stable=True)
    got = DX._sort_perm(row, keys, n, CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(sorted_ops[-1]))
    assert int(ops[1][0]) == np.iinfo(np.int32).min
    assert int(ops[2][2]) == np.iinfo(np.int64).min


# ---------------------------------------------------------- digit counts

@pytest.mark.parametrize("through", ("rows", "permutation"))
@pytest.mark.parametrize("name", sorted(STRADDLE_CASES))
def test_pack_counts_each_digit(name, through):
    """Every word's digit counts, read in row order or through a
    permutation, equal numpy's ``bincount`` of each 8-bit digit of the
    word's order-preserving unsigned bits."""
    row, keys, _ref = _case(name)
    n = len(row)
    trow = torch.as_tensor(row)
    perm = (None if through == "rows" else
            torch.as_tensor(_rng("perm", name).permutation(n)
                            .astype(np.int32)))
    for pieces, bits in DX._sort_layout(keys, n):
        word, counts = KX.pack_sort_key(*DX._word_args(trow, keys, pieces,
                                                       bits), perm)
        assert word.dtype == torch.int32 and counts.dtype == torch.int32
        u = word.numpy().view(np.uint32) ^ np.uint32(0x80000000)
        exp = np.concatenate([np.bincount((u >> np.uint32(8 * d)) & 0xFF,
                                          minlength=256) for d in range(4)])
        np.testing.assert_array_equal(counts.numpy(), exp)
        if bits < 32:
            assert int(u.max()) < (1 << bits) | 0x80000000


def _np_hist(keys, counts):
    """Digit counts of each partition's occupied prefix, in numpy."""
    passes = keys.dtype.itemsize
    out = np.zeros((keys.shape[0], passes, 256), np.int32)
    ubits = np.uint64 if passes == 8 else np.uint32
    top = ubits(1) << ubits(8 * passes - 1)
    for p, c in enumerate(counts):
        u = keys[p, :c].view(ubits) ^ top
        for d in range(passes):
            out[p, d] = np.bincount(((u >> ubits(8 * d)) & ubits(0xFF))
                                    .astype(np.int64), minlength=256)
    return out.reshape(-1)


@pytest.mark.parametrize("key_bits", (1, 7, 8, 9, 24, 31, 32, 40, 64))
def test_partition_sort_with_given_counts_equals_without(key_bits):
    """``partition_sort_plain`` reading the caller's digit counts (only the
    digits that move) equals it without them, over partitions of keys of
    ``key_bits`` bits, and wrong counts that hide a moving digit do not."""
    rng = _rng("given", key_bits)
    dtype = np.int64 if key_bits > 32 else np.int32
    nparts, cap = 3, 700
    lo = np.iinfo(dtype).min if key_bits in (32, 64) else 0
    vals = rng.integers(0, 1 << min(key_bits, 62), (nparts, cap),
                        dtype=np.int64) + lo
    if key_bits == 64:
        vals = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            (nparts, cap), dtype=np.int64)
    keys = vals.astype(dtype)
    counts = np.array([cap, cap // 2, 0], np.int32)
    gidx = rng.integers(0, 1 << 30, (nparts, cap)).astype(np.int32)
    hist = _np_hist(keys, counts)
    args = (torch.as_tensor(keys), torch.as_tensor(gidx),
            torch.as_tensor(counts))
    ks0, gs0 = KX.partition_sort(*args)
    ks1, gs1 = KX.partition_sort(*args, torch.as_tensor(hist))
    assert torch.equal(ks0, ks1) and torch.equal(gs0, gs1)
    # claim the top digit that moves in partition 0 takes one value: the
    # order it gives is lost
    wrong = hist.reshape(nparts, -1, 256).copy()
    top = max(d for d in range(wrong.shape[1]) if wrong[0, d].max() < cap)
    wrong[0, top] = 0
    wrong[0, top, 0] = cap
    ks2, _gs2 = KX.partition_sort(*args, torch.as_tensor(wrong.ravel()))
    assert not torch.equal(ks0, ks2)


def test_sort_chain_hands_its_counts_to_the_sort(monkeypatch):
    """``_sort_perm`` passes each word's counts from its pack to its sort:
    one pack and one sort per word, each sort given that word's counts."""
    row, keys, _ref = _case("int32_unaligned")
    n = len(row)
    trow = torch.as_tensor(row)
    seen = []
    real_pack, real_sort = KX.pack_sort_key, KX.partition_sort

    def pack(*a, **k):
        out = real_pack(*a, **k)
        seen.append(("pack", out[1]))
        return out

    def sort(keys_, gidx, counts, hist=None):
        seen.append(("sort", hist))
        return real_sort(keys_, gidx, counts, hist)
    monkeypatch.setattr(KX, "pack_sort_key", pack)
    monkeypatch.setattr(KX, "partition_sort", sort)
    DX._sort_perm(trow, keys, n, CPU)
    words = len(DX._sort_layout(keys, n))
    assert [w for w, _h in seen] == ["pack", "sort"] * words
    for (_p, packed), (_s, given) in zip(seen[::2], seen[1::2]):
        assert given is packed
