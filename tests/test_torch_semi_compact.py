"""K3 (``bitmask_semi``) and L1 (``compact_perm``) of the port on the CPU.

The plain versions are held exactly to the JAX reference, with x64 on, on
the adversarial inputs that ``chip_smoke.semi_compact_case_makers`` draws
from a seed, so that the card (which holds each kernel to its plain
version on them) and the CPU check the same inputs: K3 against
``nds_tpu.engine.kernels.bitmask_semi``; L1 against the reference's
``_compact``, the stable sort of ``(where(row, 0, 1), iota)``, for the
permutation and the present count. Beside them, the host's part of the
two designs: no launch and no look-back state on the CPU, the
compactor's scratch size on the host against every alignment of the
mask, and the smoke's K3 yardstick (``torch.isin``) and data shares. The CUDA kernels themselves are held to
the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nds_tpu.engine import device_exec as RDX
from nds_tpu.engine import kernels as REF
from nds_tpu_torch.engine import kernels as KX

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
MAKERS = {(name, label): make
          for name, label, make in chip_smoke.semi_compact_case_makers()}
K3_CASES = sorted(label for name, label in MAKERS if name == "bitmask_semi")
L1_CASES = sorted(label for name, label in MAKERS if name == "compact_perm")


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("label", K3_CASES)
def test_bitmask_semi_matches_reference(label):
    bkey, bok, pkey, pok, lo, dom = MAKERS[("bitmask_semi", label)](CPU)
    got = KX.bitmask_semi(bkey, bok, pkey, pok, lo, dom)
    ref = REF.bitmask_semi(_np(bkey), _np(bok), _np(pkey), _np(pok), lo, dom)
    assert got.dtype == torch.bool and got.shape == pkey.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _reference_compact(row: np.ndarray) -> tuple:
    """The reference's ``_compact`` over an iota column: its permutation
    and its row mask after the gather."""
    n = row.shape[0]
    rctx = RDX.DCtx(n, jnp.asarray(row))
    rctx.cols[("t", "i")] = RDX.DVal(jnp.arange(n, dtype=jnp.int32))
    out = RDX._Trace._compact(None, rctx)
    return np.asarray(out.cols[("t", "i")].arr), np.asarray(out.row)


@pytest.mark.parametrize("label", L1_CASES)
def test_compact_perm_matches_reference(label):
    (row,) = MAKERS[("compact_perm", label)](CPU)
    perm, count = KX.compact_perm(row)
    exp_perm, exp_row = _reference_compact(row.numpy())
    assert perm.dtype == torch.int32 and count.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), exp_perm)
    assert int(count) == int(exp_row.sum()) == int(row.sum())
    np.testing.assert_array_equal(row.numpy()[perm.numpy()], exp_row)


def test_cases_cover_the_issue_shapes():
    """The adversarial cases hold what the kernels' edges need: probes of
    1-17 and 511-513 rows, the largest domain, slices off alignment, and
    the compactor at the edges of a tile and of a span of the count
    pass's tiles, sliced, and over more tiles than the card holds blocks
    of the write pass at once."""
    sizes = {MAKERS[k](CPU)[2].shape[0] for k in MAKERS
             if k[0] == "bitmask_semi" and "np=" in k[1]}
    assert set(range(1, 18)) | {511, 512, 513} <= sizes
    doms = {MAKERS[k](CPU)[5] for k in MAKERS if "DIRECT_MAX" in k[1]}
    assert doms == {KX.DIRECT_MAX_DOMAIN}
    rows = {MAKERS[k](CPU)[0].shape[0] for k in MAKERS
            if k[0] == "compact_perm"}
    tile = chip_smoke.COMPACT_TILE
    for t in (tile, tile * chip_smoke.COMPACT_SPAN_TILES):
        assert {t - 1, t, t + 1, 2 * t + 1} <= rows
    # an H100's 132 SMs hold at most 8 blocks of 256 threads each
    assert max(rows) > 132 * 8 * tile
    sliced = [MAKERS[k](CPU)[0] for k in MAKERS
              if k[0] == "compact_perm" and "sliced" in k[1]]
    assert {t.storage_offset() for t in sliced} >= {1, 7, 8, 15}


def test_cpu_calls_count_no_launch_and_keep_no_state():
    """On CPU tensors K3 and L1 take their plain versions, count no launch
    and make no look-back buffer; on another device type they refuse."""
    KX.reset_launches()
    before = dict(KX._LOOKBACK)
    k = torch.tensor([3, 5, 9], dtype=torch.int32)
    ok = torch.tensor([True, False, True])
    assert KX.bitmask_semi(k, ok, k, ok, 0, 10).tolist() == [True, False,
                                                            True]
    perm, count = KX.compact_perm(ok)
    assert perm.tolist() == [0, 2, 1] and int(count) == 2
    assert KX._LOOKBACK == before
    assert KX.LAUNCHES["bitmask_semi"] == 0
    assert KX.LAUNCHES["compact_perm"] == 0
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KX.bitmask_semi(meta, meta.bool(), meta, meta.bool(), 0, 4)
    with pytest.raises(ValueError, match="no kernel"):
        KX.compact_perm(meta.bool())


@pytest.mark.parametrize("tile", [chip_smoke.COMPACT_TILE])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 8193,
                               65_537, 6_480_000, 2**31 - 2])
def test_compact_scratch_covers_every_alignment(tile, n):
    """The kernel cuts its tiles at the mask's 16-byte boundaries, so a
    mask that starts F bytes past one takes ceil((n + F) / tile) tiles;
    the wrapper's scratch (``compact_tiles``) holds the most of them."""
    need = max(-(-(n + f) // tile) for f in range(16))
    assert KX.compact_tiles(n, tile) == need


@pytest.mark.parametrize("label", ["int32, dense build of 200003 rows over "
                                   "5000 keys, np=100003",
                                   "int32, dom = DIRECT_MAX_DOMAIN"])
def test_isin_yardstick_computes_k3(label):
    """K3's library yardstick in the smoke: ``torch.isin`` of the probe
    keys in the valid build keys (compacted outside the timed call), ANDed
    with ``pok``, equals K3 where every valid build key lies in the domain,
    as the executor's domains hold both sides' bounds."""
    args = MAKERS[("bitmask_semi", label)](CPU)
    got = KX.bitmask_semi(*args)
    chip_smoke.library_agrees("bitmask_semi", args, got,
                              chip_smoke.library_call("bitmask_semi",
                                                      args)())


def test_k3_data_shares():
    """The shares ``--steps`` prints beside K3: valid build rows, the
    distinct valid keys over the domain, and the probe keys inside it."""
    bkey = torch.tensor([0, 1, 1, 7, 30], dtype=torch.int32)
    bok = torch.tensor([True, True, True, False, True])
    pkey = torch.tensor([-1, 0, 9, 10], dtype=torch.int32)
    pok = torch.tensor([True, True, False, True])
    d = chip_smoke.join_data("bitmask_semi", (bkey, bok, pkey, pok, 0, 10))
    assert d["build_valid"] == pytest.approx(0.8)
    assert d["probe_valid"] == pytest.approx(0.75)
    assert d["probe_in_domain"] == pytest.approx(0.5)
    assert d["distinct_over_dom"] == pytest.approx(0.2)


def test_k3_bound_counts_the_keys_its_data_needs():
    """K3's bound reads a build key only where its row is valid (the
    build loads no key of an invalid vector); the bound that reads every
    key stands beside it."""
    bkey = torch.arange(10, dtype=torch.int64)
    bok = torch.tensor([True, False] * 5)
    pkey = torch.arange(6, dtype=torch.int64)
    pok = torch.ones(6, dtype=torch.bool)
    args = (bkey, bok, pkey, pok, 0, 10)
    out = KX.bitmask_semi(*args)
    moved, ops = chip_smoke.work_of("bitmask_semi", list(args), out)
    assert moved == 5 * 8 + 10 + 6 * 8 + 6 + 6
    all_keys = chip_smoke.all_keys_bound("bitmask_semi", args, out, ops)
    assert all_keys["bound_ms_all_keys"] == pytest.approx(
        chip_smoke.bound(moved + 5 * 8, ops)[0])

