"""K4 (``keyed_minmax_semi``) and K9 (``rle_decode``) of the port on the CPU.

The plain versions are held exactly to the JAX reference, with x64 on, on
the adversarial inputs that ``chip_smoke.minmax_rle_case_makers`` draws
from a seed, so that the card (which holds each kernel to its plain
version on them) and the CPU check the same inputs: K4 against
``nds_tpu.engine.kernels.keyed_minmax_semi``; K9 against the RLE branch
of ``nds_tpu.columnar.device.decode``. Beside them, the host's part: no
launch on the CPU, the K4 bound's table bytes, and no library yardstick
for K4 (no one PyTorch call computes its function). The CUDA kernels
themselves are held to the plain versions on the card by
``chip_smoke.py``.
"""

import tests.torch_threads  # noqa: F401  (first: sizes torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nds_tpu.columnar import device as ref_cdev
from nds_tpu.columnar import encodings as RE
from nds_tpu.engine import kernels as REF
from nds_tpu_torch.engine import kernels as KX

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
MAKERS = {(name, label): make
          for name, label, make in chip_smoke.minmax_rle_case_makers()}
K4_CASES = sorted(label for name, label in MAKERS
                  if name == "keyed_minmax_semi")
K9_CASES = sorted(label for name, label in MAKERS if name == "rle_decode")


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("label", K4_CASES)
def test_keyed_minmax_semi_matches_reference(label):
    """Exact against the reference. The port skips a valid build key below
    ``lo`` (its domain holds every valid key of both sides, so the executor
    never passes one); the reference would wrap its negative slot into the
    table, so it is given those rows as invalid."""
    bkey, bok, bval, pkey, pok, pval, lo, dom = MAKERS[
        ("keyed_minmax_semi", label)](CPU)
    got = KX.keyed_minmax_semi(bkey, bok, bval, pkey, pok, pval, lo, dom)
    ref_bok = _np(bok) & (_np(bkey).astype(np.int64) >= lo)
    ref = REF.keyed_minmax_semi(_np(bkey), ref_bok, _np(bval), _np(pkey),
                                _np(pok), _np(pval), lo, dom)
    assert got.dtype == torch.bool and got.shape == pkey.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("label", K9_CASES)
def test_rle_decode_matches_reference(label):
    values, starts, n = MAKERS[("rle_decode", label)](CPU)
    got = KX.rle_decode(values, starts, n)
    spec = RE.EncSpec("rle", n, str(values.dtype).replace("torch.", ""),
                      runs=values.shape[0])
    ref, _valid = ref_cdev.decode(spec, {"c": jnp.asarray(_np(values)),
                                         "c#x": jnp.asarray(_np(starts))},
                                  "c")
    assert got.dtype == values.dtype and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cases_cover_the_kernels_edges():
    """The cases hold the kernels' edges: K4 row counts of 1-17 and
    511-513, ``dom`` of 1 and the largest, values at another alignment than
    their keys, both value types beside both key types, no build rows;
    K9 ``n`` below one 16-byte vector and no multiple of it, both value
    types, runs of one row and runs longer than a tile, a view decoded past
    its last run and one that ends before its last runs start."""
    k4 = {label: MAKERS[("keyed_minmax_semi", label)](CPU)
          for label in K4_CASES}
    sizes = {a[3].shape[0] for a in k4.values()}
    assert set(range(1, 18)) | {511, 512, 513} <= sizes
    assert {a[7] for a in k4.values()} >= {1, KX.DIRECT_MAX_DOMAIN}
    assert {(a[0].dtype, a[2].dtype) for a in k4.values()} == {
        (k, v) for k in (torch.int32, torch.int64)
        for v in (torch.int32, torch.int64)}
    assert any(a[0].shape[0] == 0 for a in k4.values())
    # a value array that starts at another 16-byte phase than its keys
    assert any((a[2].storage_offset() * a[2].element_size()
                - a[0].storage_offset() * a[0].element_size()) % 16
               for a in k4.values())
    k9 = [MAKERS[("rle_decode", label)](CPU) for label in K9_CASES]
    ns = {n for _v, _s, n in k9}
    assert {1, 2, 3, 5} <= ns and any(n % 4 for n in ns if n > 4)
    assert {v.dtype for v, _s, _n in k9} == {torch.int32, torch.int64}
    lengths = [np.diff(np.append(s.numpy(), n)) for _v, s, n in k9]
    # K9's tiles: 4,096 int64 rows, 8,192 int32
    assert any((ln == 1).all() and len(ln) > 2 * chip_smoke.RLE_TILE
               for ln in lengths)
    assert any((ln > 2 * chip_smoke.RLE_TILE).all() for ln in lengths)
    assert any(int(s[-1]) < n // 2 for _v, s, n in k9)
    assert any(int(s[-1]) >= n for _v, s, n in k9)


@pytest.mark.parametrize("vdt", [torch.int32, torch.int64])
def test_minmax_presence_is_min_le_max(vdt):
    """A key reached by one build row whose value is iinfo.max (or
    iinfo.min) is present: probing it with that value finds no other value
    (False), with any other finds one (True); an unreached key is absent
    whatever the probe's value."""
    info = torch.iinfo(vdt)
    bkey = torch.tensor([0, 1, 2], dtype=torch.int32)
    bval = torch.tensor([info.max, info.min, info.max], dtype=vdt)
    bok = torch.tensor([True, True, False])
    pkey = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32)
    pval = torch.tensor([info.max, 0, info.min, 0, info.max, info.min],
                        dtype=vdt)
    pok = torch.ones(6, dtype=torch.bool)
    got = KX.keyed_minmax_semi(bkey, bok, bval, pkey, pok, pval, 0, 3)
    assert got.tolist() == [False, True, False, True, False, False]


def test_cpu_calls_count_no_launch_and_refuse_other_devices():
    KX.reset_launches()
    k = torch.tensor([3, 5, 9], dtype=torch.int32)
    ok = torch.tensor([True, False, True])
    assert KX.keyed_minmax_semi(k, ok, k, k, ok, k + 1, 0, 10).tolist() == [
        True, False, True]
    assert KX.rle_decode(k, torch.tensor([0, 2, 5], dtype=torch.int32),
                         7).tolist() == [3, 3, 5, 5, 5, 9, 9]
    assert KX.LAUNCHES["keyed_minmax_semi"] == 0
    assert KX.LAUNCHES["rle_decode"] == 0
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KX.keyed_minmax_semi(meta, meta.bool(), meta, meta, meta.bool(), meta,
                             0, 4)
    with pytest.raises(ValueError, match="no kernel"):
        KX.rle_decode(meta, meta, 4)


def test_k4_has_no_library_yardstick():
    """No one PyTorch call computes K4's function: the min table's
    ``scatter_reduce_`` alone is a quarter of it, so the smoke times none."""
    args = MAKERS[("keyed_minmax_semi", "int32 keys and values, nb = np = "
                   "17")](CPU)
    assert chip_smoke.library_call("keyed_minmax_semi", args) is None


@pytest.mark.parametrize("vdt,slot", [(torch.int32, 8), (torch.int64, 16)])
def test_k4_bound_counts_valid_rows_and_the_table(vdt, slot):
    """K4's bound reads a build key and value only where the row is valid
    (its build loads neither for an invalid vector); beside it, the bound
    with the table: its fill and one slot read a probe row."""
    nb, np_, dom = 10, 6, 50
    bkey = torch.arange(nb, dtype=torch.int32)
    bok = torch.tensor([True] * 4 + [False] * 6)
    bval = torch.zeros(nb, dtype=vdt)
    pkey = torch.arange(np_, dtype=torch.int32)
    pok = torch.ones(np_, dtype=torch.bool)
    pval = torch.zeros(np_, dtype=vdt)
    args = (bkey, bok, bval, pkey, pok, pval, 0, dom)
    out = KX.keyed_minmax_semi(*args)
    moved, ops = chip_smoke.work_of("keyed_minmax_semi", list(args), out)
    vsz = bval.element_size()
    assert moved == nb + 4 * (4 + vsz) + np_ * (4 + 1 + vsz) + np_
    table = chip_smoke.all_keys_bound("keyed_minmax_semi", args, out, ops)
    assert table["table_bytes"] == dom * slot + np_ * slot
    assert table["bound_ms_with_table"] == pytest.approx(
        chip_smoke.bound(moved + dom * slot + np_ * slot, ops)[0])
