"""K8's mask unpack (``unpack_mask``) of the port on the CPU.

The plain version is held exactly to the JAX reference
(``nds_tpu.columnar.device.unpack_mask``, jax on the CPU) on the inputs
that ``chip_smoke.mask_case_makers`` draws from a seed, so that the card
(which holds the kernel to its plain version on them) and the CPU check
the same inputs. Beside them: a numpy model of the kernel's layout
(``csrc/columnar_decode.cu``: blocks of 512 words, warps of 64 words in
four stores, lane ``l`` the half ``l & 1`` of word ``l / 2``, the 16-byte
loads passed on by shuffles, the last block's tail), which must write
every row below ``n`` once, nothing at or past it, and the plain
version's values; the bits-to-bytes multiply; no launch on the CPU. The
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nds_tpu.columnar import device as ref_cdev
from nds_tpu_torch.engine import kernels as KX

CPU = torch.device("cpu")
MAKERS = {label: make for name, label, make in chip_smoke.mask_case_makers()
          if name == "unpack_mask"}
# the cases the CPU runs against jax (the card runs all of them): every
# label starts with its n
SMALL = sorted(label for label in MAKERS
               if int(re.match(r"n=(\d+),", label).group(1)) <= 1_000_003)

# the kernel's tile (csrc/columnar_decode.cu)
THREADS = 256
WARP_WORDS = 64
TILE_WORDS = WARP_WORDS * THREADS // 32


@pytest.mark.parametrize("label", SMALL)
def test_unpack_mask_matches_reference(label):
    words, n = MAKERS[label](CPU)
    got = KX.unpack_mask(words, n)
    ref = ref_cdev.unpack_mask(jnp.asarray(words.numpy()), n)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cases_cover_the_kernels_edges():
    """``n`` of 0, 1, 15-17, 31-33, 511-513, a tile's edge and the largest
    columnar call; words at 1, 2 and 3 words past a 16-byte boundary and
    aligned; more words than ``n`` needs with bits set past it; every
    fill pattern."""
    cases = {label: MAKERS[label](CPU) for label in MAKERS}
    ns = {n for _w, n in cases.values()}
    assert {0, 1, 15, 16, 17, 31, 32, 33, 511, 512, 513,
            chip_smoke.MASK_TILE_ROWS, chip_smoke.MASK_LARGEST_ROWS} <= ns
    offs = {w.storage_offset() % 4 for w, _n in cases.values()}
    assert offs == {0, 1, 2, 3}
    extra = [(w, n) for w, n in cases.values() if w.shape[0] > -(-n // 32)]
    assert extra
    for w, n in extra:
        tail = w.numpy().view(np.uint32)
        bits = np.unpackbits(tail.view(np.uint8), bitorder="little")
        assert bits[n:].any()
    fills = {int(w[0]) for w, n in cases.values() if len(w) and
             (w == w[0]).all() and n > 32}
    assert {0, -1, 0x55555555, 0xAAAAAAAA - (1 << 32), -(1 << 31)} <= fills


def test_bits_to_bytes_multiply():
    """(x * 0x00204081) & 0x01010101 puts bit k of a nibble x in byte k as
    0 or 1, with no carry between the shifted copies."""
    for x in range(16):
        v = (x * 0x00204081) & 0x01010101
        got = [(v >> (8 * k)) & 0xFF for k in range(4)]
        assert got == [(x >> k) & 1 for k in range(4)]


def _kernel_model(words: np.ndarray, n: int, aligned: bool) -> np.ndarray:
    """What the kernel writes, block by block and lane by lane, as a
    uint8 array of ``n + 64`` bytes (the bytes past ``n`` must stay 0xEE,
    never written)."""
    out = np.full(n + 64, 0xEE, np.int64)
    u = words.view(np.uint32).astype(np.int64)
    written = np.zeros(n + 64, np.int64)
    need = -(-n // 32)
    blocks = -(-need // TILE_WORDS)
    spread = lambda x: ((x & 0xF) * 0x00204081) & 0x01010101  # noqa: E731
    for b in range(blocks):
        w_base = b * TILE_WORDS
        nwords = min(need - w_base, TILE_WORDS)
        nvecs = min((n >> 4) - 2 * w_base, 2 * TILE_WORDS)
        for warp in range(THREADS // 32):
            w0 = warp * WARP_WORDS
            q = np.zeros((32, 4), np.int64)
            if aligned:
                for lane in range(WARP_WORDS // 4):
                    at = w0 + 4 * lane
                    for c in range(4):
                        if at + c < nwords:
                            q[lane, c] = u[w_base + at + c]
            for j in range(WARP_WORDS // 16):
                for lane in range(32):
                    wi = w0 + 16 * j + (lane >> 1)
                    if aligned:
                        word = q[4 * j + (lane >> 3), (lane >> 1) & 3]
                    else:
                        word = u[w_base + wi] if wi < nwords else 0
                    v = 2 * wi + (lane & 1)
                    if v < nvecs:
                        h = word >> ((lane & 1) * 16)
                        r0 = 32 * w_base + 16 * v
                        for k in range(4):
                            b4 = spread(h >> (4 * k))
                            for t in range(4):
                                out[r0 + 4 * k + t] = (b4 >> (8 * t)) & 0xFF
                                written[r0 + 4 * k + t] += 1
        if b == blocks - 1:
            for t in range(THREADS):
                r = (n & ~15) + t
                if r < n:
                    out[r] = (u[r >> 5] >> (r & 31)) & 1
                    written[r] += 1
    assert (written[:n] == 1).all(), "a row written other than once"
    assert not written[n:].any(), "a row at or past n written"
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 513, 16_383, 16_385,
                               2 * 16_384 + 31])
def test_kernel_layout_writes_each_row_once(n, aligned):
    rng = np.random.default_rng(n)
    words = rng.integers(-2**31, 2**31, -(-n // 32) + 2,
                         dtype=np.int64).astype(np.int32)
    out = _kernel_model(words, n, aligned)
    exp = KX.unpack_mask_plain(torch.from_numpy(words), n).numpy()
    np.testing.assert_array_equal(out[:n], exp.astype(np.int64))
    assert (out[n:] == 0xEE).all()


def test_no_launch_on_the_cpu_and_other_devices_refused():
    KX.reset_launches()
    words, n = MAKERS[SMALL[0]](CPU)
    KX.unpack_mask(words, n)
    assert KX.LAUNCHES["unpack_mask"] == 0
    with pytest.raises(ValueError):
        KX.unpack_mask(torch.zeros(4, dtype=torch.int32, device="meta"), 8)
