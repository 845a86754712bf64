"""Decode of encoded column buffers on the executor's device.

Port of ``nds_tpu/columnar/device.py``. The reference traces the decode
into each query's XLA program, so a column nothing reads is never
decoded and the full-width values never round-trip through device
memory. The port runs eagerly: the executor's scan hands out each
encoded column lazily (``DVal.encoded`` in ``engine/device_exec.py``)
and decodes it here at its first use in a run, never caching the decoded
tensor across runs. The decode itself is the CUDA C++ of
``csrc/columnar_decode.cu`` behind ``engine/kernels.py``'s
``bitpack_decode``, ``unpack_mask`` and ``rle_decode`` (their plain
versions on the CPU).

The contract with the scan: ``decode`` returns values of EXACTLY the
dtype the raw upload would have had (``EncSpec.dtype``), so every
downstream operator is oblivious to the encoding.
"""

from __future__ import annotations

import numpy as np
import torch

from nds_tpu_torch.columnar.encodings import EncSpec
from nds_tpu_torch.engine import kernels as KX


class DecodeError(RuntimeError):
    """A decode gave values of another dtype than its spec declares."""


def torch_dtype(spec: EncSpec) -> torch.dtype:
    """The torch dtype of the spec's numpy dtype name."""
    return torch.from_numpy(np.empty(0, dtype=spec.dtype)).dtype


def decode_values(spec: EncSpec, bufs: dict, key: str):
    """The column's values, ``spec.rows`` of them, of ``spec.dtype``.
    ``bufs`` holds the encoded buffer set uploaded under ``key`` (+
    ``#x`` for RLE run starts)."""
    dt = torch_dtype(spec)
    if spec.kind == "bitpack":
        vals = KX.bitpack_decode(bufs[key], spec.rows, spec.bits, spec.lo,
                                 dt)
    elif spec.kind == "rle":
        vals = KX.rle_decode(bufs[key], bufs[key + "#x"], spec.rows)
    else:
        vals = bufs[key]
    if vals.dtype != dt:
        # encoded-dtype propagation: a decode that hands downstream
        # operators another dtype than the raw upload would change their
        # packing and compare semantics
        raise DecodeError(f"decoded dtype {vals.dtype} != declared {dt} "
                          f"for {key!r}")
    return vals


def decode_validity(spec: EncSpec, bufs: dict, key: str):
    """The column's validity mask (None when it has none), unpacked
    where the spec packed it."""
    valid = bufs.get(key + "#v")
    if valid is not None and spec.mask_packed:
        valid = KX.unpack_mask(valid, spec.rows)
    return valid


def decode(spec: EncSpec, bufs: dict, key: str):
    """(values, validity) for one encoded scan column."""
    return decode_values(spec, bufs, key), decode_validity(spec, bufs, key)
