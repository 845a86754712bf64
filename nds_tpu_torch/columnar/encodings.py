"""Encoded-column planning and host-side encoding (numpy only).

Port copy of ``nds_tpu/columnar/encodings.py``, imports rewritten to
``nds_tpu_torch``. Specs and host buffers are byte-identical to the
reference's for the same column and mode: selection is deterministic, and
the kernels' inputs and ``bytes_scanned`` depend on it. Trimmed: the
sanitizer's ``plan_verify`` check in ``encode_values`` (it returns with
the sanitizer slice) and the manifest helpers ``manifest_set_encodings``
and ``manifest_encodings`` (they need ``io/integrity.py`` and come with
the table-cache slice). ``chunk_spec`` is kept for the chunked executor,
which is not ported yet.

The device engine is bandwidth-bound, so the cheapest large speedup is
moving fewer bytes through device memory. This module picks a per-column
encoding from load-time statistics and produces the host buffer set the
executor uploads INSTEAD of the raw values; the device side
(``columnar/device.py``) decodes where a query first reads the column.

Encodings:

- **bitpack** — integer columns (dates, surrogate keys, dictionary
  codes, flags) whose host value range fits ``bits`` ∈ {1,2,4,8,16}
  pack ``32//bits`` biased values per int32 word; ``bits=32`` is the
  biased-downcast special case for int64 storage whose range fits
  int32. Decode is a word gather + shift/mask + bias add.
- **rle** — run-length encoding for sorted/clustered columns (fact
  date and surrogate-key columns): run values + int32 run starts.
  Decode finds each row's run and gathers its value.
- **raw + packed mask** — a column whose values stay raw can still
  pack its null mask at 1 bit/row (8x on the mask bytes).

Dictionary-encoded strings already live on device as int32 codes
(io/host_table.py); here their codes additionally bitpack to the
dictionary's width. Selection is deterministic from column content
(+ the mode), so identical warehouses produce identical encodings.

No torch imports: planning/encoding must run wherever the warehouse
loads.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace

import numpy as np

# bump to invalidate memoized specs (the memo keys on the fingerprint
# token, which carries this version)
ENC_VERSION = 1

# columns below this row count stay raw: there is nothing to win and
# the degenerate shapes (0/1 rows) keep their existing special cases
MIN_ROWS = 2

# auto mode requires a real gain: encoded bytes <= 3/4 of raw bytes
# (forced modes only require encoded < raw)
GAIN_NUM, GAIN_DEN = 3, 4

# pack the null mask when it spans at least this many rows (below, the
# mask is already tiny and the extra decode is pure overhead)
MASK_PACK_MIN_ROWS = 64

_PACK_BITS = (1, 2, 4, 8, 16)


@dataclass(frozen=True)
class EncSpec:
    """One column's encoding choice. ``rows`` is the (padded) logical
    row count the decode reproduces; ``dtype`` the numpy dtype name of
    the decoded values (encoded-dtype propagation: the decode must
    hand downstream operators exactly the dtype the raw upload would
    have)."""

    kind: str            # "bitpack" | "rle" | "raw" (mask-only)
    rows: int
    dtype: str
    bits: int = 0        # bitpack: payload bits per value
    lo: int = 0          # bitpack: bias subtracted before packing
    runs: int = 0        # rle: number of runs
    mask_packed: bool = False


def spec_to_json(spec: EncSpec) -> dict:
    return asdict(spec)


def spec_from_json(doc: dict) -> EncSpec | None:
    try:
        spec = EncSpec(**doc)
    except TypeError:
        return None
    if spec.kind not in ("bitpack", "rle", "raw"):
        return None
    return spec


# ----------------------------------------------------------- statistics

def _int_bounds(values: np.ndarray, mask) -> "tuple[int, int] | None":
    vals = values if mask is None else values[mask]
    if len(vals) == 0:
        return (0, 0)
    return (int(vals.min()), int(vals.max()))


def _runs_of(values: np.ndarray) -> int:
    if len(values) < 2:
        return len(values)
    return int(np.count_nonzero(values[1:] != values[:-1])) + 1


def _pack_bits_for(span: int, itemsize: int) -> int:
    """Smallest supported bit width covering ``span`` (= hi - lo), or
    0 when bit packing cannot shrink this column."""
    for bits in _PACK_BITS:
        if span <= (1 << bits) - 1:
            # packing into int32 words only gains when the packed
            # width beats the storage width
            return bits if bits < itemsize * 8 else 0
    if itemsize == 8 and span <= 2**31 - 1:
        return 32  # biased downcast: int64 storage, int32 range
    return 0


# ------------------------------------------------------ size accounting

def _mask_words(rows: int) -> int:
    return (rows + 31) // 32


def encoded_nbytes(spec: EncSpec) -> int:
    """Bytes the device scan reads for a column encoded per ``spec``."""
    item = np.dtype(spec.dtype).itemsize
    if spec.kind == "bitpack":
        if spec.bits >= 32:
            body = spec.rows * 4
        else:
            per = 32 // spec.bits
            body = ((spec.rows + per - 1) // per) * 4
    elif spec.kind == "rle":
        body = spec.runs * (item + 4)
    else:
        body = spec.rows * item
    if spec.mask_packed:
        body += _mask_words(spec.rows) * 4
    return body


def raw_nbytes(values: np.ndarray, mask=None) -> int:
    return int(values.nbytes) + (0 if mask is None else int(mask.nbytes))


# ------------------------------------------------------------- planning

def plan_from_stats(*, rows: int, dtype: str, raw: int,
                    lo: "int | None", hi: "int | None",
                    runs: "int | None", has_mask: bool,
                    is_string: bool = False,
                    mode: str | None = None) -> EncSpec | None:
    """The pure decision procedure behind ``plan_values``, driven by
    exact column statistics instead of the value array (the reference's
    delta-segment append path plans from merged statistics through it;
    that path comes with the DML slice)."""
    from nds_tpu_torch import columnar
    mode = columnar.mode() if mode is None else mode
    if mode == "off" or rows < MIN_ROWS:
        return None
    np_dtype = np.dtype(dtype)
    if not np.issubdtype(np_dtype, np.number):
        return None
    cands: list[EncSpec] = []
    forced = mode in ("dict", "bitpack", "rle")
    if (np.issubdtype(np_dtype, np.integer)
            and mode in ("auto", "dict", "bitpack")
            and (mode != "dict" or is_string)
            and lo is not None and hi is not None):
        bits = _pack_bits_for(hi - lo, np_dtype.itemsize)
        if bits:
            cands.append(EncSpec("bitpack", rows, dtype, bits=bits,
                                 lo=lo))
    # RLE never applies to floats: run detection (and the run-value
    # representative) compares by VALUE, and -0.0 == +0.0 would
    # splice signed zeros into one run — the decode then flips
    # signbits vs the raw upload, breaking the byte-identical
    # contract (and sign-sensitive math like 1/x)
    if (not has_mask and mode in ("auto", "rle")
            and not np.issubdtype(np_dtype, np.floating)
            and runs is not None):
        cands.append(EncSpec("rle", rows, dtype, runs=runs))
    if (has_mask and rows >= MASK_PACK_MIN_ROWS
            and (mode in ("auto", "bitpack")
                 or (mode == "dict" and is_string))):
        # mask packing rides every candidate, and stands alone when no
        # value encoding applies
        cands = [replace(c, mask_packed=True) for c in cands]
        cands.append(EncSpec("raw", rows, dtype, mask_packed=True))
    if not cands:
        return None
    best = min(cands, key=encoded_nbytes)
    enc = encoded_nbytes(best)
    if forced or best.kind == "raw":
        # forced modes — and mask-only packing, whose decode is a
        # couple of int32 ops — only need to actually shrink; the
        # auto-mode gain margin exists to keep marginal VALUE decodes
        # off the critical path
        return best if enc < raw else None
    return best if enc * GAIN_DEN <= raw * GAIN_NUM else None


def plan_values(values: np.ndarray, mask=None, *,
                mode: str | None = None,
                is_string: bool = False) -> EncSpec | None:
    """Encoding choice for one column's (possibly padded) value array,
    or None for the raw path. Deterministic in (content, mode): the
    same bytes under the same mode always plan the same spec. Forced
    modes apply exactly ONE family — ``dict`` touches only
    dictionary-code (string) columns, so a differential run can
    attribute a reproduction to one encoding."""
    from nds_tpu_torch import columnar
    mode = columnar.mode() if mode is None else mode
    rows = len(values)
    if mode == "off" or rows < MIN_ROWS:
        return None
    lo = hi = runs = None
    if np.issubdtype(values.dtype, np.number):
        if np.issubdtype(values.dtype, np.integer):
            lo, hi = _int_bounds(values, mask)
        if mask is None and not np.issubdtype(values.dtype,
                                              np.floating):
            runs = _runs_of(values)
    return plan_from_stats(
        rows=rows, dtype=values.dtype.name,
        raw=raw_nbytes(values, mask), lo=lo, hi=hi, runs=runs,
        has_mask=mask is not None, is_string=is_string, mode=mode)


def plan_padded(values: np.ndarray, mask, nrows: int, *,
                is_string: bool = False) -> EncSpec | None:
    """Encoding choice for a PADDED buffer (reduced scan views pad
    survivors to a power-of-two capacity): the plan derives from the
    LIVE prefix only — pad zeros are gated by the row mask and must
    not drag the bitpack bounds (or the run count) toward 0 — and the
    spec's ``rows`` covers the full padded capacity. Encode with the
    matching ``nrows`` so the RLE runs come from the same prefix."""
    if nrows < MIN_ROWS:
        return None
    spec = plan_values(values[:nrows],
                       None if mask is None else mask[:nrows],
                       is_string=is_string)
    return None if spec is None else replace(spec, rows=len(values))


_SPEC_MEMO = "_nds_enc_memo"


def column_spec(col) -> EncSpec | None:
    """Memoized encoding choice for a HostColumn (the load-time stats
    pass). The memo keys on the active fingerprint token so a mode
    change mid-process cannot serve a stale spec; DML builds new
    column objects, so content drift can't either."""
    from nds_tpu_torch import columnar
    token = columnar.fingerprint_token()
    memo = getattr(col, _SPEC_MEMO, None)
    if memo is not None and memo[0] == token:
        return memo[1]
    spec = plan_values(col.values, col.null_mask,
                       is_string=col.is_string)
    try:
        setattr(col, _SPEC_MEMO, (token, spec))
    except Exception:  # noqa: BLE001 - slotted column: recompute next time
        pass
    return spec


def seed_column_spec(col, spec: EncSpec | None) -> None:
    """Pre-seed the memo from persisted metadata (table_cache restore).
    Rejected when the spec no longer fits the column (stale manifest)."""
    if spec is not None and spec.rows != len(col.values):
        return
    from nds_tpu_torch import columnar
    try:
        setattr(col, _SPEC_MEMO, (columnar.fingerprint_token(), spec))
    except Exception:  # noqa: BLE001
        pass


def chunk_spec(col, chunk_rows: int, bounds: tuple) -> EncSpec | None:
    """Encoding for a STREAMED table's per-chunk buffers: bitpack only
    (every chunk must share one static shape — RLE run counts vary per
    chunk) with bounds from the WHOLE table, so one spec serves every
    chunk of the column and the compiled chunk program is reused
    unchanged."""
    from nds_tpu_torch import columnar
    mode = columnar.mode()
    if mode not in ("auto", "dict", "bitpack"):
        return None
    if mode == "dict" and not col.is_string:
        return None
    if chunk_rows < MIN_ROWS or not np.issubdtype(
            col.values.dtype, np.integer):
        return None
    lo, hi = bounds
    if lo is None or hi is None:
        return None
    bits = _pack_bits_for(hi - lo, col.values.dtype.itemsize)
    mask_packed = (col.null_mask is not None
                   and chunk_rows >= MASK_PACK_MIN_ROWS)
    if not bits and not mask_packed:
        return None
    spec = EncSpec("bitpack" if bits else "raw", chunk_rows,
                   col.values.dtype.name, bits=bits, lo=lo,
                   mask_packed=mask_packed)
    raw = col.values.dtype.itemsize * chunk_rows + (
        chunk_rows if col.null_mask is not None else 0)
    return spec if encoded_nbytes(spec) * GAIN_DEN <= raw * GAIN_NUM \
        else None


# ------------------------------------------------------------- encoding

def _pack_words(norm: np.ndarray, bits: int) -> np.ndarray:
    """Pack non-negative int64 values < 2**bits into int32 words,
    ``32//bits`` per word, low field first."""
    per = 32 // bits
    nwords = (len(norm) + per - 1) // per
    lanes = np.zeros(nwords * per, dtype=np.uint64)
    lanes[:len(norm)] = norm.astype(np.uint64)
    lanes = lanes.reshape(nwords, per)
    shifts = (np.arange(per, dtype=np.uint64) * np.uint64(bits))
    words = np.bitwise_or.reduce(lanes << shifts, axis=1)
    return words.astype(np.uint32).view(np.int32)


def encode_values(spec: EncSpec, values: np.ndarray, mask=None,
                  nrows: "int | None" = None) -> dict:
    """Host buffer set for one column under ``spec``: suffix -> numpy
    array. ``""`` is the primary buffer the scan reads, ``"#x"`` the
    RLE run STARTS (the decode rebuilds run ids via scatter+prefix
    sum), ``"#v"`` the (possibly bit-packed) validity mask. ``nrows``
    marks the live prefix (chunk tails and reduced views pad past
    it); RLE runs derive from the live prefix and the decode extends
    the last run over the pad. Null/pad slots clip into the packed
    range — they are gated by the row/validity masks, never read as
    values. A pure function of its arguments: no module or column memo
    is read or written here."""
    out: dict[str, np.ndarray] = {}
    if spec.kind == "bitpack":
        norm = values.astype(np.int64) - spec.lo
        if spec.bits >= 32:
            out[""] = np.clip(norm, 0, 2**31 - 1).astype(np.int32)
        else:
            norm = np.clip(norm, 0, (1 << spec.bits) - 1)
            out[""] = _pack_words(norm, spec.bits)
    elif spec.kind == "rle":
        live = values if nrows is None else values[:nrows]
        change = np.nonzero(live[1:] != live[:-1])[0]
        starts = np.concatenate(
            [np.zeros(1, dtype=np.int64), change + 1])
        out[""] = np.ascontiguousarray(live[starts])
        # run STARTS (not cumulative ends): the reference's decode
        # rebuilds run ids with one scatter + cumsum; the port's
        # kernel searches them per row
        out["#x"] = starts.astype(np.int32)
    else:
        out[""] = values
    if mask is not None:
        out["#v"] = (_pack_words(mask.astype(np.int64), 1)
                     if spec.mask_packed else mask)
    return out


def encode_column(spec: EncSpec, col) -> dict:
    return encode_values(spec, col.values, col.null_mask)


# -------------------------------------------------- per-table reporting

def scan_nbytes(col) -> int:
    """Bytes a device scan of this column reads under the active mode
    (encoded when a spec applies, raw otherwise) — the encoded-width
    input to the scheduler cost model and MemoryGovernor budget."""
    spec = column_spec(col)
    if spec is None:
        return raw_nbytes(col.values, col.null_mask)
    return encoded_nbytes(spec)


def table_specs(table) -> dict:
    """{column: EncSpec|None} under the active mode."""
    return {name: column_spec(col)
            for name, col in table.columns.items()}


def table_compression(table) -> dict:
    """Per-table compression report: raw vs encoded bytes and the
    ratio (1.0 when nothing encodes)."""
    raw = enc = 0
    for col in table.columns.values():
        r = raw_nbytes(col.values, col.null_mask)
        raw += r
        spec = column_spec(col)
        enc += r if spec is None else encoded_nbytes(spec)
    return {"raw_bytes": raw, "encoded_bytes": enc,
            "ratio": round(raw / enc, 4) if enc else 1.0}
