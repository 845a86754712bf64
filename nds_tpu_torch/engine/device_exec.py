"""Device executor of the port: one logical plan -> eager PyTorch on the card.

Port of ``nds_tpu/engine/device_exec.py`` for the plans of the NDS-H
and NDS (TPC-DS) power runs. The reference traces each plan into one static-shape XLA
program; this port runs the same dataflow eagerly with torch tensors on
the executor's device (``cuda`` unless the caller asks for the CPU), and
on the card captures each plan's launches once into a CUDA graph that its
later runs replay (``engine/plan_graph.py``, the counterpart of the
reference's compile-once program):

- **Masked fixed-capacity dataflow.** Every relation is a set of
  fixed-capacity tensors plus a boolean presence mask, with the
  reference's capacities: filters AND the mask, every operator's output
  capacity is a host-known function of its inputs', and M:N join
  overflow is counted on the device and read once per query, at its end,
  to retry with doubled slack exactly as the reference does.
- **Kernels.** The planner's kernel stamps (``engine/kernels.py``) pick
  the join, semi-join and grouped min/max machinery, and the executor
  counts the kernel each node actually used under the reference's names
  (``join.direct``, ``join.matmul``, ``semi.bitmask``, ``agg.segscan``
  ...), so each query's ``__kernels`` block matches the reference's.
  The hand-written CUDA kernels run behind those stamps (the radix
  partitioned M:N join among them), under the window functions'
  running and whole-partition aggregates, and in the sorts, searches
  and the result compactor; cumsum and gathers are torch library ops,
  as the reference left them to XLA.
- **Windows, set operations, DISTINCT** follow the reference: one
  multi-key sort into partition-major order per window column, with
  rank from running maxima, whole-partition sums from cumsum
  differences and running or whole-partition min/max from the
  segmented scan kernels; UNION concatenates and deduplicates by the
  group-id sort, INTERSECT/EXCEPT probe packed whole-row keys.
- **Staging.** Plans heavier than ``STAGE_WEIGHT`` nodes split at the
  reference's cuts (``engine/staging.py``) into sub-plans whose results
  become host temp tables, each sub-plan with a graph of its own. A
  capture is no compile, so the split buys no compile time here; it is
  kept so that the staged statements run with the reference's
  capacities, retries and kernel blocks.
- **Compressed columnar store.** Under an active ``columnar`` mode
  (``NDS_TPU_COLUMNAR`` or ``columnar.set_mode``; off by default) each
  scanned column uploads as its encoded buffer set (bit-packed words,
  RLE runs and starts, a packed mask), re-planned on the live rows of a
  survivor-reduced view, and decodes lazily where the run first reads
  it (``DVal.encoded``, the CUDA kernels of ``columnar_decode.cu``).
  ``bytes_scanned`` sums the buffers a query reads, encoded or not, as
  the reference does; an active mode adds ``bytes_scanned_raw`` and
  ``compression_ratio``.
- **Strings never reach the device.** Dictionary codes only; LIKE, IN
  and compares against literals are evaluated on the host dictionary
  into lookup tables the device gathers through.
- **Decimals are scaled int64**; division and AVG go through float64.

A multi-key ``lax.sort`` becomes order-preserving words of at most 32
bits, laid out on the host from the keys' bounds (``_sort_layout``) and
sorted stably from the least significant word up by the radix sort,
with the row ids as payload (``_sort_perm``), which gives the same
permutation as one stable lexicographic sort. Gathers whose index can
leave the array (dictionary codes of NULL rows) clamp it, since torch
faults where ``jnp.take`` fills. What is not ported yet (parameterized
literals, the reduced float precisions) raises ``DeviceExecError``: it
never runs on the CPU instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import time

import numpy as np
import torch

from nds_tpu_torch import columnar
from nds_tpu_torch.columnar import device as columnar_dev
from nds_tpu_torch.device import resolve_device
from nds_tpu_torch.engine import kernels as KX
from nds_tpu_torch.engine import staging
from nds_tpu_torch.engine.cpu_exec import ResultTable, like_mask
from nds_tpu_torch.engine.plan_graph import PlanGraphs
from nds_tpu_torch.engine.types import (
    DateType, DecimalType, DType, FloatType, IntType, StringType,
)
from nds_tpu_torch.io.host_table import HostTable
from nds_tpu_torch.resilience import faults, watchdog
from nds_tpu_torch.sql import ir
from nds_tpu_torch.sql import plan as P

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


class DeviceExecError(RuntimeError):
    pass


class DVal:
    """One evaluated column on the device: tensor + optional validity,
    plus host-side metadata (string dictionary; integer value bounds
    used for join-key bit packing).

    A column gathered through a join's, sort's or limit's row indices is
    lazy: it keeps its concrete source column and the indices (composed
    through later gathers, with the validity mask they clear), and
    gathers at first use. Eager execution would otherwise materialize
    every column of every join at the join's capacity, where the
    reference's compiled program drops the columns nothing reads.

    A scan column of an encoded upload (``nds_tpu_torch/columnar/``) is
    lazy too (``DVal.encoded``): its values and its packed mask decode
    apart, each at its first use in the run."""

    __slots__ = ("_arr", "_valid", "sdict", "lo", "hi", "_src", "_idx",
                 "_clear", "_enc_arr", "_enc_valid")

    def __init__(self, arr, valid=None, sdict=None, lo=None, hi=None):
        self._arr = arr
        self._valid = valid
        self.sdict = sdict
        self.lo = lo
        self.hi = hi
        self._src = self._idx = self._clear = None
        self._enc_arr = self._enc_valid = None

    @classmethod
    def encoded(cls, spec, bufs: dict, key: str, sdict=None, lo=None,
                hi=None) -> "DVal":
        """The scan column uploaded as the encoded buffer set ``bufs``
        under ``key``, decoded at first use."""
        out = cls(None, None, sdict, lo, hi)
        out._enc_arr = (spec, bufs, key)
        if key + "#v" in bufs:
            out._enc_valid = (spec, bufs, key)
        return out

    @property
    def arr(self):
        if self._enc_arr is not None:
            self._arr = columnar_dev.decode_values(*self._enc_arr)
            self._enc_arr = None
        if self._src is not None:
            self._materialize()
        return self._arr

    @property
    def valid(self):
        if self._enc_valid is not None:
            self._valid = columnar_dev.decode_validity(*self._enc_valid)
            self._enc_valid = None
        if self._src is not None:
            self._materialize()
        return self._valid

    def _materialize(self) -> None:
        src, idx, clear = self._src, self._idx, self._clear
        self._arr = src.arr.index_select(0, idx)
        valid = None if src.valid is None else src.valid.index_select(0,
                                                                      idx)
        self._valid = _and_valid(valid, clear)
        self._src = self._idx = self._clear = None

    def with_arrays(self, arr, valid):
        return DVal(arr, valid, self.sdict, self.lo, self.hi)

    def gather(self, idx, clear=None, memo: "dict | None" = None):
        """This column at rows ``idx`` (in range by construction), its
        validity ANDed with ``clear``; lazy. ``memo`` shares one
        composition of the indices among the columns of one context."""
        if self._src is None:
            base, bidx, bclear = self, idx, clear
        else:
            key = (id(self._idx), id(self._clear))
            hit = None if memo is None else memo.get(key)
            if hit is None:
                c0 = (None if self._clear is None
                      else self._clear.index_select(0, idx))
                hit = (self._idx.index_select(0, idx), _and_valid(c0, clear))
                if memo is not None:
                    memo[key] = hit
            base, (bidx, bclear) = self._src, hit
        out = DVal(None, None, self.sdict, self.lo, self.hi)
        out._src, out._idx, out._clear = base, bidx, bclear
        return out

    def head(self, cap: int):
        """The first ``cap`` rows, without gathering the rest."""
        if self._src is None:
            valid = self.valid
            return self.with_arrays(
                self.arr[:cap], None if valid is None else valid[:cap])
        out = DVal(None, None, self.sdict, self.lo, self.hi)
        out._src, out._idx = self._src, self._idx[:cap]
        out._clear = None if self._clear is None else self._clear[:cap]
        return out


def _pred_sig(e) -> str:
    """Canonical predicate signature with column bindings normalized
    out (the key of a table's survivor-reduced scan view)."""
    if isinstance(e, ir.ColRef):
        return f"col:{e.name}"
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        parts = [type(e).__name__]
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (list, tuple)):
                parts.append(
                    "[" + ",".join(_pred_sig(x) for x in v) + "]")
            else:
                parts.append(_pred_sig(v))
        return "(" + " ".join(parts) + ")"
    return repr(e)


def _ir_children(e):
    """Every IR node one step below e, through nested lists/tuples."""
    for f in dataclasses.fields(e):
        stack = [getattr(e, f.name)]
        while stack:
            v = stack.pop()
            if isinstance(v, (list, tuple)):
                stack.extend(v)
            elif isinstance(v, ir.IR):
                yield v


def _touches_float(e) -> bool:
    if isinstance(e, ir.IR):
        if isinstance(getattr(e, "dtype", None), FloatType):
            return True
        if isinstance(e, ir.Arith) and e.op == "/":
            return True
        return any(_touches_float(c) for c in _ir_children(e))
    return False


_EXACT_FLOAT_NODES = (
    ir.ColRef, ir.Lit, ir.Arith, ir.Cmp, ir.BoolOp, ir.Not, ir.Neg,
    ir.CaseIR, ir.LikeIR, ir.InListIR, ir.IsNullIR, ir.ExtractIR,
    ir.SubstrIR, ir.StrMapIR, ir.ConcatIR, ir.CastIR)


def _float_exact_safe(e) -> bool:
    """Host f64 reduction of a float-touching predicate is sound only
    when every node evaluates bit-identically on the host and the
    device f64 path."""
    if isinstance(e, ir.IR):
        if not isinstance(e, _EXACT_FLOAT_NODES):
            return False
        return all(_float_exact_safe(c) for c in _ir_children(e))
    return True


class _ReducedScan:
    """A survivor-reduced view of one table for one scan-filter
    signature: host row indices of the survivors plus a power-of-two
    padded capacity."""

    __slots__ = ("prefix", "table", "nrows", "capacity", "idx")

    def __init__(self, prefix: str, table: str, nrows: int, idx):
        self.prefix = prefix
        self.table = table
        self.nrows = nrows
        self.idx = idx
        c = 1
        while c < max(nrows, 1):
            c <<= 1
        self.capacity = c


class DCtx:
    """One relation: capacity (host int), presence mask (bool tensor),
    and columns keyed by (binding, name)."""

    # set True only by a scan whose arrays are in host storage order
    # with a prefix row mask (the presorted-build fast path)
    pristine = False

    def __init__(self, n: int, row):
        self.n = n
        self.row = row
        self.cols: dict[tuple, DVal] = {}

    def gather(self, idx, clear_valid=None) -> "DCtx":
        """New ctx with every column gathered at idx (in range by
        construction), lazily (``DVal.gather``). clear_valid, if given,
        is ANDed into every column's validity (nulls out the build side
        of outer joins)."""
        out = DCtx(idx.shape[0], None)
        memo: dict = {}
        for k, dv in self.cols.items():
            out.cols[k] = dv.gather(idx, clear_valid, memo)
        return out

    def merge(self, other: "DCtx") -> "DCtx":
        if self.n != other.n:
            raise DeviceExecError("merging contexts of unequal capacity")
        out = DCtx(self.n, self.row)
        out.cols.update(self.cols)
        out.cols.update(other.cols)
        return out


def _ok(dv: DVal, row):
    """Row-presence AND value-validity for a column."""
    return row if dv.valid is None else (row & dv.valid)


def _scale_of(t: DType) -> int:
    return t.scale if isinstance(t, DecimalType) else 0


def _to_float(arr, t: DType, fdt):
    if isinstance(t, DecimalType):
        # the divisor is a tensor on the array's device: on the card torch
        # turns a division by a Python number into a multiplication by its
        # reciprocal, whose result can differ from the CPU oracle's
        # quotient in the last bit, and so break a tie that a rank or an
        # ORDER BY over a decimal ratio sees (NDS q49)
        return arr.to(fdt) / torch.full((), 10.0 ** t.scale, dtype=fdt,
                                        device=arr.device)
    return arr.to(fdt)


def _rescale(arr, from_s: int, to_s: int):
    if from_s == to_s:
        return arr
    if to_s > from_s:
        return arr.to(torch.int64) * (10 ** (to_s - from_s))
    return torch.floor_divide(arr.to(torch.int64), 10 ** (from_s - to_s))


def _merge_stage_bill(timings: dict, bill: dict) -> None:
    """Fold the staged sub-plans' timings and kernel counts into the
    main plan's, so ``last_timings`` bills the whole statement."""
    for k, v in bill.items():
        if k == "__kernels":
            kacc = timings.setdefault("__kernels", {})
            for kn, cnt in v.items():
                kacc[kn] = kacc.get(kn, 0) + cnt
        else:
            timings[k] = timings.get(k, 0.0) + v


def _memo(store: dict, cap: int, key: tuple, pins: tuple, build):
    """``build()`` memoized in ``store`` under ``key``, FIFO-bounded to
    ``cap`` entries. The entry pins the ``pins`` objects whose ids are in
    ``key``, so a recycled id cannot serve a stale value."""
    hit = store.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], pins)):
        return hit[1]
    value = build()
    while store and len(store) >= cap:
        store.pop(next(iter(store)))
    store[key] = (tuple(pins), value)
    return value


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _promoted(ks, q):
    """``ks`` and ``q`` in one dtype, as ``jnp.searchsorted`` promotes."""
    if ks.dtype != q.dtype:
        dt = torch.promote_types(ks.dtype, q.dtype)
        ks, q = ks.to(dt), q.to(dt)
    return ks.contiguous(), q.contiguous()


def _ss(ks, q, side="left"):
    """searchsorted of q into the sorted ks (the reference's ``_ss``):
    int64 places for ``side`` "left" or "right", both for "both"
    (``kernels.sorted_search``)."""
    return KX.sorted_search(*_promoted(ks, q), side)


def _take_codes(table, codes):
    """Host-built lookup table gathered at dictionary codes, clamped:
    codes of NULL rows may be any value (``jnp.take`` fills those, torch
    would fault). An empty table (the map of an empty dictionary, whose
    column holds no value) gives zeros, where ``jnp.take`` raises."""
    n = table.shape[0]
    if n == 0:
        return torch.zeros(codes.shape, dtype=table.dtype,
                           device=codes.device)
    return table.index_select(0, codes.to(torch.int64).clamp(0, n - 1))


def _lexsort(keys, n: int, device):
    """Stable permutation sorting rows by ``keys`` (most significant
    first): one stable sort per key from the least significant up, the
    same order as ``lax.sort(keys + [iota], num_keys=len(keys),
    is_stable=True)``. The plain cross-check of ``_sort_perm``: the
    executor never calls it."""
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for key in reversed(keys):
        _, idx = torch.sort(key.index_select(0, perm), stable=True)
        perm = perm.index_select(0, idx)
    return perm


@dataclasses.dataclass(frozen=True, eq=False)
class SortKey:
    """One operand of a multi-key sort, as the reference builds it:
    ``arr`` filled with 0 where ``valid`` is False or, with ``use_row``,
    the row is not present; then taken as 1 - value (``invert``, a bool:
    a presence or NULLS LAST rank) and negated (``negate``: a descending
    key). ``lo``/``hi`` bound ``arr`` on every slot the fill leaves, the
    absent rows' among them (None where no such bound is known)."""
    arr: torch.Tensor
    valid: "torch.Tensor | None" = None
    use_row: bool = False
    invert: bool = False
    negate: bool = False
    lo: "int | None" = None
    hi: "int | None" = None


def _sort_operand(row, k: SortKey):
    """The operand ``k`` stands for, as a tensor (``_lexsort``'s input;
    a bool as int32)."""
    v = k.arr.to(torch.int32) if k.arr.dtype == torch.bool else k.arr
    ok = _and_valid(row if k.use_row else None, k.valid)
    if ok is not None:
        v = torch.where(ok, v, torch.zeros((), dtype=v.dtype,
                                           device=v.device))
    if k.invert:
        v = 1 - v
    return -v if k.negate else v


def _sort_field(k: SortKey) -> tuple:
    """``(mode, lo, width)`` of one operand's field (``kernels.SORT_*``):
    a float takes its full width in ``lax.sort``'s order; an integer
    whose values, fill and negation included, lie in a span narrower than
    its type takes value - lo in the span's bits; any other integer its
    full width."""
    dt = k.arr.dtype
    if dt.is_floating_point:
        return KX.SORT_FLOAT, 0, torch.finfo(dt).bits
    if dt == torch.bool:
        lo, hi, full = 0, 1, 64
    else:
        lo, hi, full = k.lo, k.hi, torch.iinfo(dt).bits
        if lo is None or hi is None or (k.negate
                                        and lo == torch.iinfo(dt).min):
            return KX.SORT_INT, 0, full
    lo, hi = int(lo), int(hi)
    if k.negate:
        lo, hi = -hi, -lo
    lo, hi = min(lo, 0), max(hi, 0)
    width = (hi - lo).bit_length()
    if width >= full:
        return KX.SORT_INT, 0, full
    return KX.SORT_SPAN, lo, width


def _sort_layout(keys, n: int) -> list:
    """How a multi-key sort's operands (``SortKey``s, the most
    significant first) split into words, decided on the host from their
    bounds: ``[(pieces, bits), ...]``, the most significant word first.
    The operands' order-preserving bits (``_sort_field``; a field of no
    bits, a span of one value, takes none), the most significant first,
    make one string, which is cut into words of at most 32 bits and
    ``kernels.SORT_MAX_FIELDS`` pieces; each piece ``(index of its key,
    mode, lo, width, shift)`` is bits ``[shift, shift + width)`` of its
    operand's field, so an operand may straddle two words (or three). The
    cuts take the fewest digit passes (a word of w bits sorts in ceil(w /
    8) passes of 8 bits), then the fewest words, then the fewest operands
    split, and of those the one whose least significant word is longest.
    A bound is only as good as the fill behind it: a key whose absent
    rows are not filled is bounded only where its ``lo``/``hi`` hold there
    too (``SortKey``)."""
    if not 1 <= n < 2**31 - 1:
        raise DeviceExecError(f"a sort of {n} rows: the row ids are int32")
    fields = [(i, *_sort_field(k)) for i, k in enumerate(keys)]
    fields = [f for f in fields if f[3]]
    words = []
    start = 0
    for cut in _sort_cuts(tuple(f[3] for f in fields), KX.SORT_MAX_FIELDS):
        pieces, top = [], 0
        for i, mode, lo, width in fields:
            a, b = max(start, top), min(cut, top + width)
            if a < b:
                pieces.append((i, mode, lo, b - a, top + width - b))
            top += width
        words.append((pieces, cut - start))
        start = cut
    return words


@functools.lru_cache(maxsize=256)
def _sort_cuts(widths: tuple, max_pieces: int) -> tuple:
    """The ends of the words of ``_sort_layout`` over fields of
    ``widths`` bits (the most significant first), each word at most 32
    bits and ``max_pieces`` pieces: the least cost (digit passes, then
    words, then fields split) over every way to cut, by dynamic
    programming over the bit positions from the top."""
    total = sum(widths)
    field_at = []  # the field of each bit, from the top
    first = []     # the first bit of each field
    for f, w in enumerate(widths):
        first.append(len(field_at))
        field_at += [f] * w
    # cost as one integer: passes, then words, then splits
    unit_pass, unit_word = 1 << 40, 1 << 20
    best = [0] + [None] * total
    back = [0] * (total + 1)
    for c in range(1, total + 1):
        # a cut at c inside a field splits it, counted at its first cut
        inside = c < total and first[field_at[c]] < c
        for p in range(max(0, c - 32), c):
            if best[p] is None or field_at[c - 1] - field_at[p] >= max_pieces:
                continue
            cost = (best[p] + unit_pass * -(-(c - p) // 8) + unit_word
                    + (1 if inside and p <= first[field_at[c]] else 0))
            if best[c] is None or cost < best[c]:
                best[c], back[c] = cost, p
    cuts = []
    c = total
    while c:
        cuts.append(c)
        c = back[c]
    return tuple(reversed(cuts))


def _word_args(row, keys, pieces, bits: int) -> tuple:
    """``kernels.pack_sort_key``'s arguments for one word of
    ``_sort_layout``: the row mask where a piece fills by it, each
    piece's operand values and validity, its ``(flags, mode, lo, width,
    shift)``, the word's bits."""
    flags = [KX.SORT_USE_ROW * keys[i].use_row
             | KX.SORT_INVERT * keys[i].invert
             | KX.SORT_NEGATE * keys[i].negate for i, *_f in pieces]
    return (row if any(f & KX.SORT_USE_ROW for f in flags) else None,
            [keys[i].arr.contiguous() for i, *_f in pieces],
            [None if keys[i].valid is None else keys[i].valid.contiguous()
             for i, *_f in pieces],
            [(f, *piece) for f, (_i, *piece) in zip(flags, pieces)],
            bits)


def _sort_perm(row, keys, n: int, device):
    """The stable permutation (int32) sorting the rows by ``keys``
    (``SortKey``s, the most significant first), ``_lexsort``'s of their
    operands exactly: each word of ``_sort_layout``, from the least
    significant up, packed in the order of the permutation so far
    (``kernels.pack_sort_key``, which counts the word's digits too) and
    sorted stably with that permutation as its payload (``partition_sort``
    over one partition, from those counts). ``row``: the mask the
    ``use_row`` keys fill by."""
    perm = torch.arange(n, dtype=torch.int32, device=device)
    counts = torch.full((1,), n, dtype=torch.int32, device=device)
    first = True
    for pieces, bits in reversed(_sort_layout(keys, n)):
        word, hist = KX.pack_sort_key(*_word_args(row, keys, pieces, bits),
                                      None if first else perm)
        _ks, perm = KX.partition_sort(word.view(1, n), perm.view(1, n),
                                      counts, hist)
        perm = perm.view(n)
        first = False
    return perm


def _sort_values(key):
    """``key`` (int32 or int64) sorted: ``partition_sort`` of one word."""
    n = key.shape[0]
    ks, _ = KX.partition_sort(
        key.contiguous().view(1, n),
        torch.arange(n, dtype=torch.int32, device=key.device).view(1, n),
        torch.full((1,), n, dtype=torch.int32, device=key.device))
    return ks.view(n)


def _group_sort_keys(row, keyvals) -> list:
    """The keys of the reference's group-id sort, most significant
    first: presence, then per key its validity (where it has one) and its
    narrowed value filled with 0 where not ``_ok`` (``:2207-2218``); the
    fill bounds a key on every slot where its values are bounded."""
    keys = [SortKey(row, invert=True)]
    for kv in keyvals:
        if kv.valid is not None:
            keys.append(SortKey(kv.valid, invert=True))
        lo, hi = ((0, len(kv.sdict) - 1) if kv.sdict is not None
                  else (kv.lo, kv.hi))
        keys.append(SortKey(_narrow_key(kv), kv.valid, use_row=True,
                            lo=lo, hi=hi))
    return keys


def _group_operands(row, keyvals) -> list:
    """The operands of the reference's group-id sort, as tensors."""
    return [_sort_operand(row, k) for k in _group_sort_keys(row, keyvals)]


def _order_keys(dv, asc: bool, nulls_first: bool) -> list:
    """An ORDER BY or window order key's sort keys (the reference's
    ``_run_sort`` ``:2598-2608``): its NULL rank where it has a validity,
    then its narrowed value (a bool as 0/1), negated where descending and
    0 where NULL. Absent rows keep their values, so no bound holds on
    every slot: the value takes its full width."""
    keys = []
    if dv.valid is not None:
        keys.append(SortKey(dv.valid, invert=not nulls_first))
    keys.append(SortKey(_narrow_key(dv), dv.valid, negate=not asc))
    return keys


# the widest packed group key: an int64 that stays non-negative
PACK_MAX_BITS = 63


def _pack_layout(keyvals, n: int):
    """How the group-id sort's operands pack into one non-negative
    integer, decided on the host from bounds: ``(fields, bits)``, where
    ``fields`` holds per key (has a validity bit, low end of its value
    span, value bits) and ``bits`` counts them all with the presence bit
    at the top; None where a key is a float or has no bounds, the layout
    needs more than ``PACK_MAX_BITS`` bits or more fields than the pack
    kernel takes, or the rows do not fit the sort's int32 row ids. A
    value is filled with 0 where it is not ``_ok``, so its span takes in
    0; a bool packs as 0/1; a dictionary code spans its dictionary."""
    if not 1 <= n < 2**31 - 1:
        return None
    fields, bits = [], 1
    for kv in keyvals:
        dtype = kv.arr.dtype
        if dtype == torch.bool:
            lo, hi = 0, 1
        elif dtype not in (torch.int32, torch.int64):
            return None
        elif kv.sdict is not None:
            lo, hi = 0, len(kv.sdict) - 1
        elif kv.lo is None or kv.hi is None:
            return None
        else:
            lo, hi = int(kv.lo), int(kv.hi)
        lo, hi = min(lo, 0), max(hi, 0)
        width = (hi - lo).bit_length()
        has_valid = kv.valid is not None
        bits += int(has_valid) + width
        if bits > PACK_MAX_BITS:
            return None
        fields.append((has_valid, lo, width))
    if sum(1 for v, _lo, w in fields if v or w) > KX.PACK_MAX_FIELDS:
        return None
    return fields, bits


def _pack_group_key(row, keyvals, fields, bits: int):
    """The group-id sort's operands as one key (``_pack_layout``), and the
    counts of its 8-bit digits: ``(key, counts)``. The key is int32 for up
    to 32 bits (a key of 32 biased by -2^31, which keeps its order), else
    int64; the presence bit (set where the row is not present) at bit
    ``bits - 1``, then per key its validity bit (set where NULL) and its
    filled value minus the span's low end, in one pass
    (``kernels.pack_group_key``). The order of the keys is the
    lexicographic order of the operands. The values need no narrowing:
    they are the same in either width."""
    return KX.pack_group_key(row, [kv.arr.contiguous() for kv in keyvals],
                             [None if kv.valid is None
                              else kv.valid.contiguous() for kv in keyvals],
                             fields, bits)


def _epoch_days_to_civil(days):
    """Hinnant's algorithm: epoch days -> (year, month, day), integer ops
    only."""
    z = days.to(torch.int64) + 719468
    era = torch.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = torch.floor_divide(
        doe - torch.floor_divide(doe, 1460) + torch.floor_divide(doe, 36524)
        - torch.floor_divide(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.floor_divide(yoe, 4)
                 - torch.floor_divide(yoe, 100))
    mp = torch.floor_divide(5 * doy + 2, 153)
    d = doy - torch.floor_divide(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _narrow_key(dv: DVal):
    """int64 sort keys whose host bounds fit int32 narrow to int32 (the
    reference's choice; the values, and so the order, are the same)."""
    arr = dv.arr
    if (arr.dtype == torch.int64 and dv.lo is not None
            and dv.hi is not None and -2**31 < dv.lo
            and dv.hi < 2**31 - 1):
        return arr.to(torch.int32)
    return arr


def _plan_bindings(node: P.Node) -> set:
    out = set()
    for n in P.walk_plan(node):
        b = getattr(n, "binding", "")
        if b:
            out.add(b)
    return out


def _expr_bindings(e: ir.IR) -> set:
    return {x.binding for x in ir.walk(e) if isinstance(x, ir.ColRef)}


def _plan_label(planned: P.PlannedQuery) -> str:
    """A plan's name in an error: its digest, tables and output
    columns."""
    tables = sorted({n.table for root in [planned.root,
                                          *planned.scalar_subplans]
                     for n in P.walk_plan(root) if isinstance(n, P.Scan)})
    cols = planned.column_names or [n for n, _ in planned.root.output]
    return (f"plan {staging.plan_digest(planned)} (tables "
            f"{', '.join(tables)}; columns {', '.join(map(str, cols))})")


class DeviceExecutor:
    """Executes logical plans with torch tensors on one device. One
    instance lives for a whole session: it owns the device buffer pool
    (columns uploaded once, the load analog), each plan's slack and, on
    the card, each plan's CUDA graph (``engine/plan_graph.py``): a plan's
    first call runs eagerly and captures, later calls replay."""

    DEFAULT_SLACK = 2.0

    # capture each plan into a CUDA graph on the card and replay it. The
    # class's value decides whether an executor gets a graph runner (its
    # stream and pool) at all; an instance may set it False to run its
    # plans eagerly while its graphs stay
    use_graphs = True

    def __init__(self, tables: dict[str, HostTable], device=None):
        self.tables = tables
        self.device = resolve_device(device)
        # the graph runner: the executor's own stream, one graph memory
        # pool and a graph per plan; only on the card (the CPU has nothing
        # to capture)
        self._graphs = (PlanGraphs(self.device)
                        if self.use_graphs and self.device.type == "cuda"
                        else None)
        # the host table each table's device state was built from: a
        # table registered again drops that state (``_check_table``)
        self._table_src: dict[str, HostTable] = {}
        # uploads so far: a replay must find every buffer of its graph
        # resident
        self._uploads = 0
        # the slack a plan's first run takes (each plan keeps its own,
        # doubled on overflow)
        self.slack = self.DEFAULT_SLACK
        self._buffers: dict[str, torch.Tensor] = {}
        # columnar encoding state (nds_tpu_torch/columnar/): buffer key
        # -> EncSpec of every ENCODED upload (the scan decodes by it),
        # and the raw host bytes that buffer set replaces (the
        # compression_ratio numerator). Both live and die with the
        # corresponding _buffers entries (_drop_col_buffers)
        self._enc_specs: dict[str, object] = {}
        self._raw_nbytes: dict[str, float] = {}
        # tables that upload raw even under an active mode (the
        # reference's chunk-swapped tables; none in the port yet)
        self._no_encode: set = set()
        self._bounds: dict[tuple, tuple] = {}
        self._scan_views: dict[tuple, object] = {}
        # host-built dictionary lookup tables (LIKE/IN/compare masks,
        # string rewrites) keyed by the dictionary's identity and the
        # operation: the reference bakes them into each compiled
        # program once; eager execution would rebuild them per run
        self._dict_tables: dict[tuple, tuple] = {}
        # memoized string-dictionary unions, bounded apart by
        # ``columnar.dict_union_cap()`` as the reference bounds its own
        self._union_cache: dict[tuple, tuple] = {}
        # per-plan state keyed by id(plan) (or a staged sub-plan's key);
        # each entry pins its plan so the id cannot be recycled while
        # the entry lives
        self._entries: dict[object, dict] = {}
        self.last_timings: dict = {}
        # host-staged plan splitting (engine/staging.py): key -> the
        # once-computed (orig_planned, [(sub_planned, temp_name), ...],
        # main_planned); orig_planned pins the caller's plan object
        self._stage_plans: dict[object, tuple] = {}
        self._stage_fps: dict[str, str] = {}  # temp -> content md5

    # ------------------------------------------------------------------ API

    MAX_ENTRIES = 256
    MAX_RETRIES = 3

    # plans whose deduplicated node count exceeds this split into
    # sub-plans with host-staged intermediates: the reference's default
    # (``NDS_TPU_STAGE``)
    STAGE_WEIGHT = 56

    def execute(self, planned: P.PlannedQuery,
                key: object = None) -> ResultTable:
        """Run one planned query to its result on the host:
        ``execute_async(planned, key).result()``."""
        return self.execute_async(planned, key).result()

    def execute_async(self, planned: P.PlannedQuery, key: object = None):
        """Dispatch one planned query; returns a handle whose ``result()``
        gives the ``ResultTable``. On M:N join overflow the plan runs again
        at a doubled slack (kept for the plan's later runs). ``key`` names
        the plan's state (its id by default; staged sub-plans run under
        ``(key, "__stage__", i)``). On the card a plan's first call runs
        eagerly and then captures its launches into a CUDA graph
        (``compile_ms`` bills the capture); that call, every run on the
        CPU and every eager run return a completed handle. A later call
        replays the graph and queues its copies to the host on the
        executor's stream at once, before any other graph can replay,
        into pinned host buffers of this dispatch's own; ``result()``
        waits for them, checks the overflow and materializes
        (``_Replayed``). Everything runs on the executor's stream."""
        if not isinstance(planned, P.PlannedQuery):
            raise DeviceExecError(f"cannot execute {type(planned).__name__}")
        # on the host before any dispatch, eager run or replay alike
        # (never inside a capture: fault_point checks)
        faults.fault_point("device.execute", executor=type(self).__name__)
        watchdog.beat("engine", phase="device.execute",
                      executor=type(self).__name__)
        key = id(planned) if key is None else key
        entry = self._entries.get(key)
        if entry is None or entry["ref"] is not planned:
            if entry is not None:
                self._evict_query_state(key)
            entry = {"slack": self.slack, "ref": planned}
            self._entries[key] = entry
            self._bound_entries(key)
        with self._on_stream():
            return self._dispatch(planned, key, entry)

    def _on_stream(self):
        return (self._graphs.on_stream() if self._graphs is not None
                else contextlib.nullcontext())

    def _dispatch(self, planned: P.PlannedQuery, key, entry: dict):
        planned, stage_bill = self._staged_effective(planned, key)
        timings: dict = {"compile_ms": 0.0}
        t0 = time.perf_counter()
        # bytes the query reads from its device-resident scan buffers
        # (encoded ones under an active mode), uploading what is not
        # resident yet, as the reference does at dispatch
        uploads = self._uploads
        bufs = self._collect_buffers(planned)
        timings["bytes_scanned"] = float(
            sum(t.numel() * t.element_size() for t in bufs.values()))
        self._attach_compression(timings, bufs)
        self._attach_delta(timings, planned)
        del bufs
        run = (planned, key, entry, timings, t0, stage_bill)
        graphs = self._graphs if self.use_graphs else None
        pg = None if graphs is None else graphs.get(key)
        if (graphs is None and self._graphs is not None
                and self._graphs.get(key) is not None):
            # graphs off on an executor that holds this plan's graph: run
            # it eagerly from the graphs' pool
            with self._graphs.pool_run(self._label(entry, planned)):
                host, side, retries, t1 = self._first_run(
                    planned, key, entry, 0, timings, None)
            return _Done(self._finish(run, host, side, retries, t1))
        if pg is not None:
            if (pg.plan is not planned or self._uploads != uploads
                    or pg.side["bytes_scanned"] != timings["bytes_scanned"]):
                raise DeviceExecError(
                    f"the graph of {self._label(entry, planned)} would "
                    f"read buffers other than those it was captured with")
            return _Replayed(self, run, pg.side,
                             _HostCopies(self, *graphs.replay(pg)))
        return _Done(self._finish(run, None, None, 0, None))

    def _finish(self, run: tuple, host, side, retries: int, t1):
        """The blocking half of a dispatch: with ``host`` None, the plan's
        eager run (and, with graphs, its capture), once more after the
        graphs' pool is reset where it runs out of memory; then the
        materialized result, and the query's ``last_timings``."""
        planned, key, entry, timings, t0, stage_bill = run
        graphs = self._graphs if self.use_graphs else None
        if host is None:
            for attempt in (0, 1):
                try:
                    host, side, retries, t1 = self._first_run(
                        planned, key, entry, retries, timings, graphs)
                    break
                except torch.cuda.OutOfMemoryError:
                    if attempt or graphs is None or not graphs.graphs:
                        raise
                # outside the handler, so that the failed run's tensors
                # are gone: drop every graph and the pool, then once more
                graphs.reset()
        t2 = time.perf_counter()
        row_h, outs_h = host
        out = self._materialize(planned, row_h, outs_h, side["dicts"])
        t3 = time.perf_counter()
        timings["execute_ms"] = ((t1 or t2) - t0) * 1000
        timings["materialize_ms"] = (t3 - t2) * 1000
        timings["slack_retries"] = float(retries)
        timings["__kernels"] = dict(side["kernels"])
        if stage_bill:
            _merge_stage_bill(timings, stage_bill)
            bs = timings.get("bytes_scanned", 0.0)
            if bs and timings.get("bytes_scanned_raw"):
                # whole-statement ratio: the sub-plans' raw bytes count
                timings["compression_ratio"] = round(
                    timings["bytes_scanned_raw"] / bs, 4)
        self.last_timings = timings
        return out

    @staticmethod
    def _label(entry: dict, planned) -> str:
        """The plan's name in errors (``_plan_label``), once per entry."""
        if "label" not in entry:
            entry["label"] = _plan_label(planned)
        return entry["label"]

    def _first_run(self, planned, key, entry: dict, retries: int,
                   timings: dict, graphs) -> tuple:
        """The plan's eager run, retried with a doubled slack on overflow,
        then, with ``graphs``, its capture at the slack that held (into
        ``compile_ms``). Returns (host result, side, retries, the time
        the eager run ended)."""
        while True:
            e0 = KX.lookback_epochs()
            tr = self._trace(entry["slack"])
            row, outs, dicts = tr.run_query(planned)
            host = self._to_host(*self._on_device(row, outs,
                                                  tr.total_overflow()))
            if host is not None:
                break
            if retries >= self.MAX_RETRIES:
                raise DeviceExecError("join expansion overflow after retries")
            retries += 1
            _notify_overflow(entry)
            entry["slack"] *= 2
        side = {"dicts": dicts, "kernels": dict(tr.kernels),
                "bytes_scanned": timings["bytes_scanned"]}
        del tr, row, outs
        t1 = time.perf_counter()
        if graphs is not None:
            slack = entry["slack"]

            def captured():
                tr = self._trace(slack)
                row, outs, _dicts = tr.run_query(planned)
                return self._on_device(row, outs, tr.total_overflow())
            graphs.capture(key, planned, self._label(entry, planned), e0,
                           side, captured)
            timings["compile_ms"] = (time.perf_counter() - t1) * 1000
        return host, side, retries, t1

    def _trace(self, slack: float) -> "_Trace":
        return _Trace(self, slack)

    @staticmethod
    def _is_stage_key(k: object) -> bool:
        return isinstance(k, tuple) and len(k) == 3 and k[1] == "__stage__"

    def _stage_key_derives_from(self, k: object, base: object) -> bool:
        """True when k is a (recursive) staged sub-plan key rooted at
        base."""
        while self._is_stage_key(k):
            k = k[0]
            if k == base:
                return True
        return False

    def _bound_entries(self, active: object) -> None:
        """FIFO-evict plan entries past MAX_ENTRIES, with their staged
        state; never the entry being run, nor staged sub-plan entries
        (those go with their base key)."""
        while len(self._entries) > self.MAX_ENTRIES:
            victim = next((k for k in self._entries
                           if k != active and not self._is_stage_key(k)),
                          None)
            if victim is None:
                return
            self._evict_query_state(victim)

    def _evict_query_state(self, key: object) -> None:
        """Drop the entry of ``key`` and every staged sub-plan entry
        derived from it, unregistering the split's temp tables."""
        for d in (self._stage_plans, self._entries):
            for k in [key] + [k for k in d
                              if self._stage_key_derives_from(k, key)]:
                old = d.pop(k, None)
                if d is self._stage_plans and old is not None:
                    for _sub, temp in old[1]:
                        self._unregister_staged(temp)
                if d is self._entries and self._graphs is not None:
                    self._graphs.drop(k)

    # ------------------------------------------------------------ staging

    def _staged_effective(self, planned: P.PlannedQuery, key):
        """(plan to run, the sub-plans' bill) for ``planned``: itself
        below STAGE_WEIGHT, else its staged main plan, after running
        every sub-plan (each run pays for its sub-plans) and registering
        their results as temp tables. The split is computed once per
        key, with the reference's cuts and temp names; the bill sums the
        sub-plans' timings and kernel counts."""
        # execute() evicts a key's split when the key's plan changes
        plans = self._stage_plans.get(key)
        if plans is None:
            subs, main = [], planned
            base_digest = None
            while staging.plan_weight(main) > self.STAGE_WEIGHT:
                cut = staging.choose_cut(main)
                if cut is None:
                    break
                if base_digest is None:
                    base_digest = staging.plan_digest(planned)
                temp = staging.stage_temp_name(base_digest, len(subs))
                sub, main = staging.build_stage(main, cut, temp)
                subs.append((sub, temp))
            plans = (planned, subs, main)
            self._stage_plans[key] = plans
        _orig, subs, main = plans
        agg: dict = {}
        for i, (sub, temp) in enumerate(subs):
            # recursive: an oversized sub-plan splits again here
            rt = self.execute(sub, key=(key, "__stage__", i))
            _merge_stage_bill(agg, {
                k: v for k, v in self.last_timings.items()
                if k in ("compile_ms", "execute_ms", "materialize_ms",
                         "slack_retries", "bytes_scanned",
                         "bytes_scanned_raw", "__kernels")})
            self._register_staged(temp, staging.result_to_host_table(
                temp, rt))
        if subs:
            agg["staged_programs"] = len(subs)
        return main, agg

    def _register_staged(self, temp: str, table: HostTable) -> None:
        """(Re-)register a staged temp table, dropping its device
        buffers, bounds and scan views when the content changed; an
        unchanged result keeps the registered table and its buffers."""
        h = hashlib.md5()
        for name in sorted(table.columns):
            arr = np.ascontiguousarray(table.columns[name].values)
            h.update(name.encode())
            h.update(str(arr.shape).encode())
            h.update(arr)
        fp = h.hexdigest()
        if self._stage_fps.get(temp) == fp:
            return
        self._stage_fps[temp] = fp
        self.tables[temp] = table
        self._drop_table_state(temp)

    def _unregister_staged(self, temp: str) -> None:
        self.tables.pop(temp, None)
        self._stage_fps.pop(temp, None)
        self._drop_table_state(temp)

    def _drop_table_state(self, table: str) -> None:
        """Free one table's device buffers (its reduced scan views'
        too) with their encoding specs, host bounds and scan views."""
        self._table_src.pop(table, None)
        self._drop_col_buffers(table + ".")
        for ck in [ck for ck in self._scan_views if ck[0] == table]:
            old = self._scan_views.pop(ck)
            if isinstance(old, _ReducedScan):
                self._drop_col_buffers(old.prefix + ".")
        for k in [k for k in self._bounds if k[0] == table]:
            del self._bounds[k]

    def invalidate_tables(self, names) -> None:
        """Scoped DML invalidation (the reference's ``invalidate_tables``):
        drop only the mutated tables' device state, that is their column
        buffers and deleted-row masks, their bounds and ``col_is_sorted``
        verdicts, their scan views and every graph that read any of
        them. Every other table's buffers, and the graphs of plans that
        read none of the mutated tables, stay."""
        for t in set(names):
            self._drop_table_state(t)

    def _drop_col_buffers(self, prefix: str) -> None:
        """Free every device buffer under a key prefix together with its
        encoding bookkeeping (a stale EncSpec outliving its buffer would
        mis-decode whatever uploads again under the same key) and the
        graphs that read any of them."""
        for d in (self._buffers, self._enc_specs, self._raw_nbytes):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]
        if self._graphs is not None:
            self._graphs.drop_reading(prefix)

    def _no_fill(self, cache: str) -> None:
        """Raise if ``cache`` is about to be filled while a plan is being
        captured, or run from the graphs' pool: the fill would not be in
        the graph (an upload's pageable copy cannot even be captured), and
        what it made would be pool memory that later replays overwrite."""
        barring = None if self._graphs is None else self._graphs.barring
        if barring is not None:
            raise DeviceExecError(
                f"{cache} would be filled while {barring}: the plan's "
                f"eager run before its capture must have filled it")

    def _check_table(self, table: str) -> None:
        """Drop the device state of a table registered again since that
        state was built (its buffers, bounds and views, and the graphs
        that read them)."""
        cur = self.tables[table]
        src = self._table_src.get(table)
        if src is not cur:
            if src is not None:
                self._drop_table_state(table)
            self._table_src[table] = cur

    def _attach_compression(self, timings: dict, bufs: dict) -> None:
        """Under an active columnar mode, the raw bytes the query's scan
        buffers replace (``bytes_scanned_raw``) and ``compression_ratio``
        over ``bytes_scanned``; nothing with the mode off, so those
        summaries stay as they were."""
        if not columnar.enabled():
            return
        raw = 0.0
        for k, t in bufs.items():
            base = k[:-2] if k.endswith(("#v", "#x")) else k
            if base in self._enc_specs:
                if k == base:
                    raw += self._raw_nbytes.get(
                        base, float(t.numel() * t.element_size()))
            else:
                raw += float(t.numel() * t.element_size())
        timings["bytes_scanned_raw"] = raw
        if timings.get("bytes_scanned") and raw:
            timings["compression_ratio"] = round(
                raw / timings["bytes_scanned"], 4)

    def _attach_delta(self, timings: dict, planned) -> None:
        """Per-query delta accounting (``columnar/delta.py``): how many
        append-only segments and deleted-row mask entries rode under the
        tables this query scanned. Emitted only when a scanned table
        carries delta state, so the summaries of queries over unmutated
        tables stay as they were."""
        from nds_tpu_torch.columnar import delta
        scanned = {node.table
                   for root in [planned.root, *planned.scalar_subplans]
                   for node in P.walk_plan(root)
                   if isinstance(node, P.Scan)}
        segments = appended = masked = 0
        hit = False
        for t in sorted(scanned):
            rep = delta.delta_report(self.tables.get(t))
            if rep is None:
                continue
            hit = True
            segments += rep["segments"]
            appended += rep["appended_rows"]
            masked += rep["masked_rows"]
        if hit:
            timings["delta_segments"] = float(segments)
            timings["delta_appended_rows"] = float(appended)
            timings["delta_masked_rows"] = float(masked)

    # capacity at or above which results compact on the device before
    # the copy to the host (the reference's COMPACT_MIN_ROWS)
    COMPACT_MIN_ROWS = 1 << 17

    def _on_device(self, row, outs, overflow) -> tuple:
        """The device half of the query's one device->host exchange, which
        a plan's graph captures: ``(row, outs, perm, counts)``. Large
        results compact (``kernels.compact_perm`` moves the valid rows to
        the front: ``perm``, and ``counts`` holds their count and the
        overflow); below ``COMPACT_MIN_ROWS``, ``perm`` is None and
        ``counts`` the overflow alone."""
        overflow = overflow.to(torch.int64)
        if row.shape[0] >= self.COMPACT_MIN_ROWS and outs:
            perm, cnt = KX.compact_perm(row)
            return row, outs, perm, torch.stack([cnt, overflow])
        return row, outs, None, overflow.reshape(1)

    def _to_host(self, row, outs, perm, counts):
        """The host half after an eager run: the counts in one copy (None
        is returned on overflow, for the caller's retry), then the result;
        a compacted one only as the power-of-two prefix that covers its
        valid rows. A replay's copies are ``_HostCopies``, the same
        copies queued without waiting."""
        if perm is not None:
            cnt_h, over_h = counts.cpu().tolist()
            if over_h:
                return None
            row, outs = _compacted(row, outs, perm, cnt_h)
        elif int(counts.cpu()[0]):
            return None
        return (row.cpu().numpy(),
                [(a.cpu().numpy(), v.cpu().numpy()) for a, v in outs])

    DICT_TABLES_MAX = 512

    def dict_table(self, key: tuple, pins: tuple, build):
        """Memoized ``build()`` for a host dictionary operation. ``key``
        holds the ids of the ``pins`` objects (dictionaries, plan
        nodes); the entry pins them, so a recycled id cannot serve a
        stale table."""
        return self._memo_read("dict_table", self._dict_tables,
                               self.DICT_TABLES_MAX, key, pins, build)

    def dict_union(self, lsd, rsd, build):
        """Memoized ``build()`` of the union of two string dictionaries,
        bounded by ``columnar.dict_union_cap()``
        (``NDS_TPU_DICT_UNION_CAP``, default 256), the reference's bound
        on its union memo."""
        return self._memo_read("dict_union", self._union_cache,
                               columnar.dict_union_cap(), (id(lsd), id(rsd)),
                               (lsd, rsd), build)

    def _memo_read(self, cache: str, store: dict, cap: int, key: tuple,
                   pins: tuple, build):
        """``_memo`` for the executor's memos: a miss raises during a
        capture, and a capture pins what it read, so a graph keeps the
        values its launches read after the memo's FIFO evicts them."""
        def fill():
            self._no_fill(cache)
            return build()
        value = _memo(store, cap, key, pins, fill)
        if self._graphs is not None:
            self._graphs.pin(value)
        return value

    # ------------------------------------------------------------ buffers

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

    def scan_buffers(self, table: str, name: str, rv=None) -> tuple:
        """``(key, {buffer key: tensor})`` of one scanned column: its
        whole buffer set (``key``, ``key#v``, and ``key#x`` for RLE run
        starts), uploaded once and pooled. Under an active columnar mode
        the set is the encoded one and ``_enc_specs[key]`` says how to
        decode it."""
        key = f"{table}.{name}" if rv is None else f"{rv.prefix}.{name}"
        if key not in self._buffers:
            self._no_fill("scan_buffers")
            if rv is None:
                self._upload(key, table, name)
            else:
                self._upload_reduced(key, rv, name)
        bufs = {key + sfx: self._buffers[key + sfx]
                for sfx in ("", "#v", "#x") if key + sfx in self._buffers}
        if self._graphs is not None:
            for k, t in bufs.items():
                self._graphs.read(k, t)
        return key, bufs

    def live_buffer(self, table: str):
        """The table's deleted-row mask on the device (True = live, the
        reference's ``_upload_live``) under ``{table}.__live``, uploaded
        once and pooled beside the table's columns (so dropping the
        table's buffers drops it, and the graphs that read it), or None
        when every physical row is live. Uploaded raw under any columnar
        mode: the scan ANDs it into its row gate."""
        from nds_tpu_torch.columnar import delta
        live = delta.live_mask(self.tables[table])
        if live is None:
            return None
        key = f"{table}.__live"
        if key not in self._buffers:
            self._no_fill("live_buffer")
            self._place(key, None, {"": self._live_host(table, live)}, 0)
        buf = self._buffers[key]
        if self._graphs is not None:
            self._graphs.read(key, buf)
        return buf

    def _live_host(self, table: str, live: np.ndarray) -> np.ndarray:
        """The host array a table's live mask uploads as (the
        distributed executor's sharded layout overrides it)."""
        return live

    def _encoding_on(self, table: str) -> bool:
        return columnar.enabled() and table not in self._no_encode

    def _place(self, key: str, spec, host: dict, raw: int) -> None:
        """Pool one column's host buffer set (suffix -> array) under
        ``key``, with its spec and raw byte count when it is encoded."""
        for sfx, arr in host.items():
            self._buffers[key + sfx] = self._to_device(arr)
        self._uploads += 1
        if spec is not None:
            self._enc_specs[key] = spec
            self._raw_nbytes[key] = float(raw)

    def _upload(self, key: str, table: str, name: str) -> None:
        """A full-table column (the reference's ``_pool_upload``):
        encoded per its memoized ``column_spec`` under an active mode."""
        col = self.tables[table].columns[name]
        spec = (columnar.column_spec(col) if self._encoding_on(table)
                else None)
        if spec is not None:
            host = columnar.encode_column(spec, col)
        else:
            host = {"": col.values}
            if col.null_mask is not None:
                host["#v"] = col.null_mask
        self._place(key, spec, host,
                    columnar.raw_nbytes(col.values, col.null_mask))

    def _upload_reduced(self, key: str, rv, name: str) -> None:
        """A survivor-reduced view's column (the reference's
        ``_upload_reduced``): the survivors padded to the view's
        capacity, the encoding re-planned on the live rows
        (``plan_padded``, so the pad's zeros do not drag the bounds or
        the run count); the spec evicts with the view's buffers."""
        col = self.tables[rv.table].columns[name]
        vals = col.values[rv.idx]
        nulls = None if col.null_mask is None else col.null_mask[rv.idx]
        pad = rv.capacity - rv.nrows
        if pad:
            vals = np.concatenate([vals, np.zeros(pad, dtype=vals.dtype)])
            if nulls is not None:
                nulls = np.concatenate([nulls, np.zeros(pad, dtype=bool)])
        spec = (columnar.plan_padded(vals, nulls, rv.nrows,
                                     is_string=col.is_string)
                if self._encoding_on(rv.table) else None)
        if spec is not None:
            host = columnar.encode_values(spec, vals, nulls,
                                          nrows=rv.nrows)
        else:
            host = {"": vals}
            if nulls is not None:
                host["#v"] = nulls
        self._place(key, spec, host, columnar.raw_nbytes(vals, nulls))

    def _collect_buffers(self, planned: P.PlannedQuery) -> dict:
        """{buffer key: tensor} of every scan of the plan and its scalar
        sub-plans (the reference's ``_collect_buffers``): what the query
        reads, and what ``bytes_scanned`` sums."""
        bufs: dict = {}
        for root in [planned.root, *planned.scalar_subplans]:
            for node in P.walk_plan(root):
                if isinstance(node, P.Scan):
                    self._check_table(node.table)
                    rv = self.scan_view(node)
                    for name, _dt in node.output:
                        bufs.update(self.scan_buffers(node.table, name,
                                                      rv)[1])
                    live = None if rv is not None else self.live_buffer(
                        node.table)
                    if live is not None:
                        # the deleted-row mask rides along for the scan's
                        # row gate (a reduced view gathered it out)
                        bufs[f"{node.table}.__live"] = live
        return bufs

    # survivor-reduced scans, as the reference: at first use the scan's
    # filter conjunction is evaluated once on the host, and when few
    # enough rows survive the scan reads a reduced power-of-two-capacity
    # buffer set instead, shrinking every downstream capacity. Filters
    # are still applied on the device.
    REDUCE_MIN_ROWS = 1 << 14
    REDUCE_MAX_FRAC = 0.5
    # The reference bounds its views at 96: it consults them when it
    # traces a program, and the compiled program keeps running after an
    # eviction. Eager execution consults them on every run, so the bound
    # must hold a whole power run's scan signatures (the NDS run has
    # more than 96), or each pass re-filters the evicted tables on the
    # host and uploads them again. Which view a signature gets does not
    # depend on the bound, so the kernel choices do not either.
    MAX_SCAN_VIEWS = 256

    def scan_view(self, node):
        """_ReducedScan for this scan's (table, filters), or None for the
        full-table path. Deterministic per signature; cached."""
        t = self.tables[node.table]
        if not node.filters or t.nrows < self.REDUCE_MIN_ROWS:
            return None
        sig = "&".join(sorted(_pred_sig(f) for f in node.filters))
        ck = (node.table, sig)
        hit = self._scan_views.get(ck)
        if hit is not None:
            return hit if isinstance(hit, _ReducedScan) else None
        self._no_fill("scan_view")
        keep = self._host_keep_mask(node, t)
        s = 0 if keep is None else int(keep.sum())
        if keep is None or s > t.nrows * self.REDUCE_MAX_FRAC:
            self._scan_views[ck] = "full"
            return None
        h = hashlib.md5(sig.encode()).hexdigest()[:8]
        rv = _ReducedScan(f"{node.table}@{h}", node.table, s,
                          np.nonzero(keep)[0])
        while len(self._scan_views) >= self.MAX_SCAN_VIEWS:
            old = self._scan_views.pop(next(iter(self._scan_views)))
            if isinstance(old, _ReducedScan):
                self._drop_col_buffers(old.prefix + ".")
        self._scan_views[ck] = rv
        return rv

    def _host_keep_mask(self, node, t: HostTable):
        """Vectorized host evaluation of the scan's filters via the CPU
        evaluator. Predicates it cannot evaluate simply don't reduce.
        None = nothing evaluable."""
        from nds_tpu_torch.engine import cpu_exec as cx
        ctx = cx.Context(t.nrows)
        for name, _dt in node.output:
            col = t.columns[name]
            arr = col.decode() if col.is_string else col.values
            ctx.put((node.binding, name), np.asarray(arr), col.null_mask)
        helper = cx.CpuExecutor(self.tables)
        from nds_tpu_torch.columnar import delta
        live = delta.live_mask(t)
        # seed from the delta deleted-row bitmask: a reduced view then
        # physically excludes deleted rows and needs no runtime gate
        keep = np.ones(t.nrows, dtype=bool) if live is None \
            else live.copy()
        handled = 1 if live is not None else 0
        for pred in node.filters:
            # a float predicate reduces on the host only when every op
            # is IEEE-exact on both sides
            if _touches_float(pred) and not _float_exact_safe(pred):
                continue
            try:
                m, mv = helper.eval(pred, ctx)
            except Exception:  # noqa: BLE001 - per-predicate fallback
                continue
            m = np.asarray(m).astype(bool)
            if mv is not None:
                m = m & mv
            keep &= m
            handled += 1
        return keep if handled else None

    def col_is_sorted(self, table: str, name: str) -> bool:
        """Host-cached: column is non-null and nondecreasing."""
        ck = (table, name, "sorted")
        if ck not in self._bounds:
            col = self.tables[table].columns[name]
            ok = (col.null_mask is None and not col.is_string
                  and np.issubdtype(col.values.dtype, np.number)
                  and (len(col.values) < 2
                       or bool(np.all(np.diff(col.values) >= 0))))
            self._bounds[ck] = ok
        return self._bounds[ck]

    def cols_unique(self, table: str, names: tuple) -> bool:
        """Host-cached: no two rows of the table share a value of the
        columns ``names`` (rows with a NULL among them excluded; deleted
        rows included, so it holds for every live subset)."""
        ck = (table, names, "unique")
        if ck not in self._bounds:
            t = self.tables[table]
            cols = [t.columns[n] for n in names]
            keep = np.ones(t.nrows, dtype=bool)
            for c in cols:
                if c.null_mask is not None:
                    keep &= c.null_mask
            keys = np.stack([c.values[keep].astype(np.int64)
                             for c in cols], axis=1)
            self._bounds[ck] = (len(keys) < 2 or len(
                np.unique(keys, axis=0)) == len(keys))
        return self._bounds[ck]

    def col_bounds(self, table: str, name: str):
        """Host-side (min, max) of an integer-typed column."""
        ck = (table, name)
        if ck not in self._bounds:
            col = self.tables[table].columns[name]
            if col.is_string:
                self._bounds[ck] = (0, max(len(col.dictionary) - 1, 0))
            elif np.issubdtype(col.values.dtype, np.integer):
                vals = col.values
                if col.null_mask is not None:
                    vals = vals[col.null_mask]
                if len(vals) == 0:
                    self._bounds[ck] = (0, 0)
                else:
                    self._bounds[ck] = (int(vals.min()), int(vals.max()))
            else:
                self._bounds[ck] = (None, None)
        return self._bounds[ck]

    # ---------------------------------------------------------- materialize

    def _materialize(self, planned: P.PlannedQuery, row, outs, dicts):
        idx = np.nonzero(row)[0]
        arrs, valids, dtypes = [], [], []
        for (arr, valid), (name, dt), sd in zip(
                outs, planned.root.output, dicts):
            a = np.asarray(arr)[idx]
            v = np.asarray(valid)[idx]
            if sd is not None:
                a = sd[np.clip(a, 0, len(sd) - 1)]
                a = np.asarray(a, dtype=object)
            arrs.append(a)
            valids.append(None if v.all() else v)
            dtypes.append(dt)
        names = planned.column_names or [n for n, _ in planned.root.output]
        return ResultTable(names, arrs, dtypes, valids)


def _compacted(row, outs, perm, valid: int) -> tuple:
    """A compacted result's rows to copy: the power-of-two prefix of the
    compactor's permutation that covers its ``valid`` rows."""
    n = row.shape[0]
    C = 1
    while C < max(valid, 1):
        C <<= 1
    perm = perm[:min(C, n)]
    return (row.index_select(0, perm),
            [(a.index_select(0, perm), v.index_select(0, perm))
             for a, v in outs])


class _HostCopies:
    """A replay's copies to the host, queued on the current stream as
    soon as the graph is: on the card, the same copies as ``_to_host``'s
    (the counts, the row mask, each column's values and validity), each
    into a pinned host buffer of its own that this dispatch owns, never
    the graph, so two dispatches of one plan in flight share none, then
    an event. The graph's static outputs are read before any later replay
    can write them, since everything runs on one stream. A compacted
    result's prefix depends on its count of valid rows, so that count is
    read first, as ``_to_host`` reads it. Off the card there is nothing
    to overlap: ``_to_host`` runs at once. ``wait()`` returns the host
    arrays, or None on overflow."""

    def __init__(self, ex: "DeviceExecutor", row, outs, perm, counts):
        self.host = self.event = self.counts = None
        self.overflow = False
        if row.device.type != "cuda":
            self.host = ex._to_host(row, outs, perm, counts)
            self.overflow = self.host is None
            return
        if perm is not None:
            cnt_h, over_h = counts.cpu().tolist()
            if over_h:
                self.overflow = True
                return
            row, outs = _compacted(row, outs, perm, cnt_h)
        else:
            self.counts = self._copy(counts)
        self.row = self._copy(row)
        self.outs = [(self._copy(a), self._copy(v)) for a, v in outs]
        self.event = torch.cuda.Event()
        self.event.record()

    @staticmethod
    def _copy(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def wait(self):
        if self.overflow:
            return None
        if self.host is not None:
            return self.host
        self.event.synchronize()
        if self.counts is not None and int(self.counts[0]):
            return None
        return (self.row.numpy(),
                [(a.numpy(), v.numpy()) for a, v in self.outs])


class _Done:
    """A completed dispatch's handle."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class _Replayed:
    """The handle of a dispatch that replayed its plan's graph:
    ``result()`` waits for the dispatch's copies, checks the overflow
    and materializes, setting the executor's ``last_timings``. An
    overflow drops the graph, doubles the plan's slack and runs it again
    (the reference's recompile), unless another handle of the plan did
    so since this replay (the slack is no longer the one it ran at): the
    plan then replays its new graph, or runs again where it has none.
    Resolved once; later calls return the same result."""

    def __init__(self, ex: "DeviceExecutor", run: tuple, side: dict,
                 copies: _HostCopies):
        self.ex = ex
        self.run = run
        self.side = side
        self.copies = copies
        self.slack = run[2]["slack"]
        self._out = None
        self._done = False

    def result(self):
        if self._done:
            return self._out
        ex = self.ex
        with ex._on_stream():
            host = self.copies.wait()
            self.copies = None
            side, retries = self.side, 0
            if host is None:
                _planned, key, entry = self.run[:3]
                pg = None if ex._graphs is None else ex._graphs.get(key)
                if entry["slack"] != self.slack and pg is not None:
                    again = _Replayed(ex, self.run, pg.side, _HostCopies(
                        ex, *ex._graphs.replay(pg)))
                    self._out = again.result()
                    self._done = True
                    return self._out
                if entry["slack"] == self.slack:
                    if pg is not None:
                        ex._graphs.drop(key)
                    _notify_overflow(entry)
                    entry["slack"] *= 2
                side, retries = None, 1
            self._out = ex._finish(self.run, host, side, retries, None)
        self._done = True
        return self._out


class _Trace:
    """Runs one plan eagerly. Host-side numpy work (dictionary predicate
    tables, key bounds) happens inline; every tensor lives on the
    executor's device."""

    def __init__(self, ex: DeviceExecutor, slack: float = 2.0):
        self.ex = ex
        self.dev = ex.device
        self.slack = slack
        self.fdt = torch.float64
        self.scalars: dict[int, tuple] = {}
        self._cache: dict[int, DCtx] = {}
        self._overflows: list = []
        # which kernel each hot operator actually used, under the
        # reference's names (the BenchReport "kernels" block)
        self.kernels: dict[str, int] = {}

    def _note(self, kernel: str) -> None:
        self.kernels[kernel] = self.kernels.get(kernel, 0) + 1

    # small constructors on the trace's device
    def _arange(self, n: int, dtype=torch.int32):
        return torch.arange(n, dtype=dtype, device=self.dev)

    def _zeros(self, n: int, dtype):
        return torch.zeros(n, dtype=dtype, device=self.dev)

    def _ones_bool(self, n: int):
        return torch.ones(n, dtype=torch.bool, device=self.dev)

    def _host(self, arr: np.ndarray):
        self.ex._no_fill("an upload (_host)")
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.dev)

    def total_overflow(self):
        tot = torch.zeros((), dtype=torch.int64, device=self.dev)
        for o in self._overflows:
            tot = tot + o.to(torch.int64)
        return tot

    def result_ctx(self, node: P.Node) -> DCtx:
        """The context of a scalar subplan or of the root, as the query
        reads its result."""
        return self.run(node)

    def run_query(self, planned: P.PlannedQuery):
        for i, sub in enumerate(planned.scalar_subplans):
            ctx = self.result_ctx(sub)
            name, dt = sub.output[0]
            dv = ctx.cols[(sub.binding, name)]
            # the first present row, gathered on the device (indexing by
            # a 0-dim tensor would read it on the host)
            pos = torch.argmax(ctx.row.to(torch.int32)).reshape(1)
            v = dv.arr.index_select(0, pos).reshape(())
            ok = ctx.row.index_select(0, pos).reshape(())
            if dv.valid is not None:
                ok = ok & dv.valid.index_select(0, pos).reshape(())
            self.scalars[i] = (v, ok, dv.sdict, dt)
        ctx = self.result_ctx(planned.root)
        root = planned.root
        outs, dicts = [], []
        for name, _dt in root.output:
            dv = ctx.cols[(root.binding, name)]
            valid = dv.valid if dv.valid is not None else self._ones_bool(
                ctx.n)
            outs.append((dv.arr, valid))
            dicts.append(dv.sdict)
        return ctx.row, outs, dicts

    # ----------------------------------------------------------- plan nodes

    def stash(self, node: P.Node, ctx: DCtx) -> None:
        """The one write point of the node-result cache. Trace-scoped:
        the running plan pins every node, so no id can recycle while its
        entry lives."""
        self._cache[id(node)] = ctx

    def run(self, node: P.Node) -> DCtx:
        nid = id(node)
        if nid in self._cache:
            return self._cache[nid]
        method = getattr(self, "_run_" + type(node).__name__.lower(), None)
        if method is None:
            raise DeviceExecError(
                f"plan node {type(node).__name__} is not ported to the "
                f"torch engine yet")
        ctx = method(node)
        self.stash(node, ctx)
        return ctx

    def _run_scan(self, node: P.Scan) -> DCtx:
        t = self.ex.tables[node.table]
        rv = self.ex.scan_view(node)
        if rv is not None:
            n, nrows = rv.capacity, rv.nrows
        else:
            n, nrows = max(t.nrows, 1), t.nrows
        row = self._arange(n) < nrows
        live = self.ex.live_buffer(node.table) if rv is None else None
        if live is not None:
            # delta deleted-row bitmask: DF_*-deleted rows leave every
            # scan's row population before predicates run (the column
            # buffers stay resident: deletion is one boolean AND)
            row = row & live
        ctx = DCtx(n, row)
        for name, _dt in node.output:
            col = t.columns[name]
            key, bufs = self.ex.scan_buffers(node.table, name, rv)
            lo, hi = self.ex.col_bounds(node.table, name)
            sdict = col.dictionary if col.is_string else None
            spec = self.ex._enc_specs.get(key)
            if spec is not None:
                # encoded upload: decoded where the run first reads it
                # (a spec covers at least MIN_ROWS rows, never an empty
                # column)
                dv = DVal.encoded(spec, bufs, key, sdict, lo, hi)
            else:
                arr, valid = bufs[key], bufs.get(key + "#v")
                if arr.shape[0] == 0:
                    arr = torch.zeros(1, dtype=arr.dtype, device=self.dev)
                    valid = None
                dv = DVal(arr, valid, sdict, lo, hi)
            ctx.cols[(node.binding, name)] = dv
        for pred in node.filters:
            ctx = self._apply_filter(ctx, pred)
        # the presorted-build fast path's marker: arrays in host storage
        # order behind a prefix row mask. A live mask breaks that prefix
        # property (a deleted row inside the prefix is still a valid key)
        ctx.pristine = not node.filters and live is None
        return ctx

    def _apply_filter(self, ctx: DCtx, pred: ir.IR) -> DCtx:
        dv = self.eval(pred, ctx)
        m = dv.arr.to(torch.bool)
        if dv.valid is not None:
            m = m & dv.valid
        out = DCtx(ctx.n, ctx.row & m)
        out.cols = ctx.cols
        return out

    def _run_derivedscan(self, node: P.DerivedScan) -> DCtx:
        child = self.run(node.child)
        cb = node.child.binding
        out = DCtx(child.n, child.row)
        for name, _dt in node.child.output:
            out.cols[(node.binding, name)] = child.cols[(cb, name)]
        return out

    def _run_stagedscan(self, node: P.StagedScan) -> DCtx:
        """Host-staged intermediate (engine/staging.py): scan the temp
        table, then restore each column's original (binding, name)
        address so the ancestors' expressions resolve unchanged."""
        inner = self.run(node.child)
        sb = node.child.binding
        out = DCtx(inner.n, inner.row)
        for b, name, mangled, _dt in node.cols:
            out.cols[(b, name)] = inner.cols[(sb, mangled)]
        out.pristine = inner.pristine
        return out

    def _run_filter(self, node: P.Filter) -> DCtx:
        return self._apply_filter(self.run(node.child), node.predicate)

    def _run_project(self, node: P.Project) -> DCtx:
        ctx = self.run(node.child)
        out = DCtx(ctx.n, ctx.row)
        for name, e in node.exprs:
            dv = self.eval(e, ctx)
            if dv.arr.dim() == 0:
                dv = dv.with_arrays(
                    dv.arr.expand(ctx.n),
                    None if dv.valid is None else dv.valid.expand(ctx.n))
            out.cols[(node.binding, name)] = dv
        return out

    # -------------------------------------------------------------- joins

    def _join_key_arrays(self, lvals, rvals, lctx, rctx):
        """Align key pairs (string dictionary union, decimal rescale),
        then bit-pack multi-column keys into one int64 per side. Returns
        (lkey, lok, rkey, rok, span): span is the host-known (lo, hi)
        range of the combined key, or None when a side lacks bounds."""
        lok = lctx.row
        rok = rctx.row
        if len(lvals) == 1 and lvals[0].sdict is None \
                and rvals[0].sdict is None:
            lv, rv = lvals[0], rvals[0]
            lk, rk = lv.arr.to(torch.int64), rv.arr.to(torch.int64)
            span = None
            if (lv.lo is not None and rv.lo is not None
                    and lv.hi is not None and rv.hi is not None):
                span = (min(lv.lo, rv.lo), max(lv.hi, rv.hi))
                if span[0] > -2**31 and span[1] < 2**31 - 1:
                    lk, rk = lk.to(torch.int32), rk.to(torch.int32)
            return lk, _ok(lv, lok), rk, _ok(rv, rok), span
        lks, rks, widths = [], [], []
        for lv, rv in zip(lvals, rvals):
            la, ra, lo, hi = self._align_pair(lv, rv)
            lok = _ok(lv, lok)
            rok = _ok(rv, rok)
            lks.append((la, lo, hi))
            rks.append((ra, lo, hi))
            widths.append(max((hi - lo).bit_length(), 1))
        if sum(widths) > 62:
            raise DeviceExecError(
                f"join key too wide to pack: {widths} bits")
        lkey = self._pack(lks, widths)
        rkey = self._pack(rks, widths)
        if sum(widths) <= 30:
            lkey = lkey.to(torch.int32)
            rkey = rkey.to(torch.int32)
        return lkey, lok, rkey, rok, (0, (1 << sum(widths)) - 1)

    @staticmethod
    def _pack(keys, widths):
        acc = None
        for (arr, lo, hi), w in zip(keys, widths):
            norm = (arr.to(torch.int64) - lo).clamp(0, hi - lo)
            acc = norm if acc is None else ((acc << w) | norm)
        return acc

    def _dict_union(self, lsd, rsd):
        """Memoized string-dictionary union for one (left, right)
        dictionary pair. Returns (union, lmap, rmap), the maps on the
        device. The union is the memo's own object array, so that every
        run hands the same dictionary on (memos downstream key on its
        identity)."""
        def build():
            union = np.union1d(lsd.astype(str), rsd.astype(str))
            return (union.astype(object),
                    self._host(np.searchsorted(union, lsd.astype(str))),
                    self._host(np.searchsorted(union, rsd.astype(str))))
        return self.ex.dict_union(lsd, rsd, build)

    def _align_pair(self, lv: DVal, rv: DVal):
        """Make one key pair comparable as integers; returns
        (l_arr, r_arr, lo, hi) with host-known bounds."""
        if lv.sdict is not None or rv.sdict is not None:
            if lv.sdict is None or rv.sdict is None:
                raise DeviceExecError("string vs non-string join key")
            if lv.sdict is rv.sdict or (
                    len(lv.sdict) == len(rv.sdict)
                    and np.array_equal(lv.sdict, rv.sdict)):
                hi = max(len(lv.sdict) - 1, 0)
                return lv.arr, rv.arr, 0, hi
            union, lmap, rmap = self._dict_union(lv.sdict, rv.sdict)
            return (_take_codes(lmap, lv.arr), _take_codes(rmap, rv.arr),
                    0, max(len(union) - 1, 0))
        if (lv.lo is None or lv.hi is None or rv.lo is None
                or rv.hi is None):
            raise DeviceExecError(
                "join key without host bounds (needed for packing)")
        return lv.arr, rv.arr, min(lv.lo, rv.lo), max(lv.hi, rv.hi)

    def _presorted_build(self, right: P.Node, right_keys) -> bool:
        """True when the build side is a bare unfiltered Scan whose
        single join key is a host-proven sorted non-null column."""
        if not isinstance(right, P.Scan) or right.filters:
            return False
        if len(right_keys) != 1:
            return False
        k = right_keys[0]
        if not isinstance(k, ir.ColRef) or k.binding != right.binding:
            return False
        return self.ex.col_is_sorted(right.table, k.name)

    @staticmethod
    def _build_lookup(key, ok):
        """Sort build keys (invalid rows to the sentinel end): the sorted
        keys and their rows (int32), ``partition_sort`` of one partition
        with the row ids as payload (the reference's explicit int32
        iota)."""
        sentinel = torch.iinfo(key.dtype).max
        k = torch.where(ok, key, torch.full_like(key, sentinel))
        n = k.shape[0]
        ks, order = KX.partition_sort(
            k.view(1, n),
            torch.arange(n, dtype=torch.int32, device=k.device).view(1, n),
            torch.full((1,), n, dtype=torch.int32, device=k.device))
        return ks.view(n), order.view(n)

    @staticmethod
    def _probe(ks, order, pkey, pok):
        """Each probe key's build row and whether it matched: the
        reference's ``_probe`` in one ``sorted_search``."""
        ks, pkey = _promoted(ks, pkey)
        return KX.sorted_search(ks, pkey, "probe", order, pok.contiguous())

    def _run_join(self, node: P.Join) -> DCtx:
        lctx, rctx = self.run(node.left), self.run(node.right)
        if not node.left_keys:
            return self._cross_join(node, lctx, rctx)
        lvals = [self.eval(k, lctx) for k in node.left_keys]
        rvals = [self.eval(k, rctx) for k in node.right_keys]
        lkey, lok, rkey, rok, span = self._join_key_arrays(
            lvals, rvals, lctx, rctx)
        if node.kind == "full":
            return self._full_join(node, lctx, rctx, lkey, lok, rkey,
                                   rok)
        if node.right_unique:
            # gather join: probe from the left, build on the unique
            # right; infeasible kernel choices demote to the sort path
            ridx = hit = None
            if (node.kernel == KX.JOIN_MATMUL
                    and rctx.n <= 4 * KX.MATMUL_MAX_BUILD):
                ridx, hit = KX.matmul_probe_join(
                    rkey.contiguous(), rok.contiguous(),
                    lkey.contiguous(), lok.contiguous())
                self._note("join.matmul")
            elif node.kernel in (KX.JOIN_MATMUL, KX.JOIN_DIRECT):
                dom = (None if span is None
                       else KX.domain_of(span[0], span[1]))
                if KX.direct_feasible(dom, rctx.n):
                    ridx, hit = KX.direct_lookup_join(
                        rkey.contiguous(), rok.contiguous(),
                        lkey.contiguous(), lok.contiguous(),
                        int(span[0]), dom)
                    self._note("join.direct")
            if ridx is None:
                if (rctx.pristine
                        and self._presorted_build(node.right,
                                                  node.right_keys)):
                    sentinel = torch.iinfo(rkey.dtype).max
                    ks = torch.where(rok, rkey,
                                     torch.full_like(rkey, sentinel))
                    order = self._arange(rkey.shape[0])
                    self._note("join.presorted")
                else:
                    ks, order = self._build_lookup(rkey, rok)
                    self._note("join.sortmerge")
                ridx, hit = self._probe(ks, order, lkey, lok)
            if node.kind == "left":
                out = DCtx(lctx.n, lctx.row)
                out.cols.update(lctx.cols)
                gathered = rctx.gather(ridx, clear_valid=hit)
                out.cols.update(gathered.cols)
                if node.residual is not None:
                    resid = self.eval(node.residual, out)
                    rk = resid.arr.to(torch.bool)
                    if resid.valid is not None:
                        rk = rk & resid.valid
                    keep = hit & rk
                    out2 = DCtx(lctx.n, lctx.row)
                    out2.cols.update(lctx.cols)
                    out2.cols.update(
                        rctx.gather(ridx, clear_valid=keep).cols)
                    return out2
                return out
            out = DCtx(lctx.n, lctx.row & hit)
            out.cols.update(lctx.cols)
            out.cols.update(rctx.gather(ridx).cols)
            if node.residual is not None:
                out = self._apply_filter(out, node.residual)
            return out
        if node.kind == "inner":
            return self._mn_join(node, lctx, rctx, lkey, lok, rkey, rok)
        return self._left_expanding_join(node, lctx, rctx, lkey, lok,
                                         rkey, rok)

    def _mn_join(self, node, lctx, rctx, lkey, lok, rkey, rok) -> DCtx:
        """Generic M:N inner join: sort the left side by key, find each
        right row's match range by one two-sided search, expand into a
        fixed-capacity slot array. Capacity = slack * max(|L|, |R|);
        overflow is counted for the executor's doubled-slack retry."""
        K = max(int(self.slack * max(lctx.n, rctx.n)), 1)
        if (node.kernel == KX.JOIN_PARTITIONED
                and min(lctx.n, rctx.n) >= 2 * KX.NPART):
            # radix-partitioned join (K6): part_slack rides the
            # executor's overflow retry, which grows partition and
            # output capacity together
            part_slack = max(2.0, self.slack)
            lidx2, ridx, present, over = KX.partitioned_mn_join(
                lkey.contiguous(), lok.contiguous(), rkey.contiguous(),
                rok.contiguous(), K, part_slack)
            self._overflows.append(over)
            self._note("join.partitioned")
            out = DCtx(int(lidx2.shape[0]), present)
            out.cols.update(lctx.gather(lidx2).cols)
            out.cols.update(rctx.gather(ridx).cols)
            if node.residual is not None:
                out = self._apply_filter(out, node.residual)
            return out
        self._note("join.sortmerge")
        ks, order = self._build_lookup(lkey, lok)
        lo, hi = _ss(ks, rkey, side="both")
        cnt = torch.where(rok, hi - lo, torch.zeros_like(lo)).to(
            torch.int64)
        offs = torch.cumsum(cnt, 0)
        total = offs[-1]
        slots = self._arange(K)
        if K + 1 >= 2**31:
            raise DeviceExecError(f"join capacity {K} exceeds int32")
        offs32 = offs.clamp_max(K + 1).to(torch.int32)
        ridx = _ss(offs32, slots, side="right").clamp(0, rctx.n - 1)
        prev = torch.where(
            ridx > 0, offs32.index_select(0, (ridx - 1).clamp_min(0)),
            torch.zeros((), dtype=torch.int32, device=self.dev))
        within = slots - prev
        lpos = (lo.index_select(0, ridx) + within).clamp(0, lctx.n - 1)
        lidx2 = order.index_select(0, lpos)
        present = slots < torch.clamp_max(total, K)
        self._overflows.append((total - K).clamp_min(0))
        out = DCtx(K, present)
        out.cols.update(lctx.gather(lidx2).cols)
        out.cols.update(rctx.gather(ridx).cols)
        if node.residual is not None:
            out = self._apply_filter(out, node.residual)
        return out

    def _left_expanding_join(self, node, lctx, rctx, lkey, lok, rkey,
                             rok) -> DCtx:
        """Left outer with a non-unique right side (q13's customer LEFT
        JOIN orders): probe from the right against the unique left.
        Block A = matched right rows with the left columns gathered;
        block B = left rows with no surviving match. The reference takes
        this path whatever the left side; the port only where the left
        is a scan proven unique on its keys (``_left_unique``), and the
        other left joins (``_left_multi_join``) where a left key may
        repeat."""
        self._note("join.sortmerge")
        if not self._left_unique(node):
            return self._left_multi_join(node, lctx, rctx, lkey, lok,
                                         rkey, rok)
        ks, order = self._build_lookup(lkey, lok)
        lidx, hit = self._probe(ks, order, rkey, rok)
        presentA = rctx.row & hit
        if node.residual is not None:
            combined = DCtx(rctx.n, presentA)
            combined.cols.update(rctx.cols)
            combined.cols.update(lctx.gather(lidx).cols)
            resid = self.eval(node.residual, combined)
            rk = resid.arr.to(torch.bool)
            if resid.valid is not None:
                rk = rk & resid.valid
            presentA = presentA & rk
        scat = self._zeros(lctx.n, torch.int32).scatter_reduce_(
            0, lidx.to(torch.int64), presentA.to(torch.int32), "amax",
            include_self=True)
        matched = scat > 0
        n_out = rctx.n + lctx.n
        out = DCtx(n_out, torch.cat([presentA, lctx.row & ~matched]))
        gatheredA = lctx.gather(lidx)
        for k, dv in lctx.cols.items():
            ga = gatheredA.cols[k]
            arr = torch.cat([ga.arr, dv.arr])
            valid = None
            if ga.valid is not None or dv.valid is not None:
                gav = ga.valid if ga.valid is not None else self._ones_bool(
                    rctx.n)
                dvv = dv.valid if dv.valid is not None else self._ones_bool(
                    lctx.n)
                valid = torch.cat([gav, dvv])
            out.cols[k] = dv.with_arrays(arr, valid)
        falses = self._zeros(lctx.n, torch.bool)
        for k, dv in rctx.cols.items():
            arr = torch.cat([dv.arr, self._zeros(lctx.n, dv.arr.dtype)])
            av = dv.valid if dv.valid is not None else self._ones_bool(rctx.n)
            out.cols[k] = dv.with_arrays(arr, torch.cat([av, falses]))
        return out

    def _left_unique(self, node: P.Join) -> bool:
        """True when the left side is a scan whose join key columns are
        host-proven unique over the whole table (q13's customer)."""
        left = node.left
        if not isinstance(left, P.Scan):
            return False
        names = set()
        for k in node.left_keys:
            if not isinstance(k, ir.ColRef) or k.binding != left.binding:
                return False
            names.add(k.name)
        return self.ex.cols_unique(left.table, tuple(sorted(names)))

    def _left_multi_join(self, node, lctx, rctx, lkey, lok, rkey,
                         rok) -> DCtx:
        """Left outer where a left key may repeat and a right key too
        (the LF_* refresh views: staging line items LEFT JOIN a dimension
        on a business key the catalog does not know unique). Each left
        row probes the sorted right side: its first match, or NULLs, in
        its own slot (block A, the left's capacity), and its further
        matches in block B, of the right's capacity times half the slack,
        whose overflow the executor's doubled-slack retry takes. The
        capacity grows by the right's at each join, as on the unique
        path."""
        if node.residual is not None:
            raise DeviceExecError(
                "LEFT JOIN with a residual over a left side not proven "
                "unique on its keys")
        nl, nr = lctx.n, rctx.n
        ks, order = self._build_lookup(rkey, rok)
        lo, hi = _ss(ks, lkey, side="both")
        cnt = torch.where(lok, hi - lo, torch.zeros_like(lo)).to(
            torch.int64)
        has = cnt > 0
        ridxA = order.index_select(0, lo.clamp(0, nr - 1))
        E = max(int(self.slack * nr / 2), 1)
        if E + 1 >= 2**31:
            raise DeviceExecError(f"join capacity {E} exceeds int32")
        offs = torch.cumsum((cnt - 1).clamp_min(0), 0)
        total = offs[-1]
        slots = self._arange(E)
        offs32 = offs.clamp_max(E + 1).to(torch.int32)
        lidxB = _ss(offs32, slots, side="right").clamp(0, nl - 1)
        prev = torch.where(
            lidxB > 0, offs32.index_select(0, (lidxB - 1).clamp_min(0)),
            torch.zeros((), dtype=torch.int32, device=self.dev))
        rpos = (lo.index_select(0, lidxB) + 1 + (slots - prev)).clamp(
            0, nr - 1)
        ridxB = order.index_select(0, rpos)
        presentB = slots < torch.clamp_max(total, E)
        self._overflows.append((total - E).clamp_min(0))
        out = DCtx(nl + E, torch.cat([lctx.row, presentB]))
        gatheredB = lctx.gather(lidxB)
        for k, dv in lctx.cols.items():
            gb = gatheredB.cols[k]
            valid = None
            if dv.valid is not None or gb.valid is not None:
                valid = torch.cat([
                    dv.valid if dv.valid is not None
                    else self._ones_bool(nl),
                    gb.valid if gb.valid is not None
                    else self._ones_bool(E)])
            out.cols[k] = dv.with_arrays(torch.cat([dv.arr, gb.arr]),
                                         valid)
        rA = rctx.gather(ridxA, clear_valid=has)
        rB = rctx.gather(ridxB)
        for k, dv in rctx.cols.items():
            ga, gb = rA.cols[k], rB.cols[k]
            out.cols[k] = dv.with_arrays(
                torch.cat([ga.arr, gb.arr]),
                torch.cat([ga.valid if ga.valid is not None else has,
                           gb.valid if gb.valid is not None
                           else self._ones_bool(E)]))
        return out

    def _full_join(self, node: P.Join, lctx, rctx, lkey, lok, rkey,
                   rok) -> DCtx:
        """FULL OUTER over unique keys on both sides: capacity |L|+|R|."""
        if not node.right_unique:
            raise DeviceExecError(
                "FULL OUTER JOIN requires unique join keys")
        ks, order = self._build_lookup(rkey, rok)
        ridx, hit = self._probe(ks, order, lkey, lok)
        ks2, order2 = self._build_lookup(lkey, lok)
        _lidx, rhit = self._probe(ks2, order2, rkey, rok)
        unmatched_r = rctx.row & ~rhit
        falsev = self._zeros(rctx.n, torch.bool)
        out = DCtx(lctx.n + rctx.n, torch.cat([lctx.row, unmatched_r]))
        gathered = rctx.gather(ridx, clear_valid=hit)
        for k, dv in lctx.cols.items():
            pad = torch.zeros((rctx.n,) + tuple(dv.arr.shape[1:]),
                              dtype=dv.arr.dtype, device=self.dev)
            arr = torch.cat([dv.arr, pad])
            lv = dv.valid if dv.valid is not None else self._ones_bool(
                lctx.n)
            out.cols[k] = dv.with_arrays(arr, torch.cat([lv, falsev]))
        for k, dv in rctx.cols.items():
            g = gathered.cols[k]
            arr = torch.cat([g.arr, dv.arr])
            gv = g.valid if g.valid is not None else hit
            dvv = dv.valid if dv.valid is not None else self._ones_bool(
                rctx.n)
            out.cols[k] = dv.with_arrays(arr, torch.cat([gv, dvv]))
        return out

    def _cross_join(self, node: P.Join, lctx: DCtx, rctx: DCtx) -> DCtx:
        if lctx.n * rctx.n > 1 << 24:
            raise DeviceExecError(
                f"cross join too large: {lctx.n} x {rctx.n}")
        li = torch.repeat_interleave(self._arange(lctx.n), rctx.n)
        ri = self._arange(rctx.n).repeat(lctx.n)
        out = lctx.gather(li).merge(rctx.gather(ri))
        out.row = lctx.row.index_select(0, li) & rctx.row.index_select(0, ri)
        if node.residual is not None:
            out = self._apply_filter(out, node.residual)
        return out

    def _run_semijoin(self, node: P.SemiJoin) -> DCtx:
        lctx, rctx = self.run(node.left), self.run(node.right)
        lvals = [self.eval(k, lctx) for k in node.left_keys]
        rvals = [self.eval(k, rctx) for k in node.right_keys]
        if not node.left_keys:
            raise DeviceExecError("semi join without keys")
        lkey, lok, rkey, rok, span = self._join_key_arrays(
            lvals, rvals, lctx, rctx)
        dom = None if span is None else KX.domain_of(span[0], span[1])
        want_bitmask = (node.kernel == KX.SEMI_BITMASK
                        and KX.direct_feasible(dom, rctx.n))
        if node.residual is None:
            if want_bitmask:
                exists = KX.bitmask_semi(
                    rkey.contiguous(), rok.contiguous(), lkey.contiguous(),
                    lok.contiguous(), int(span[0]), dom)
                self._note("semi.bitmask")
            else:
                ks, order = self._build_lookup(rkey, rok)
                _idx, hit = self._probe(ks, order, lkey, lok)
                exists = hit
                self._note("semi.sortmerge")
        else:
            exists = self._exists_with_residual(
                node, lctx, rctx, lkey, lok, rkey, rok,
                dom if want_bitmask else None,
                None if span is None else int(span[0]))
        keep = (lctx.row & ~exists) if node.anti else (lctx.row & exists)
        out = DCtx(lctx.n, keep)
        out.cols = lctx.cols
        return out

    def _exists_with_residual(self, node, lctx, rctx, lkey, lok, rkey,
                              rok, dom=None, key_lo=None):
        """EXISTS with a cross-side residual of the q21 shape
        ``r.col <> l.col``: a right row with the key and a different
        non-NULL col exists iff the per-key [min, max] of col over the
        right rows is not exactly [l.col, l.col]. With a dense key domain
        the min/max tables come from ``keyed_minmax_semi``; otherwise
        from one 2-key sort of (key, col)."""
        e = node.residual
        if not (isinstance(e, ir.Cmp) and e.op == "<>"):
            raise DeviceExecError(
                f"unsupported semi-join residual: {e!r}")
        rbinds = _plan_bindings(node.right)
        if _expr_bindings(e.left) <= rbinds:
            r_ir, l_ir = e.left, e.right
        elif _expr_bindings(e.right) <= rbinds:
            r_ir, l_ir = e.right, e.left
        else:
            raise DeviceExecError("residual does not split by side")
        lcol = self.eval(l_ir, lctx)
        rcol = self.eval(r_ir, rctx)
        la, ra, lo, hi = self._align_pair(lcol, rcol)
        lok2 = _ok(lcol, lok)
        rok2 = _ok(rcol, rok)
        rcol_n = ra
        lcol_n = la
        if (rkey.dtype == torch.int32 and -2**31 < lo
                and hi < 2**31 - 1):
            rcol_n = ra.to(torch.int32)
            lcol_n = la.to(torch.int32)
        if dom is not None and not rcol_n.dtype.is_floating_point \
                and rcol_n.dtype != torch.bool:
            self._note("semi.minmax")
            return lok2 & KX.keyed_minmax_semi(
                rkey.contiguous(), rok2.contiguous(), rcol_n.contiguous(),
                lkey.contiguous(), lok2.contiguous(), lcol_n.contiguous(),
                key_lo, dom)
        self._note("semi.sortmerge")
        k_sent = torch.iinfo(rkey.dtype).max
        rkey_s = torch.where(rok2, rkey, torch.full_like(rkey, k_sent))
        perm = _sort_perm(None, [SortKey(rkey_s), SortKey(rcol_n)],
                          rkey_s.shape[0], self.dev)
        sk = rkey_s.index_select(0, perm)
        sc = rcol_n.index_select(0, perm)
        pos_l, pos_r = _ss(sk, lkey, side="both")
        n = sk.shape[0]
        cmin = sc.index_select(0, pos_l.clamp(0, n - 1))
        cmax = sc.index_select(0, (pos_r - 1).clamp(0, n - 1))
        has_key = pos_r > pos_l
        differs = (cmin != lcol_n) | (cmax != lcol_n)
        return lok & lok2 & has_key & differs

    # --------------------------------------------------------- aggregation

    def _run_aggregate(self, node: P.Aggregate) -> DCtx:
        ctx = self.run(node.child)
        b = node.binding
        # each aggregate's argument is evaluated once and shared by the
        # aggregate and its bounds (the reference re-traces it; XLA
        # deduplicates, eager execution would not)
        args = [None if spec.arg is None else self.eval(spec.arg, ctx)
                for _, spec in node.aggs]
        if not node.group_keys:
            out = DCtx(1, self._ones_bool(1))
            for (name, spec), dv in zip(node.aggs, args):
                arr, valid, sdict = self._agg_global(spec, ctx, dv)
                lo, hi = self._agg_bounds(spec, ctx, dv)
                out.cols[(b, name)] = DVal(arr, valid, sdict, lo, hi)
            return out
        keyvals = [self.eval(e, ctx) for _, e in node.group_keys]
        G = self._group_capacity(ctx.n, keyvals)
        # starts2: first sorted position per group (n for empty groups)
        perm, gid, present_s, ngroups, starts2 = self._group_ids(
            ctx, keyvals, G)
        out = DCtx(G, self._arange(G) < ngroups)
        starts = starts2.clamp(0, ctx.n - 1)
        for (kname, _kexpr), kv in zip(node.group_keys, keyvals):
            arr_s = kv.arr.index_select(0, perm)
            arr_g = arr_s.index_select(0, starts)
            valid_g = None
            if kv.valid is not None:
                valid_g = kv.valid.index_select(0, perm).index_select(
                    0, starts)
            out.cols[(b, kname)] = kv.with_arrays(arr_g, valid_g)
        for (name, spec), dv in zip(node.aggs, args):
            arr, valid, sdict = self._agg_grouped(
                spec, ctx, dv, perm, gid, present_s, G, starts2,
                kernel=node.kernel)
            lo, hi = self._agg_bounds(spec, ctx, dv)
            out.cols[(b, name)] = DVal(arr, valid, sdict, lo, hi)
        return out

    @staticmethod
    def _seg_sum(data, gid, starts2):
        """Per-segment sum over the sorted row space (gid sorted, starts2[g]
        = first sorted row of group g, n for empty groups; rows outside
        any group carry 0), in the data's dtype, as the reference's
        cumsum differences give it: K5 with op sum."""
        return KX.seg_reduce_at_ends("sum", data.contiguous(), gid, starts2)

    @staticmethod
    def _agg_bounds(spec: P.AggSpec, ctx: DCtx, dv):
        """Host-known value bounds of an aggregate output."""
        if spec.func == "count":
            return 0, ctx.n
        if dv is None or dv.lo is None or dv.hi is None:
            return None, None
        if spec.func in ("min", "max"):
            return dv.lo, dv.hi
        if spec.func == "sum" and not isinstance(spec.dtype, FloatType):
            return min(0, dv.lo) * ctx.n, max(0, dv.hi) * ctx.n
        return None, None

    @staticmethod
    def _group_capacity(n: int, keyvals) -> int:
        """Static bound on distinct groups: min(rows, product of key
        domains)."""
        prod = 1
        for kv in keyvals:
            if kv.sdict is not None:
                dom = max(len(kv.sdict), 1)
            elif kv.lo is not None and kv.hi is not None:
                dom = max(int(kv.hi) - int(kv.lo) + 1, 1)
            else:
                return n
            if kv.valid is not None:
                dom += 1  # a NULL key forms one extra group
            prod *= dom
            if prod >= n:
                return n
        return max(min(prod, n), 1)

    def _group_ids(self, ctx: DCtx, keyvals, G: int):
        """Stable sort rows by (presence, key validity+values...);
        returns (perm, gid int32 per sorted row clipped to the group
        capacity G, presence per sorted row, ngroups, starts2 = the first
        sorted row of each of the G groups, n past the last). Present
        rows sort to the front. Where the keys' bounds pack them into one
        integer (``_pack_layout``, a host decision), the repo's radix sort
        orders that key, given the digit counts the pack took (so the sort
        launches no histogram pass), and ``group_bounds`` reads the groups
        off it in one pass; else the multi-key sort of the operands as words
        (``_sort_perm``)."""
        n = ctx.n
        layout = _pack_layout(keyvals, n)
        if layout is not None:
            fields, bits = layout
            key, hist = _pack_group_key(ctx.row, keyvals, fields, bits)
            counts = torch.full((1,), n, dtype=torch.int32, device=self.dev)
            ks, perm = KX.partition_sort(key.view(1, n),
                                         self._arange(n).view(1, n), counts,
                                         hist)
            present_s, gid, ngroups, starts2 = KX.group_bounds(
                ks.view(n), bits - 1, G)
            return perm.view(n), gid, present_s, ngroups, starts2
        ops = _group_operands(ctx.row, keyvals)
        perm = _sort_perm(ctx.row, _group_sort_keys(ctx.row, keyvals), n,
                          self.dev)
        present_s = ctx.row.index_select(0, perm)
        diff = self._zeros(n, torch.bool)
        diff[:1].fill_(True)
        for o in ops[1:]:
            o = o.index_select(0, perm)
            diff[1:] |= o[1:] != o[:-1]
        first_s = present_s & diff
        gid = torch.cumsum(first_s.to(torch.int32), 0,
                           dtype=torch.int32) - 1
        gid = gid.clamp(0, n - 1).clamp_max(G - 1)
        ngroups = first_s.sum()
        starts2 = _ss(gid, self._arange(G, gid.dtype))
        return perm, gid, present_s, ngroups, starts2

    def _agg_global(self, spec: P.AggSpec, ctx: DCtx, dv):
        if spec.func == "count":
            if dv is None:
                cnt = ctx.row.sum()
                return (cnt.reshape(1).to(torch.int64),
                        self._ones_bool(1), None)
            w = _ok(dv, ctx.row)
            if spec.distinct:
                # sentinel-free distinct: validity is its own sort key
                arr = _narrow_key(dv)
                perm = _sort_perm(None, [SortKey(w, invert=True),
                                         SortKey(arr)], arr.shape[0],
                                  self.dev)
                v_s = arr.index_select(0, perm)
                w_s = w.index_select(0, perm)
                newv = torch.cat([self._ones_bool(1), v_s[1:] != v_s[:-1]])
                cnt = (newv & w_s).sum()
            else:
                cnt = w.sum()
            return (cnt.reshape(1).to(torch.int64), self._ones_bool(1),
                    None)
        w = _ok(dv, ctx.row)
        cnt = w.sum()
        valid = (cnt > 0).reshape(1)
        zero_f = torch.zeros((), dtype=self.fdt, device=self.dev)
        if spec.func == "sum":
            if isinstance(spec.dtype, FloatType):
                s = torch.where(w, dv.arr.to(self.fdt), zero_f).sum()
            else:
                s = torch.where(w, dv.arr.to(torch.int64),
                                torch.zeros((), dtype=torch.int64,
                                            device=self.dev)).sum()
            return s.reshape(1), valid, None
        if spec.func == "avg":
            f = _to_float(dv.arr, spec.arg.dtype, self.fdt)
            s = torch.where(w, f, zero_f).sum()
            return (s / cnt.clamp_min(1)).reshape(1), valid, None
        if spec.func in ("min", "max"):
            if dv.arr.dtype.is_floating_point:
                fill = float("inf") if spec.func == "min" else float("-inf")
                masked = torch.where(w, dv.arr, torch.full_like(dv.arr, fill))
            else:
                fill = I64_MAX if spec.func == "min" else I64_MIN
                a64 = dv.arr.to(torch.int64)
                masked = torch.where(w, a64, torch.full_like(a64, fill))
            red = masked.min() if spec.func == "min" else masked.max()
            return red.reshape(1), valid, dv.sdict
        if spec.func in ("stddev_samp", "stddev"):
            f = _to_float(dv.arr, spec.arg.dtype, self.fdt)
            s1 = torch.where(w, f, zero_f).sum()
            s2 = torch.where(w, f * f, zero_f).sum()
            c = cnt.to(self.fdt)
            var = (s2 - s1 * s1 / c.clamp_min(1)) / (c - 1).clamp_min(1)
            sd = torch.sqrt(var.clamp_min(0.0))
            nan = torch.full_like(sd, float("nan"))
            return torch.where(cnt > 1, sd, nan).reshape(1), valid, None
        raise DeviceExecError(spec.func)

    def _agg_grouped(self, spec: P.AggSpec, ctx: DCtx, dv, perm, gid,
                     present_s, G, starts2, kernel: str = ""):
        if spec.func == "count" and spec.distinct:
            return self._count_distinct_grouped(ctx, dv, perm, gid, G)
        if dv is None:  # count(*)
            cnt = self._seg_sum(present_s.to(torch.int32), gid,
                                starts2).to(torch.int64)
            return cnt, None, None
        arr_s = dv.arr.index_select(0, perm)
        w = present_s
        if dv.valid is not None:
            w = w & dv.valid.index_select(0, perm)
        cnt = self._seg_sum(w.to(torch.int32), gid, starts2).to(torch.int64)
        if spec.func == "count":
            return cnt, None, None
        valid = cnt > 0
        zero_f = torch.zeros((), dtype=self.fdt, device=self.dev)
        if spec.func == "sum":
            if isinstance(spec.dtype, FloatType):
                data = torch.where(w, arr_s.to(self.fdt), zero_f)
            else:
                data = torch.where(w, arr_s.to(torch.int64),
                                   torch.zeros((), dtype=torch.int64,
                                               device=self.dev))
            return self._seg_sum(data, gid, starts2), valid, None
        if spec.func == "avg":
            f = _to_float(arr_s, spec.arg.dtype, self.fdt)
            s = self._seg_sum(torch.where(w, f, zero_f), gid, starts2)
            return s / cnt.clamp_min(1).to(self.fdt), valid, None
        if spec.func in ("min", "max"):
            isf = arr_s.dtype.is_floating_point
            if isf:
                fill = float("inf") if spec.func == "min" else float("-inf")
                data = torch.where(w, arr_s, torch.full_like(arr_s, fill))
            else:
                # int32 when host bounds allow, as the reference
                arr_i = arr_s.to(torch.int64)
                if (dv.lo is not None and dv.hi is not None
                        and -2**31 < dv.lo and dv.hi < 2**31 - 1):
                    arr_i = arr_s.to(torch.int32)
                info = torch.iinfo(arr_i.dtype)
                fill = info.max if spec.func == "min" else info.min
                data = torch.where(w, arr_i, torch.full_like(arr_i, fill))
            if kernel == KX.AGG_SEGSCAN:
                red = KX.seg_reduce_at_ends(spec.func, data.contiguous(),
                                            gid.contiguous(),
                                            starts2.contiguous())
                self._note("agg.segscan")
            else:
                red = torch.full((G,), fill, dtype=data.dtype,
                                 device=self.dev).scatter_reduce_(
                    0, gid.to(torch.int64), data,
                    "amin" if spec.func == "min" else "amax",
                    include_self=True)
                self._note("agg.scatter")
            if not isf and not isinstance(spec.dtype,
                                          (FloatType, DecimalType)):
                red = red.to(arr_s.dtype)
            elif not isf:
                red = red.to(torch.int64)
            return red, valid, dv.sdict
        if spec.func in ("stddev_samp", "stddev"):
            f = _to_float(arr_s, spec.arg.dtype, self.fdt)
            s1 = self._seg_sum(torch.where(w, f, zero_f), gid, starts2)
            s2 = self._seg_sum(torch.where(w, f * f, zero_f), gid, starts2)
            c = cnt.to(self.fdt)
            var = (s2 - s1 * s1 / c.clamp_min(1)) / (c - 1).clamp_min(1)
            sd = torch.sqrt(var.clamp_min(0.0))
            return (torch.where(cnt > 1, sd, torch.full_like(sd, float("nan"))),
                    valid, None)
        raise DeviceExecError(spec.func)

    def _count_distinct_grouped(self, ctx, dv, perm, gid, G):
        """Re-sort by (presence, gid, value validity, value); count first
        occurrences of (gid, value) among valid rows."""
        n = ctx.n
        val = _narrow_key(dv)
        lo, hi = ((0, len(dv.sdict) - 1) if dv.sdict is not None
                  else (dv.lo, dv.hi))
        if val.dtype not in (torch.int32, torch.int64):
            val = dv.arr.to(torch.int64)
            lo, hi = (0, 1) if dv.arr.dtype == torch.bool else (None, None)
        w0 = _ok(dv, ctx.row)
        # group id per original row: scatter sorted gid back through perm
        # (a permutation: every slot takes a gid in [0, G - 1])
        gid_orig = torch.empty_like(gid)
        gid_orig[perm.to(torch.int64)] = gid
        keys = [SortKey(ctx.row, invert=True), SortKey(gid_orig, lo=0,
                                                       hi=G - 1),
                SortKey(w0, invert=True),
                SortKey(val, dv.valid, use_row=True, lo=lo, hi=hi)]
        perm2 = _sort_perm(ctx.row, keys, n, self.dev)
        g2 = gid_orig.index_select(0, perm2)
        v2 = _sort_operand(ctx.row, keys[3]).index_select(0, perm2)
        w2 = w0.index_select(0, perm2)
        newpair = torch.cat([self._ones_bool(1),
                             (g2[1:] != g2[:-1]) | (v2[1:] != v2[:-1])])
        flag = w2 & newpair
        starts2 = _ss(g2, self._arange(G, g2.dtype))
        cnt = self._seg_sum(flag.to(torch.int32), g2, starts2).to(
            torch.int64)
        return cnt, None, None

    # ------------------------------------------------------------- windows

    def _run_window(self, node: P.Window) -> DCtx:
        """Sort-based window evaluation: per window column one multi-key
        sort into partition-major/order-minor space, then running maxima
        (``running_max``), cumsum differences and segmented scans,
        scattered back through the permutation."""
        ctx = self.run(node.child)
        out = DCtx(ctx.n, ctx.row)
        out.cols.update(ctx.cols)
        for name, spec in node.specs:
            out.cols[(node.binding, name)] = self._window_col(spec, ctx)
        return out

    @staticmethod
    def _changes(o):
        """True at row 0 and wherever the sorted key changes."""
        return torch.cat([torch.ones(1, dtype=torch.bool, device=o.device),
                          o[1:] != o[:-1]])

    def _window_col(self, spec: P.WindowSpec, ctx: DCtx) -> DVal:
        n = ctx.n
        iota = self._arange(n)
        zero_i = torch.zeros((), dtype=torch.int32, device=self.dev)
        # the keys of the reference's sort (``:2424-2456``): presence, the
        # partition keys as the group-by fills them, the order keys
        keys = _group_sort_keys(ctx.row, [self.eval(p, ctx)
                                          for p in spec.partition])
        nparts = len(keys)
        for e, asc, nulls_first in spec.order:
            keys += _order_keys(self.eval(e, ctx), asc, nulls_first)
        perm = _sort_perm(ctx.row, keys, n, self.dev)
        part_ops = list(range(1, nparts))
        order_ops = list(range(nparts, len(keys)))
        sorted_ops = {i: _sort_operand(ctx.row, keys[i]).index_select(0, perm)
                      for i in part_ops + order_ops}
        present_s = ctx.row.index_select(0, perm)
        part_start = self._zeros(n, torch.bool)
        part_start[:1].fill_(True)
        for i in part_ops:
            part_start = part_start | self._changes(sorted_ops[i])
        start_pos = KX.running_max(torch.where(part_start, iota, zero_i))

        def scatter(res_sorted, valid_sorted=None, lo=None, hi=None):
            # perm is a permutation: every slot is written once
            idx = perm.to(torch.int64)
            arr = torch.zeros_like(res_sorted).index_copy_(0, idx,
                                                           res_sorted)
            valid = None
            if valid_sorted is not None:
                valid = torch.zeros_like(valid_sorted).index_copy_(
                    0, idx, valid_sorted)
            return DVal(arr, valid, None, lo, hi)

        def order_change():
            change = part_start
            for i in order_ops:
                change = change | self._changes(sorted_ops[i])
            return change

        if spec.func in ("rank", "dense_rank", "row_number"):
            if spec.func == "row_number":
                return scatter((iota - start_pos + 1).to(torch.int64),
                               lo=1, hi=n)
            change = order_change()
            if spec.func == "dense_rank":
                c = torch.cumsum(change.to(torch.int64), 0)
                cstart = KX.running_max(
                    torch.where(part_start, c, torch.zeros_like(c)))
                return scatter(c - cstart + 1, lo=1, hi=n)
            lastchg = KX.running_max(torch.where(change, iota, zero_i))
            return scatter((lastchg - start_pos + 1).to(torch.int64),
                           lo=1, hi=n)

        # aggregate windows
        if spec.arg is not None:
            dv = self.eval(spec.arg, ctx)
            w = _ok(dv, ctx.row).index_select(0, perm)
            vals = dv.arr.index_select(0, perm)
        else:  # count(*)
            w = present_s
            vals = torch.ones(n, dtype=torch.int64, device=self.dev)
        running = bool(spec.order)
        is_f = isinstance(spec.dtype, FloatType)
        if spec.func == "avg":
            vals = _to_float(vals, spec.arg.dtype, self.fdt)
        elif is_f:
            vals = vals.to(self.fdt)
        else:
            vals = vals.to(torch.int64)
        # per-row partition end: the last row of its partition, the
        # reference's reversed running minimum of the next partition start
        pend = KX.last_of_group(part_start, n)

        def part_total(data):
            # the partition's sum as inclusive-cumsum differences at its
            # bounding rows (the cumsum keeps the data's dtype)
            csum = torch.cumsum(data, 0, dtype=data.dtype)
            hi = csum.index_select(0, pend)
            lo = torch.where(start_pos > 0,
                             csum.index_select(0, (start_pos - 1).clamp(
                                 0, n - 1)),
                             torch.zeros((), dtype=csum.dtype,
                                         device=self.dev))
            return hi - lo

        if spec.func == "count":
            src = w.to(torch.int32)
            res = (KX.seg_scan("sum", src, part_start) if running
                   else part_total(src))
            return self._window_range_fix(
                spec, scatter, res.to(torch.int64), None, order_change,
                running)
        cnt_src = w.to(torch.int32)
        cnt = (KX.seg_scan("sum", cnt_src, part_start) if running
               else part_total(cnt_src))
        valid = cnt > 0
        if spec.func in ("sum", "avg"):
            data = torch.where(w, vals, torch.zeros((), dtype=vals.dtype,
                                                    device=self.dev))
            res = (KX.seg_scan("sum", data, part_start) if running
                   else part_total(data))
            if spec.func == "avg":
                res = res.to(self.fdt) / cnt.clamp_min(1).to(self.fdt)
        elif spec.func in ("min", "max"):
            if vals.dtype.is_floating_point:
                fill = float("inf") if spec.func == "min" else float("-inf")
            else:
                fill = I64_MAX if spec.func == "min" else I64_MIN
            data = torch.where(w, vals, torch.full_like(vals, fill))
            if running:
                res = KX.seg_scan(spec.func, data, part_start)
            else:
                # whole-partition min/max: the segmented scan read at the
                # partition's last row, broadcast to every row
                res = KX.part_reduce_broadcast(spec.func, data, part_start,
                                               pend)
        else:
            raise DeviceExecError(f"window func {spec.func}")
        return self._window_range_fix(spec, scatter, res, valid,
                                      order_change, running)

    @staticmethod
    def _window_range_fix(spec, scatter, res, valid, order_change,
                          running):
        """SQL's default frame with ORDER BY is RANGE .. CURRENT ROW:
        peer (order-key-tied) rows share the value at the peer group's
        last row. A ROWS frame keeps the per-row running value."""
        if running and spec.frame is None:
            n = res.shape[0]
            last = KX.last_of_group(order_change(), n)
            res = res.index_select(0, last)
            if valid is not None:
                valid = valid.index_select(0, last)
        return scatter(res, valid)

    # ------------------------------------------------ distinct and set ops

    def _distinct_ctx(self, ctx: DCtx, keyvals, output, b: str) -> DCtx:
        """One row per distinct key tuple: the group-id sort, read at
        each group's first sorted row."""
        G = ctx.n
        perm, _gid, _present_s, ngroups, starts2 = self._group_ids(
            ctx, keyvals, G)
        starts = starts2.clamp(0, ctx.n - 1)
        out = DCtx(G, self._arange(G) < ngroups)
        for (name, _dt), kv in zip(output, keyvals):
            arr_g = kv.arr.index_select(0, perm).index_select(0, starts)
            valid_g = None
            if kv.valid is not None:
                valid_g = kv.valid.index_select(0, perm).index_select(
                    0, starts)
            out.cols[(b, name)] = kv.with_arrays(arr_g, valid_g)
        return out

    def _run_distinct(self, node: P.Distinct) -> DCtx:
        ctx = self.run(node.child)
        b = node.binding
        keyvals = [ctx.cols[(b, name)] for name, _ in node.output]
        return self._distinct_ctx(ctx, keyvals, node.output, b)

    def _run_setop(self, node: P.SetOp) -> DCtx:
        lctx, rctx = self.run(node.left), self.run(node.right)
        lb, rb = node.left.binding, node.right.binding
        if node.kind.startswith("union"):
            out = DCtx(lctx.n + rctx.n, torch.cat([lctx.row, rctx.row]))
            for (lname, _), (rname, _) in zip(node.left.output,
                                              node.right.output):
                lv = lctx.cols[(lb, lname)]
                rv = rctx.cols[(rb, rname)]
                la, ra = lv.arr, rv.arr
                sdict = lv.sdict
                if lv.sdict is not None or rv.sdict is not None:
                    la, ra, sdict = self._union_dict(lv, rv)
                if la.dtype != ra.dtype:
                    tgt = torch.promote_types(la.dtype, ra.dtype)
                    la, ra = la.to(tgt), ra.to(tgt)
                valid = None
                if lv.valid is not None or rv.valid is not None:
                    lvv = (lv.valid if lv.valid is not None
                           else self._ones_bool(lctx.n))
                    rvv = (rv.valid if rv.valid is not None
                           else self._ones_bool(rctx.n))
                    valid = torch.cat([lvv, rvv])
                out.cols[(lb, lname)] = DVal(
                    torch.cat([la, ra]), valid, sdict,
                    None if (lv.lo is None or rv.lo is None)
                    else min(lv.lo, rv.lo),
                    None if (lv.hi is None or rv.hi is None)
                    else max(lv.hi, rv.hi))
            if node.kind == "union":
                keyvals = [out.cols[(lb, name)]
                           for name, _ in node.left.output]
                return self._distinct_ctx(out, keyvals, node.left.output,
                                          lb)
            return out
        # INTERSECT / EXCEPT: whole-row membership against the right
        # side. Rows pack into one int64 (pair-aligned per column, plus a
        # validity bit so NULLs compare equal, the SQL set-op rule); the
        # probe is a sorted-membership check. A Distinct above
        # (planner-inserted) gives the set semantics.
        lvals = [lctx.cols[(lb, name)] for name, _ in node.left.output]
        rvals = [rctx.cols[(rb, name)] for name, _ in node.right.output]
        lkey = self._zeros(lctx.n, torch.int64)
        rkey = self._zeros(rctx.n, torch.int64)
        total_w = 0
        for lv, rv in zip(lvals, rvals):
            la, ra, lo, hi = self._align_pair(lv, rv)
            w = max((hi - lo).bit_length(), 1)
            ln = (la.to(torch.int64) - lo).clamp(0, hi - lo)
            rn = (ra.to(torch.int64) - lo).clamp(0, hi - lo)
            if lv.valid is not None or rv.valid is not None:
                lval = (lv.valid if lv.valid is not None
                        else self._ones_bool(lctx.n))
                rval = (rv.valid if rv.valid is not None
                        else self._ones_bool(rctx.n))
                ln = (torch.where(lval, ln, torch.zeros_like(ln))
                      | (lval.to(torch.int64) << w))
                rn = (torch.where(rval, rn, torch.zeros_like(rn))
                      | (rval.to(torch.int64) << w))
                w += 1
            total_w += w
            if total_w > 62:
                raise DeviceExecError(
                    f"set-op row too wide to pack ({total_w} bits)")
            lkey = (lkey << w) | ln
            rkey = (rkey << w) | rn
        sent = I64_MAX
        if total_w <= 30:
            lkey = lkey.to(torch.int32)
            rkey = rkey.to(torch.int32)
            sent = 2**31 - 1
        ks = _sort_values(torch.where(rctx.row, rkey,
                                      torch.full_like(rkey, sent)))
        _idx, hit = KX.sorted_search(ks, lkey.contiguous(), "probe")
        keep = hit if node.kind == "intersect" else ~hit
        out = DCtx(lctx.n, lctx.row & keep)
        out.cols = lctx.cols
        return out

    # ------------------------------------------------------- sort and misc

    def _run_sort(self, node: P.Sort) -> DCtx:
        ctx = self.run(node.child)
        keys = [SortKey(ctx.row, invert=True)]
        for e, asc, nulls_first in node.keys:
            keys += _order_keys(self.eval(e, ctx), asc, nulls_first)
        perm = _sort_perm(ctx.row, keys, ctx.n, self.dev)
        out = ctx.gather(perm)
        out.row = ctx.row.index_select(0, perm)
        return out

    def _compact(self, ctx: DCtx) -> DCtx:
        """Stable-sort present rows to the front (before Limit when the
        child did not already order them): the compactor."""
        perm, _count = KX.compact_perm(ctx.row)
        out = ctx.gather(perm)
        out.row = ctx.row.index_select(0, perm)
        return out

    def _run_limit(self, node: P.Limit) -> DCtx:
        ctx = self.run(node.child)
        if not isinstance(node.child, P.Sort):
            ctx = self._compact(ctx)
        cap = min(node.count, ctx.n)
        out = DCtx(cap, ctx.row[:cap])
        for k, dv in ctx.cols.items():
            out.cols[k] = dv.head(cap)
        return out

    # ---------------------------------------------------------- expressions

    def eval(self, e: ir.IR, ctx: DCtx) -> DVal:
        if isinstance(e, ir.ColRef):
            return ctx.cols[(e.binding, e.name)]
        if isinstance(e, ir.Lit):
            return self._eval_lit(e, ctx)
        if isinstance(e, ir.ScalarRef):
            v, ok, sdict, _dt = self.scalars[e.plan_id]
            return DVal(v.expand(ctx.n), ok.expand(ctx.n), sdict)
        if isinstance(e, ir.Arith):
            return self._eval_arith(e, ctx)
        if isinstance(e, ir.Cmp):
            return self._eval_cmp(e, ctx)
        if isinstance(e, ir.BoolOp):
            vals = [self.eval(a, ctx) for a in e.args]
            out = vals[0].arr.to(torch.bool)
            valid = vals[0].valid
            for dv in vals[1:]:
                if e.op == "and":
                    out = out & dv.arr.to(torch.bool)
                else:
                    out = out | dv.arr.to(torch.bool)
                valid = _and_valid(valid, dv.valid)
            return DVal(out, valid)
        if isinstance(e, ir.Not):
            dv = self.eval(e.operand, ctx)
            return DVal(~dv.arr.to(torch.bool), dv.valid)
        if isinstance(e, ir.Neg):
            dv = self.eval(e.operand, ctx)
            lo = None if dv.hi is None else -dv.hi
            hi = None if dv.lo is None else -dv.lo
            return DVal(-dv.arr, dv.valid, None, lo, hi)
        if isinstance(e, ir.CaseIR):
            return self._eval_case(e, ctx)
        if isinstance(e, ir.LikeIR):
            dv = self.eval(e.operand, ctx)
            if dv.sdict is None:
                raise DeviceExecError("LIKE over non-string")
            sd = dv.sdict

            def build():
                table = like_mask(sd, e.pattern)
                return self._host(~table if e.negated else table)
            table = self.ex.dict_table(
                ("like", id(sd), e.pattern, e.negated), (sd,), build)
            return DVal(_take_codes(table, dv.arr), dv.valid)
        if isinstance(e, ir.InListIR):
            return self._eval_inlist(e, ctx)
        if isinstance(e, ir.IsNullIR):
            dv = self.eval(e.operand, ctx)
            if dv.valid is None:
                isnull = self._zeros(ctx.n, torch.bool)
            else:
                isnull = ~dv.valid
            return DVal(~isnull if e.negated else isnull, None)
        if isinstance(e, ir.ExtractIR):
            dv = self.eval(e.operand, ctx)
            y, m, d = _epoch_days_to_civil(dv.arr)
            if e.part == "year":
                return DVal(y, dv.valid, None, 1970, 2199)
            if e.part == "month":
                return DVal(m, dv.valid, None, 1, 12)
            if e.part == "day":
                return DVal(d, dv.valid, None, 1, 31)
            raise DeviceExecError(f"extract {e.part}")
        if isinstance(e, ir.StrMapIR):
            dv = self.eval(e.operand, ctx)
            f = str.upper if e.op == "upper" else str.lower
            return self._rewrite_dict(dv, f, ("strmap", e.op))
        if isinstance(e, ir.ConcatIR):
            dv = self.eval(e.operand, ctx)
            return self._rewrite_dict(dv, lambda s: e.prefix + s + e.suffix,
                                      ("concat", e.prefix, e.suffix))
        if isinstance(e, ir.SubstrIR):
            return self._eval_substr(e, ctx)
        if isinstance(e, ir.CastIR):
            return self._eval_cast(e, ctx)
        raise DeviceExecError(
            f"cannot eval {type(e).__name__} on the torch engine")

    def _eval_lit(self, e: ir.Lit, ctx: DCtx) -> DVal:
        n = ctx.n
        if isinstance(e.dtype, StringType):
            # string literals only appear inside comparisons, which bind
            # them against a dictionary
            sd = self.ex.dict_table(
                ("lit", id(e)), (e,),
                lambda: np.array(["" if e.value is None else e.value],
                                 dtype=object))
            return DVal(self._zeros(n, torch.int32),
                        self._zeros(n, torch.bool) if e.value is None
                        else None, sd, 0, 0)
        v = e.value
        if v is None:
            if isinstance(e.dtype, FloatType):
                return DVal(self._zeros(n, self.fdt),
                            self._zeros(n, torch.bool))
            dt = torch.int32 if isinstance(e.dtype, DateType) else torch.int64
            return DVal(self._zeros(n, dt), self._zeros(n, torch.bool),
                        None, 0, 0)
        if isinstance(e.dtype, FloatType):
            return DVal(torch.full((n,), float(v), dtype=self.fdt,
                                   device=self.dev), None)
        iv = int(v)
        dtype = torch.int64
        if isinstance(e.dtype, IntType) and e.dtype.bits <= 32 \
                and -2**31 <= iv < 2**31:
            dtype = torch.int32
        if isinstance(e.dtype, DateType):
            dtype = torch.int32
        return DVal(torch.full((n,), iv, dtype=dtype, device=self.dev),
                    None, None, iv, iv)

    def _eval_arith(self, e: ir.Arith, ctx: DCtx) -> DVal:
        l = self.eval(e.left, ctx)  # noqa: E741
        r = self.eval(e.right, ctx)
        valid = _and_valid(l.valid, r.valid)
        lt, rt = e.left.dtype, e.right.dtype
        if isinstance(e.dtype, DateType):
            return DVal(l.arr + r.arr, valid)
        if e.op == "/":
            la = _to_float(l.arr, lt, self.fdt)
            ra = _to_float(r.arr, rt, self.fdt)
            return DVal(la / ra, valid)
        if isinstance(e.dtype, FloatType):
            return DVal(_apply(e.op, _to_float(l.arr, lt, self.fdt),
                               _to_float(r.arr, rt, self.fdt)), valid)
        if isinstance(e.dtype, DecimalType):
            if e.op == "*":
                return DVal(l.arr.to(torch.int64) * r.arr.to(torch.int64),
                            valid)
            s = e.dtype.scale
            la = _rescale(l.arr, _scale_of(lt), s)
            ra = _rescale(r.arr, _scale_of(rt), s)
            return DVal(_apply(e.op, la, ra), valid)
        out = _apply(e.op, l.arr, r.arr)
        lo = hi = None
        if (l.lo is not None and r.lo is not None
                and l.hi is not None and r.hi is not None):
            if e.op == "+":
                lo, hi = l.lo + r.lo, l.hi + r.hi
            elif e.op == "-":
                lo, hi = l.lo - r.hi, l.hi - r.lo
            elif e.op == "*":
                cands = [l.lo * r.lo, l.lo * r.hi, l.hi * r.lo, l.hi * r.hi]
                lo, hi = min(cands), max(cands)
        return DVal(out, valid, None, lo, hi)

    def _eval_cmp(self, e: ir.Cmp, ctx: DCtx) -> DVal:
        lt, rt = e.left.dtype, e.right.dtype
        if isinstance(lt, StringType) or isinstance(rt, StringType):
            return self._string_cmp(e, ctx)
        l = self.eval(e.left, ctx)  # noqa: E741
        r = self.eval(e.right, ctx)
        valid = _and_valid(l.valid, r.valid)
        la, ra = l.arr, r.arr
        if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            if isinstance(lt, FloatType) or isinstance(rt, FloatType):
                la, ra = (_to_float(la, lt, self.fdt),
                          _to_float(ra, rt, self.fdt))
            else:
                s = max(_scale_of(lt), _scale_of(rt))
                la = _rescale(la.to(torch.int64), _scale_of(lt), s)
                ra = _rescale(ra.to(torch.int64), _scale_of(rt), s)
        elif isinstance(lt, FloatType) or isinstance(rt, FloatType):
            la, ra = (_to_float(la, lt, self.fdt),
                      _to_float(ra, rt, self.fdt))
        return DVal(_cmp(e.op, la, ra), valid)

    def _string_cmp(self, e: ir.Cmp, ctx: DCtx) -> DVal:
        lit, col_ir, flipped = None, None, False
        if isinstance(e.right, ir.Lit):
            lit, col_ir = e.right.value, e.left
        elif isinstance(e.left, ir.Lit):
            lit, col_ir, flipped = e.left.value, e.right, True
        if lit is not None:
            dv = self.eval(col_ir, ctx)
            if dv.sdict is None:
                raise DeviceExecError("string compare on non-dict column")
            sd = dv.sdict
            op = e.op
            if flipped:
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            table = self.ex.dict_table(
                ("cmp", id(sd), op, str(lit)), (sd,),
                lambda: self._host(_np_cmp(op, sd.astype(str), str(lit))))
            return DVal(_take_codes(table, dv.arr), dv.valid)
        l = self.eval(e.left, ctx)  # noqa: E741
        r = self.eval(e.right, ctx)
        valid = _and_valid(l.valid, r.valid)
        la, ra, _sd = self._union_dict(l, r)
        return DVal(_cmp(e.op, la, ra), valid)

    def _union_dict(self, lv: DVal, rv: DVal):
        if lv.sdict is None or rv.sdict is None:
            raise DeviceExecError("union of string and non-string column")
        if lv.sdict is rv.sdict or (
                len(lv.sdict) == len(rv.sdict)
                and np.array_equal(lv.sdict, rv.sdict)):
            return lv.arr, rv.arr, lv.sdict
        union, lmap, rmap = self._dict_union(lv.sdict, rv.sdict)
        return _take_codes(lmap, lv.arr), _take_codes(rmap, rv.arr), union

    def _eval_case(self, e: ir.CaseIR, ctx: DCtx) -> DVal:
        if isinstance(e.dtype, StringType):
            return self._eval_case_string(e, ctx)
        conds, vals, branch_valids = [], [], []
        for c, v in e.whens:
            cdv = self.eval(c, ctx)
            cm = cdv.arr.to(torch.bool)
            if cdv.valid is not None:
                cm = cm & cdv.valid
            vdv = self.eval(v, ctx)
            conds.append(cm)
            vals.append(self._coerce(vdv, v.dtype, e.dtype))
            branch_valids.append(vdv.valid)
        if e.else_ is not None:
            edv = self.eval(e.else_, ctx)
            default = self._coerce(edv, e.else_.dtype, e.dtype)
            valid = edv.valid
        else:
            if isinstance(e.dtype, FloatType):
                default = self._zeros(ctx.n, self.fdt)
            else:
                default = self._zeros(ctx.n, torch.int64)
            valid = self._zeros(ctx.n, torch.bool)  # no branch -> NULL
        out = default
        # the result's validity is the selected branch's validity
        need_valid = valid is not None or any(
            bv is not None for bv in branch_valids)
        if need_valid and valid is None:
            valid = self._ones_bool(ctx.n)
        for c, v, bv in zip(reversed(conds), reversed(vals),
                            reversed(branch_valids)):
            out = torch.where(c, v, out)
            if need_valid:
                bvv = bv if bv is not None else self._ones_bool(ctx.n)
                valid = torch.where(c, bvv, valid)
        return DVal(out, valid)

    def _eval_case_string(self, e: ir.CaseIR, ctx: DCtx) -> DVal:
        """String-valued CASE: union the branch dictionaries on the
        host, remap every branch's codes, then a where-chain over codes."""
        branches = []
        for c, v in e.whens:
            cdv = self.eval(c, ctx)
            cm = cdv.arr.to(torch.bool)
            if cdv.valid is not None:
                cm = cm & cdv.valid
            branches.append((cm, self.eval(v, ctx)))
        else_dv = (self.eval(e.else_, ctx) if e.else_ is not None
                   else DVal(self._zeros(ctx.n, torch.int32),
                             self._zeros(ctx.n, torch.bool),
                             self.ex.dict_table(
                                 ("case-null", id(e)), (e,),
                                 lambda: np.array([""], dtype=object))))
        dvals = [dv for _, dv in branches] + [else_dv]
        for dv in dvals:
            if dv.sdict is None:
                raise DeviceExecError(
                    "string CASE branch without dictionary")
        sds = tuple(dv.sdict for dv in dvals)

        def build():
            union = np.array(sorted(set().union(
                *[set(sd.astype(str)) for sd in sds])), dtype=object)
            return union, [self._host(np.searchsorted(
                union.astype(str), sd.astype(str)).astype(np.int32))
                for sd in sds]
        union, tables = self.ex.dict_table(
            ("case",) + tuple(id(sd) for sd in sds), sds, build)
        remapped = []
        for dv, table in zip(dvals, tables):
            arr = _take_codes(table, dv.arr)
            if arr.dim() == 0:
                arr = arr.expand(ctx.n)
            remapped.append(arr)
        out = remapped[-1]
        valid = (else_dv.valid if else_dv.valid is not None
                 else self._ones_bool(ctx.n))
        for (cm, dv), arr in zip(reversed(branches),
                                 reversed(remapped[:-1])):
            out = torch.where(cm, arr, out)
            bv = (dv.valid if dv.valid is not None
                  else self._ones_bool(ctx.n))
            valid = torch.where(cm, bv, valid)
        return DVal(out, valid, union, 0, max(len(union) - 1, 0))

    def _coerce(self, dv: DVal, src: DType, dst: DType):
        if repr(src) == repr(dst):
            return dv.arr
        if isinstance(dst, FloatType):
            return _to_float(dv.arr, src, self.fdt)
        if isinstance(dst, DecimalType):
            return _rescale(dv.arr.to(torch.int64), _scale_of(src),
                            dst.scale)
        return dv.arr

    def _eval_inlist(self, e: ir.InListIR, ctx: DCtx) -> DVal:
        dv = self.eval(e.operand, ctx)
        if dv.sdict is not None:
            sd = dv.sdict
            want = tuple(str(v) for v in e.values)

            def build():
                table = np.isin(sd.astype(str), np.array(want))
                return self._host(~table if e.negated else table)
            table = self.ex.dict_table(("in", id(sd), want, e.negated),
                                       (sd,), build)
            return DVal(_take_codes(table, dv.arr), dv.valid)
        vals = e.values
        if isinstance(e.operand.dtype, DecimalType):
            s = e.operand.dtype.scale
            vals = [int(round(float(x) * 10 ** s)) for x in vals]
        m = self._zeros(ctx.n, torch.bool)
        for v in vals:
            m = m | (dv.arr == v)
        return DVal(~m if e.negated else m, dv.valid)

    def _rewrite_dict(self, dv: DVal, fn, key: tuple) -> DVal:
        """Apply a per-entry string transform to a dictionary-encoded
        value: codes stay on the device; the host dictionary is
        rewritten, deduplicated, re-sorted, and codes remapped. The
        (new dictionary, remap) pair is memoized per (dictionary, key),
        so later runs see the same dictionary object."""
        if dv.sdict is None:
            raise DeviceExecError("string transform over non-string")
        sd = dv.sdict

        def build():
            newvals = np.array([fn(s) for s in sd.astype(str)],
                               dtype=object)
            uniq, inverse = np.unique(newvals.astype(str),
                                      return_inverse=True)
            return uniq.astype(object), self._host(inverse.astype(np.int32))
        uniq, table = self.ex.dict_table(("rewrite", id(sd)) + key, (sd,),
                                         build)
        return DVal(_take_codes(table, dv.arr), dv.valid, uniq, 0,
                    max(len(uniq) - 1, 0))

    def _eval_substr(self, e: ir.SubstrIR, ctx: DCtx) -> DVal:
        dv = self.eval(e.operand, ctx)
        lo = e.start - 1
        hi = None if e.length is None else lo + e.length
        return self._rewrite_dict(dv, lambda s: s[lo:hi],
                                  ("substr", lo, hi))

    def _eval_cast(self, e: ir.CastIR, ctx: DCtx) -> DVal:
        dv = self.eval(e.operand, ctx)
        src = e.operand.dtype
        if isinstance(e.dtype, FloatType):
            return DVal(_to_float(dv.arr, src, self.fdt), dv.valid)
        if isinstance(e.dtype, IntType):
            if isinstance(src, DecimalType):
                return DVal(torch.floor_divide(dv.arr, 10 ** src.scale).to(
                    torch.int64), dv.valid)
            return DVal(dv.arr.to(torch.int64), dv.valid, None,
                        dv.lo, dv.hi)
        if isinstance(e.dtype, DecimalType):
            s = e.dtype.scale
            if isinstance(src, DecimalType):
                return DVal(_rescale(dv.arr, src.scale, s), dv.valid)
            if isinstance(src, IntType):
                return DVal(dv.arr.to(torch.int64) * 10 ** s, dv.valid)
            return DVal(torch.round(dv.arr * 10 ** s).to(torch.int64),
                        dv.valid)
        raise DeviceExecError(f"cast to {e.dtype}")


def _apply(op, l, r):  # noqa: E741
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "%":
        return torch.remainder(l, r)
    raise DeviceExecError(op)


def _cmp(op, l, r):  # noqa: E741
    if op == "=":
        return l == r
    if op == "<>":
        return l != r
    if op == "<":
        return l < r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == ">=":
        return l >= r
    raise DeviceExecError(op)


def _np_cmp(op, vals, lit):
    if op == "=":
        return vals == lit
    if op == "<>":
        return vals != lit
    if op == "<":
        return vals < lit
    if op == "<=":
        return vals <= lit
    if op == ">":
        return vals > lit
    if op == ">=":
        return vals >= lit
    raise DeviceExecError(op)


def _notify_overflow(entry: dict) -> None:
    """An M:N join outgrew its capacity and the plan runs again at a
    doubled slack: a recovered task-level failure, which the power run's
    report records (``CompletedWithTaskFailures``), with the reference's
    message. Imported here, as in the reference: the engine does not
    depend on the report layer to load."""
    from nds_tpu_torch.utils.report import TaskFailureCollector
    TaskFailureCollector.notify(
        f"join expansion overflow: retry with slack {entry['slack'] * 2}")


def make_device_factory(precision: str = "f64", device=None):
    """Session executor factory that keeps ONE DeviceExecutor per table
    registry, preserving its device buffers across queries (the
    load-once, query-many lifecycle of a power run). ``device=None`` is
    the card (``cuda``) and raises where there is none; the CPU must be
    asked for (``device="cpu"``). Floats compute in float64, which
    matches the CPU oracle; the reference's f32/bf16 precisions are not
    ported yet."""
    if precision != "f64":
        raise ValueError(f"engine.precision {precision!r} is not ported "
                         f"to the torch engine; only 'f64' is")
    dev = resolve_device(device)
    holder: dict = {}

    def factory(tables):
        ex = holder.get("ex")
        if ex is None or ex.tables is not tables:
            ex = DeviceExecutor(tables, dev)
            holder["ex"] = ex
        return ex

    # DML invalidation hooks (Session.invalidate): the wholesale one drops
    # the executor; the scoped one keeps it and drops only the mutated
    # tables' device state and the graphs that read it
    factory.invalidate = holder.clear

    def invalidate_tables(names):
        ex = holder.get("ex")
        if ex is not None:
            ex.invalidate_tables(names)

    factory.invalidate_tables = invalidate_tables
    factory.device = dev
    return factory
