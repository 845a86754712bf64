"""Compressed device-resident columnar store of the port.

Port copy of ``nds_tpu/columnar/__init__.py``, imports rewritten to
``nds_tpu_torch``. The warehouse uploads to the card in ENCODED form:
dictionary codes and narrow ints bit-packed into int32 words, sorted
fact columns run-length encoded, null masks packed at 1 bit per row.
Each scan decodes where a query first reads the column (the CUDA C++
kernels behind ``engine/kernels.py``'s ``bitpack_decode``,
``unpack_mask`` and ``rle_decode``), so ``bytes_scanned`` counts encoded
bytes and each query reports a ``compression_ratio``.

Activation (off by default; ``off`` leaves every upload and every
summary as it was):

  columnar.encode           off | auto | dict | bitpack | rle
                            (config key; forced modes apply one
                            encoding family wherever applicable)
  NDS_TPU_COLUMNAR          env equivalent, the reference's name, so
                            that one setting drives both packages
  columnar.dict_union_cap   bound on the executor's memoized
                            string-dictionary unions (default 256;
                            NDS_TPU_DICT_UNION_CAP)

Layout: ``encodings.py`` plans and encodes on the host (numpy only,
byte-identical to the reference's); ``device.py`` decodes on the
executor's device. ``fingerprint_token()`` (encoder version + mode) keys
the per-column spec memo, as in the reference. The table cache
(``io/table_cache.py``) records each cached table's encodings in its
manifest (``manifest_set_encodings``) and seeds them on load
(``manifest_encodings``).
"""

from __future__ import annotations

import os

from nds_tpu_torch.columnar.encodings import (  # noqa: F401
    ENC_VERSION, EncSpec, chunk_spec, column_spec, encode_column,
    encode_values, encoded_nbytes, manifest_encodings,
    manifest_set_encodings, plan_padded, plan_values, raw_nbytes,
    scan_nbytes, seed_column_spec, spec_from_json, spec_to_json,
    table_compression, table_specs,
)

MODES = ("off", "auto", "dict", "bitpack", "rle")

ENV_MODE = "NDS_TPU_COLUMNAR"
ENV_UNION_CAP = "NDS_TPU_DICT_UNION_CAP"

DEFAULT_DICT_UNION_CAP = 256

_mode_override: "str | None" = None
_union_cap_override: "int | None" = None


def set_mode(mode: "str | None") -> None:
    """Programmatic mode gate (None = defer to the env var)."""
    global _mode_override
    if mode is not None and mode not in MODES:
        raise ValueError(
            f"unknown columnar.encode {mode!r} (known: {MODES})")
    _mode_override = mode


def mode() -> str:
    if _mode_override is not None:
        return _mode_override
    env = os.environ.get(ENV_MODE, "").strip().lower()
    if env in ("", "0", "false"):
        return "off"
    if env in ("1", "true", "on"):
        return "auto"
    if env not in MODES:
        return "off"  # telemetry-grade tolerance: a typo never crashes
    return env


def enabled() -> bool:
    return mode() != "off"


def set_dict_union_cap(cap: "int | None") -> None:
    global _union_cap_override
    _union_cap_override = cap


def dict_union_cap() -> int:
    """Bound on the executor's memoized string-dictionary unions
    (device_exec._dict_union) — a config key because a serving
    workload cycling many table pairs silently thrashes a hard cap.
    Floored at 1: the eviction loop holds the just-built entry, so a
    zero/negative cap ("disable the memo") would pop from an empty
    dict mid-query — cap=1 IS the no-reuse behavior."""
    if _union_cap_override is not None:
        return max(1, _union_cap_override)
    try:
        return max(1, int(os.environ.get(ENV_UNION_CAP, "")
                          or DEFAULT_DICT_UNION_CAP))
    except ValueError:
        return DEFAULT_DICT_UNION_CAP


def configure_from(config) -> None:
    """Engine-activation hook: explicit ``columnar.*`` config keys
    override the environment; absent keys RESET the override so one
    process's sessions don't inherit a previous session's choices."""
    set_mode(config.get("columnar.encode") or None)
    cap = config.get("columnar.dict_union_cap")
    set_dict_union_cap(int(cap) if cap is not None else None)


def fingerprint_token() -> str:
    """Encoder version + active mode: the key of each column's spec
    memo (``encodings.column_spec``), and what the reference's plan-cache
    fingerprint folds in. Specs derive deterministically from table
    content, so the token tells any two encoded uploads apart."""
    return f"v{ENC_VERSION}:{mode()}"
