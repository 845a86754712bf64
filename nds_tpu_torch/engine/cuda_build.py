"""Build and load the port's CUDA C++ kernels (``nds_tpu_torch/csrc``).

Each source file compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, in ``.build/nds_tpu_torch/`` at the
root of the checkout, and loads through ``ctypes``. The libraries are
built at first use, all sources at once (one ``nvcc`` process per
source, started together), and are named by a digest of their source
and flags, so an edited source rebuilds and an unchanged one loads.

Nothing here runs at import. ``library(name)`` raises ``CudaBuildError``
where there is no CUDA device or no ``nvcc``: it never hands back the
plain PyTorch versions in place of a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / ".build" / "nds_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# C entry points per source: name -> argtypes (every one returns the
# cudaError_t of its launches as an int)
SIGNATURES = {
    "dense_domain": {
        "nds_direct_lookup_join": [_P, _P, _LL, _P, _P, _LL, _I, _LL, _LL,
                                   _P, _P, _P, _P],
        "nds_bitmask_semi": [_P, _P, _LL, _P, _P, _LL, _I, _LL, _LL, _P,
                             _P, _P],
        "nds_keyed_minmax_semi": [_P, _P, _P, _LL, _P, _P, _P, _LL, _I, _I,
                                  _LL, _LL, _P, _P, _P],
    },
    "small_build_probe": {
        "nds_small_build_max": [],
        "nds_small_build_slot_bits": [_I],
        "nds_matmul_probe_join": [_P, _P, _I, _P, _P, _LL, _I, _P, _P, _P],
    },
    "seg_scan": {
        "nds_seg_scan_tile": [],
        "nds_seg_scan_state_words": [],
        "nds_seg_reduce_at_ends": [_P, _I, _I, _P, _LL, _P, _I, _LL, _P, _P,
                                   _P, _P, _P],
        "nds_seg_scan": [_P, _I, _I, _P, _LL, _LL, _P, _P, _P, _P],
        "nds_part_reduce_broadcast": [_P, _I, _I, _P, _LL, _P, _I, _P, _P,
                                      _P, _P, _P],
        "nds_last_of_group": [_P, _LL, _P, _P, _P, _P],
        "nds_group_bounds_tile": [],
        "nds_group_bounds": [_P, _I, _I, _LL, _LL, _P, _P, _P, _P, _P, _P,
                             _P],
    },
    "partitioned_join": {
        "nds_pj_partition_tile": [],
        "nds_pj_sort_tile": [_I],
        "nds_pj_max_parts": [],
        "nds_pj_partition": [_P, _P, _LL, _I, _I, _I, _LL, _P, _P, _P, _P,
                             _P, _P, _P],
        "nds_pj_sort": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _P, _P, _I, _P,
                        _P, _P, _P, _P],
        "nds_pj_ranges": [_P, _I, _LL, _P, _LL, _I, _P, _P, _P, _P, _P],
        "nds_pj_expand": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P, _P, _P, _P,
                          _P, _P, _P],
    },
    "group_key": {
        "nds_pack_max_fields": [],
        "nds_pack_group_key": [_P, _LL, _I, _P, _P, _P, _P, _P, _I, _I, _P,
                               _P, _P],
    },
    "sort_key": {
        "nds_sort_max_fields": [],
        "nds_pack_sort_key": [_P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _P, _P, _P],
    },
    "sorted_search": {
        "nds_search_index_keys": [_I],
        "nds_sorted_search": [_P, _I, _LL, _P, _LL, _I, _P, _P, _P, _P, _P,
                              _P, _P],
    },
    "compact": {
        "nds_compact_tile": [],
        "nds_compact_perm": [_P, _LL, _P, _P, _P, _P, _P, _P],
    },
    "columnar_decode": {
        "nds_bitpack_decode": [_P, _LL, _I, _LL, _I, _I, _P, _P],
        "nds_unpack_mask": [_P, _LL, _P, _P],
        "nds_rle_decode": [_P, _P, _I, _LL, _I, _P, _P],
    },
    "exchange": {
        "nds_exchange_tile": [],
        "nds_exchange_max_dest": [],
        "nds_exchange_pack": [_P, _P, _I, _P, _LL, _LL, _LL, _I, _LL, _I,
                              _P, _P, _P, _P, _P, _P, _P, _P],
    },
}


class CudaBuildError(RuntimeError):
    """The kernels cannot be built or loaded here (no CUDA device, no
    nvcc, or nvcc refused a source)."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error."""


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> "str | None":
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = pathlib.Path(cand) / "bin" / "nvcc"
            if p.exists():
                return str(p)
    return shutil.which("nvcc")


def _lib_path(name: str) -> pathlib.Path:
    # the digest covers the shared headers, which every source may include
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source that has no current library, all nvcc
    processes at once; returns {source: seconds} for what was built."""
    if not torch.cuda.is_available():
        raise CudaBuildError("no CUDA device: the kernels run only on the "
                             "card, and the CPU takes the plain versions")
    nvcc = find_nvcc()
    if nvcc is None:
        raise CudaBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                             "PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    built = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
        built[name] = time.perf_counter() - t0
    if errors:
        raise CudaBuildError("nvcc failed:\n" + "\n".join(errors))
    BUILD_SECONDS.update(built)
    return built


def is_loaded(name: str) -> bool:
    """True once ``library(name)`` has loaded the source's library."""
    return name in _LIBS


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (``dense_domain``,
    ``small_build_probe``, ``seg_scan``, ``partitioned_join``,
    ``group_key``, ``sort_key``, ``sorted_search``, ``compact``,
    ``columnar_decode``, ``exchange``), built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        if name not in SIGNATURES:
            raise KeyError(f"no kernel source {name!r}")
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the C entry points take it."""
    return torch.cuda.current_stream().cuda_stream
