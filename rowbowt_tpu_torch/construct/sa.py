"""Suffix array construction.

Host-side, like the reference's (pfbwt-f runs as a separate process before
rb_build, rowbowt:scripts/vcf_to_rowbowt.sh).  Two backends:

- native: SA-IS implemented in C++ (native/sais.cpp), compiled with g++ on
  first use into the port's build directory and loaded via ctypes — O(n).
- numpy fallback: prefix-doubling with lexsort, O(n log^2 n) — only for texts
  of at most NUMPY_MAX_N symbols (tests), and only when the native library
  cannot be built; a larger text without the native library is an error.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rowbowt_tpu_torch import _native

NUMPY_MAX_N = 1 << 20

_NATIVE = None
_NATIVE_TRIED = False
_NATIVE_ERROR: str | None = None


def _load_native():
    """The host library (SA-IS, the merge walk, PFP, the CPU engine, and the
    FASTQ reader where zlib links), built on first use; None when no compiler
    could build it."""
    global _NATIVE, _NATIVE_TRIED, _NATIVE_ERROR
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    try:
        path, _ = _native.build_host_library()
    except _native.BuildError as e:
        _NATIVE_ERROR = str(e)
        return None
    lib = ctypes.CDLL(path)
    lib.rbt_sais_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.rbt_sais_u8.restype = ctypes.c_int
    _NATIVE = lib
    return _NATIVE


def require_native(entry: str):
    """The host library, or RuntimeError when it could not be built or lacks
    `entry`: a caller that needs a native entry point never runs a slower
    path in its place."""
    lib = _load_native()
    if lib is None or not hasattr(lib, entry):
        raise RuntimeError(f"host library lacks {entry}: "
                           f"{_NATIVE_ERROR or 'built without its source'}")
    return lib


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array over uint8 text (no implicit sentinel:
    suffixes compare as plain byte strings; the caller's final TERM byte is the
    unique smallest byte so ordering matches the standard convention)."""
    n = int(text.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = text.astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        new_rank = np.empty(n, dtype=np.int64)
        key_prev = (rank[order[:-1]], rank2[order[:-1]])
        key_next = (rank[order[1:]], rank2[order[1:]])
        neq = (key_prev[0] != key_next[0]) | (key_prev[1] != key_next[1])
        new_rank[order] = np.concatenate(([0], np.cumsum(neq)))
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of uint8 text: native SA-IS, or numpy for tiny texts."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = int(text.shape[0])
    lib = _load_native()
    if lib is not None and n > 0:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.rbt_sais_u8(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
        )
        if rc != 0:
            raise RuntimeError(f"native SA-IS failed (rc={rc}, n={n})")
        return sa
    if n > NUMPY_MAX_N:
        raise RuntimeError(
            f"native SA-IS unavailable for a text of n={n} symbols: {_NATIVE_ERROR}")
    return suffix_array_numpy(text)
