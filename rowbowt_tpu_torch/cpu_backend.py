"""ctypes binding to the native single-thread CPU query engine
(native/cpu_engine.cpp) — the vs_baseline reference for bench.py and a host
fallback when no accelerator is present.

The copy of rowbowt_tpu/cpu_backend.py (numpy and ctypes), imports
renamed, kept line-for-line close.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rowbowt_tpu_torch.construct.sa import _load_native, require_native
from rowbowt_tpu_torch.index import RbtIndex


def available() -> bool:
    lib = _load_native()
    return lib is not None and hasattr(lib, "rbt_cpu_count")


def count_ranges_fb2(big, qcodes: np.ndarray, lengths: np.ndarray):
    """Single-thread C++ count over a BigIndex's two-level fused-block tables
    — equivalent work to the device engine (ops/rank.py rank_fblock2), the
    honest CPU baseline for the n >= 2^31 config."""
    lib = require_native("rbt_cpu_count_fb2")
    f = lib.rbt_cpu_count_fb2
    f.restype = None
    fb2 = np.ascontiguousarray(big.fb2, dtype=np.int32)
    base = np.ascontiguousarray(big.base, dtype=np.int64)
    F = np.ascontiguousarray(big.F, dtype=np.int64)
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    lo = np.empty(nq, dtype=np.int64)
    hi = np.empty(nq, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f(
        fb2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(fb2.shape[0]), ctypes.c_int64(big.per_blk),
        base.ctypes.data_as(i64p), ctypes.c_int64(base.shape[0]),
        F.ctypes.data_as(i64p), ctypes.c_int64(big.A), ctypes.c_int64(big.n),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride),
        lo.ctypes.data_as(i64p), hi.ctypes.data_as(i64p),
    )
    return lo, hi


def _fb2_params(big):
    """(fb2, per_blk, block, lanes, base, F) as contiguous ctypes-ready
    arrays, cached on the BigIndex (the int64 casts of the O(R)/O(M) tables
    are one-time)."""
    cache = getattr(big, "_cpu_cache", None)
    if cache is None:
        cache = big._cpu_cache = {}
    if "fb2" not in cache:
        cache["fb2"] = np.ascontiguousarray(big.fb2, dtype=np.int32)
        cache["base"] = np.ascontiguousarray(big.base, dtype=np.int64)
        cache["F"] = np.ascontiguousarray(big.F, dtype=np.int64)
    lanes = int(big.fb2.shape[1])
    return (cache["fb2"], int(big.per_blk), (lanes - 8) * 8, lanes,
            cache["base"], cache["F"])


def _i64(big, name):
    cache = big._cpu_cache
    if name not in cache:
        cache[name] = np.ascontiguousarray(getattr(big, name),
                                           dtype=np.int64)
    return cache[name]


def count_ranges_fb2g(big, qcodes: np.ndarray, lengths: np.ndarray):
    """Single-thread count over any fb2 row size (the 256-symbol giant
    layout included)."""
    lib = require_native("rbt_cpu_count_fb2g")
    fb2, per_blk, block, lanes, base, F = _fb2_params(big)
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    lo = np.empty(nq, dtype=np.int64)
    hi = np.empty(nq, dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.rbt_cpu_count_fb2g(
        fb2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(per_blk), ctypes.c_int64(block), ctypes.c_int64(lanes),
        base.ctypes.data_as(p), F.ctypes.data_as(p),
        ctypes.c_int64(big.A), ctypes.c_int64(big.n),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride),
        lo.ctypes.data_as(p), hi.ctypes.data_as(p))
    return lo, hi


def locate_fb2(big, qcodes: np.ndarray, lengths: np.ndarray,
               max_hits: int = 4):
    """Single-thread toehold locate (rb_align -s workload) over the BigIndex
    tables: per-step LF_w_loc + a max_hits phi walk per read.  Returns
    (lo, hi, k, locs [nq, max_hits], cnt)."""
    lib = require_native("rbt_cpu_locate_fb2")
    fb2, per_blk, block, lanes, base, F = _fb2_params(big)
    rs = _i64(big, "run_start")
    sl = _i64(big, "samples_last")
    ck = _i64(big, "cruns_keys")
    pp = _i64(big, "pred_pos")
    pa = _i64(big, "phi_at")
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    lo = np.empty(nq, dtype=np.int64)
    hi = np.empty(nq, dtype=np.int64)
    k = np.empty(nq, dtype=np.int64)
    locs = np.empty((nq, max_hits), dtype=np.int64)
    cnt = np.empty(nq, dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.rbt_cpu_locate_fb2(
        fb2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(per_blk), ctypes.c_int64(block), ctypes.c_int64(lanes),
        base.ctypes.data_as(p), F.ctypes.data_as(p),
        ctypes.c_int64(big.A), ctypes.c_int64(big.n),
        rs.ctypes.data_as(p), ctypes.c_int64(big.R), sl.ctypes.data_as(p),
        ck.ctypes.data_as(p), pp.ctypes.data_as(p),
        ctypes.c_int64(pp.shape[0]), pa.ctypes.data_as(p),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride), ctypes.c_int64(max_hits),
        lo.ctypes.data_as(p), hi.ctypes.data_as(p), k.ctypes.data_as(p),
        locs.ctypes.data_as(p), cnt.ctypes.data_as(p))
    return lo, hi, k, locs, cnt


def markers_fb2(big, qcodes: np.ndarray, lengths: np.ndarray, wsize: int,
                max_range: int):
    """Single-thread windowed marker queries (rb_align -m workload).
    Returns (lo, hi, total marker-entry count per read)."""
    lib = require_native("rbt_cpu_markers_fb2")
    fb2, per_blk, block, lanes, base, F = _fb2_params(big)
    mr = _i64(big, "ma_row")
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    lo = np.empty(nq, dtype=np.int64)
    hi = np.empty(nq, dtype=np.int64)
    mcnt = np.empty(nq, dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.rbt_cpu_markers_fb2(
        fb2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(per_blk), ctypes.c_int64(block), ctypes.c_int64(lanes),
        base.ctypes.data_as(p), F.ctypes.data_as(p),
        ctypes.c_int64(big.A), ctypes.c_int64(big.n),
        mr.ctypes.data_as(p), ctypes.c_int64(mr.shape[0]),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride), ctypes.c_int64(wsize),
        ctypes.c_int64(max_range), lo.ctypes.data_as(p),
        hi.ctypes.data_as(p), mcnt.ctypes.data_as(p))
    return lo, hi, mcnt


def greedy_fb2(big, qcodes: np.ndarray, lengths: np.ndarray, wsize: int,
               max_range: int):
    """Single-thread greedy-seeding marker genotyping (the rb_markers
    production workload; caller supplies fwd+rc lanes).  Returns
    (seed count, total probed marker entries) per lane."""
    lib = require_native("rbt_cpu_greedy_fb2")
    fb2, per_blk, block, lanes, base, F = _fb2_params(big)
    mr = _i64(big, "ma_row")
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    ns = np.empty(nq, dtype=np.int64)
    mcnt = np.empty(nq, dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.rbt_cpu_greedy_fb2(
        fb2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(per_blk), ctypes.c_int64(block), ctypes.c_int64(lanes),
        base.ctypes.data_as(p), F.ctypes.data_as(p),
        ctypes.c_int64(big.A), ctypes.c_int64(big.n),
        mr.ctypes.data_as(p), ctypes.c_int64(mr.shape[0]),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride), ctypes.c_int64(wsize),
        ctypes.c_int64(max_range), ns.ctypes.data_as(p),
        mcnt.ctypes.data_as(p))
    return ns, mcnt


def count_ranges(idx: RbtIndex, qcodes: np.ndarray, lengths: np.ndarray):
    """Single-thread C++ count over an [nq, L] right-aligned code batch."""
    lib = require_native("rbt_cpu_count")
    f = lib.rbt_cpu_count
    f.restype = None
    rs = np.ascontiguousarray(idx.run_start, dtype=np.int64)
    occ = np.ascontiguousarray(idx.occ.reshape(-1), dtype=np.int64)
    F = np.ascontiguousarray(idx.F, dtype=np.int64)
    head = np.ascontiguousarray(idx.run_head, dtype=np.uint8)
    q = np.ascontiguousarray(qcodes, dtype=np.int16)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    nq, stride = q.shape
    lo = np.empty(nq, dtype=np.int64)
    hi = np.empty(nq, dtype=np.int64)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    f(
        rs.ctypes.data_as(c_i64p), ctypes.c_int64(idx.R),
        occ.ctypes.data_as(c_i64p), F.ctypes.data_as(c_i64p),
        ctypes.c_int64(idx.A),
        head.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(idx.n),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nq), ctypes.c_int64(stride),
        lo.ctypes.data_as(c_i64p), hi.ctypes.data_as(c_i64p),
    )
    return lo, hi
