"""Chunked (per-document) BWT construction by insertion merge.

Whole-text SA-IS needs the full suffix array in RAM — the reason the
reference outsources pangenome-scale construction to pfbwt-f's prefix-free
parsing (rowbowt:README.md:37-44, .gitmodules:7-9).  A haplotype
panel is naturally a COLLECTION of separator-terminated documents, so this
module builds the index document by document instead:

  1. per-document suffix array (SA-IS on one document: int32, small),
  2. a backward walk of the document through the existing collection BWT
     (native rbt_ebwt_walk: one O(1) rank per character) yields every
     suffix's insertion rank,
  3. one vectorized numpy interleave merges BWT codes (and SA values).

Suffix order convention — the "generalized" order: suffixes stop at their
document's end (shorter-is-smaller), ties between equal strings break by
document id.  For any query over the in-document alphabet (ACGT — separators
never appear in reads) backward search, counts, locate SETS, toehold kval
and phi are EXACTLY the same as under whole-text order: every pattern
character's text predecessor is in-document, so LF is exact (see
tests/test_merge.py for the brute-force oracle parity).  Only the relative
order of separator-prefixed rows differs.

Peak memory: one document's SA + the growing (codes, sa) arrays — ~9 bytes
per symbol with SA, ~1 byte/symbol for the count-only path (with_sa=False),
vs whole-text SA-IS's ~17 bytes/symbol.

The copy of rowbowt_tpu/construct/merge.py (numpy and ctypes), imports
renamed, kept line-for-line close.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.construct.sa import require_native, suffix_array


def _walk_native(lib, bwt, A, Fcum, E, ph_rows, ph_chars, doc):
    m = doc.shape[0]
    p = np.empty(m, dtype=np.int64)
    if not hasattr(lib, "_rbt_walk_ready"):
        lib.rbt_ebwt_walk.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rbt_ebwt_walk.restype = ctypes.c_int
        lib._rbt_walk_ready = True
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rbt_ebwt_walk(
        bwt.ctypes.data_as(u8), bwt.shape[0], A,
        Fcum.ctypes.data_as(i64p), E.ctypes.data_as(i64p),
        ph_rows.ctypes.data_as(i64p), ph_chars.ctypes.data_as(u8),
        ph_rows.shape[0], doc.ctypes.data_as(u8), m,
        p.ctypes.data_as(i64p))
    if rc != 0:
        raise RuntimeError("rbt_ebwt_walk failed")
    return p


def _walk_python(bwt, A, Fcum, E, ph_rows, ph_chars, doc):
    """Reference walk (same recurrence, O(N) rank), for the tests: the port's
    merge_construct always takes the native walk."""
    occ = np.zeros((A, bwt.shape[0] + 1), dtype=np.int64)
    for c in range(A):
        np.cumsum(bwt == c, out=occ[c, 1:])
    m = doc.shape[0]
    p_out = np.empty(m, dtype=np.int64)
    c = int(doc[m - 1])
    p = int(Fcum[c]) + int(E[c])
    p_out[m - 1] = p
    by_char = {cc: np.sort(ph_rows[ph_chars == cc]) for cc in range(A)}
    for j in range(m - 2, -1, -1):
        c = int(doc[j])
        real = int(occ[c, p]) - int(np.searchsorted(by_char[c], p, side="left"))
        p = int(Fcum[c]) + int(E[c]) + real
        p_out[j] = p
    return p_out


def _interleave(lib, old, ins, neu):
    """out[ins[r]] = neu[r] (final positions, strictly increasing); old keeps
    order in the gaps.  Native memcpy path when available."""
    N, m = old.shape[0], neu.shape[0]
    out = np.empty(N + m, dtype=old.dtype)
    if lib is not None and old.dtype in (np.uint8, np.int64, np.uint32):
        if not hasattr(lib, "_rbt_il_ready"):
            for fn, ct in ((lib.rbt_interleave_u8, ctypes.c_uint8),
                           (lib.rbt_interleave_i64, ctypes.c_int64),
                           (lib.rbt_interleave_u32, ctypes.c_uint32)):
                fn.argtypes = [ctypes.POINTER(ct), ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ct), ctypes.c_int64,
                               ctypes.POINTER(ct)]
                fn.restype = None
            lib._rbt_il_ready = True
        fn, ct = {np.dtype(np.uint8): (lib.rbt_interleave_u8, ctypes.c_uint8),
                  np.dtype(np.int64): (lib.rbt_interleave_i64, ctypes.c_int64),
                  np.dtype(np.uint32): (lib.rbt_interleave_u32, ctypes.c_uint32),
                  }[old.dtype]
        p = ctypes.POINTER(ct)
        i64p = ctypes.POINTER(ctypes.c_int64)
        fn(old.ctypes.data_as(p), N, ins.ctypes.data_as(i64p),
           np.ascontiguousarray(neu).ctypes.data_as(p), m,
           out.ctypes.data_as(p))
        return out
    keep = np.ones(N + m, dtype=bool)
    keep[ins] = False
    out[ins] = neu
    out[keep] = old
    return out


def _sa_of_doc(part_bytes: bytes) -> np.ndarray:
    """Worker-process entry: per-document suffix array, int32 (docs < 2^31)."""
    arr = np.frombuffer(part_bytes, dtype=np.uint8)
    return suffix_array(arr).astype(np.int32)


def merge_construct(parts: list[np.ndarray], alpha: Alphabet | None = None,
                    with_sa: bool = True, verbose: bool = False,
                    prefetch: bool = True, sa_dtype=np.int64):
    """eBWT of the document collection `parts` (uint8 byte arrays; each
    document INCLUDES its separator tail, the last one its terminator).

    Returns (bwt_codes uint8[n], sa sa_dtype[n] | None, alpha): the BWT code
    sequence and (optionally) the full suffix array in BWT-row order, both
    under the generalized order above with GLOBAL text predecessors / SA
    values, ready for construct.build.build_index(text, sa=sa).

    sa_dtype=np.uint32 halves SA memory and interleave traffic for total
    n < 2^32 (every pangenome config here; the >= 2^32 regime keeps int64).
    """
    if sa_dtype == np.uint32:
        assert sum(int(p.shape[0]) for p in parts) < (1 << 32)
    if alpha is None:
        alpha = Alphabet(np.unique(np.concatenate(
            [np.unique(p) for p in parts])).astype(np.uint8))
    A = alpha.size
    assert A <= 16, "merge_construct packs codes as nibbles"
    tab = alpha.encode_table()
    lib = require_native("rbt_ebwt_walk")

    k = len(parts)
    doc_lens = np.array([p.shape[0] for p in parts], dtype=np.int64)
    doc_starts = np.concatenate(([0], np.cumsum(doc_lens)[:-1]))
    # global predecessor char of each document's first position
    prev_last = np.empty(k, dtype=np.uint8)
    for d in range(k):
        prev_last[d] = parts[d - 1][-1]  # d=0 wraps to the last document

    bwt = np.empty(0, dtype=np.uint8)
    sa = np.empty(0, dtype=sa_dtype) if with_sa else None
    counts = np.zeros(A, dtype=np.int64)
    E = np.zeros(A, dtype=np.int64)
    ph_rows = np.empty(0, dtype=np.int64)
    ph_chars = np.empty(0, dtype=np.uint8)

    # pipeline: the NEXT document's SA-IS runs in a worker process while this
    # one walks + merges (the two are independent; ~halves chr-scale wall)
    pool = pending = None
    if prefetch and k > 1:
        try:
            import multiprocessing as mp

            pool = mp.get_context("fork").Pool(1)
            pending = pool.apply_async(_sa_of_doc, (parts[0].tobytes(),))
        except Exception:
            pool = pending = None

    for d, part in enumerate(parts):
        dcodes = tab[part.astype(np.int64)]
        assert (dcodes >= 0).all(), "document byte outside the index alphabet"
        dcodes = dcodes.astype(np.uint8)
        m = int(dcodes.shape[0])
        if pending is not None:
            own_sa = pending.get().astype(np.int64)
            pending = pool.apply_async(
                _sa_of_doc, (parts[d + 1].tobytes(),)) if d + 1 < k else None
        else:
            own_sa = suffix_array(np.ascontiguousarray(part, dtype=np.uint8))
        own_bwt = np.where(own_sa > 0,
                           dcodes[np.maximum(own_sa - 1, 0)],
                           tab[int(prev_last[d])]).astype(np.uint8)
        r0 = int(np.nonzero(own_sa == 0)[0][0])  # row of the doc-initial suffix
        Fcum = np.zeros(A + 1, dtype=np.int64)
        np.cumsum(counts, out=Fcum[1:])
        if d == 0:
            bwt = own_bwt
            if with_sa:
                sa = (own_sa + doc_starts[d]).astype(sa_dtype)
            new_ph = r0
        else:
            p_by_pos = _walk_native(lib, bwt, A, Fcum, E,
                                    ph_rows, ph_chars, dcodes)
            p_sorted = p_by_pos[own_sa]
            # insertion ranks must be sorted in own-suffix order
            assert (np.diff(p_sorted) >= 0).all(), "walk produced unsorted ranks"
            ins = p_sorted + np.arange(m, dtype=np.int64)
            bwt = _interleave(lib, bwt, ins, own_bwt)
            if with_sa:
                sa = _interleave(lib, sa, ins,
                                 (own_sa + doc_starts[d]).astype(sa_dtype))
            ph_rows = ph_rows + np.searchsorted(p_sorted, ph_rows, side="right")
            new_ph = int(ins[r0])
        ph_rows = np.append(ph_rows, new_ph)
        ph_chars = np.append(ph_chars, tab[int(prev_last[d])].astype(np.uint8))
        srt = np.argsort(ph_rows, kind="stable")
        ph_rows, ph_chars = ph_rows[srt], ph_chars[srt]
        counts += np.bincount(dcodes, minlength=A)
        E[int(dcodes[-1])] += 1
        if verbose:
            import sys
            print(f"merge: doc {d + 1}/{k} inserted (n={bwt.shape[0]:,})",
                  file=sys.stderr)
    if pool is not None:
        pool.close()
        pool.join()
    return bwt, sa, alpha


def split_text_docs(text: np.ndarray, doc_starts: np.ndarray) -> list[np.ndarray]:
    """Slice the canonical panel text (docs + separator tails + final TERM)
    into merge_construct documents: each doc carries its separator tail; the
    final TERM byte rides with the last document."""
    bounds = list(doc_starts) + [text.shape[0]]
    return [text[bounds[i]: bounds[i + 1]] for i in range(len(doc_starts))]
