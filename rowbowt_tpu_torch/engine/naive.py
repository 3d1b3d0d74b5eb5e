"""Reference-exact run-space search over RbtIndex, in plain numpy/python.

The part of the JAX package's executable spec (rowbowt_tpu/engine/naive.py)
that the count path needs: the dense ftab builder and the run-space rank/LF
helpers it calls.  These never read the fused-block rows, so they are also an
independent oracle for the LF kernel.

All functions take character *codes* (index alphabet); code < 0 == char absent.
"""

from __future__ import annotations

import numpy as np

from rowbowt_tpu_torch.index import RbtIndex

EMPTY = (1, 0)  # reference empty-range encoding (rowbowt.hpp:77)


# ---------------- core rank / LF ----------------

def run_of(idx: RbtIndex, i: int) -> int:
    """Run containing BWT position i (rle_string::run_of_position equivalent)."""
    return int(np.searchsorted(idx.run_start, i, side="right")) - 1


def rank(idx: RbtIndex, i: int, c: int) -> int:
    """Number of code-c chars in BWT[0:i) (rle_string::rank equivalent)."""
    if c < 0 or c >= idx.A:
        return 0
    if i >= idx.n:
        return int(idx.F[c + 1] - idx.F[c])
    r = run_of(idx, i)
    v = int(idx.occ[c, r])
    if int(idx.run_head[r]) == c:
        v += i - int(idx.run_start[r])
    return v


def full_range(idx: RbtIndex):
    return (0, idx.n - 1)


def lf_range(idx: RbtIndex, rn, c: int):
    """RowBowt::LF(range, c) (rowbowt.hpp:74-88)."""
    if c < 0 or c >= idx.A:
        return EMPTY
    c_before = rank(idx, rn[0], c)
    c_inside = rank(idx, rn[1] + 1, c) - c_before
    if c_inside == 0:
        return EMPTY
    lo = int(idx.F[c]) + c_before
    return (lo, lo + c_inside - 1)


# ---------------- ftab ----------------

def acgt_code_array(idx: RbtIndex) -> np.ndarray:
    return idx.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8)).astype(np.int64)


def build_ftab_dense(idx: RbtIndex, k: int) -> np.ndarray:
    """Dense 4^k range table (replaces RowBowt::build_ftab, rowbowt.hpp:726-743).

    Instead of 4^k independent searches, extend all nonempty kmers one char at a
    time (vectorized): total work ~ O(#nonempty kmers), not O(4^k * k).
    """
    acgt = acgt_code_array(idx)
    # level 1
    codes_lvl = []
    ranges_lvl = []
    for b in range(4):
        rn = lf_range(idx, full_range(idx), int(acgt[b]))
        if rn[0] <= rn[1]:
            codes_lvl.append(b)
            ranges_lvl.append(rn)
    kmers = np.array(codes_lvl, dtype=np.int64)
    los = np.array([r[0] for r in ranges_lvl], dtype=np.int64)
    his = np.array([r[1] for r in ranges_lvl], dtype=np.int64)
    for length in range(1, k):
        new_kmers, new_los, new_his = [], [], []
        for b in range(4):
            c = int(acgt[b])
            nl, nh = _lf_range_vec(idx, los, his, c)
            keep = nl <= nh
            # prepending char b adds the high 2 bits (big-endian encoding)
            new_kmers.append((b << (2 * length)) + kmers[keep])
            new_los.append(nl[keep])
            new_his.append(nh[keep])
        kmers = np.concatenate(new_kmers)
        los = np.concatenate(new_los)
        his = np.concatenate(new_his)
    ftab = np.full((4 ** k, 2), -1, dtype=np.int64)
    ftab[kmers, 0] = los
    ftab[kmers, 1] = his
    return ftab


def _lf_range_vec(idx: RbtIndex, los, his, c):
    """Vectorized LF over arrays of ranges for a fixed char code."""
    rs = idx.run_start
    rl = np.searchsorted(rs, los, side="right") - 1
    rh = np.searchsorted(rs, his + 1, side="right") - 1
    occ_c = idx.occ[c]
    head = idx.run_head

    def rk(i, r):
        v = occ_c[r] + np.where(head[r] == c, i - rs[r], 0)
        return np.where(i >= idx.n, idx.F[c + 1] - idx.F[c], v)

    before = rk(los, rl)
    inside = rk(his + 1, rh) - before
    nl = idx.F[c] + before
    nh = nl + inside - 1
    empty = inside <= 0
    return np.where(empty, 1, nl), np.where(empty, 0, nh)
