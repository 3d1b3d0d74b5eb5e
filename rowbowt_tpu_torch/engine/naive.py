"""Reference-exact query algorithms over RbtIndex, in plain numpy/python.

The copy of the JAX package's executable spec (rowbowt_tpu/engine/naive.py),
line for line with its import renamed: the run-space rank/LF and count, the
toehold and phi walk, the marker probes, greedy, overlap and L-MEM seeding,
the ftab and the checkpointed search.  These never read the fused-block rows
or the dense tables, so they are an independent oracle for the batched
engine.

All functions take character *codes* (index alphabet); code < 0 == char absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rowbowt_tpu_torch.index import RbtIndex

EMPTY = (1, 0)  # reference empty-range encoding (rowbowt.hpp:77)


# ---------------- core rank / LF ----------------

def run_of(idx: RbtIndex, i: int) -> int:
    """Run containing BWT position i (rle_string::run_of_position equivalent)."""
    return int(np.searchsorted(idx.run_start, i, side="right")) - 1


def bwt_at(idx: RbtIndex, i: int) -> int:
    return int(idx.run_head[run_of(idx, i)])


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


def find_range(idx: RbtIndex, codes: np.ndarray, use_ftab: bool = True):
    """RowBowt::find_range (rowbowt.hpp:121-131): backward search, right to left."""
    rn = full_range(idx)
    m = len(codes)
    i = 0
    if use_ftab and idx.ftab is not None and m >= idx.ftab_k:
        rn, i = search_ftab(idx, codes[m - idx.ftab_k:])
    while i < m and rn[1] >= rn[0]:
        rn = lf_range(idx, rn, int(codes[m - i - 1]))
        i += 1
    return rn


def count(idx: RbtIndex, codes: np.ndarray) -> int:
    rn = find_range(idx, codes)
    return rn[1] - rn[0] + 1 if rn[1] >= rn[0] else 0


# ---------------- toehold locate ----------------

def last_run_sample(idx: RbtIndex) -> int:
    """ToeholdSA::get_last_run_sample (toehold_sa.hpp:97-99)."""
    return (int(idx.samples_last[idx.R - 1]) + 1) % idx.n


def _last_c_run_before(idx: RbtIndex, r: int, c: int) -> int:
    """Largest c-run id strictly less than run id r (-1 if none)."""
    lo, hi = int(idx.cruns_off[c]), int(idx.cruns_off[c + 1])
    sub = idx.cruns_flat[lo:hi]
    p = int(np.searchsorted(sub, r, side="left")) - 1
    return int(sub[p]) if p >= 0 else -1


def lf_w_loc(idx: RbtIndex, rn, c: int, k: int):
    """RowBowt::LF_w_loc (rowbowt.hpp:553-573): LF + toehold maintenance."""
    nrange = lf_range(idx, rn, c)
    if nrange[0] > nrange[1]:
        return EMPTY, 0
    r_end = run_of(idx, rn[1])
    if int(idx.run_head[r_end]) == c:  # trivial case
        nk = (k - 1) % idx.n
    else:
        cr = _last_c_run_before(idx, r_end, c)
        assert cr >= 0
        nk = int(idx.samples_last[cr])
    return nrange, nk


def find_range_w_toehold(idx: RbtIndex, codes: np.ndarray):
    """RowBowt::find_range_w_toehold (rowbowt.hpp:167-184). Returns (range, ssamp)."""
    rn = full_range(idx)
    k = last_run_sample(idx)
    m = len(codes)
    for i in range(m):
        rn, k = lf_w_loc(idx, rn, int(codes[m - i - 1]), k)
        if rn[1] < rn[0]:
            return EMPTY, 0
    return rn, k


def phi(idx: RbtIndex, i: int) -> int:
    """ToeholdSA::phi (toehold_sa.hpp:56-72)."""
    rk = int(np.searchsorted(idx.pred_pos, i, side="left"))  # = #values < i
    jr = idx.R - 1 if rk == 0 else rk - 1
    j = int(idx.pred_pos[jr])
    delta = i - j if j < i else i + 1
    prev_sample = int(idx.samples_last[int(idx.pred_to_run[jr]) - 1])
    return (prev_sample + delta) % idx.n


def locate_range(idx: RbtIndex, l: int, r: int, k: int, max_hits: int) -> list[int]:
    """ToeholdSA::locate_range (toehold_sa.hpp:37-49): toehold-first, then phi chain."""
    n_occ = (r - l) + 1 if r >= l else 0
    n_occ = min(n_occ, max_hits)
    locs = []
    if n_occ > 0:
        k1 = k
        locs.append(k1)
        for _ in range(1, n_occ):
            k1 = phi(idx, k1)
            locs.append(k1)
    return locs


def resolve_offset(idx: RbtIndex, i: int) -> tuple[str, int]:
    """DocList::doc_and_offset_at (doclist.hpp:46-50)."""
    j = int(np.searchsorted(idx.doc_starts, i, side="right")) - 1
    return idx.doc_names[j], i - int(idx.doc_starts[j])


# ---------------- markers ----------------

def markers_at_range(idx: RbtIndex, l: int, r: int) -> np.ndarray:
    """MarkerArray::at_range equivalent: packed markers of rows l..r inclusive."""
    if idx.ma_row is None:
        return np.empty(0, dtype=np.int64)
    lo = int(np.searchsorted(idx.ma_row, l, side="left"))
    hi = int(np.searchsorted(idx.ma_row, r + 1, side="left"))
    return idx.ma_val[lo:hi]


@dataclasses.dataclass
class LFData:
    """Mirror of RowBowt::LFData (rowbowt.hpp:133-165)."""

    rn: tuple = EMPTY
    qstart: int = 0
    qend: int = 0
    ssamp: int = 0
    markers: list = dataclasses.field(default_factory=list)


def find_range_w_markers(idx: RbtIndex, codes: np.ndarray, wsize: int, max_range: int) -> LFData:
    """RowBowt::find_range_w_markers (rowbowt.hpp:292-339), incl. the final
    (m-1)%wsize re-query quirk and front-insertion order."""
    lf = LFData()
    m = len(codes)
    if m < wsize:
        return lf
    lf.rn = full_range(idx)
    window_ei = m
    for i in range(m):
        lf.rn = lf_range(idx, lf.rn, int(codes[m - i - 1]))
        if lf.rn[1] < lf.rn[0]:
            return LFData()
        if window_ei - (m - i) >= wsize:
            if lf.rn[1] - lf.rn[0] + 1 <= max_range:
                mbuf = markers_at_range(idx, lf.rn[0], lf.rn[1])
                lf.markers = list(mbuf) + lf.markers
            window_ei = m - i
    if lf.rn[1] >= lf.rn[0] and (m - 1) % wsize != 0:
        if lf.rn[1] - lf.rn[0] + 1 <= max_range:
            mbuf = markers_at_range(idx, lf.rn[0], lf.rn[1])
            lf.markers = list(mbuf) + lf.markers
    lf.qstart, lf.qend = 0, m
    return lf


# ---------------- greedy seeding ----------------

def get_seeds_greedy_w_sample(idx: RbtIndex, codes: np.ndarray, min_length: int) -> list[LFData]:
    """RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256)."""
    out: list[LFData] = []
    m = len(codes)
    rn = full_range(idx)
    prev = full_range(idx)
    first_k = last_run_sample(idx)
    k = first_k
    pk = -1
    ei = m
    for i in range(m):
        rn, k = lf_w_loc(idx, rn, int(codes[m - i - 1]), k)
        if rn[1] < rn[0]:
            if ei - (m - i) >= min_length:
                out.append(LFData(rn=prev, qstart=m - i, qend=ei, ssamp=pk))
            k = first_k
            rn = full_range(idx)
            prev = full_range(idx)
            ei = m - i - 1
        else:
            prev = rn
            pk = k
    if ei >= min_length:
        out.append(LFData(rn=prev, qstart=0, qend=ei, ssamp=pk))
    return out


def locate_from_longest_seed(idx: RbtIndex, max_hits: int, lfs: list[LFData]) -> list[int]:
    """RowBowt::locate_from_longest_seed (rowbowt.hpp:664-690)."""
    if not lfs:
        return []
    best = LFData()
    max_len = 0
    for lfd in lfs:
        if lfd.qend - lfd.qstart > max_len:
            max_len = lfd.qend - lfd.qstart
            best = lfd
    locs = locate_range(idx, best.rn[0], best.rn[1], best.ssamp, max_hits)
    return [l - best.qstart for l in locs]


def get_markers_greedy_seeding(idx, codes, wsize, max_range, fn, use_ftab=True):
    """RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482).

    fn(range, (qstart, qend_inclusive), markers) per seed — exact reference
    callback contract, incl. the ftab kmer-shift restart scan (rowbowt.hpp:454-464).
    """
    m = len(codes)
    k = idx.ftab_k if (use_ftab and idx.ftab is not None) else 0
    prev = full_range(idx)
    rn = full_range(idx)
    i = 0
    if k and m >= k:
        rn, i = search_ftab(idx, codes[m - k:])
        prev = rn
    window_ei, seed_ei = m, m
    mbuf: list = []

    def update_mbuf(r):
        nonlocal mbuf
        if r[1] - r[0] + 1 <= max_range:
            mbuf = mbuf + list(markers_at_range(idx, r[0], r[1]))

    while i < m:
        rn = lf_range(idx, rn, int(codes[m - i - 1]))
        if rn[1] < rn[0]:  # seed fails
            if seed_ei - (m - i) >= wsize:
                update_mbuf(prev)
            fn(prev, (m - i, seed_ei - 1), mbuf)
            mbuf = []
            prev = full_range(idx)
            seed_ei = m - i - 1
            window_ei = m - i - 1
            if k and m - i - 1 >= k:
                while m - i - 1 >= k:
                    seed_ei = m - i - 1
                    window_ei = m - i - 1
                    rn, _ = search_ftab(idx, codes[m - i - 1 - k : m - i - 1])
                    if rn[0] <= rn[1]:
                        i += k  # i will be just before the kmer seed next iter
                        prev = rn
                        break
                    rn = full_range(idx)
                    i += 1
            else:
                rn = full_range(idx)
        else:
            if window_ei - (m - i - 1) >= wsize:
                update_mbuf(rn)
                window_ei = m - i - 1
            prev = rn
        i += 1

    if rn[1] >= rn[0] and seed_ei - (m - i) >= wsize:
        update_mbuf(rn)
    fn(rn, (m - i, seed_ei - 1), mbuf)


def get_markers_lmems(idx, codes, wsize, max_range, fn):
    """RowBowt::get_markers_lmems (rowbowt.hpp:341-404): one L-MEM per start offset k."""
    if idx.ftab is None:
        raise ValueError("ftab must be enabled for lmem queries")
    kft = idx.ftab_k
    mfull = len(codes)
    for koff in range(mfull):
        mbuf: list = []

        def update_mbuf(r):
            nonlocal mbuf
            if r[1] - r[0] + 1 <= max_range:
                mbuf = mbuf + list(markers_at_range(idx, r[0], r[1]))

        m = mfull - koff
        i = 0
        window_ei = m
        prev = full_range(idx)
        rn = full_range(idx)
        if m >= kft:
            rn, j = search_ftab(idx, codes[m - kft : m])
            if rn[1] < rn[0]:
                break  # no possible lmem here (reference breaks the outer loop)
            i += kft
            prev = rn
        broke = False
        while i < m:
            prev = rn
            rn = lf_range(idx, rn, int(codes[m - i - 1]))
            if rn[1] < rn[0]:
                if m - (m - i) >= wsize:
                    update_mbuf(prev)
                fn(prev, (m - i, m - 1), mbuf)
                mbuf = []
                broke = True
                break
            if window_ei - (m - i - 1) >= wsize:
                update_mbuf(rn)
                window_ei = m - i - 1
            i += 1
        if broke:
            continue
        if rn[1] >= rn[0] and m - (m - i) >= wsize:
            update_mbuf(rn)
        fn(rn, (m - i, m - 1), mbuf)


# ---------------- ftab ----------------

def kmer_code(codes: np.ndarray, acgt_codes: np.ndarray) -> int:
    """Big-endian 2-bit encoding of a kmer given the index codes of A,C,G,T."""
    v = 0
    for c in codes:
        b = int(np.searchsorted(acgt_codes, c))
        if b >= 4 or acgt_codes[b] != c:
            return -1
        v = (v << 2) | b
    return v


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


def search_ftab(idx: RbtIndex, codes: np.ndarray):
    """RowBowt::search_ftab (rowbowt.hpp:745-758): returns (range, chars_consumed)."""
    assert len(codes) == idx.ftab_k
    acgt = acgt_code_array(idx)
    v = kmer_code(codes, acgt)
    if v >= 0 and idx.ftab[v, 0] >= 0:
        return (int(idx.ftab[v, 0]), int(idx.ftab[v, 1])), idx.ftab_k
    return full_range(idx), 0


def find_range_w_toehold_chkpnts(idx: RbtIndex, codes: np.ndarray, wsize: int) -> list[LFData]:
    """RowBowt::find_range_w_toehold_chkpnts (rowbowt.hpp:575-611)."""
    lfs: list[LFData] = []
    if idx.samples_last is None:
        return lfs
    m = len(codes)
    window_ei = m
    rn = full_range(idx)
    k = last_run_sample(idx)
    i = 0
    for i in range(m):
        rn, k = lf_w_loc(idx, rn, int(codes[m - i - 1]), k)
        if rn[1] < rn[0]:
            return []
        if window_ei - (m - i) >= wsize:
            lfs.append(LFData(rn=rn, qstart=m - i, qend=window_ei, ssamp=k))
            window_ei = m - i
    if rn[1] >= rn[0] and (m - 1) % wsize != 0:
        lfs.append(LFData(rn=rn, qstart=0, qend=m, ssamp=k))
    return lfs


def get_markers_greedy_overlap_seeding(idx, codes, wsize, max_range, fn,
                                       max_steps: int | None = None):
    """RowBowt::get_markers_greedy_overlap_seeding (rowbowt.hpp:485-551).

    On seed failure the restart kmer OVERLAPS the failed seed (i is rewound by
    ftab k-1).  NB the reference routine can livelock when the rewound scan
    cannot reach a kmer probe (e.g. an absent char among the first k-1 query
    chars) — one reason rb_markers hard-disables it (rb_markers.cpp:121-124).
    We guard with max_steps (default 4*m + 16) and raise instead of looping.
    """
    if idx.ftab is None:
        raise ValueError("ftab required for this function")
    k = idx.ftab_k
    if k - 1 > wsize:
        raise ValueError("wsize cannot be less than ftab k-1")
    m = len(codes)
    prev = full_range(idx)
    rn = full_range(idx)
    i = 0
    if m >= k:
        rn, i = search_ftab(idx, codes[m - k:])
        prev = rn
    window_ei, seed_ei = m, m
    mbuf: list = []
    steps = 0
    budget = max_steps if max_steps is not None else 4 * m + 16

    def update_mbuf(r):
        nonlocal mbuf
        if r[1] - r[0] + 1 <= max_range:
            mbuf = mbuf + list(markers_at_range(idx, r[0], r[1]))

    while i < m:
        steps += 1
        if steps > budget:
            raise RuntimeError(
                "overlap seeding livelocked (reference-inherited pathology)")
        rn = lf_range(idx, rn, int(codes[m - i - 1]))
        if rn[1] < rn[0]:
            if seed_ei - (m - i) >= wsize:
                update_mbuf(prev)
            fn(prev, (m - i, seed_ei - 1), mbuf)
            mbuf = []
            prev = full_range(idx)
            i = i + 1 - k if i + 1 >= k else i  # overlap rewind (rowbowt.hpp:519)
            seed_ei = m - i - 1
            window_ei = m - i - 1
            if m - i - 1 >= k:
                while m - i - 1 >= k:
                    seed_ei = m - i - 1
                    window_ei = m - i - 1
                    rn, _ = search_ftab(idx, codes[m - i - 1 - k: m - i - 1])
                    if rn[0] <= rn[1]:
                        i += k
                        prev = rn
                        break
                    rn = full_range(idx)
                    i += 1
            else:
                rn = full_range(idx)
        else:
            if window_ei - (m - i - 1) >= wsize:
                update_mbuf(rn)
                window_ei = m - i - 1
            prev = rn
        i += 1

    if seed_ei - (m - i) >= wsize:
        update_mbuf(rn)
    fn(rn, (m - i, seed_ei - 1), mbuf)


def get_seeds_greedy(idx: RbtIndex, codes: np.ndarray, min_length: int) -> list[LFData]:
    """RowBowt::get_seeds_greedy (rowbowt.hpp:191-215): like the _w_sample
    variant but without toehold tracking, and the final seed is pushed
    UNconditionally (no min_length gate on the tail, rowbowt.hpp:212)."""
    out: list[LFData] = []
    m = len(codes)
    rn = full_range(idx)
    prev = full_range(idx)
    ei = m
    for i in range(m):
        rn = lf_range(idx, rn, int(codes[m - i - 1]))
        if rn[1] < rn[0]:
            if ei - (m - i) >= min_length:
                out.append(LFData(rn=prev, qstart=m - i, qend=ei))
            rn = full_range(idx)
            prev = full_range(idx)
            ei = m - i - 1
        else:
            prev = rn
    out.append(LFData(rn=prev, qstart=0, qend=ei))
    return out
