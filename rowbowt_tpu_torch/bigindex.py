"""BigIndex: the n >= 2^31 count-path index artifact.

The copy of rowbowt_tpu/bigindex.py (numpy only), imports renamed, kept
line-for-line close.  The device view is engine/device.py
TorchIndex.from_big and the position-sharded view of the mesh engines is
sharded_index (parallel/sharded_dense.py).  The nibble-count marker rows
(marker_nibble_rank, BigIndex._ma_cnt64) are here with the JAX package's
cache, but no device route takes them: the JAX package's RBT_MA_NIB opt-in
was not ported, since on an H100 they probed no faster than the bucketed
bound, at several times its device memory (PERF.md §6).

The reference contract is u64 row indices throughout (toehold_sa.hpp:133-155);
device gathers want int32 row ids.  The two-level layout splits the
difference:

  fb2   int32[nb_pad, 24] — fused-block rows (8 checkpoint lanes + 16 packed
        4-bit BWT words per 128 symbols, construct.build.build_fblock) whose
        checkpoints are SUPERBLOCK-local, so int32 never overflows;
  base  int64[n_sup, 8]   — global per-char count before each superblock.

rank(i, c) = base[superblock(i), c] + local checkpoint + in-block popcount
(ops.rank.rank_fblock2).  Only the LANES (lo/hi/i) are int64; every gather
index stays int32 up to n = 2^38.

Version 2 adds the O(R)/O(M) auxiliary tables the reference serves at any n
with u64 indices (toehold_sa.hpp:27-49,105-131, rowbowt.hpp:406-482):

  run_start u32[R], samples_last u32[R]   run-boundary SA samples — the
        .ssa/.esa role (toehold_sa.hpp:133-155) as dense sorted arrays;
  pred_pos u32[~R], phi_at u32[~R]        the phi predecessor table
        (ToeholdSA::build_phi role) as exact SA-adjacency breakpoints, for
        the run-space phi walk (ops.rank.phi_step "phi_at" branch);
  cruns_keys i32[R]                       run ids sorted by (head, id) packed
        as head*R+id — "last c-run at or before r" is ONE searchsorted (the
        toehold-postpass ltk resolve, engine/locate.py);
  ma_row u32[M], ma_val i64[M]            the marker CSR (pfbwt-f MarkerArray
        role) probed by two searchsorteds (ops.rank.markers_bounds).

All row/position values pack into u32 below n = 2^32; lanes stay int64 end
to end (the reference's u64 contract).

The disk caches next to an artifact (fb2_64.npy, phi_rows.npy with
phi_delta.npy, ma_runpack.npz, ma_cnt64.npy) keep the JAX package's names
and formats, so either package reads the other's; here each is checked
against the artifact's shapes before use and rebuilt when it does not fit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np

from rowbowt_tpu_torch.alphabet import Alphabet

_SUP_SYMS_MAX = 1 << 30  # superblock symbol span: int32 checkpoints with 2x margin


def big_locate_tables(codes: np.ndarray, sa: np.ndarray,
                      isa: np.ndarray | None = None,
                      chunk: int = 1 << 26, A: int = 8) -> dict[str, np.ndarray]:
    """Run boundaries + O(R) run-space toehold/phi tables from the merged BWT
    code sequence and the full SA (any dtype; values < n).

    The phi table is built from EXACT SA-adjacency breakpoints — positions i
    where phi(i) = SA[isa(i) - 1] stops advancing by +1 — rather than from
    run-start samples: exact for ANY permutation (the chunked merge's
    generalized document order breaks phi linearity at document-initial
    rows), same O(R) size (#breakpoints ~ R + #docs).  phi(i) =
    phi_at[pred(i)] + (i - pred_pos[pred(i)]) — ops.rank.phi_step's "phi_at"
    branch.

    The chunked scans keep temporaries O(chunk) except the inverse SA
    (4 B/position below 2^32; pass `isa` to share it with the marker build).

    Conventions otherwise match construct.build.build_index: samples_last is
    (SA[run_end] + n - 1) % n — the text position of the row's BWT char, the
    value the reference stores (y-1 with 0 -> n-1, toehold_sa.hpp:133-155).
    """
    n = int(codes.shape[0])
    parts = [np.zeros(1, dtype=np.int64)]
    for lo in range(1, n, chunk):
        hi = min(lo + chunk, n)
        d = np.flatnonzero(codes[lo:hi] != codes[lo - 1:hi - 1])
        parts.append(d + lo)
    run_start = np.concatenate(parts)
    R = int(run_start.shape[0])
    run_head = codes[run_start].astype(np.uint8)
    run_end = np.empty(R, dtype=np.int64)
    run_end[:-1] = run_start[1:] - 1
    run_end[-1] = n - 1

    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    sl = (sa[run_end].astype(np.int64) + n - 1) % n
    keys = run_head.astype(np.int64) * R + np.arange(R, dtype=np.int64)
    order = np.argsort(run_head, kind="stable")
    ck = keys[order]
    # dtype must cover the QUERY ceiling (c*R + r goes up to A*R - 1 in
    # traj_resolve_toehold), not just ck[-1]: a c with no runs still probes
    key_dt = np.int32 if A * R < (1 << 31) else np.int64

    if isa is None:
        isa = np.empty(n, dtype=pos_dt)
        isa[np.asarray(sa)] = np.arange(n, dtype=pos_dt)
    bp_parts, val_parts = [], []
    prev_tail = None  # phi value at the last position of the previous chunk
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        j = isa[lo:hi].astype(np.int64)
        ph = np.asarray(sa)[(j - 1) % n].astype(np.int64)  # phi(i), i in [lo,hi)
        d = np.flatnonzero(np.diff(ph) != 1) + 1
        first_breaks = (lo == 0) or (ph[0] != prev_tail + 1)
        if first_breaks:
            d = np.concatenate(([0], d))
        bp_parts.append(d + lo)
        val_parts.append(ph[d])
        prev_tail = int(ph[-1])
    pred_pos = np.concatenate(bp_parts)
    phi_at = np.concatenate(val_parts)
    return {
        "run_start": run_start.astype(pos_dt),
        "run_head": run_head,
        "samples_last": sl.astype(pos_dt),
        "pred_pos": pred_pos.astype(pos_dt),
        "phi_at": phi_at.astype(pos_dt),
        "cruns_keys": ck.astype(key_dt),
    }


def big_marker_tables(sa: np.ndarray, marker_tpos: np.ndarray,
                      marker_packed: np.ndarray, wsize: int, n: int,
                      isa: np.ndarray | None = None):
    """Marker CSR (ma_row sorted, ma_val) from the full SA: BWT row i carries
    marker m iff SA[i] in [t-w+1, t] (the variant lies within the first w
    characters of the suffix — same rule as construct.build.build_index).
    Builds the full inverse SA once (4 B/position below 2^32)."""
    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    lo_p = np.maximum(marker_tpos.astype(np.int64) - wsize + 1, 0)
    span = marker_tpos - lo_p + 1
    off = np.repeat(np.cumsum(span) - span, span)
    flat = np.arange(off.shape[0], dtype=np.int64) - off
    ps = np.repeat(lo_p, span) + flat
    vals = np.repeat(marker_packed, span)
    if isa is None:
        isa = np.empty(n, dtype=pos_dt)
        isa[np.asarray(sa)] = np.arange(n, dtype=pos_dt)
    rows = isa[ps].astype(np.int64)
    srt = np.lexsort((vals, rows))
    return rows[srt].astype(pos_dt), vals[srt]


def marker_nibble_rank(ma_row: np.ndarray, n: int) -> np.ndarray | None:
    """ONE-gather ma_start1: int32[n/64 + 1, 16] fused 64-byte rows of
    [entries-before-block ckpt | 8 packed u32 words of per-row 4-bit entry
    counts | 7 pad] per 64 BWT rows — the same 64B/16-lane row shape as the
    fb2_64 rank table (1 B/row, so 2.2 GB at n = 2.2 G), 16 lanes a row
    as in the JAX package, so the two share the ma_cnt64.npy cache.

    ms_at(i) = ckpt + SWAR nibble-SUM of counts below i's offset
    (ops.rank._ms_nibble): one row gather a probe, where the bucketed search
    takes one bucket gather and `iters` binary-search gathers.

    Returns None when any row holds > 15 entries (callers fall back to the
    bucketed bound) — at wsize=10 that needs 16+ variants within one window,
    absent from any real panel."""
    M = int(ma_row.shape[0])
    if M >= (1 << 31):
        return None  # int32 checkpoint lanes
    nb = (n + 63) >> 6
    rows64 = np.zeros((nb + 1, 16), dtype=np.int32)
    if M:
        ur, cnt = np.unique(np.asarray(ma_row), return_counts=True)
        if int(cnt.max()) > 15:
            return None
        words = np.zeros(nb * 8, dtype=np.uint32)
        np.add.at(words, (ur >> 3).astype(np.int64),
                  cnt.astype(np.uint32) << ((ur.astype(np.uint32) & 7) * 4))
        rows64[:nb, 1:9] = words.reshape(nb, 8).view(np.int32)
        del words
        # exclusive cumulative entries before each 64-row block
        bounds = np.minimum(np.arange(nb + 1, dtype=np.int64) << 6, n)
        ck = np.searchsorted(np.asarray(ma_row),
                             bounds.astype(ma_row.dtype), side="left")
        assert int(ck[-1]) == M
        rows64[:, 0] = ck.astype(np.int32)
    return rows64


_PHI_POS = 480  # positions per 64B phi row: [ckpt i32 | 15 u32 bit words]


def phi_pack_tables(pred_pos: np.ndarray, phi_at: np.ndarray, n: int):
    """ONE-gather phi predecessor rank: (rows int32[nb, 16], delta).

    The SA-adjacency breakpoint table (big_locate_tables) makes phi piecewise
    i + const; a hop therefore needs only (a) the rank of i among the sorted
    breakpoint positions and (b) that breakpoint's constant.  The positions
    pack into a bitmap with fused checkpoints — 64-byte/16-lane rows of
    [#breakpoints-before-row | 15 u32 words of per-position bits] per 480
    text positions (0.13 B/position) — so rank(i) is one row gather + a
    popcount, and phi(i) = (i + delta[rank-1]) mod n is one more element
    gather (ops.rank.phi_step's "phi_rows" branch).

    delta[r] = (phi_at[r] - pred_pos[r]) mod n, stored u32 below n = 2^32
    and int64 beyond.  Requires #breakpoints < 2^31 (int32 checkpoint lanes).
    """
    Rp = int(pred_pos.shape[0])
    assert Rp < (1 << 31), "int32 phi checkpoint lanes"
    nb = n // _PHI_POS + 1
    rows = np.zeros((nb + 1, 16), dtype=np.int32)
    p = np.asarray(pred_pos).astype(np.int64)
    words = np.zeros(nb * 15, dtype=np.uint32)
    np.bitwise_or.at(words, p // _PHI_POS * 15 + (p % _PHI_POS) // 32,
                     np.uint32(1) << (p % 32).astype(np.uint32))
    rows[:nb, 1:] = words.reshape(nb, 15).view(np.int32)
    del words
    # breakpoints strictly before each row's first position
    bounds = np.arange(nb + 1, dtype=np.int64) * _PHI_POS
    rows[:, 0] = np.searchsorted(p, bounds, side="left").astype(np.int32)
    dd = np.uint32 if n < (1 << 32) else np.int64
    delta = ((np.asarray(phi_at).astype(np.int64) - p) % n).astype(dd)
    return rows, delta


def marker_buckets(ma_row: np.ndarray, n: int, target_seg: int = 32):
    """Bucket table for the marker-CSR lower bound: off[b] = first entry in
    row bucket b (span 2^shift rows).  Cuts markers_bounds' dependent chain
    from log2(M) to 1 bucket gather + ceil(log2(max segment)) binary-search
    gathers.  Returns (off u32/i64[nbuck+1], (shift, iters))."""
    M = int(ma_row.shape[0])
    if M == 0:
        return np.zeros(2, dtype=np.uint32), (62, 1)
    # bucket span targeting ~target_seg entries per bucket
    shift = int(np.clip(round(np.log2(max(n, 2) / M * target_seg)), 6, 30))
    nbuck = (n >> shift) + 1
    bounds = (np.arange(nbuck + 1, dtype=np.int64) << shift)
    off = np.searchsorted(ma_row, np.minimum(bounds, np.iinfo(ma_row.dtype).max
                                             ).astype(ma_row.dtype),
                          side="left")
    max_seg = int(np.diff(off).max())
    iters = max(1, int(np.ceil(np.log2(max_seg + 1))))
    dt = np.uint32 if M < (1 << 32) else np.int64
    return off.astype(dt), (shift, iters)


_MRP_SHIFT = 16  # run-pack max bucket span: in-bucket start deltas fit u16


def marker_run_pack(ma_row: np.ndarray, n: int):
    """Run-table marker rank: ma_start1[i] in THREE dependent gather levels.

    Marker rows are runs of consecutive BWT rows (the suffixes starting
    inside one variant window agree across near-identical haplotypes, so
    they occupy contiguous row ranges), so rank over the CSR needs only the
    run containing (or preceding) i:

      rank(i) = cum[j] + mult[j] * clip(i - start[j], 0, len[j]),
      j = last run with start <= i

    Tables:

      off   u32[(n>>shift)+2]  bucket directory over row space
      sd16  i32[ceil(K/32),16] run-start low 16 bits, 32 u16 per 64B row
      rec   i64[K, 2]          [start | cum + (len<<32) + (mult<<56)]

    j resolves as off[b] + (count of in-bucket starts <= i) - 1: one off
    gather, a STATIC `nrows` parallel 64B sd16 row gathers + SWAR
    compare-count, one 16B rec gather (ops.rank._ms_runs).  The bucket shift
    adapts to the run density — the largest shift <= 16 whose worst bucket
    segment fits 4 sd16 rows.  Low-16-bit comparison stays exact for any
    shift <= 16: in-bucket starts share all bits >= shift.  Returns
    (off, sd16, rec, (shift, nrows)) or None when the structure doesn't
    fit (mult > 127, len >= 2^24, M >= 2^32, or off table > 2^27 entries).
    """
    M = int(ma_row.shape[0])
    if M == 0 or M >= (1 << 32):
        return None
    mr = np.asarray(ma_row).astype(np.int64)
    first = np.r_[True, mr[1:] != mr[:-1]]  # ma_row is sorted
    pos = np.flatnonzero(first)
    ur = mr[pos]
    cnt = np.diff(np.r_[pos, M])
    if cnt.max(initial=0) > 127:
        return None
    same = (np.diff(ur) == 1) & (cnt[1:] == cnt[:-1])
    sidx = np.r_[0, np.flatnonzero(~same) + 1]
    starts = ur[sidx]
    K = int(starts.shape[0])
    if K >= (1 << 31):  # int32 rec gather indices
        return None
    lens = np.diff(np.r_[sidx, ur.shape[0]]).astype(np.int64)  # rows per run
    if lens.max(initial=0) >= (1 << 24):
        return None
    mult = cnt[sidx].astype(np.int64)
    centry = lens * mult
    cum = np.concatenate(([0], np.cumsum(centry)))[:-1]
    assert cum[-1] + centry[-1] == M
    rec = np.empty((K, 2), np.int64)
    rec[:, 0] = starts
    rec[:, 1] = cum | (lens << 32) | (mult << 56)
    for shift in range(_MRP_SHIFT, 5, -2):
        if (n >> shift) >= (1 << 27):  # off table ceiling (512 MB u32)
            return None
        nbuck = (n >> shift) + 1
        off = np.searchsorted(
            starts, np.arange(nbuck + 1, dtype=np.int64) << shift,
            side="left")
        maxseg = int(np.diff(off).max(initial=0))
        nrows = max(1, (maxseg - 1) // 32 + 2)  # segments straddle row bounds
        if nrows <= 4:
            break
    else:
        return None
    Kp = -(-K // 32) * 32
    sd16 = np.full(Kp, 0xFFFF, np.uint16)
    sd16[:K] = (starts & 0xFFFF).astype(np.uint16)
    sd16 = sd16.reshape(-1, 32).view(np.uint32).view(np.int32)  # [Kp/32, 16]
    return off.astype(np.uint32), sd16, rec, (shift, nrows)


def _run_pack_fits(off, sd16, rec, shift: int, nrows: int, ma_row, n: int) -> bool:
    """True when cached run-pack tables belong to this marker CSR: the bucket
    directory spans n rows at `shift`, and the runs of `rec` hold exactly
    the CSR's M entries (their last run ends at the last entry)."""
    M = int(ma_row.shape[0])
    if M == 0 or rec.ndim != 2 or rec.shape[1] != 2 or rec.shape[0] == 0:
        return False
    if off.shape != ((n >> shift) + 2,) or sd16.shape != (-(-rec.shape[0] // 32), 16):
        return False
    last = int(rec[-1, 1])
    cum, ln, mu = last & 0xFFFFFFFF, (last >> 32) & 0xFFFFFF, (last >> 56) & 0x7F
    return (cum + ln * mu == M and int(rec[0, 0]) == int(ma_row[0])
            and int(rec[-1, 0]) + ln - 1 == int(ma_row[-1]) and 1 <= nrows <= 4)


@dataclasses.dataclass
class BigIndex:
    fb2: np.ndarray  # int32[nb_pad, 24] (or [nb_pad, 40]: 256-symbol rows)
    base: np.ndarray  # int64[n_sup, 8]
    F: np.ndarray  # int64[A+1]
    n: int
    A: int
    per_blk: int  # fb rows per superblock
    alpha: Alphabet
    prefix: str | None = None  # load dir; enables the disk caches
    # v2 optional components (see module docstring)
    run_start: np.ndarray | None = None
    run_head: np.ndarray | None = None
    samples_last: np.ndarray | None = None
    pred_pos: np.ndarray | None = None
    phi_at: np.ndarray | None = None
    cruns_keys: np.ndarray | None = None
    ma_row: np.ndarray | None = None
    ma_val: np.ndarray | None = None
    ma_wsize: int = 0
    doc_starts: np.ndarray | None = None
    doc_names: list[str] | None = None

    @property
    def n_sup(self) -> int:
        return self.base.shape[0]

    @property
    def R(self) -> int:
        return 0 if self.run_start is None else int(self.run_start.shape[0])

    @property
    def has_locate(self) -> bool:
        return self.samples_last is not None

    @property
    def has_markers(self) -> bool:
        return self.ma_row is not None

    def attach_locate(self, codes: np.ndarray, sa: np.ndarray,
                      isa: np.ndarray | None = None) -> None:
        for k, v in big_locate_tables(codes, sa, isa=isa, A=self.A).items():
            setattr(self, k, v)

    def _cache(self, name: str) -> str | None:
        return os.path.join(self.prefix, name) if self.prefix else None

    def _fresh(self, cache: str | None, *sources: str) -> bool:
        """Whether the disk cache at `cache` exists and is no older than
        each artifact file of `sources` (names of the .npy files it derives
        from): a cache older than its sources was derived from another
        artifact and is rebuilt, whatever its shape."""
        if not cache or not os.path.exists(cache):
            return False
        t = os.stat(cache).st_mtime_ns
        for name in sources:
            src = os.path.join(self.prefix, f"{name}.npy")
            if os.path.exists(src) and os.stat(src).st_mtime_ns > t:
                return False
        return True

    def _fb2_64(self) -> np.ndarray:
        """The 64-symbol/64B repack of the 128-symbol fb2 rows
        (construct.build.fblock_to_fb64), disk-cached next to the artifact;
        a cache older than fb2.npy, or whose row count is not twice fb2's, is
        rebuilt."""
        from rowbowt_tpu_torch.construct.build import fblock_to_fb64

        cache = self._cache("fb2_64.npy")
        if self._fresh(cache, "fb2"):
            fb = np.load(cache, mmap_mode="r")
            if fb.shape == (2 * self.fb2.shape[0], 16) and fb.dtype == np.int32:
                return fb
        fb = fblock_to_fb64(np.asarray(self.fb2), self.n)
        if cache:
            np.save(cache, fb)
        return fb

    def _ma_cnt64(self) -> np.ndarray | None:
        """The nibble-count marker rank rows (marker_nibble_rank), disk-cached
        next to the artifact (like the fb2_64 repack); None on >15-entry rows.
        Unlike the JAX package's, not gated on RBT_MA_NIB: no device route
        of the port calls it.  A cache older than ma_row.npy, or not [((n +
        63) >> 6) + 1, 16] int32, is rebuilt."""
        cache = self._cache("ma_cnt64.npy")
        if self._fresh(cache, "ma_row"):
            nib = np.load(cache, mmap_mode="r")
            if nib.shape == (((self.n + 63) >> 6) + 1, 16) and nib.dtype == np.int32:
                return nib
        nib = marker_nibble_rank(self.ma_row, self.n)
        if nib is not None and cache:
            np.save(cache, nib)
        return nib

    def _ma_runpack(self):
        """The run-pack marker-rank tables (marker_run_pack), disk-cached
        next to the artifact; None when the run structure doesn't fit.  A
        cache older than ma_row.npy, or that does not account for this CSR's
        entries, is rebuilt, and a cached "does not fit" is recomputed (it
        carries nothing to check)."""
        cache = self._cache("ma_runpack.npz")
        if self._fresh(cache, "ma_row"):
            z = np.load(cache)
            if "shift" in z.files and z["nrows"].item() != 0:
                rp = (z["off"], z["sd16"], z["rec"],
                      (int(z["shift"].item()), int(z["nrows"].item())))
                if _run_pack_fits(*rp[:3], *rp[3], self.ma_row, self.n):
                    return rp
        rp = marker_run_pack(self.ma_row, self.n)
        if cache:
            if rp is None:
                np.savez(cache, shift=np.int64(0), nrows=np.int64(0))
            else:
                off, sd16, rec, (shift, nrows) = rp
                np.savez(cache, off=off, sd16=sd16, rec=rec,
                         shift=np.int64(shift), nrows=np.int64(nrows))
        return rp

    def _phi_pack(self):
        """The bitmap-rank phi tables (phi_pack_tables), disk-cached next to
        the artifact; (None, None) when the breakpoint count exceeds int32
        checkpoints.  A cache no older than pred_pos.npy and phi_at.npy, with
        n // 480 + 2 rows and one delta per breakpoint, is used, any other
        rebuilt."""
        if int(self.pred_pos.shape[0]) >= (1 << 31):
            return None, None
        rc, dc = self._cache("phi_rows.npy"), self._cache("phi_delta.npy")
        if self._fresh(rc, "pred_pos", "phi_at") and self._fresh(dc, "pred_pos", "phi_at"):
            pr, pd = np.load(rc, mmap_mode="r"), np.load(dc, mmap_mode="r")
            if (pr.shape == (self.n // _PHI_POS + 2, 16)
                    and pd.shape == self.pred_pos.shape):
                return pr, pd
        pr, pd = phi_pack_tables(self.pred_pos, self.phi_at, self.n)
        if rc:
            np.save(rc, pr)
            np.save(dc, pd)
        return pr, pd

    def attach_markers(self, sa: np.ndarray, marker_tpos, marker_packed,
                       wsize: int, isa: np.ndarray | None = None) -> None:
        self.ma_row, self.ma_val = big_marker_tables(
            sa, np.asarray(marker_tpos, dtype=np.int64),
            np.asarray(marker_packed, dtype=np.int64), wsize, self.n,
            isa=isa)
        self.ma_wsize = wsize

    @staticmethod
    def from_codes(codes: np.ndarray, alpha: Alphabet, n_sup: int | None = None,
                   block: int = 128) -> "BigIndex":
        """Build straight from BWT codes (uint8, values < A <= 8): no global
        int32 table is ever materialized — per-superblock fblocks have local
        checkpoints; `base` carries the int64 offsets.  block = 256 builds
        the 256-symbol rows (fb2 of 40 lanes) instead of the 128-symbol ones."""
        from rowbowt_tpu_torch.construct.build import fb3_from_codes

        n = int(codes.shape[0])
        A = alpha.size
        if n_sup is None:
            n_sup = max(2, -(-n // _SUP_SYMS_MAX))
        fb3, base, per_blk = fb3_from_codes(codes, A, n_sup, block)
        counts = np.zeros(A + 1, dtype=np.int64)
        counts[1:] = np.bincount(codes, minlength=A)[:A]
        F = np.cumsum(counts)
        return BigIndex(fb2=fb3.reshape(-1, fb3.shape[-1]), base=base, F=F,
                        n=n, A=A, per_blk=per_blk, alpha=alpha)

    def sharded_index(self):
        """The position-sharded view (n_idx == n_sup shards) for mesh runs.

        The fb rank tables shard by position; the O(R) toehold/phi tables and
        the O(M) marker CSR REPLICATE (they are 20-300x smaller than the fb
        shards) — the sharded engines' `big_*` path (parallel/sharded_dense)."""
        from rowbowt_tpu_torch.parallel.sharded_dense import ShardedDenseIndex

        bt = None
        k0 = 0
        pp_bs = ()
        if self.has_locate:
            bt = {"run_start": np.asarray(self.run_start),
                  "samples_last": np.asarray(self.samples_last),
                  "pred_pos": np.asarray(self.pred_pos),
                  "phi_at": np.asarray(self.phi_at),
                  "cruns_keys": np.asarray(self.cruns_keys)}
            bt["pp_off"], pp_bs = marker_buckets(np.asarray(self.pred_pos),
                                                 self.n)
            k0 = int((int(self.samples_last[-1]) + 1) % self.n)
        ma_bs = ()
        if self.has_markers:
            bt = bt or {}
            bt["ma_row"] = np.asarray(self.ma_row)
            bt["ma_val"] = np.asarray(self.ma_val)
            bt["ma_off"], ma_bs = marker_buckets(self.ma_row, self.n)
        return ShardedDenseIndex(
            fb3=np.ascontiguousarray(
                self.fb2.reshape(self.n_sup, self.per_blk, -1)),
            base=self.base, F=self.F.astype(np.int64), n=self.n, A=self.A,
            n_idx=self.n_sup, per_blk=self.per_blk, k0=k0,
            big_tables=bt, R=self.R, ma_wsize=self.ma_wsize, ma_bs=ma_bs,
            pp_bs=pp_bs,
        )

    # ---------------- serialization (.npy so mmap load works) ----------------

    _OPT = ("run_start", "run_head", "samples_last", "pred_pos",
            "phi_at", "cruns_keys", "ma_row", "ma_val", "doc_starts")

    # the caches the loaders derive from the artifact's files, next to them
    _CACHES = ("fb2_64.npy", "ma_cnt64.npy", "ma_runpack.npz", "phi_rows.npy",
               "phi_delta.npy")

    def save(self, prefix: str) -> None:
        """The artifact's .npy files and meta.json into `prefix`, after
        removing the derived caches an artifact saved there before left."""
        os.makedirs(prefix, exist_ok=True)
        for name in self._CACHES:
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(prefix, name))
        np.save(os.path.join(prefix, "fb2.npy"), self.fb2)
        np.save(os.path.join(prefix, "base.npy"), self.base)
        np.save(os.path.join(prefix, "F.npy"), self.F)
        present = []
        for k in self._OPT:
            v = getattr(self, k)
            if v is not None:
                np.save(os.path.join(prefix, f"{k}.npy"), v)
                present.append(k)
        with open(os.path.join(prefix, "meta.json"), "w") as f:
            json.dump({"format": "rowbowt-tpu-bigindex", "version": 2,
                       "n": self.n, "A": self.A, "per_blk": self.per_blk,
                       "alpha_bytes": self.alpha.bytes_.tolist(),
                       "optional": present, "ma_wsize": self.ma_wsize,
                       "doc_names": self.doc_names}, f)

    @staticmethod
    def load(prefix: str, mmap: bool = True) -> "BigIndex":
        with open(os.path.join(prefix, "meta.json")) as f:
            meta = json.load(f)
        mm = "r" if mmap else None
        big = BigIndex(
            fb2=np.load(os.path.join(prefix, "fb2.npy"), mmap_mode=mm),
            base=np.load(os.path.join(prefix, "base.npy")),
            F=np.load(os.path.join(prefix, "F.npy")),
            n=int(meta["n"]), A=int(meta["A"]), per_blk=int(meta["per_blk"]),
            alpha=Alphabet(np.array(meta["alpha_bytes"], dtype=np.uint8)),
            prefix=prefix,
            ma_wsize=int(meta.get("ma_wsize", 0)),
            doc_names=meta.get("doc_names"),
        )
        for k in meta.get("optional", ()):
            setattr(big, k, np.load(os.path.join(prefix, f"{k}.npy"),
                                    mmap_mode=mm))
        return big

    @staticmethod
    def is_big_dir(path: str) -> bool:
        """True when `path` is a BigIndex directory (CLI auto-detect)."""
        meta = os.path.join(path, "meta.json")
        if not os.path.isdir(path) or not os.path.exists(meta):
            return False
        try:
            with open(meta) as f:
                return json.load(f).get("format") == "rowbowt-tpu-bigindex"
        except (json.JSONDecodeError, OSError):
            return False
