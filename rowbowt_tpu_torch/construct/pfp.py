"""Prefix-free-parsing (PFP) construction: pangenome-scale BWT + r-index
tables in time O(n) streaming + O(parse + dict + R + M) everything else.

The reference delegates panel-scale construction to pfbwt-f's prefix-free
parsing (rowbowt:README.md:37-44, scripts/vcf_to_rowbowt.sh:9-10) —
whole-text suffix sorting cannot run at 10^10 symbols, and the chunked
insertion merge (construct/merge.py) still pays one rank per character of
every document.  PFP exploits what makes a panel a panel: haplotypes are the
reference plus sparse edits, so the phrase DICTIONARY is ~(reference/p + one
phrase per variant) and the PARSE is n/p tokens.  All suffix sorting happens
on those two small objects; the n-sized text is only ever streamed once.

This is an independent implementation (native/pfp.cpp; the pfbwt-f submodule
is empty in the reference checkout).  Key differences from the merge path:
the suffix order is the STANDARD whole-text order (the final TERM byte is the
unique smallest, so every comparison resolves inside the text) rather than
the merge's generalized document order.  Count ranges for any pattern over
in-document content (reads never contain separators) are IDENTICAL under
both orders — every comparison against such a pattern diverges at a real
byte before any document end; toehold values and phi chains differ only in
which member of an equal-range they report, as both are order-consistent
r-indexes (tests/test_pfp.py proves byte-equality against the whole-text
SA-IS oracle and count-range equality against the merge).

Outputs feed BigIndex directly: run-length BWT (R entries, never the n-sized
code array), run-boundary SA samples, exact phi breakpoints, marker CSR.

The copy of rowbowt_tpu/construct/pfp.py (numpy and ctypes), imports
renamed, kept line-for-line close.  Positions stay numpy uint32/int64 here;
engine/device.TorchIndex.from_big widens them to int64 on the card.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.construct.sa import require_native

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = require_native("rbt_pfp_new")
    if not hasattr(lib, "_rbt_pfp_ready"):
        lib.rbt_pfp_new.restype = ctypes.c_void_p
        lib.rbt_pfp_new.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        lib.rbt_pfp_feed.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
        lib.rbt_pfp_finish.argtypes = [ctypes.c_void_p]
        lib.rbt_pfp_stats.argtypes = [ctypes.c_void_p, _i64p]
        lib.rbt_pfp_dict_parse.argtypes = [ctypes.c_void_p, _u8p, _i64p, _u32p]
        lib.rbt_pfp_free.argtypes = [ctypes.c_void_p]
        lib.rbt_kasai.argtypes = [_u8p, ctypes.c_int64, _i64p, _i32p]
        lib.rbt_sais_i32.argtypes = [_i32p, _i64p, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.rbt_sais_i32.restype = ctypes.c_int
        lib.rbt_pfp_sweep.restype = ctypes.c_int64
        lib.rbt_pfp_sweep.argtypes = [
            _u8p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p,  # dict + dsa
            _i32p, ctypes.c_int64,                         # lcp, w
            _u32p, ctypes.c_int64,                         # parse, np
            _i64p, _i32p, _i32p, _i64p,                    # ilist + tstart
            _i32p, _i64p, _i32p, ctypes.c_int64, _i64p,    # probes + rows out
            _i64p, ctypes.c_int64, _i64p, _i64p,           # watches
            ctypes.c_int64, _u8p, _i64p, _i64p, _i64p,     # cap + run outputs
            _i64p,                                         # out_n_rows
        ]
        lib.rbt_fb2_fill_rle.argtypes = [
            _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p, _i64p,
        ]
        lib._rbt_pfp_ready = True
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class PfpResult:
    """Everything the sweep produces, in host numpy arrays.

    run_heads are BYTES (text alphabet); run_start/run_sa_first/run_sa_last
    are int64 rows / text positions.  `probe_rows` aligns with the probe
    arrays passed in (marker windows + watched positions).
    """

    def __init__(self, n, run_heads, run_start, run_sa_first, run_sa_last,
                 probe_rows, parse_stats):
        self.n = n
        self.run_heads = run_heads
        self.run_start = run_start
        self.run_sa_first = run_sa_first
        self.run_sa_last = run_sa_last
        self.probe_rows = probe_rows
        self.parse_stats = parse_stats

    @property
    def R(self):
        return int(self.run_heads.shape[0])

    def run_lens(self):
        ends = np.empty(self.R, dtype=np.int64)
        ends[:-1] = self.run_start[1:]
        ends[-1] = self.n
        return ends - self.run_start


def pfp_construct(parts, w: int = 10, p: int = 100,
                  probe_pos=None, verbose: bool = False) -> PfpResult:
    """Run the full PFP pipeline over an iterable of uint8 document arrays
    (each already carrying its separator tail; the last ends with TERM).

    probe_pos: optional int64 text positions whose BWT rows are wanted
    (marker windows).  Position 0 is always probed internally — its row and
    neighbors supply the SA[j]=0 phi breakpoint candidates.
    """
    lib = _lib()
    h = lib.rbt_pfp_new(w, p)
    try:
        for part in parts:
            buf = np.ascontiguousarray(part, dtype=np.uint8)
            lib.rbt_pfp_feed(h, _ptr(buf, ctypes.c_uint8), buf.shape[0])
        lib.rbt_pfp_finish(h)
        st = np.zeros(4, dtype=np.int64)
        lib.rbt_pfp_stats(h, _ptr(st, ctypes.c_int64))
        n, np_, nd, dchars = (int(x) for x in st)
        assert n > w, "text shorter than the parse window"
        if verbose:
            print(f"pfp: n={n:,} parse={np_:,} dict={nd:,} phrases "
                  f"({dchars / 1e6:,.1f} M chars)", file=sys.stderr)
        dlen = dchars + nd
        dcat = np.empty(dlen, dtype=np.uint8)
        dstarts = np.empty(nd + 1, dtype=np.int64)
        parse = np.empty(np_, dtype=np.uint32)
        lib.rbt_pfp_dict_parse(h, _ptr(dcat, ctypes.c_uint8),
                               _ptr(dstarts, ctypes.c_int64),
                               _ptr(parse, ctypes.c_uint32))
    finally:
        lib.rbt_pfp_free(h)

    # dict suffix array + LCP (Kasai)
    dsa = np.empty(dlen, dtype=np.int64)
    lib.rbt_sais_u8(_ptr(dcat, ctypes.c_uint8), _ptr(dsa, ctypes.c_int64),
                    dlen)
    lcp = np.empty(dlen, dtype=np.int32)
    lib.rbt_kasai(_ptr(dcat, ctypes.c_uint8), dlen,
                  _ptr(dsa, ctypes.c_int64), _ptr(lcp, ctypes.c_int32))

    # parse suffix array -> keys (rank of the FOLLOWING parse suffix) + ILIST
    assert np_ < (1 << 31)
    pa = parse.view(np.int32)  # ids < 2^31
    sa_p = np.empty(np_, dtype=np.int64)
    lib.rbt_sais_i32(_ptr(pa, ctypes.c_int32), _ptr(sa_p, ctypes.c_int64),
                     np_, nd)
    # occurrences ordered by continuation rank: sentinel first (t = np-1,
    # key 0), then ranks 1..np for t = sa_p[r] - 1 where t >= 0
    sp = sa_p.astype(np.int64)
    keep = sp >= 1
    t_by_key = np.concatenate(([np_ - 1], (sp[keep] - 1)))
    key_by_key = np.concatenate(
        ([0], (np.flatnonzero(keep) + 1))).astype(np.int32)
    # ILIST: stable sort by phrase id keeps the key order within each phrase
    order = np.argsort(parse[t_by_key], kind="stable")
    ilist_t = t_by_key[order].astype(np.int32)
    ilist_key = key_by_key[order]
    freqs = np.bincount(parse, minlength=nd).astype(np.int64)
    ilist_off = np.concatenate(([0], np.cumsum(freqs)))
    del sa_p, sp, keep, t_by_key, key_by_key, order

    # text start of each occurrence: s_{k+1} = s_k + |d_k| - w
    plens = np.diff(dstarts) - 1  # concat stores one 0x00 per phrase
    adv = plens[parse.astype(np.int64)] - w
    tstart = np.concatenate(([0], np.cumsum(adv)))
    assert int(tstart[-1]) == n, (int(tstart[-1]), n)

    # probes: marker positions + position 0 (phi wrap candidates)
    probe_pos = (np.asarray(probe_pos, dtype=np.int64)
                 if probe_pos is not None else np.empty(0, dtype=np.int64))
    allpos = np.concatenate((probe_pos, [0]))
    pr_t = np.searchsorted(tstart, allpos, side="right") - 1
    pr_off = allpos - tstart[pr_t]
    pr_pid = parse[pr_t].astype(np.int32)
    # key of occurrence t = rank of P'[t+1:]; recover from ilist arrays:
    # entry position of t within its phrase segment
    ord_t = np.argsort(ilist_t, kind="stable")
    key_of_t = np.empty(np_, dtype=np.int32)
    key_of_t[ilist_t[ord_t].astype(np.int64)] = ilist_key[ord_t]
    pr_key = key_of_t[pr_t]
    del ord_t, key_of_t
    srt = np.lexsort((pr_key, pr_off, pr_pid))
    inv = np.empty_like(srt)
    inv[srt] = np.arange(srt.shape[0])
    spid = np.ascontiguousarray(pr_pid[srt])
    soff = np.ascontiguousarray(pr_off[srt])
    skey = np.ascontiguousarray(pr_key[srt])
    srow = np.zeros(srt.shape[0], dtype=np.int64)

    nil = np.zeros(1, dtype=np.int64)
    out_n = np.zeros(1, dtype=np.int64)
    # call 1: cap_R = 0 -> pass A only; returns -R, fills probe rows
    rc = lib.rbt_pfp_sweep(
        _ptr(dcat, ctypes.c_uint8), dlen, _ptr(dstarts, ctypes.c_int64), nd,
        _ptr(dsa, ctypes.c_int64), _ptr(lcp, ctypes.c_int32), w,
        _ptr(parse, ctypes.c_uint32), np_,
        _ptr(ilist_off, ctypes.c_int64), _ptr(ilist_t, ctypes.c_int32),
        _ptr(ilist_key, ctypes.c_int32), _ptr(tstart, ctypes.c_int64),
        _ptr(spid, ctypes.c_int32), _ptr(soff, ctypes.c_int64),
        _ptr(skey, ctypes.c_int32), srt.shape[0],
        _ptr(srow, ctypes.c_int64),
        _ptr(nil, ctypes.c_int64), 0, _ptr(nil, ctypes.c_int64),
        _ptr(nil, ctypes.c_int64),
        0, _ptr(np.zeros(1, dtype=np.uint8), ctypes.c_uint8),
        _ptr(nil, ctypes.c_int64), _ptr(nil, ctypes.c_int64),
        _ptr(nil, ctypes.c_int64), _ptr(out_n, ctypes.c_int64))
    R = -int(rc)
    assert R > 0 and int(out_n[0]) == n, (rc, int(out_n[0]), n)
    probe_rows = srow[inv]
    j0 = int(probe_rows[-1])  # row of text position 0
    probe_rows = probe_rows[:-1]

    # call 2: pass B with run outputs + watches {j0, j0+1}
    watch = np.array(sorted({j0, (j0 + 1) % n}), dtype=np.int64)
    wsa = np.zeros(watch.shape[0], dtype=np.int64)
    wprev = np.zeros(watch.shape[0], dtype=np.int64)
    run_heads = np.zeros(R, dtype=np.uint8)
    run_start = np.zeros(R, dtype=np.int64)
    run_sa_first = np.zeros(R, dtype=np.int64)
    run_sa_last = np.zeros(R, dtype=np.int64)
    rc = lib.rbt_pfp_sweep(
        _ptr(dcat, ctypes.c_uint8), dlen, _ptr(dstarts, ctypes.c_int64), nd,
        _ptr(dsa, ctypes.c_int64), _ptr(lcp, ctypes.c_int32), w,
        _ptr(parse, ctypes.c_uint32), np_,
        _ptr(ilist_off, ctypes.c_int64), _ptr(ilist_t, ctypes.c_int32),
        _ptr(ilist_key, ctypes.c_int32), _ptr(tstart, ctypes.c_int64),
        _ptr(spid, ctypes.c_int32), _ptr(soff, ctypes.c_int64),
        _ptr(skey, ctypes.c_int32), 0, _ptr(nil, ctypes.c_int64),
        _ptr(watch, ctypes.c_int64), watch.shape[0],
        _ptr(wsa, ctypes.c_int64), _ptr(wprev, ctypes.c_int64),
        R, _ptr(run_heads, ctypes.c_uint8), _ptr(run_start, ctypes.c_int64),
        _ptr(run_sa_first, ctypes.c_int64), _ptr(run_sa_last, ctypes.c_int64),
        _ptr(out_n, ctypes.c_int64))
    assert int(rc) == R, (rc, R)
    res = PfpResult(n, run_heads, run_start, run_sa_first, run_sa_last,
                    probe_rows, dict(parse_len=np_, dict_phrases=nd,
                                     dict_chars=dchars))
    res.watch_rows = watch
    res.watch_sa = wsa
    res.watch_prev = wprev
    res.j0 = j0
    if verbose:
        print(f"pfp: R={R:,} (n/R={n / R:,.1f})", file=sys.stderr)
    return res


def phi_breakpoints(res: PfpResult):
    """Exact phi breakpoint table (pred_pos, phi_at) from the run-boundary SA
    samples — the same minimal set bigindex.big_locate_tables extracts from a
    full SA.  Candidates: i = SA[j] at every run-start row j (paired with
    SA[j-1]), the wrap row 0, and the rows around SA[j] == 0."""
    n = res.n
    cand_i = res.run_sa_first.copy()
    cand_v = np.empty_like(cand_i)
    cand_v[1:] = res.run_sa_last[:-1]
    cand_v[0] = res.run_sa_last[-1]  # row 0: phi(SA[0]) = SA[n-1]
    wi = res.watch_sa
    wp = res.watch_prev
    cand_i = np.concatenate((cand_i, wi))
    cand_v = np.concatenate((cand_v, wp))
    srt = np.argsort(cand_i, kind="stable")
    ci = cand_i[srt]
    cv = cand_v[srt]
    first = np.concatenate(([True], ci[1:] != ci[:-1]))
    ci, cv = ci[first], cv[first]
    assert ci[0] == 0, "position 0 must be a candidate"
    # keep true breakpoints: phi deviates from the previous candidate's line
    keep = np.concatenate(
        ([True], cv[1:] != cv[:-1] + (ci[1:] - ci[:-1])))
    return ci[keep], cv[keep]


def assemble_bigindex(res: PfpResult, alpha: Alphabet, block: int = 128,
                      sup_syms: int = 1 << 30, verbose: bool = False):
    """BigIndex (count + locate tables) from a PfpResult: the fb2 rank table
    is filled straight from the run-length BWT (native rbt_fb2_fill_rle), the
    O(R) locate tables from the boundary samples — no n-sized array is ever
    materialized on the host."""
    from rowbowt_tpu_torch.bigindex import BigIndex

    lib = _lib()
    n = res.n
    R = res.R
    tab = alpha.encode_table()
    heads = tab[res.run_heads.astype(np.int64)]
    assert (heads >= 0).all(), "BWT byte outside the alphabet"
    heads = np.ascontiguousarray(heads, dtype=np.uint8)
    lens = np.ascontiguousarray(res.run_lens())
    A = alpha.size

    nb = -(-n // block)
    n_sup = max(2, -(-n // sup_syms))
    per_blk = -(-nb // n_sup)
    lanes = 8 + block // 8
    fb2 = np.zeros((n_sup * per_blk, lanes), dtype=np.int32)
    base = np.zeros((n_sup, 8), dtype=np.int64)
    lib.rbt_fb2_fill_rle(
        _ptr(heads, ctypes.c_uint8), _ptr(lens, ctypes.c_int64), R, A, n,
        block, per_blk, n_sup, _ptr(fb2, ctypes.c_int32),
        _ptr(base, ctypes.c_int64))
    counts = np.zeros(A + 1, dtype=np.int64)
    np.add.at(counts, heads.astype(np.int64) + 1, lens)
    F = np.cumsum(counts)

    big = BigIndex(fb2=fb2, base=base, F=F, n=n, A=A, per_blk=per_blk,
                   alpha=alpha)
    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    big.run_start = res.run_start.astype(pos_dt)
    big.run_head = heads
    sl = (np.concatenate((res.run_start[1:], [n])) - 1)  # run end rows
    del sl
    big.samples_last = ((res.run_sa_last + n - 1) % n).astype(pos_dt)
    pp, pa = phi_breakpoints(res)
    big.pred_pos = pp.astype(pos_dt)
    big.phi_at = pa.astype(pos_dt)
    keys = heads.astype(np.int64) * R + np.arange(R, dtype=np.int64)
    order = np.argsort(heads, kind="stable")
    ck = keys[order]
    key_dt = np.int32 if A * R < (1 << 31) else np.int64
    big.cruns_keys = ck.astype(key_dt)
    if verbose:
        print(f"pfp: fb2 {fb2.nbytes / 2**30:.2f} GB ({block}-symbol rows), "
              f"phi breakpoints {pp.shape[0]:,}", file=sys.stderr)
    return big


def attach_markers_from_probes(big, res: PfpResult, marker_tpos,
                               marker_packed, wsize: int):
    """Marker CSR from probe rows: the probes passed to pfp_construct must be
    the flattened window positions [t-w+1, t] of every marker (same rule as
    bigindex.big_marker_tables); their resolved BWT rows become ma_row."""
    n = big.n
    tpos = np.asarray(marker_tpos, dtype=np.int64)
    packed = np.asarray(marker_packed, dtype=np.int64)
    lo_p = np.maximum(tpos - wsize + 1, 0)
    span = tpos - lo_p + 1
    vals = np.repeat(packed, span)
    rows = res.probe_rows
    assert rows.shape[0] == vals.shape[0], "probes != flattened windows"
    srt = np.lexsort((vals, rows))
    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    big.ma_row = rows[srt].astype(pos_dt)
    big.ma_val = vals[srt]
    big.ma_wsize = wsize


def marker_window_positions(marker_tpos, wsize: int):
    """Flattened [t-w+1, t] probe positions for attach_markers_from_probes."""
    tpos = np.asarray(marker_tpos, dtype=np.int64)
    lo_p = np.maximum(tpos - wsize + 1, 0)
    span = tpos - lo_p + 1
    off = np.repeat(np.cumsum(span) - span, span)
    flat = np.arange(off.shape[0], dtype=np.int64) - off
    return np.repeat(lo_p, span) + flat
