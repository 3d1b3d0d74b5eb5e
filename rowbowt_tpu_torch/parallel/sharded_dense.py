"""The production sharding layout: every dense table partitioned along the
BWT-position axis over the 'idx' axis of the mesh, fused-block rank per shard.

The counterpart of rowbowt_tpu/parallel/sharded_dense.py; ShardedDenseIndex
and its build are its numpy, copied (fb3_from_codes is construct/build.py's).
Layout:
  fb3   [n_idx, per_blk, 24] int32 — fblock rows with SHARD-LOCAL exclusive
        checkpoints; stays int32 at ANY global n (a shard's local count can't
        exceed its 128*per_blk positions).  The global rank is
        base[shard, c] + local checkpoint + in-block popcount.
  base  [n_idx, 8] — global count of each char before the shard (replicated;
        n_idx*8 ints, trivial).
  kval2/phi2 [n_idx, per_pos]  — SA values / dense phi, position-sharded.
  ms2   [n_idx, per_pos + 1]   — dense marker offsets with the right edge
        duplicated so a shard can answer ma_start1[i] for any owned i..i+1.
  mv2   [n_idx, max_ent] int64 — packed markers, entry-sharded on the same
        position boundaries; goff [n_idx+1] = each shard's first global
        entry id (replicated).
  F     [A+1] replicated; k0 scalar replicated.
On the big (n >= 2^31) layout of BigIndex.sharded_index the O(R) toehold/phi
tables and the O(M) marker CSR are `big_*` tables, replicated on every rank.

Every rank/gather is: all shards compute a local candidate, the owner's
survives one sum over 'idx' (Mesh.psum_idx, an all_reduce of
where(owner, v, 0) in the lane dtype).  Each rank holds its own dp rows and
its shard's tables (device_put); the engines take and return this rank's
rows.  The per-step ranks are torch ops here, as the JAX package's are XLA
ops inside shard_map; the collective counts are the JAX package's: one
[2B] all-reduce per LF step, two a step in greedy seeding plus one [S*K, B]
entry-value all-reduce at its end, one a window pass of the window markers.

Equivalence targets: find_range (rowbowt.hpp:121-131), find_range_w_toehold
(:167-184), locate_range (toehold_sa.hpp:37-49), find_range_w_markers
(:292-339), get_markers_greedy_seeding (:406-482).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rowbowt_tpu_torch.construct.build import (
    DENSE_BLOCK, FB_CKPT, FB_ROW, fb3_from_codes, fblock_to_fb64,
)
from rowbowt_tpu_torch.index import RbtIndex
from rowbowt_tpu_torch.ops import update as U
from rowbowt_tpu_torch.ops.rank import _fb_rank_from_rows, bucketed_lower_bound

_U32 = 0xFFFFFFFF
# row width (int32 lanes) -> log2 of its symbols: 128-symbol build rows, the
# 64B repack, the 256-symbol giant layout
_SHIFT = {FB_ROW: 7, 16: 6, 40: 8}


@dataclasses.dataclass
class ShardedDenseIndex:
    """Host-side container; device_put() places this rank's shard."""

    fb3: np.ndarray  # int32[n_idx, per_blk, 24], local checkpoints
    base: np.ndarray  # int64[n_idx, 8], global count before each shard
    F: np.ndarray  # int[A+1]
    n: int
    A: int
    n_idx: int
    per_blk: int
    k0: int  # (samples_last[R-1] + 1) % n, the initial toehold
    kval2: np.ndarray | None = None  # [n_idx, per_pos]
    phi2: np.ndarray | None = None  # [n_idx, per_pos]
    ms2: np.ndarray | None = None  # [n_idx, per_pos + 1]
    mv2: np.ndarray | None = None  # int64[n_idx, max_ent]
    goff: np.ndarray | None = None  # [n_idx + 1]
    ma_wsize: int = 10
    # big (n >= 2^31) layout: the O(n) kval2/phi2/ms2 cannot exist; the O(R)
    # run-space toehold/phi tables and the O(M) marker CSR are REPLICATED
    # (20-300x smaller than the sharded fb3) — bigindex.py conventions
    big_tables: dict | None = None  # run_start/samples_last/pred_pos/phi_at/
    #                                 cruns_keys[/ma_row/ma_val/ma_off], numpy
    R: int = 0
    ma_bs: tuple = ()  # (shift, iters) of the bucketed marker lower bound
    pp_bs: tuple = ()  # (shift, iters) of the bucketed phi-breakpoint bound

    @property
    def per_pos(self) -> int:
        return self.per_blk * DENSE_BLOCK

    # (fb3, base, per_blk) straight from BWT codes, the n >= 2^31 path
    fb3_from_codes = staticmethod(fb3_from_codes)

    @staticmethod
    def build(idx: RbtIndex, n_idx: int) -> "ShardedDenseIndex":
        if idx.fblock is None:
            raise ValueError("ShardedDenseIndex needs an fblock build")
        dt = idx.idx_dtype
        fb = idx.fblock
        nb = fb.shape[0]
        per_blk = (nb + n_idx - 1) // n_idx
        fb3 = np.zeros((n_idx, per_blk, FB_ROW), dtype=np.int32)
        # pad rows: nibble 15 everywhere matches no code
        fb3[:, :, FB_CKPT:] = -1
        base = np.zeros((n_idx, FB_CKPT), dtype=np.int64)
        for s in range(n_idx):
            b0 = min(s * per_blk, nb)
            b1 = min(b0 + per_blk, nb)
            if b1 > b0:
                fb3[s, : b1 - b0] = fb[b0:b1]
                base[s] = fb[b0, :FB_CKPT]
                fb3[s, : b1 - b0, :FB_CKPT] -= fb[b0, :FB_CKPT]
            else:  # shard owns nothing: count before n == total per-char count
                base[s, : idx.A] = np.diff(idx.F.astype(np.int64))

        per_pos = per_blk * DENSE_BLOCK
        kval2 = phi2 = ms2 = mv2 = goff = None

        def pos_shard(arr, fill):
            out = np.full((n_idx, per_pos), fill, dtype=arr.dtype)
            flat = out.reshape(-1)
            flat[: arr.shape[0]] = arr
            return flat.reshape(n_idx, per_pos)

        if idx.kval is not None:
            kval2 = pos_shard(idx.kval.astype(dt), 0)
            phi2 = pos_shard(idx.phi1.astype(dt), 0)
        if idx.ma_start1 is not None:
            ms = idx.ma_start1.astype(dt)  # [n+1]
            M = int(ms[-1])
            ms2 = np.full((n_idx, per_pos + 1), M, dtype=dt)
            for s in range(n_idx):
                p0 = s * per_pos
                p1 = min(p0 + per_pos + 1, ms.shape[0])
                if p1 > p0:
                    ms2[s, : p1 - p0] = ms[p0:p1]
            goff = np.empty(n_idx + 1, dtype=np.int64)
            goff[:n_idx] = ms2[:, 0]
            goff[n_idx] = M
            max_ent = max(1, int((ms2[:, -1] - ms2[:, 0]).max()))
            mv2 = np.zeros((n_idx, max_ent), dtype=np.int64)
            for s in range(n_idx):
                e0, e1 = int(goff[s]), int(ms2[s, -1])
                mv2[s, : e1 - e0] = idx.ma_val[e0:e1]
        k0 = int((idx.samples_last[-1] + 1) % idx.n) if idx.samples_last is not None else 0
        return ShardedDenseIndex(
            fb3=fb3, base=base, F=idx.F.astype(dt), n=idx.n, A=idx.A,
            n_idx=n_idx, per_blk=per_blk, k0=k0,
            kval2=kval2, phi2=phi2, ms2=ms2, mv2=mv2, goff=goff,
            ma_wsize=idx.ma_wsize,
        )

    def device_put(self, mesh, fb64: bool = True) -> dict:
        """This rank's shard (mesh.idx) of the position-sharded tables and
        every replicated table, on the mesh's device.  fb64=True (default)
        repacks the shard's 24-lane rows to the 64-symbol/64B layout
        (fblock_to_fb64, row by row, so one shard's repack is that shard of
        the whole table's); the 40-lane (256-symbol) rows ship as built.  The
        big layout's u32 tables widen to int64 (engine/device.py)."""
        if mesh.n_idx != self.n_idx:
            raise ValueError(f"index built for n_idx = {self.n_idx}, mesh has {mesh.n_idx}")
        s = mesh.idx
        fb = np.asarray(self.fb3[s])
        if fb64 and fb.shape[-1] == FB_ROW:
            fb = fblock_to_fb64(fb, self.n)

        def put(a):
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.astype(np.int64)
            return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(mesh.device)

        d = {"fb3": put(fb), "base": put(self.base), "F": put(self.F)}
        for name in ("kval2", "phi2", "ms2", "mv2"):
            v = getattr(self, name)
            if v is not None:
                d[name] = put(v[s])
        if self.goff is not None:
            d["goff"] = put(self.goff)
        if self.big_tables:
            for name, v in self.big_tables.items():
                d["big_" + name] = put(v)
        return d


def _mk_rank(mesh, sdx: ShardedDenseIndex, tb):
    """Shard-local fused-block rank closure.

    Row width/count come from the placed table, so the 96B (24-lane), 64B
    (16-lane) and 256-symbol (40-lane) layouts run the same code."""
    my = mesh.idx
    fb_loc = tb["fb3"]
    per_blk = fb_loc.shape[0]  # rows per shard in the PLACED layout
    shift = _SHIFT[fb_loc.shape[1]]
    n = sdx.n
    F_ = tb["F"]
    base8 = tb["base"][my]  # [8] global count before this shard
    lanes = torch.arange(FB_CKPT, dtype=torch.int32, device=fb_loc.device)[None, :]

    def rank(i, c):
        csafe = torch.clamp(c, min=0)
        isafe = torch.clamp(i, max=n - 1)
        blk = isafe >> shift
        lblk = blk - my * per_blk
        owner = (lblk >= 0) & (lblk < per_blk)
        row = fb_loc[torch.clamp(lblk, 0, per_blk - 1).long()]
        v = _fb_rank_from_rows(row, isafe & ((1 << shift) - 1), csafe)
        sel = lanes == csafe[:, None].to(torch.int32)
        # widen the int32 local rank to the LANE dtype before adding the int64
        # global base — never narrow the base (it holds counts >= 2^31 on a
        # 1000G index); the all-reduce rides the lane dtype too
        b = torch.where(sel, base8[None, :], 0).sum(dim=1).to(i.dtype)
        v = mesh.psum_idx(torch.where(owner, v.to(i.dtype) + b, 0))
        cl = csafe.long()
        total = (F_[cl + 1] - F_[cl]).to(i.dtype)
        v = torch.where(i >= n, total, v)
        return torch.where(c < 0, 0, v)

    return rank


def _mk_sym(mesh, sdx: ShardedDenseIndex, tb):
    """Owner-picked BWT symbol at position i from the sharded fb rows (the
    sharded ops.rank.bwt_sym): one packed-word element gather + all-reduce."""
    my = mesh.idx
    fb_loc = tb["fb3"]
    per_blk = fb_loc.shape[0]
    shift = _SHIFT[fb_loc.shape[1]]

    def sym(i):
        isafe = torch.clamp(i, 0, sdx.n - 1)
        blk = isafe >> shift
        lblk = blk - my * per_blk
        owner = (lblk >= 0) & (lblk < per_blk)
        off = isafe & ((1 << shift) - 1)
        w = fb_loc[torch.clamp(lblk, 0, per_blk - 1).long(), (FB_CKPT + (off >> 3)).long()]
        w = w.to(torch.int64) & _U32
        nib = ((w >> (4 * (off & 7))) & 15).to(torch.int32)
        return mesh.psum_idx(torch.where(owner, nib, 0))

    return sym


def _mk_ms(mesh, sdx: ShardedDenseIndex, tb):
    """Owner-picked global ma_start1[i] closure (i in [0, n]).  The right
    edge is duplicated into each shard (ms2 build), so the last shard owns
    the i == n probe."""
    my = mesh.idx
    ms_loc = tb["ms2"]
    per = sdx.per_pos
    last = my == sdx.n_idx - 1

    def ms_at(i):
        li = i - my * per
        owner = (li >= 0) & (li < per)
        if last:
            owner = owner | (li == per)
        v = ms_loc[torch.clamp(li, 0, per).long()]
        return mesh.psum_idx(torch.where(owner, v, 0))

    return ms_at


def _mk_mv_pick(mesh, sdx: ShardedDenseIndex, tb):
    """Entry-sharded packed-marker resolve: ids -> values via one owner
    all-reduce."""
    my = mesh.idx
    mv_loc = tb["mv2"]
    g0, g1 = int(sdx.goff[my]), int(sdx.goff[my + 1])

    def pick(entry, valid):
        lg = entry.to(torch.int64) - g0
        owner = (lg >= 0) & (lg < g1 - g0) & valid
        v = mv_loc[torch.clamp(lg, 0, mv_loc.shape[0] - 1)]
        return mesh.psum_idx(torch.where(owner, v, 0))

    return pick


def _mk_ms_any(mesh, sdx: ShardedDenseIndex, tb):
    """ma_start1[i] closure: dense owner-pick (ms2) or, on the big layout, a
    bounded search over the REPLICATED marker CSR — no collective at all."""
    if "ms2" in tb:
        return _mk_ms(mesh, sdx, tb)
    mr = tb["big_ma_row"]
    if "big_ma_off" in tb and sdx.ma_bs:
        shift, iters = sdx.ma_bs
        off = tb["big_ma_off"]

        def ms_at(i):
            return bucketed_lower_bound(mr, off, shift, iters, i)

        return ms_at

    def ms_at(i):
        return torch.searchsorted(mr, i.to(mr.dtype), right=False).to(i.dtype)

    return ms_at


def _mk_mv_any(mesh, sdx: ShardedDenseIndex, tb):
    """Packed-marker value resolve: entry-sharded all-reduce (mv2) or a
    plain replicated gather (big layout)."""
    if "mv2" in tb:
        return _mk_mv_pick(mesh, sdx, tb)
    mv = tb["big_ma_val"]

    def pick(entry, valid):
        return mv[torch.clamp(entry, 0, mv.shape[0] - 1).long()]

    return pick


def _pos_pick(mesh, sdx: ShardedDenseIndex, tb, name, i):
    """Owner-picked gather from a position-sharded [n_idx, per_pos] table."""
    loc = tb[name]
    per = sdx.per_pos
    li = i - mesh.idx * per
    owner = (li >= 0) & (li < per)
    v = loc[torch.clamp(li, 0, per - 1).long()]
    return mesh.psum_idx(torch.where(owner, v, 0))


def _lf_body(rank, F_, qc, lens_, L):
    """Shared LF-loop body factory: returns body(j, (lo, hi, done)).

    Both ranks of the step (at lo and hi+1) ride ONE concatenated [2B]
    owner all-reduce — one collective per LF step, not two."""
    dt = lens_.dtype

    def body(j, st):
        lo, hi, done = st
        c = qc[:, L - 1 - j].to(dt)
        active = (~done) & (j < lens_)
        both = rank(torch.cat([lo, hi + 1]), torch.cat([c, c]))
        B = lo.shape[0]
        cb = both[:B]
        ci = both[B:] - cb
        csafe = torch.clamp(c, min=0).long()
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        nlo = torch.where(empty, 1, nlo)
        nhi = torch.where(empty, 0, nhi)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & empty)
        return lo, hi, done

    return body


def _start(sdx, qc, dt):
    B = qc.shape[0]
    dev = qc.device
    return (torch.zeros(B, dtype=dt, device=dev), torch.full((B,), sdx.n - 1, dtype=dt, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev))


def find_ranges_sharded_dense(mesh, sdx: ShardedDenseIndex, tables: dict, qcodes, lengths):
    """Batched count over the position-sharded fblock index."""
    L = qcodes.shape[1]
    rank = _mk_rank(mesh, sdx, tables)
    dt = tables["F"].dtype
    body = _lf_body(rank, tables["F"], qcodes, lengths.to(dt), L)
    st = _start(sdx, qcodes, dt)
    for j in range(L):
        st = body(j, st)
    return st[0], st[1]


def find_ranges_w_toehold_sharded_dense(mesh, sdx: ShardedDenseIndex, tables: dict,
                                        qcodes, lengths):
    """Count LF + final kval pick: the sharded form of the kval invariant
    (toehold == SA[final hi], ops.rank.toehold_from_range).

    On the big (n >= 2^31) layout — no dense kval2 — this is the sharded
    trajectory postpass (engine.locate._toehold_trajectory): the count loop
    records each step's pre-step hi, BWT[hi] checks ride ONE owner
    all-reduce of [L, B] packed-word gathers (_mk_sym), and the single
    non-trivial ltk resolve runs on the replicated O(R) tables with no
    collective."""
    tb = tables
    L = qcodes.shape[1]
    big = sdx.kval2 is None and sdx.big_tables is not None
    rank = _mk_rank(mesh, sdx, tb)
    dt = tb["F"].dtype
    lens_ = lengths.to(dt)
    body = _lf_body(rank, tb["F"], qcodes, lens_, L)
    lo, hi, done = _start(sdx, qcodes, dt)
    if not big:
        for j in range(L):
            lo, hi, done = body(j, (lo, hi, done))
        k = _pos_pick(mesh, sdx, tb, "kval2", torch.clamp(hi, 0, sdx.n - 1)).to(dt)
        k = torch.where(hi < lo, 0, k)
        return lo, hi, k

    Bl = qcodes.shape[0]
    hi_rec = torch.zeros((L, Bl), dtype=dt, device=qcodes.device)
    for j in range(L):
        hi_rec[j] = hi
        lo, hi, done = body(j, (lo, hi, done))

    sym = _mk_sym(mesh, sdx, tb)(hi_rec.reshape(-1)).reshape(L, Bl)
    csteps = qcodes.flip(1).t().to(torch.int32)
    jidx = torch.arange(L, dtype=dt, device=qcodes.device)[:, None]
    nontriv = (jidx < lens_[None, :]) & (sym != csteps)
    t_star = torch.where(nontriv, jidx, -1).max(dim=0).values

    sl = tb["big_samples_last"]
    k0 = (sl[sdx.R - 1].to(dt) + 1) % sdx.n
    k_triv = (k0 - lens_) % sdx.n
    ts = torch.clamp(t_star, min=0)
    hi_ts = torch.gather(hi_rec, 0, ts[None, :])[0]
    c_ts = torch.gather(csteps, 0, ts[None, :])[0].to(dt)
    rs = tb["big_run_start"]
    r_ts = torch.searchsorted(rs, hi_ts.to(rs.dtype), right=True).to(dt) - 1
    keys = tb["big_cruns_keys"]
    q = (c_ts * sdx.R + r_ts).to(keys.dtype)
    jc = torch.searchsorted(keys, q, right=True).to(dt) - 1
    rr = keys[torch.clamp(jc, min=0)].to(dt) - c_ts * sdx.R
    k_at = sl[torch.clamp(rr, 0, sdx.R - 1)].to(dt)
    k_nt = (k_at - (lens_ - 1 - t_star)) % sdx.n
    k = torch.where(t_star < 0, k_triv, k_nt)
    k = torch.where(hi < lo, 0, k)
    return lo, hi, k


def locate_sharded_dense(mesh, sdx: ShardedDenseIndex, tables: dict, lo, hi, k,
                         max_hits: int):
    """Sharded phi walk: each hop is one owner-picked phi2 gather +
    all-reduce; on the big layout each hop is a search over the REPLICATED
    adjacency breakpoint table (ops.rank.phi_step "phi_at" semantics) —
    collective-free."""
    tb = tables
    big = sdx.phi2 is None and sdx.big_tables is not None
    dt = lo.dtype
    n_occ = torch.clamp(hi - lo + 1, 0, max_hits)
    locs = torch.full((lo.shape[0], max_hits), -1, dtype=dt, device=lo.device)
    locs[:, 0] = torch.where(n_occ > 0, k, -1)
    if big:
        pp, pa = tb["big_pred_pos"], tb["big_phi_at"]
        if "big_pp_off" in tb and sdx.pp_bs:
            shift, iters = sdx.pp_bs
            ppo = tb["big_pp_off"]

            def phi(cur):
                rk = (bucketed_lower_bound(pp, ppo, shift, iters, cur + 1) - 1).long()
                return (pa[rk].to(dt) + (cur - pp[rk].to(dt))) % sdx.n
        else:
            def phi(cur):
                rk = torch.searchsorted(pp, cur.to(pp.dtype), right=True) - 1
                return (pa[rk].to(dt) + (cur - pp[rk].to(dt))) % sdx.n
    else:
        def phi(cur):
            return _pos_pick(mesh, sdx, tb, "phi2", torch.clamp(cur, 0, sdx.n - 1)).to(dt)

    cur = k
    for j in range(1, max_hits):
        cur = phi(cur)
        locs[:, j] = torch.where(j < n_occ, cur, -1)
    return locs, n_occ


def find_ranges_w_markers_sharded_dense(mesh, sdx: ShardedDenseIndex, tables: dict,
                                        qcodes, lengths, wsize: int,
                                        max_range: int = 1 << 62, max_k: int = 32):
    """Sharded RowBowt::find_range_w_markers: the window loop records global
    (entry offset, count) pairs via ms2 owner picks; value expansion resolves
    each window's entry ids against the entry-sharded mv2 (one [B, max_k]
    all-reduce after the loop — not per step)."""
    tb = tables
    B, L = qcodes.shape
    W = L // wsize + 2
    rank = _mk_rank(mesh, sdx, tb)
    ms_at = _mk_ms_any(mesh, sdx, tb)
    dt = tb["F"].dtype
    F_ = tb["F"]
    dev = qcodes.device
    m = lengths.to(dt)
    mr = min(int(max_range), int(torch.iinfo(dt).max))

    lo, hi, _ = _start(sdx, qcodes, dt)
    too_short = m < wsize
    done = too_short
    window_ei = m
    # transposed [W, B] records
    ws = torch.zeros((W, B), dtype=dt, device=dev)
    wc = torch.zeros((W, B), dtype=dt, device=dev)
    nw = torch.zeros(B, dtype=dt, device=dev)

    def record(lo, hi, gate, nw):
        small = (hi - lo + 1) <= mr
        do = gate & small
        both = ms_at(torch.clamp(torch.cat([
            torch.where(do, lo, 0), torch.where(do, hi + 1, 0)]), 0, sdx.n))
        s, e = both[:B], both[B:]
        cnt = torch.where(do, torch.clamp(e - s, min=0), 0).to(dt)
        slot = torch.clamp(nw, max=W - 1)
        U.tslot_set(ws, slot, do, s.to(dt))
        U.tslot_set(wc, slot, do, cnt)
        return nw + do.to(dt)

    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j < m)
        both = rank(torch.cat([lo, hi + 1]), torch.cat([c, c]))
        cb = both[:B]
        ci = both[B:] - cb
        csafe = torch.clamp(c, min=0).long()
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        nlo = torch.where(empty, 1, nlo)
        nhi = torch.where(empty, 0, nhi)
        fail = active & empty
        nw = torch.where(fail, 0, nw)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | fail
        ok = active & ~empty
        trigger = ok & (window_ei - (m - j) >= wsize)
        nw = record(lo, hi, trigger, nw)
        window_ei = torch.where(trigger, m - j, window_ei)
    final = (~done) & (~too_short) & (hi >= lo) & ((m - 1) % wsize != 0)
    nw = record(lo, hi, final, nw)

    # value expansion against the entry-sharded mv2: per-slot entry ids
    # computed arithmetically, then ONE owner-pick all-reduce
    entry, valid, used, total = U.window_entry_ids(ws.t(), wc.t(), nw, max_k)
    vals = _mk_mv_any(mesh, sdx, tb)(entry, valid)
    buf = torch.where(valid, vals, -1)
    bad = done | too_short
    lo = torch.where(bad, 1, lo)
    hi = torch.where(bad, 0, hi)
    return lo, hi, buf, used, total > used


def markers_greedy_seeding_sharded_dense(mesh, sdx: ShardedDenseIndex, tables: dict,
                                         qcodes, lengths, wsize: int,
                                         max_range: int = 1 << 62, max_seeds: int = 8,
                                         max_k: int = 16, values: bool = True):
    """The PRODUCTION genotyping engine on the position-sharded layout:
    RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482) — rb_markers'
    workload — over an index too big for one device.

    The non-ftab state machine of engine.seeds.markers_greedy_seeding with
    the sharded primitives: 2 all-reduces per LF step (the [2B] rank, then
    the [2B] window/seed marker bounds — the probe targets depend on the
    step's ranks, so they cannot fuse), plus one [S*K, B] entry-value
    all-reduce at the end.

    Returns (slo, shi, sqs, sqe [B,S], mvals [B,S,K], mcnt [B,S], ns [B]);
    with values=False, mvals holds ma_val ENTRY IDS for host resolve.
    """
    tb = tables
    Bl, L = qcodes.shape
    S, K = max_seeds, max_k
    W = 2 * (L // max(wsize, 1)) + 4
    rank = _mk_rank(mesh, sdx, tb)
    ms_at = _mk_ms_any(mesh, sdx, tb)
    dt = tb["F"].dtype
    F_ = tb["F"]
    dev = qcodes.device
    m = lengths.to(dt)
    mr = min(int(max_range), int(torch.iinfo(dt).max))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    lo, hi, _ = _start(sdx, qcodes, dt)
    i = zeros(Bl)
    plo, phi_ = lo, hi
    seed_ei = m
    window_ei = m
    ws, wc, wseed = zeros(W, Bl), zeros(W, Bl), zeros(W, Bl)
    nrec = zeros(Bl)
    slo = torch.ones((S, Bl), dtype=dt, device=dev)
    shi, sqs, sqe = zeros(S, Bl), zeros(S, Bl), zeros(S, Bl)
    ns = zeros(Bl)
    qflat = qcodes.reshape(-1).to(dt)
    lane_base = torch.arange(Bl, dtype=dt, device=dev) * L

    def probe(go, tlo, thi, ns):
        """Record the window/seed probe of (tlo, thi) where go: one [2B]
        marker-bounds all-reduce."""
        both_ms = ms_at(torch.clamp(torch.cat([
            torch.where(go, tlo, 0), torch.where(go, thi + 1, 0)]), 0, sdx.n))
        s_ = both_ms[:Bl]
        cnt = torch.where(go, torch.clamp(both_ms[Bl:] - s_, min=0), 0).to(dt)
        slot_r = torch.clamp(nrec, max=W - 1)
        U.tslot_set(ws, slot_r, go, s_.to(dt))
        U.tslot_set(wc, slot_r, go, cnt)
        U.tslot_set(wseed, slot_r, go, ns)
        return nrec + go.to(dt)

    def put(rec, plo, phi_, qs, qe):
        slot = torch.clamp(ns, max=S - 1)
        U.tslot_set(slo, slot, rec, plo)
        U.tslot_set(shi, slot, rec, phi_)
        U.tslot_set(sqs, slot, rec, qs)
        U.tslot_set(sqe, slot, rec, qe)

    for _ in range(L):
        active = i < m
        col = torch.clamp(L - 1 - i, 0, L - 1)
        c = qflat[(lane_base + col).long()]
        # LF: one concatenated [2B] rank all-reduce (same shape as _lf_body)
        both = rank(torch.cat([lo, hi + 1]), torch.cat([c, c]))
        cb = both[:Bl]
        ci = both[Bl:] - cb
        csafe = torch.clamp(c, min=0).long()
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        nlo = torch.where(empty, 1, nlo)
        nhi = torch.where(empty, 0, nhi)

        ok = active & ~empty
        fail = active & empty
        # success: window probe; failure: seed-final probe of prev
        w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
        f_probe = fail & (seed_ei - (m - i) >= wsize)
        tlo = torch.where(fail, plo, nlo)
        thi = torch.where(fail, phi_, nhi)
        go = (w_trigger | f_probe) & ((thi - tlo + 1) <= mr)
        nrec = probe(go, tlo, thi, ns)
        window_ei = torch.where(w_trigger, m - i - 1, window_ei)

        put(fail & (ns < S), plo, phi_, m - i, seed_ei - 1)
        ns = ns + fail.to(dt)
        seed_ei = torch.where(fail, m - i - 1, seed_ei)
        window_ei = torch.where(fail, m - i - 1, window_ei)
        lo = torch.where(ok, nlo, torch.where(fail, 0, lo))
        hi = torch.where(ok, nhi, torch.where(fail, sdx.n - 1, hi))
        plo = torch.where(ok, nlo, torch.where(fail, 0, plo))
        phi_ = torch.where(ok, nhi, torch.where(fail, sdx.n - 1, phi_))
        i = torch.where(active, i + 1, i)

    # final emission (rowbowt.hpp:477-481)
    nonempty = hi >= lo
    f_probe = nonempty & (seed_ei - (m - i) >= wsize)
    go = f_probe & ((hi - lo + 1) <= mr)
    nrec = probe(go, lo, hi, ns)
    emit = m > 0
    put(emit & (ns < S), lo, hi, m - i, seed_ei - 1)
    ns = ns + emit.to(dt)

    # chronological per-seed append replay (the replicated engine's), then
    # ONE entry-sharded value all-reduce
    eflat = zeros(S * K, Bl)
    evalid = torch.zeros((S * K, Bl), dtype=torch.bool, device=dev)
    used_s = zeros(S, Bl)
    mcnt = zeros(S, Bl)
    col_s = (torch.arange(S * K, dtype=dt, device=dev) // K)[:, None]
    col_k = (torch.arange(S * K, dtype=dt, device=dev) % K)[:, None]
    for w in range(W):
        live = (w < nrec) & (wseed[w] < S)
        sl = torch.clamp(wseed[w], 0, S - 1)
        cnt = torch.where(live, wc[w], 0)
        u = U.tslot_get(used_s, sl)
        src = col_k - u[None, :]
        take = ((src >= 0) & (src < torch.clamp(cnt, max=K)[None, :])
                & live[None, :] & (col_s == sl[None, :]))
        eflat = torch.where(take, ws[w][None, :] + torch.clamp(src, 0, K - 1), eflat)
        evalid = evalid | take
        U.tslot_set(used_s, sl, live, torch.clamp(u + cnt, max=K))
        U.tslot_set(mcnt, sl, live, U.tslot_get(mcnt, sl) + cnt)
    if values:
        vals = _mk_mv_any(mesh, sdx, tb)(eflat, evalid)
        mvals = torch.where(evalid, vals, -1)
    else:
        mvals = torch.where(evalid, eflat.to(torch.int64), -1)
    mvals = mvals.reshape(S, K, Bl).permute(2, 0, 1)
    return (slo.t(), shi.t(), sqs.t(), sqe.t(), mvals, mcnt.t(), ns)
