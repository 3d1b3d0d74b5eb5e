"""Sharded-index query engines: run tables partitioned along R over the
'idx' axis of the mesh, for panel indexes whose tables exceed one device.

The counterpart of rowbowt_tpu/parallel/sharded.py; ShardedIndex.build is
its numpy, copied.  Layout: shard s owns a contiguous slice of runs and
therefore the contiguous BWT position interval [bounds[s], bounds[s+1]).  A
rank(i, c) query runs the same local searchsorted on every shard; only the
owner's contribution survives the sum over 'idx' (Mesh.psum_idx, an
all_reduce).  One LF step = 2 ranks = 2 all-reduces.  The toehold tables
(samples_last, ltk) shard the same way; the phi predecessor array (pred_pos,
sorted text positions) shards contiguously in VALUE order, so a global
predecessor rank is the sum of local counts.

Each rank holds its own dp rows (replicated over 'idx') and this shard's
tables; the engines take and return this rank's rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rowbowt_tpu_torch.index import RbtIndex


@dataclasses.dataclass
class ShardedIndex:
    """Host-side container of the R-sharded tables + replicated scalars."""

    run_start: np.ndarray  # int[R_pad]  (padded with n so pads own nothing)
    run_head: np.ndarray  # int32[R_pad]
    occ: np.ndarray  # int[A, R_pad]
    F: np.ndarray  # int[A+1]
    bounds: np.ndarray  # int[n_idx+1]: first owned BWT position per shard
    n: int
    A: int
    n_idx: int
    R: int
    # --- locate support (None without SA samples) ---
    samples_last: np.ndarray | None = None  # int[R_pad], BWT run order
    ltk: np.ndarray | None = None  # int[A, R_pad]
    pred_pos: np.ndarray | None = None  # int[R_pad] sorted text positions (pad n)
    pred_to_run: np.ndarray | None = None  # int[R_pad]

    @staticmethod
    def build(idx: RbtIndex, n_idx: int) -> "ShardedIndex":
        dt = idx.idx_dtype
        R = idx.R
        R_pad = ((R + n_idx - 1) // n_idx) * n_idx
        rs = np.full(R_pad, idx.n, dtype=dt)
        rs[:R] = idx.run_start
        head = np.zeros(R_pad, dtype=np.int32)
        head[:R] = idx.run_head
        occ = np.zeros((idx.A, R_pad), dtype=dt)
        occ[:, :R] = idx.occ
        per = R_pad // n_idx
        bounds = np.empty(n_idx + 1, dtype=dt)
        for s in range(n_idx):
            r0 = s * per
            bounds[s] = rs[r0] if r0 < R else idx.n
        bounds[n_idx] = idx.n
        sl = ltk = pp = pr = None
        if idx.samples_last is not None:
            sl = np.zeros(R_pad, dtype=dt)
            sl[:R] = idx.samples_last
            ltk = np.zeros((idx.A, R_pad), dtype=dt)
            ltk[:, :R] = idx.ltk
            pp = np.full(R_pad, idx.n, dtype=dt)  # pad beyond any query pos
            pp[:R] = idx.pred_pos
            pr = np.zeros(R_pad, dtype=dt)
            pr[:R] = idx.pred_to_run
        return ShardedIndex(
            run_start=rs, run_head=head, occ=occ,
            F=idx.F.astype(dt), bounds=bounds,
            n=idx.n, A=idx.A, n_idx=n_idx, R=R,
            samples_last=sl, ltk=ltk, pred_pos=pp, pred_to_run=pr,
        )

    def device_put(self, mesh) -> dict:
        """This rank's slice of every R-sharded table (shard mesh.idx) and
        the replicated F and bounds, on the mesh's device."""
        if mesh.n_idx != self.n_idx:
            raise ValueError(f"index built for n_idx = {self.n_idx}, mesh has {mesh.n_idx}")
        per = self.run_start.shape[0] // self.n_idx
        cols = slice(mesh.idx * per, (mesh.idx + 1) * per)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

        d = {
            "run_start": put(self.run_start[cols]),
            "run_head": put(self.run_head[cols]),
            "occ": put(self.occ[:, cols]),
            "F": put(self.F),
            "bounds": put(self.bounds),
        }
        if self.samples_last is not None:
            d["samples_last"] = put(self.samples_last[cols])
            d["ltk"] = put(self.ltk[:, cols])
            d["pred_pos"] = put(self.pred_pos[cols])
            d["pred_to_run"] = put(self.pred_to_run[cols])
        return d


def _owner_pick(mesh, local_vals, owner):
    """Every shard computes a candidate; only the owner's survives the sum."""
    return mesh.psum_idx(torch.where(owner, local_vals, 0))


def _mk_rank(mesh, sidx: ShardedIndex, tb):
    """The R-sharded rank(i, c) closure and its local run lookup."""
    n = sidx.n
    my = mesh.idx
    lo_own, hi_own = int(sidx.bounds[my]), int(sidx.bounds[my + 1])
    rs_loc = tb["run_start"]
    Rloc = rs_loc.shape[0]
    occ_flat = tb["occ"].reshape(-1)
    F_ = tb["F"]

    def local_run_of(i):
        isafe = torch.clamp(i, max=n - 1)
        r = torch.searchsorted(rs_loc, isafe.to(rs_loc.dtype), right=True).to(i.dtype) - 1
        return torch.clamp(r, 0, Rloc - 1).long()

    def rank_(i, c):
        csafe = torch.clamp(c, min=0).long()
        owner = (i >= lo_own) & (i < hi_own)
        rsafe = local_run_of(i)
        v = occ_flat[csafe * Rloc + rsafe]
        v = v + torch.where(tb["run_head"][rsafe] == c, i - rs_loc[rsafe], 0)
        v = _owner_pick(mesh, v, owner)
        total = F_[csafe + 1] - F_[csafe]
        v = torch.where(i >= n, total, v)
        return torch.where(c < 0, 0, v)

    return rank_, local_run_of, (lo_own, hi_own)


def find_ranges_sharded(mesh, sidx: ShardedIndex, tables: dict, qcodes, lengths):
    """Batched count over the R-sharded index.  qcodes [B, L] right-aligned
    (this rank's dp rows); returns (lo [B], hi [B]) with (1,0) empty
    encoding.  Two all-reduces a step."""
    n = sidx.n
    B, L = qcodes.shape
    rank_, _, _ = _mk_rank(mesh, sidx, tables)
    F_ = tables["F"]
    dt = tables["run_start"].dtype
    dev = qcodes.device
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), n - 1, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lens_ = lengths.to(dt)
    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j < lens_)
        cb = rank_(lo, c)
        ci = rank_(hi + 1, c) - cb
        csafe = torch.clamp(c, min=0).long()
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        nlo = torch.where(empty, 1, nlo)
        nhi = torch.where(empty, 0, nhi)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & empty)
    return lo, hi


def find_ranges_w_toehold_sharded(mesh, sidx: ShardedIndex, tables: dict, qcodes, lengths):
    """Batched toehold search over the R-sharded index (LF_w_loc with the
    trivial-case check and ltk lookup resolved by the owning shard): four
    all-reduces a step."""
    n, R = sidx.n, sidx.R
    B, L = qcodes.shape
    tb = tables
    my = mesh.idx
    rank_, local_run_of, (lo_own, hi_own) = _mk_rank(mesh, sidx, tb)
    rs_loc = tb["run_start"]
    dt = rs_loc.dtype
    Rloc = rs_loc.shape[0]
    ltk_flat = tb["ltk"].reshape(-1)
    F_ = tb["F"]
    dev = qcodes.device

    # samples_last[R-1] lives on the shard owning run R-1
    last_owner = (R - 1) // Rloc == my
    k0 = mesh.psum_idx(torch.where(torch.tensor([last_owner], device=dev),
                                   tb["samples_last"][(R - 1) % Rloc].reshape(1), 0))
    k0 = (k0 + 1) % n

    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), n - 1, dtype=dt, device=dev)
    k = k0.expand(B).clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lens_ = lengths.to(dt)
    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j < lens_)
        csafe = torch.clamp(c, min=0).long()
        cb = rank_(lo, c)
        ci = rank_(hi + 1, c) - cb
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        # toehold update: owner of position hi answers trivial + ltk
        owner_hi = (hi >= lo_own) & (hi < hi_own)
        r_hi = local_run_of(hi)
        trivial_l = owner_hi & (tb["run_head"][r_hi] == c)
        trivial = mesh.psum_idx(trivial_l.to(dt)) > 0
        ltk_v = _owner_pick(mesh, ltk_flat[csafe * Rloc + r_hi], owner_hi)
        nk = torch.where(trivial, torch.where(k == 0, n - 1, k - 1), ltk_v)
        nlo = torch.where(empty, 1, nlo)
        nhi = torch.where(empty, 0, nhi)
        nk = torch.where(empty, 0, nk)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        k = torch.where(active, nk, k)
        done = done | (active & empty)
    k = torch.where(hi < lo, 0, k)
    return lo, hi, k


def locate_sharded(mesh, sidx: ShardedIndex, tables: dict, lo, hi, k, max_hits: int):
    """Sharded phi walk (ToeholdSA::locate_range): pred rank as the sum of
    local counts, pred/sample lookups via owner shards; four all-reduces a
    hop."""
    n, R = sidx.n, sidx.R
    tb = tables
    dt = lo.dtype
    pp = tb["pred_pos"]
    Rloc = pp.shape[0]
    r0 = mesh.idx * Rloc

    def phi(i):
        # global predecessor rank: sum of local counts < i
        rk_l = torch.searchsorted(pp, i.to(pp.dtype), right=False).to(dt)
        rk = mesh.psum_idx(rk_l)
        jr = torch.where(rk == 0, R - 1, rk - 1)
        local = jr - r0
        owner = (local >= 0) & (local < Rloc)
        lsafe = torch.clamp(local, 0, Rloc - 1).long()
        j = _owner_pick(mesh, pp[lsafe], owner)
        run_id = _owner_pick(mesh, tb["pred_to_run"][lsafe], owner)
        delta = torch.where(j < i, i - j, i + 1)
        # samples_last[run_id - 1] via its owner
        plocal = run_id - 1 - r0
        powner = (plocal >= 0) & (plocal < Rloc)
        psafe = torch.clamp(plocal, 0, Rloc - 1).long()
        prev_sample = _owner_pick(mesh, tb["samples_last"][psafe], powner)
        return (prev_sample + delta) % n

    B = lo.shape[0]
    n_occ = torch.clamp(hi - lo + 1, 0, max_hits)
    locs = torch.full((B, max_hits), -1, dtype=dt, device=lo.device)
    locs[:, 0] = torch.where(n_occ > 0, k, -1)
    cur = k
    for j in range(1, max_hits):
        cur = phi(cur)
        locs[:, j] = torch.where(j < n_occ, cur, -1)
    return locs, n_occ
