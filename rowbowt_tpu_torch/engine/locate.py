"""Batched toehold locate.

The counterpart of rowbowt_tpu/engine/locate.py.  find_ranges_w_toehold ==
RowBowt::find_range_w_toehold (rowbowt.hpp:167-184) on indexes built with the
full SA: the loop is the plain count LF (K1 on a CUDA device) and the toehold
is one kval gather of the final range.  locate() is the phi walk
(ToeholdSA::locate_range, toehold_sa.hpp:37-49) across lanes to a fixed
max_hits, toehold first then the phi chain; locate_ragged walks each lane
to its own range size, so one huge range does not widen every lane.  Both
are one ops/cuda_phi.phi_walk: the walk kernel on a CUDA device over phi1,
a BigIndex's phi rows or breakpoint table phi_at, or the predecessor search
over the run-start samples; locate_ragged on an index whose kval is the
full SA reads kval[hi - j] with no chain (the kval kernel).
find_ranges_w_toehold_chkpnts records the search state every wsize chars,
and find_locs is the whole-read search plus the phi walk.

A big (n >= 2^31) index has no kval: its toehold comes from the trajectory
of the search (traj_nontrivial, traj_resolve_toehold), a resolve over its
O(R) run tables after a count search that records each step's hi: on a CUDA
device K1's record launch over the two-level rows, which raises rather than
fall back to the torch loop; on the CPU that loop.  An index built from run
samples alone (a raw `.bwt/.ssa/.esa` or `.rbwt` build, or `--no-dense`) has
no kval either: the toehold rides through the search step by step
(RowBowt::LF_w_loc, rowbowt.hpp:553-573), from tk1 when it is resident, else
from ltk.  On a CUDA device over fused rows that search is K1's toehold
launch (ops/cuda_lf.find_ranges_toehold), over an index without fused
rows (`--no-dense`, more than 8 codes) the tables kernel's toehold
instance; each raises rather than fall back.  On the CPU it is the torch
loop of lf_step_w_loc_occ1 or lf_step_w_loc
(cuda_lf.find_ranges_toehold_plain).  The loops still torch on every device
are the checkpointed search (find_ranges_w_toehold_chkpnts) and the
sampled seeding (engine/seeds.seeds_greedy_w_sample).
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf, cuda_phi
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops import update as U


def find_ranges_w_toehold(tx: TorchIndex, qcodes, lengths):
    """Returns (lo, hi, toehold) per lane; empty -> (1, 0, 0) like the reference.

    By the invariant k == SA[hi] the toehold is a function of the final range,
    so on a full-SA index the loop is the count LF without the ftab start and
    the toehold is one kval gather at the end (ops/rank.toehold_from_range).
    On a big index it is the trajectory resolve (_toehold_trajectory); on an
    index built from run samples alone, the per-step toehold search
    (ops/cuda_lf.find_ranges_toehold: K1's toehold launch on the card over
    fused rows, else the tables kernel's; the torch loop on the CPU)."""
    from rowbowt_tpu_torch.engine.seeds import _toehold_by_kval

    mode = _toehold_by_kval(tx, "find_ranges_w_toehold")
    if mode == "kval":
        lo, hi = find_ranges(tx, qcodes, lengths, use_ftab=False)
        return lo, hi, R.toehold_from_range(tx, lo, hi)
    if mode == "trajectory":
        return _toehold_trajectory(tx, qcodes, lengths)
    return cuda_lf.find_ranges_toehold(tx, qcodes, lengths)


def traj_nontrivial(tx: TorchIndex, hi_rec, csteps, m):
    """[L, B] mask: step j was a NON-trivial LF_w_loc step (BWT[hi] != c,
    rowbowt.hpp:559-571), from one packed-word gather per step and lane."""
    L = hi_rec.shape[0]
    sym = R.bwt_sym(tx, hi_rec.reshape(-1)).reshape(hi_rec.shape)
    jidx = torch.arange(L, dtype=m.dtype, device=m.device)[:, None]
    return (jidx < m[None, :]) & (sym != csteps)


def traj_resolve_toehold(tx: TorchIndex, hi_rec, csteps, nontriv, a, b):
    """Toehold k = SA[hi after step b] for a search SPAN of steps [a, b]
    (inclusive), restarted from the full range at step a: the O(R)
    trajectory resolve of whole-read search (a = 0), per-seed greedy spans
    and checkpoints.

    hi_rec / csteps / nontriv are the [L, B] step records (pre-step hi, the
    code of each step, non-trivial steps); a, b are [K, B] step indices.
    The last non-trivial step t* of the span takes its k from samples_last
    of the last c-run at or before run_of(hi_t*) (two searchsorteds: run_of
    over big_run_start, the ltk resolve over cruns_keys); every later step
    is trivial and takes 1 from k mod n (rowbowt.hpp:557-558); a span with no
    non-trivial step starts from k0 = SA[n-1].  b < a (empty span) resolves
    to k0.  Returns k [K, B] int64; the caller masks failed lanes."""
    dt = torch.int64
    L = hi_rec.shape[0]
    dev = hi_rec.device
    jidx = torch.arange(L, dtype=dt, device=dev)[:, None]
    # prefix max: the last nontrivial step at or before each step
    lastnt = torch.cummax(torch.where(nontriv, jidx, -1), dim=0).values
    bc = torch.clamp(b, 0, L - 1)
    lnt = torch.gather(lastnt, 0, bc)
    t_star = torch.where((b >= a) & (lnt >= a), lnt, -1)

    sl = tx.arrays["samples_last"]
    k0 = (sl[tx.R - 1].to(dt) + 1) % tx.n
    steps_total = torch.clamp(b - a + 1, min=0)
    k_triv = (k0 - steps_total) % tx.n

    ts = torch.clamp(t_star, 0, L - 1)
    hi_ts = torch.gather(hi_rec, 0, ts)
    c_ts = torch.gather(csteps, 0, ts).to(dt)
    rs = tx.arrays["big_run_start"]
    r_ts = torch.searchsorted(rs, hi_ts.to(rs.dtype), right=True).to(dt) - 1
    keys = tx.arrays["cruns_keys"]
    q = (c_ts * tx.R + r_ts).to(keys.dtype)
    jc = torch.searchsorted(keys, q, right=True).to(dt) - 1
    rr = keys[torch.clamp(jc, min=0)].to(dt) - c_ts * tx.R
    k_at = sl[torch.clamp(rr, 0, tx.R - 1)].to(dt)
    k_nt = (k_at - (b - t_star)) % tx.n
    return torch.where(t_star < 0, k_triv, k_nt)


def span_toeholds(tx: TorchIndex, qcodes, hi_rec, m, a, b):
    """traj_resolve_toehold of the spans [a, b] ([K, B]) of the searches of
    the right-aligned qcodes, whose pre-step hi of every step is hi_rec."""
    csteps = qcodes.flip(1).t().to(torch.int32)  # [L, B]: the code step j reads
    return traj_resolve_toehold(tx, hi_rec, csteps, traj_nontrivial(tx, hi_rec, csteps, m), a, b)


def _toehold_trajectory(tx: TorchIndex, qcodes, lengths):
    """Toehold by trajectory postpass, the big-index (n >= 2^31) path: the
    count search over the two-level rows, which records each step's
    pre-step hi ([L, B]; ops/cuda_lf.find_ranges_record: the record launch
    of K1 on a CUDA device, the plain torch loop on the CPU), then the
    resolve of traj_resolve_toehold over the whole read."""
    B = qcodes.shape[0]
    dt = torch.int64
    m = lengths.to(dt)
    lo, hi, hi_rec = cuda_lf.find_ranges_record(tx, qcodes, lengths)
    k = span_toeholds(tx, qcodes, hi_rec, m, torch.zeros((1, B), dtype=dt, device=m.device),
                      (m - 1)[None, :])[0]
    return lo, hi, torch.where(hi < lo, 0, k)


def locate(tx: TorchIndex, lo, hi, k, max_hits: int):
    """Phi walk: locs [B, max_hits] (pad -1), count [B] = min(range size,
    max_hits).  Order matches the reference: toehold first, then the phi
    chain.  One ops/cuda_phi.phi_walk over lane b's row b * max_hits."""
    B = lo.shape[0]
    n_occ = torch.clamp(hi - lo + 1, 0, max_hits)
    out = torch.full((B * max_hits,), -1, dtype=torch.int64, device=lo.device)
    off = torch.arange(B, dtype=torch.int64, device=lo.device) * max_hits
    cuda_phi.phi_walk(tx, k, n_occ.to(torch.int64), off, out)
    return out.view(B, max_hits).to(lo.dtype), n_occ


def locate_ragged(tx: TorchIndex, lo, hi, k, max_hits: int | None = None):
    """Ragged phi walk: O(total hits) output, not O(B * max range).

    Lane b's size is its range size, capped at max_hits; the offsets are the
    sizes' running sum, and one ops/cuda_phi.phi_walk fills every lane's
    segment on tx.device.  k is each range's toehold (find_ranges_w_toehold's):
    on an index with kval that is kval[hi] (the invariant k == SA[hi]), so
    the walk is handed hi and, where kval is the full SA, reads kval[hi - j]
    with no chain (cuda_phi's kval route); elsewhere it walks the chain from
    k.  Returns (flat [total] int64
    positions, offsets [B+1]) as numpy arrays: lane b's occurrences, toehold
    first then the phi chain, are flat[offsets[b]:offsets[b+1]]."""
    B = lo.shape[0]
    size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
    if max_hits is not None:
        size = torch.clamp(size, max=max_hits)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=lo.device)
    offsets[1:] = torch.cumsum(size, 0)
    flat = torch.empty(int(offsets[-1]), dtype=torch.int64, device=lo.device)
    if flat.numel():
        cuda_phi.phi_walk(tx, k, size, offsets[:-1], flat, hi)
    return flat.cpu().numpy(), offsets.cpu().numpy()


def resolve_docs(tx: TorchIndex, locs):
    """Batched DocList resolve: (doc id, offset in the doc) per text position."""
    d = R.doc_of(tx, locs)
    return d, locs - tx.arrays["doc_starts"][torch.clamp(d, min=0).long()]


def find_ranges_w_toehold_chkpnts(tx: TorchIndex, qcodes, lengths, wsize: int):
    """Batched RowBowt::find_range_w_toehold_chkpnts (rowbowt.hpp:575-611):
    record the (range, toehold) state every wsize characters along the
    backward search.

    Returns (clo, chi, ck, cqs, cqe) [B, C] and ncp [B] with C = L//wsize + 1.
    Checkpoint j of lane b covers query span [cqs, cqe) with BWT range
    (clo, chi) and toehold ck.  A failed full-read search returns ncp=0 (the
    reference clears the vector, rowbowt.hpp:586-589).  On a full-SA index
    the loop is the plain LF and every checkpoint's toehold is one kval
    gather afterwards; on a big index it is the trajectory resolve of the
    prefix span [0, its last step]; on an index built from run samples alone
    the loop carries the toehold (lf_step_w_loc or lf_step_w_loc_occ1) and a
    checkpoint records it.
    """
    from rowbowt_tpu_torch.engine.seeds import _toehold_by_kval, _w_loc_step

    mode = _toehold_by_kval(tx, "find_ranges_w_toehold_chkpnts")
    big = mode == "trajectory"
    per_step = mode == "per_step"
    B, L = qcodes.shape
    C = L // wsize + 1
    dt = tx.idx_dtype
    dev = qcodes.device
    m = lengths.to(dt)
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    window_ei = m
    clo = torch.ones((C, B), dtype=dt, device=dev)
    chi = torch.zeros((C, B), dtype=dt, device=dev)
    cqs = torch.zeros((C, B), dtype=dt, device=dev)
    cqe = torch.zeros((C, B), dtype=dt, device=dev)
    ncp = torch.zeros(B, dtype=dt, device=dev)
    # big index: each checkpoint's last step and the pre-step hi of every step
    cb = torch.zeros((C, B), dtype=dt, device=dev) if big else None
    hi_rec = torch.zeros((L, B), dtype=dt, device=dev) if big else None
    # per-step toehold: the toehold rides in the loop and each checkpoint
    # records it
    ck = torch.zeros((C, B), dtype=dt, device=dev) if per_step else None
    if per_step:
        k0 = ((tx.arrays["samples_last"][tx.R - 1] + 1) % tx.n).to(dt)
        k = k0.expand(B).clone()
        step = _w_loc_step(tx)
    else:
        k = None
        lf = R.lf_step_auto(tx)

    def put(rec, lo, hi, qs, qe, last, k):
        slot = torch.clamp(ncp, max=C - 1)
        for arr, v in ((clo, lo), (chi, hi), (cqs, qs), (cqe, qe), (cb, last), (ck, k)):
            if arr is not None:
                U.tslot_set(arr, slot, rec, v)

    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~failed) & (j < m)
        if big:
            hi_rec[j] = hi
        if per_step:
            nlo, nhi, nk = step(tx, lo, hi, c, k)
        else:
            nlo, nhi = lf(tx, lo, hi, c)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        lo = torch.where(ok, nlo, lo)
        hi = torch.where(ok, nhi, hi)
        if per_step:
            k = torch.where(ok, nk, k)
        failed = failed | fail
        # checkpoint trigger (rowbowt.hpp:595-600): window_ei-(m-i) >= wsize
        trig = ok & (window_ei - (m - j) >= wsize)
        put(trig & (ncp < C), lo, hi, m - j, window_ei, j, k)
        ncp = ncp + trig.to(dt)
        window_ei = torch.where(trig, m - j, window_ei)
    # final push (rowbowt.hpp:604-608)
    fin = (~failed) & (hi >= lo) & ((m - 1) % wsize != 0) & (m > 0)
    put(fin & (ncp < C), lo, hi, 0, m, m - 1, k)
    ncp = ncp + fin.to(dt)
    ncp = torch.where(failed, 0, ncp)
    if big:
        # each checkpoint is a prefix of the one search (no restarts): span
        # [0, its last step], resolved from the step records
        ck = span_toeholds(tx, qcodes, hi_rec, m, torch.zeros_like(cb), cb)
        ck = torch.where(chi < clo, 0, ck).t()
    elif per_step:
        ck = ck.t()
    clo, chi = clo.t(), chi.t()
    if mode == "kval":
        ck = R.toehold_from_range(tx, clo, chi)
    return clo, chi, ck, cqs.t(), cqe.t(), ncp


def find_locs(tx: TorchIndex, qcodes, lengths, max_hits: int):
    """Batched RowBowt::find_locs (rowbowt.hpp:627-631): whole-read toehold
    search (K1 on a CUDA device) and the phi walk in one call."""
    lo, hi, k = find_ranges_w_toehold(tx, qcodes, lengths)
    locs, cnt = locate(tx, lo, hi, k, max_hits=max_hits)
    return lo, hi, locs, cnt
