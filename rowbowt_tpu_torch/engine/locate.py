"""Batched toehold locate.

The counterpart of rowbowt_tpu/engine/locate.py.  find_ranges_w_toehold ==
RowBowt::find_range_w_toehold (rowbowt.hpp:167-184) on indexes built with the
full SA: the loop is the plain count LF (K1 on a CUDA device) and the toehold
is one kval gather of the final range.  locate() is the phi walk
(ToeholdSA::locate_range, toehold_sa.hpp:37-49) across lanes to a fixed
max_hits, toehold first then the phi chain; locate_ragged buckets lanes by
range size on the host so one huge range does not widen every lane.
find_ranges_w_toehold_chkpnts records the search state every wsize chars,
and find_locs is the whole-read search plus the phi walk.
"""

from __future__ import annotations

import numpy as np
import torch

from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops import update as U


def find_ranges_w_toehold(tx: TorchIndex, qcodes, lengths):
    """Returns (lo, hi, toehold) per lane; empty -> (1, 0, 0) like the reference.

    By the invariant k == SA[hi] the toehold is a function of the final range,
    so the loop is the count LF without the ftab start and the toehold is one
    kval gather at the end (ops/rank.toehold_from_range)."""
    arr = tx.arrays
    if "kval" in arr:
        lo, hi = find_ranges(tx, qcodes, lengths, use_ftab=False)
        return lo, hi, R.toehold_from_range(tx, lo, hi)
    if "cruns_keys" in arr:
        raise NotImplementedError(
            "the trajectory toehold of big (n >= 2^31) indexes is ROADMAP M6")
    raise NotImplementedError(
        "the per-step run-space or occ1 toehold (indexes without kval) is ROADMAP M5")


def locate(tx: TorchIndex, lo, hi, k, max_hits: int):
    """Phi walk: locs [B, max_hits] (pad -1), count [B] = min(range size,
    max_hits).  Order matches the reference: toehold first, then the phi chain."""
    B = lo.shape[0]
    n_occ = torch.clamp(hi - lo + 1, 0, max_hits)
    locs = torch.full((B, max_hits), -1, dtype=lo.dtype, device=lo.device)
    locs[:, 0] = torch.where(n_occ > 0, k, -1)
    cur = k
    for j in range(1, max_hits):
        cur = R.phi_step(tx, cur)
        locs[:, j] = torch.where(j < n_occ, cur, -1)
    return locs, n_occ


def _pow2_at_least(x: int, floor: int) -> int:
    v = floor
    while v < x:
        v <<= 1
    return v


def locate_ragged(tx: TorchIndex, lo, hi, k, max_hits: int | None = None):
    """Ragged phi walk: O(total hits) output, not O(B * max range).

    Lanes are bucketed on the host by range size (pow2 widths of at least 4,
    pow2-padded lane counts of at least 8) and each bucket is phi-walked on
    tx.device at its own width.  Returns (flat [total] int64 positions,
    offsets [B+1]) as numpy arrays: lane b's occurrences, toehold first then
    the phi chain, are flat[offsets[b]:offsets[b+1]]."""
    lo_h = lo.cpu().numpy()
    hi_h = hi.cpu().numpy()
    k_h = k.cpu().numpy()
    B = lo_h.shape[0]
    sizes = np.where(hi_h >= lo_h, hi_h - lo_h + 1, 0).astype(np.int64)
    if max_hits is not None:
        sizes = np.minimum(sizes, max_hits)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    flat = np.full(int(offsets[-1]), -1, dtype=np.int64)
    if offsets[-1] == 0:
        return flat, offsets

    buckets = np.zeros(B, dtype=np.int64)
    nz = sizes > 0
    buckets[nz] = 1 << np.maximum(np.ceil(np.log2(sizes[nz])).astype(np.int64), 2)
    dt = lo_h.dtype
    for w in np.unique(buckets[nz]):
        lanes = np.flatnonzero(buckets == w)
        P = _pow2_at_least(len(lanes), 8)
        blo = np.ones(P, dtype=dt)
        bhi = np.zeros(P, dtype=dt)
        bk = np.zeros(P, dtype=dt)
        blo[: len(lanes)] = lo_h[lanes]
        bhi[: len(lanes)] = hi_h[lanes]
        bk[: len(lanes)] = k_h[lanes]
        locs, _ = locate(tx, *(torch.from_numpy(a).to(tx.device) for a in (blo, bhi, bk)),
                         max_hits=int(w))
        locs = locs.cpu().numpy()[: len(lanes)]
        mask = np.arange(int(w), dtype=np.int64)[None, :] < sizes[lanes][:, None]
        dest = (offsets[lanes][:, None] + np.arange(int(w), dtype=np.int64)[None, :])[mask]
        flat[dest] = locs[mask]
    return flat, offsets


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
    reference clears the vector, rowbowt.hpp:586-589).  The loop is the plain
    LF; every checkpoint's toehold is one kval gather afterwards.
    """
    from rowbowt_tpu_torch.engine.seeds import _toehold_by_kval

    _toehold_by_kval(tx, "find_ranges_w_toehold_chkpnts")
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
    lf = R.lf_step_auto(tx)

    def put(rec, lo, hi, qs, qe):
        slot = torch.clamp(ncp, max=C - 1)
        for arr, v in ((clo, lo), (chi, hi), (cqs, qs), (cqe, qe)):
            U.tslot_set(arr, slot, rec, v)

    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~failed) & (j < m)
        nlo, nhi = lf(tx, lo, hi, c)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        lo = torch.where(ok, nlo, lo)
        hi = torch.where(ok, nhi, hi)
        failed = failed | fail
        # checkpoint trigger (rowbowt.hpp:595-600): window_ei-(m-i) >= wsize
        trig = ok & (window_ei - (m - j) >= wsize)
        put(trig & (ncp < C), lo, hi, m - j, window_ei)
        ncp = ncp + trig.to(dt)
        window_ei = torch.where(trig, m - j, window_ei)
    # final push (rowbowt.hpp:604-608)
    fin = (~failed) & (hi >= lo) & ((m - 1) % wsize != 0) & (m > 0)
    put(fin & (ncp < C), lo, hi, 0, m)
    ncp = ncp + fin.to(dt)
    ncp = torch.where(failed, 0, ncp)
    clo, chi = clo.t(), chi.t()
    return clo, chi, R.toehold_from_range(tx, clo, chi), cqs.t(), cqe.t(), ncp


def find_locs(tx: TorchIndex, qcodes, lengths, max_hits: int):
    """Batched RowBowt::find_locs (rowbowt.hpp:627-631): whole-read toehold
    search (K1 on a CUDA device) and the phi walk in one call."""
    lo, hi, k = find_ranges_w_toehold(tx, qcodes, lengths)
    locs, cnt = locate(tx, lo, hi, k, max_hits=max_hits)
    return lo, hi, locs, cnt
