"""Batched marker queries.

The counterpart of rowbowt_tpu/engine/markers.py.  find_ranges_w_markers ==
RowBowt::find_range_w_markers (rowbowt.hpp:292-339) in lockstep: the per-read
window bookkeeping (window_ei, the max_range gate and the final
(m-1)%wsize re-query quirk) becomes mask arithmetic inside the LF loop, and
markers fill a fixed [B, K] buffer from the RIGHT so that reading the filled
tail left to right gives the reference's front-insertion order (newest window
first, CSR row order within a window).  markers_for_ranges is the rb_align -m
path.
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops import update as U


def find_ranges_w_markers(tx: TorchIndex, qcodes, lengths, wsize: int,
                          max_range: int = 1 << 62, max_k: int = 32):
    """Returns (lo, hi, markers [B, max_k] int64 packed to the RIGHT, used [B],
    overflow [B]).

    Read the markers of lane b as markers[b, max_k-used[b]:], the reference's
    lf.markers order.  Lanes shorter than wsize return empty (the reference
    warns and bails, rowbowt.hpp:299-302).  The loop records each window's
    RANGE only; the (marker offset, count) probes run as one bulk [W*B]
    markers_bounds after it, and the values expand in one gather after that.
    """
    B, L = qcodes.shape
    W = L // wsize + 2  # max windows incl. the final re-query
    dt = tx.idx_dtype
    dev = qcodes.device
    m = lengths.to(dt)
    # the reference passes (uint64)-1 for "unbounded": clamp into the dtype
    max_range = min(int(max_range), torch.iinfo(dt).max)
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    too_short = m < wsize
    done = too_short
    window_ei = m
    # [W, B] range records; unwritten slots hold the empty (1, 0) -> count 0
    wlo = torch.ones((W, B), dtype=dt, device=dev)
    whi = torch.zeros((W, B), dtype=dt, device=dev)
    nw = torch.zeros(B, dtype=dt, device=dev)
    lf = R.lf_step_auto(tx)

    def record(lo, hi, gate, nw):
        do = gate & ((hi - lo + 1) <= max_range)
        slot = torch.clamp(nw, max=W - 1)
        U.tslot_set(wlo, slot, do, lo)
        U.tslot_set(whi, slot, do, hi)
        return nw + do.to(dt)

    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j < m)
        nlo, nhi = lf(tx, lo, hi, c)
        empty = nlo > nhi
        # a failed full-read search clears collected markers (rowbowt.hpp:311-313)
        fail = active & empty
        nw = torch.where(fail, 0, nw)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | fail
        # window trigger (rowbowt.hpp:314-324)
        trigger = active & ~empty & (window_ei - (m - j) >= wsize)
        nw = record(lo, hi, trigger, nw)
        window_ei = torch.where(trigger, m - j, window_ei)
    # final re-query quirk (rowbowt.hpp:328-335)
    final = (~done) & (~too_short) & (hi >= lo) & ((m - 1) % wsize != 0)
    nw = record(lo, hi, final, nw)

    # deferred bulk probe; stale slots beyond nw are masked by window_entry_ids
    s_flat, cnt_flat = R.markers_bounds(tx, wlo.reshape(-1), whi.reshape(-1))
    ws = s_flat.reshape(W, B).to(dt)
    wc = cnt_flat.reshape(W, B).to(dt)
    ma_val = tx.arrays["ma_val"]
    M = ma_val.shape[0]
    entry, valid, used, total = U.window_entry_ids(ws.t(), wc.t(), nw, max_k)
    buf = torch.where(valid, ma_val[torch.clamp(entry, 0, M - 1)], -1)

    # failed searches report the empty range
    bad = done | too_short
    lo = torch.where(bad, 1, lo)
    hi = torch.where(bad, 0, hi)
    return lo, hi, buf, used, total > used


def markers_for_ranges(tx: TorchIndex, lo, hi, max_k: int = 64):
    """Single-probe markers for final ranges (rb_align.cpp:138: one
    markers_at(range) call, CSR row order): (vals [B, max_k], count [B])."""
    return R.markers_at_range(tx, lo, hi, max_k)
