"""Batched toehold locate.

The counterpart of rowbowt_tpu/engine/locate.py.  find_ranges_w_toehold ==
RowBowt::find_range_w_toehold (rowbowt.hpp:167-184) on indexes built with the
full SA: the loop is the plain count LF (K1 on a CUDA device) and the toehold
is one kval gather of the final range.  locate() is the phi walk
(ToeholdSA::locate_range, toehold_sa.hpp:37-49) across lanes to a fixed
max_hits, toehold first then the phi chain; locate_ragged buckets lanes by
range size on the host so one huge range does not widen every lane.
"""

from __future__ import annotations

import numpy as np
import torch

from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R


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
