"""Per-lane slot records on the transposed [W, B] layout, and the arithmetic
window expansion.

The counterpart of rowbowt_tpu/ops/update.py.  The JAX package writes one
dynamic slot per lane with a one-hot select over the width, because the TPU
lowers an indexed update to a serialized scatter.  Here a slot write is an
indexed assignment and a slot read an indexed gather, at columns arange(B);
the values are the same.  window_entry_ids is arithmetic and ported as it is.
"""

from __future__ import annotations

import torch


def _cols(arr):
    return torch.arange(arr.shape[1], device=arr.device)


def tslot_set(arr, slot, mask, val):
    """arr[slot[b], b] = val[b] where mask[b], IN PLACE; returns arr.

    arr [W, B]; slot [B] already clamped to [0, W) by the caller; val [B]
    (cast to arr's dtype) or a Python int.  A masked-off lane writes nothing."""
    slot = slot.long()
    cols = _cols(arr)
    v = val.to(arr.dtype) if isinstance(val, torch.Tensor) else val
    arr[slot, cols] = torch.where(mask, v, arr[slot, cols])
    return arr


def tslot_get(arr, slot):
    """arr[slot[b], b] for arr [W, B], as int64 (the JAX version sums a one-hot
    select, which widens integers to int64)."""
    return arr[slot.long(), _cols(arr)].to(torch.int64)


def window_entry_ids(ws, wc, nrec, max_k: int):
    """Vectorized W-pass right-append expansion.

    Windows w < nrec[b] carry (entry offset ws[b,w], count wc[b,w]); the
    output buffer packs them to the RIGHT, newest window leftmost, clipping
    per window at the remaining capacity (overflow keeps each window's TAIL
    entries).  Returns (entry [B, K] global entry ids, valid [B, K], used [B],
    total [B]) so the caller does ONE value gather instead of W.  Dtypes as in
    the JAX version: entry and total int64, used ws's dtype.
    """
    B, W = ws.shape
    K = max_k
    dt = ws.dtype
    dev = ws.device
    live = torch.arange(W, device=dev)[None, :] < nrec[:, None]
    raw = torch.where(live, wc, 0)
    cntc = torch.clamp(raw, max=K)
    P = torch.clamp(torch.cumsum(cntc, dim=1, dtype=dt), max=K)  # used after w+1 windows
    P0 = torch.cat([torch.zeros((B, 1), dtype=dt, device=dev), P[:, :-1]], dim=1)  # before w
    used = P[:, -1] if W else torch.zeros(B, dtype=dt, device=dev)
    total = raw.sum(dim=1, dtype=torch.int64)

    q = torch.arange(K, dtype=dt, device=dev)[None, :]  # output column
    r = K - q  # windows satisfy P0[w] < r <= P[w]
    inwin = (P0[:, :, None] < r[:, None, :]) & (r[:, None, :] <= P[:, :, None])
    inwin = inwin & live[:, :, None] & (cntc[:, :, None] > 0)

    def pick(v):
        return torch.where(inwin, v[:, :, None], 0).sum(dim=1, dtype=torch.int64)

    w_ws = pick(ws)
    w_p0 = pick(P0)
    w_cnt = pick(cntc)
    src = q - K + w_p0 + w_cnt
    valid = inwin.any(dim=1) & (r <= used[:, None])
    entry = torch.where(valid, w_ws + src, 0)
    return entry, valid, used, total
