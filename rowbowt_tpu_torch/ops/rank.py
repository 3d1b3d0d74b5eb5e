"""Batched rank / LF primitives over the fused-block rank rows, in plain torch.

The counterpart of the count, locate and marker subset of
rowbowt_tpu/ops/rank.py.  A rank reads one row `[8 per-char exclusive
checkpoints | packed 4-bit BWT symbols]`, takes the checkpoint of `c` and adds
a SWAR nibble-match popcount of the symbols below the in-block offset; an LF
step is two ranks.  These are the plain versions the CUDA LF kernel
(ops/cuda_lf.py) is held against, and the path a CPU tensor takes.  The
locate and marker primitives (toehold, phi, doc lookup, marker bounds) are
one or two gathers over the dense full-SA tables (kval, phi1, ma_start1).

All functions take a TorchIndex `tx` and int vectors on `tx.device`; char
code < 0 means "absent from alphabet" and produces the empty range (1, 0).

The packed words are uint32 stored in int32 lanes (construct/build.py).  Torch
has no popcount, `>>` on int32 sign-extends and `>>` on uint32 is not
implemented on the CPU, so the word arithmetic here widens to int64 and masks
to the low 32 bits.
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.device import TorchIndex

_FB_CKPT = 8
_NIB_LOW = 0x11111111
_U32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32), by shifts and masks."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _fb_rank_from_rows(row, off, c):
    """rank within one gathered fblock row: checkpoint select + SWAR popcount.

    row [B, 8+nw] int32 (nw packed words: 16 for the 128-sym/96B layout, 8 for
    the 64-sym/64B one), off [B] symbol offset in block, c [B] code in [0, 8).
    """
    nw = row.shape[1] - _FB_CKPT
    dev = row.device
    sel = torch.arange(_FB_CKPT, dtype=torch.int32, device=dev)[None, :] == c[:, None]
    occ = torch.where(sel, row[:, :_FB_CKPT], 0).sum(dim=1, dtype=row.dtype)
    words = row[:, _FB_CKPT:].to(torch.int64) & _U32
    pat = (c.to(torch.int64) * _NIB_LOW)[:, None]
    x = words ^ pat
    t = x | (x >> 1) | (x >> 2) | (x >> 3)
    match = (~t) & _NIB_LOW  # bit 4j set where nibble j == c
    # word w covers symbols [8w, 8w+8); keep nibbles below off.  kn == 8 takes
    # the full-word mask: 1 << 32 overflows the 32-bit word it stands for
    kn = (off.to(torch.int64)[:, None]
          - 8 * torch.arange(nw, dtype=torch.int64, device=dev)[None, :]).clamp(0, 8)
    mask = torch.where(kn >= 8, _U32, (torch.ones_like(kn) << (4 * kn)) - 1)
    inblk = _popcount32(match & mask).sum(dim=1)
    return occ + inblk.to(row.dtype)


def _rank_rows(tx: TorchIndex, i, c, key: str, shift: int):
    """rank(i, c) for i in [0, n] over the rows `key` of 2^shift symbols."""
    arr = tx.arrays
    isafe = torch.clamp(i, max=tx.n - 1)
    blk = (isafe >> shift).long()
    off = isafe & ((1 << shift) - 1)
    row = arr[key][blk]  # [B, 8 + 2^shift/8]
    csafe = torch.clamp(c, min=0)
    v = _fb_rank_from_rows(row, off, csafe).to(i.dtype)
    # F[c+1] - F[c]; indices clamped to [0, A] as a jnp gather clamps them
    F = arr["F"]
    total = F[torch.clamp(csafe + 1, max=tx.A).long()] - F[torch.clamp(csafe, max=tx.A).long()]
    v = torch.where(i >= tx.n, total.to(i.dtype), v)
    return torch.where(c < 0, torch.zeros_like(v), v)


def rank_fblock(tx: TorchIndex, i, c):
    """Fused-block rank over the 128-symbol/96B rows (`fblock`).  i in [0, n]."""
    return _rank_rows(tx, i, c, "fblock", 7)


def rank_fblock64(tx: TorchIndex, i, c):
    """Fused-block rank over the 64-symbol/64B rows (`fblock64`), the default
    device layout.  Same contract as rank_fblock."""
    return _rank_rows(tx, i, c, "fblock64", 6)


def _f_onehot(tx: TorchIndex, c):
    """F[c] via one-hot sum over the tiny F table (0 for c outside [0, A))."""
    F = tx.arrays["F"]
    sel = torch.arange(tx.A, dtype=torch.int32, device=c.device)[None, :] == c[:, None]
    return torch.where(sel, F[None, :tx.A], 0).sum(dim=1, dtype=F.dtype)


def _lf_step(rank_fn, tx: TorchIndex, lo, hi, c):
    c_before = rank_fn(tx, lo, c)
    c_inside = rank_fn(tx, hi + 1, c) - c_before
    nlo = _f_onehot(tx, c).to(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    return (torch.where(empty, torch.ones_like(nlo), nlo),
            torch.where(empty, torch.zeros_like(nhi), nhi))


def lf_step_fblock64(tx: TorchIndex, lo, hi, c):
    """Batched LF over the 64B-row fused-block table: 2 row gathers per lane-step."""
    return _lf_step(rank_fblock64, tx, lo, hi, c)


def lf_step_fblock(tx: TorchIndex, lo, hi, c):
    """Batched LF over the 96B-row fused-block table: 2 row gathers per lane-step."""
    return _lf_step(rank_fblock, tx, lo, hi, c)


def lf_step_auto(tx: TorchIndex):
    """The LF step the index's tables support: the 64B rows when resident,
    else the 96B rows."""
    if "fblock64" in tx.arrays:
        return lf_step_fblock64
    if "fblock" in tx.arrays:
        return lf_step_fblock
    raise NotImplementedError(
        "rowbowt_tpu_torch runs LF over fblock/fblock64 rows only; the "
        "run-space, occ1 and dense backends are ROADMAP M5, the two-level "
        "fb2 rows of n >= 2^31 indexes ROADMAP M6")


def phi_step(tx: TorchIndex, i):
    """Batched ToeholdSA::phi (toehold_sa.hpp:56-72): one gather via the dense
    phi1 table (phi(SA[j]) = SA[j-1]).  The result has phi1's dtype."""
    arr = tx.arrays
    if "phi1" in arr:
        return arr["phi1"][torch.clamp(i, 0, tx.n - 1).long()]
    if "phi_rows" in arr or "phi_at" in arr:
        raise NotImplementedError(
            "phi over the big-index bitmap or breakpoint tables is ROADMAP M6")
    raise NotImplementedError(
        "phi by predecessor search over pred_pos (indexes without phi1) is ROADMAP M5")


def markers_bounds(tx: TorchIndex, lo, hi):
    """(start offset, count) of the markers at BWT rows [lo, hi]: two gathers
    via the dense ma_start1 table (ma_start1[i] = markers in rows [0, i))."""
    arr = tx.arrays
    if "ma_start1" in arr:
        ms = arr["ma_start1"]
        s = ms[torch.clamp(lo, 0, tx.n).long()]
        e = ms[torch.clamp(hi + 1, 0, tx.n).long()]
        return s, torch.clamp(e - s, min=0)
    if any(k in arr for k in ("ma_rec", "ma_cnt64", "ma_off")):
        raise NotImplementedError(
            "marker bounds over the big-index run-pack, nibble or bucket tables are ROADMAP M6")
    raise NotImplementedError(
        "marker bounds by binary search over ma_row (indexes without ma_start1) are ROADMAP M5")


def markers_at_range(tx: TorchIndex, lo, hi, max_k: int):
    """Batched MarkerArray::at_range: up to max_k packed markers per lane.

    Returns (vals [B, max_k] int64, pad -1; count [B]).  Lanes with empty or
    invalid ranges return count 0; count may exceed max_k (truncation)."""
    ma_val = tx.arrays["ma_val"]
    s, cnt = markers_bounds(tx, lo, hi)
    offs = torch.arange(max_k, dtype=s.dtype, device=s.device)[None, :]
    pos = torch.clamp(s[:, None] + offs, max=ma_val.shape[0] - 1)
    vals = torch.where(offs < cnt[:, None], ma_val[pos.long()], -1)
    return vals, cnt


def doc_of(tx: TorchIndex, i):
    """Batched DocList lookup: doc id containing text position i.  The
    positions are cast to the table's dtype for the search and the ids back
    to i's dtype."""
    ds = tx.arrays["doc_starts"]
    return torch.searchsorted(ds, i.to(ds.dtype), right=True).to(i.dtype) - 1


def toehold_from_range(tx: TorchIndex, lo, hi):
    """Toehold of a search state via the invariant k == SA[hi]: one kval
    gather.  Empty ranges return 0 (rowbowt.hpp:177-180).  Returns lo.dtype."""
    k = tx.arrays["kval"][torch.clamp(hi, 0, tx.n - 1).long()].to(lo.dtype)
    return torch.where(hi < lo, torch.zeros_like(k), k)


def kmer_codes(tx: TorchIndex, codes):
    """Big-endian 2-bit encode of [B, k] index codes; -1 where any char isn't ACGT."""
    a, c, g, t = tx.acgt_codes
    base = torch.full(codes.shape, -1, dtype=torch.int32, device=codes.device)
    for b, cc in enumerate((a, c, g, t)):
        base = torch.where(codes == cc, b, base)
    valid = (base >= 0).all(dim=-1)
    k = codes.shape[-1]
    weights = 4 ** torch.arange(k - 1, -1, -1, dtype=torch.int32, device=codes.device)
    v = (base * weights).sum(dim=-1, dtype=torch.int32)
    return torch.where(valid, v, -1)


def ftab_lookup(tx: TorchIndex, kcodes):
    """search_ftab: (lo, hi, hit) — misses return the full range with hit=False."""
    ft = tx.arrays["ftab"]
    safe = torch.clamp(kcodes, min=0).long()
    lo = ft[safe, 0]
    hi = ft[safe, 1]
    hit = (kcodes >= 0) & (lo >= 0)
    return (
        torch.where(hit, lo, 0),
        torch.where(hit, hi, tx.n - 1),
        hit,
    )
