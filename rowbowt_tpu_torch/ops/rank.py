"""Batched rank / LF primitives over the device tables, in plain torch.

The counterpart of rowbowt_tpu/ops/rank.py.  The fused-block backends read one
row `[8 per-char exclusive checkpoints | packed 4-bit BWT symbols]` a rank,
take the checkpoint of `c` and add a SWAR nibble-match popcount of the symbols
below the in-block offset; an LF step is two ranks.  On the two-level rows of
a big (n >= 2^31) index the checkpoints are superblock-local, an int64 base
per superblock completes the rank, and the symbols are three bit planes
(engine/device.bit_planes) whose match with c is two ands of xors a word.
These are the plain versions the CUDA LF kernel (ops/cuda_lf.py) is held
against, and the path a CPU tensor takes.  Indexes without fused rows take the other backends of the JAX file:
occ1 (one element a rank, raw builds below OCC1_MAX_N), dense (`bwt4` +
`occ_blk`, alphabets of 9-16 codes) and run-space (a searchsorted over the
run starts and two gathers, `--no-dense` builds), with the per-step toehold
(`lf_step_w_loc`, `lf_step_w_loc_occ1`) for indexes built without the full SA.
The locate and marker primitives are one or two gathers over the dense
full-SA tables (kval, phi1, ma_start1), predecessor and binary searches over
pred_pos and ma_row without them, or on a big index short searches over its
O(R) and O(M) tables (the phi bitmap or breakpoints, the marker run pack or
bucketed CSR).

All functions take a TorchIndex `tx` and int vectors on `tx.device`; char
code < 0 means "absent from alphabet" and produces the empty range (1, 0).

The packed words are uint32 stored in int32 lanes (construct/build.py).  Torch
has no popcount, `>>` on int32 sign-extends and `>>` on uint32 is not
implemented on the CPU, so the word arithmetic here widens to int64 and masks
to the low 32 bits.
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.device import (PLANE_KEYS, PLANE_SYMS, TorchIndex,
                                             plane_columns)

_FB_CKPT = 8
_NIB_LOW = 0x11111111
_U32 = 0xFFFFFFFF
_PHI_POS = 480  # positions per 64B phi bitmap row (bigindex.phi_pack_tables)


def _ss(a, v, right: bool):
    """searchsorted of v into the sorted table a (v cast to a's dtype), as
    v's dtype."""
    return torch.searchsorted(a, v.to(a.dtype), right=right).to(v.dtype)


def _F_of(tx: TorchIndex, c):
    """F[c] for c clamped to [0, A] (as a jnp gather clamps its index)."""
    return tx.arrays["F"][torch.clamp(c, 0, tx.A).long()]


def _total(tx: TorchIndex, csafe):
    """rank(n, c) = F[c+1] - F[c]."""
    return _F_of(tx, csafe + 1) - _F_of(tx, csafe)


def run_of(tx: TorchIndex, i):
    """Run id containing BWT position i (i in [0, n-1])."""
    return _ss(tx.arrays["run_start"], i, right=True) - 1


def rank_at_run(tx: TorchIndex, i, c, r):
    """rank(i, c) given r = run_of(clamp(i, n-1)) precomputed.  i in [0, n]."""
    arr = tx.arrays
    csafe = torch.clamp(c, min=0)
    occ = arr["occ_flat"][(csafe.long() * tx.R + r.long())].to(i.dtype)
    head = arr["run_head"][r.long()]
    v = occ + torch.where(head == c, i - arr["run_start"][r.long()].to(i.dtype), 0)
    v = torch.where(i >= tx.n, _total(tx, csafe).to(i.dtype), v)
    return torch.where(c < 0, torch.zeros_like(v), v)


def rank(tx: TorchIndex, i, c):
    """Number of code-c chars in BWT[0:i), batched: the run-space rank, one
    searchsorted over the run starts and two gathers."""
    r = run_of(tx, torch.clamp(i, max=tx.n - 1))
    return rank_at_run(tx, i, c, r)


_DB = 128  # dense block: symbols per occ checkpoint (construct.build.DENSE_BLOCK)
_DW = _DB // 8  # packed words per block


def rank_dense(tx: TorchIndex, i, c):
    """Dense-FM rank: one checkpoint gather + one contiguous 64B block load
    (`bwt4`, 16 words of 8 nibbles, int32 bit patterns) + a nibble count
    below the offset.  Any code in [0, 16) works."""
    arr = tx.arrays
    dev = i.device
    csafe = torch.clamp(c, min=0)
    isafe = torch.clamp(i, max=tx.n - 1).long()
    blk = isafe >> 7
    off = isafe & (_DB - 1)
    nb = arr["bwt4"].shape[0] // _DW
    occ = arr["occ_blk_flat"][csafe.long() * nb + blk].to(i.dtype)
    words = arr["bwt4"][blk[:, None] * _DW + torch.arange(_DW, device=dev)[None, :]]
    # >> on int32 sign-extends: the & 15 after each shift keeps the nibble
    shifts = (torch.arange(8, dtype=torch.int32, device=dev) * 4)[None, None, :]
    nib = (words[:, :, None] >> shifts) & 15
    pos = (torch.arange(_DW, device=dev)[:, None] * 8 + torch.arange(8, device=dev)[None, :])[None]
    hit = (nib == c[:, None, None]) & (pos < off[:, None, None])
    v = occ + hit.sum(dim=(1, 2)).to(i.dtype)
    v = torch.where(i >= tx.n, _total(tx, csafe).to(i.dtype), v)
    return torch.where(c < 0, torch.zeros_like(v), v)


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
    """rank(i, c) for i in [0, n] over the single-level rows `key` of
    2^shift symbols."""
    arr = tx.arrays
    isafe = torch.clamp(i, max=tx.n - 1)
    blk = (isafe >> shift).long()
    off = isafe & ((1 << shift) - 1)
    row = arr[key][blk]  # [B, 8 + 2^shift/8]
    csafe = torch.clamp(c, min=0)
    v = _fb_rank_from_rows(row, off, csafe).to(i.dtype)
    v = torch.where(i >= tx.n, _total(tx, csafe).to(i.dtype), v)
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


def _rank_planes(tx: TorchIndex, i, c, key: str):
    """rank(i, c) for i in [0, n] over the bit-plane rows of the two-level
    layout `key` (engine/device.bit_planes), as csrc/lf_rank.cuh ranks them:
    the superblock-local checkpoint of c, the popcount of each 32-symbol
    word's match (P0 ^ m0) & (P1 ^ m1) & (P2 ^ m2) (m_k all ones where bit
    k of c is 0) below the in-row offset, and fb2_base of the row's
    superblock (per_blk = the layout's rows over n_sup)."""
    syms = PLANE_SYMS[key]
    shift = syms.bit_length() - 1
    tab, base = tx.arrays[PLANE_KEYS[key]], tx.arrays["fb2_base"]
    dev = i.device
    isafe = torch.clamp(i, max=tx.n - 1)
    blk = (isafe >> shift).long()
    off = (isafe & (syms - 1)).to(torch.int64)
    row = tab[blk]  # [B, PLANE_ROW[syms]]
    csafe = torch.clamp(c, min=0)
    sel = torch.arange(_FB_CKPT, dtype=torch.int32, device=dev)[None, :] == csafe[:, None]
    ck = torch.where(sel, row[:, :_FB_CKPT], 0).sum(dim=1, dtype=torch.int64)
    P = row[:, torch.from_numpy(plane_columns(syms)).to(dev)].to(torch.int64) & _U32
    cl = csafe.to(torch.int64)[:, None]
    match = _U32
    for p in range(3):
        match = match & (P[:, p] ^ torch.where((cl >> p) & 1 == 1, 0, _U32))
    G = syms // 32
    kn = (off[:, None] - 32 * torch.arange(G, dtype=torch.int64, device=dev)[None, :]
          ).clamp(0, 32)
    mask = torch.where(kn >= 32, _U32, (torch.ones_like(kn) << kn) - 1)
    v = ck + _popcount32(match & mask).sum(dim=1)
    per_blk = tab.shape[0] // base.shape[0]
    v = v + torch.where(sel, base[blk // per_blk], 0).sum(dim=1)
    v = v.to(i.dtype)
    v = torch.where(i >= tx.n, _total(tx, csafe).to(i.dtype), v)
    return torch.where(c < 0, torch.zeros_like(v), v)


def rank_fblock2(tx: TorchIndex, i, c, key: str = "fb2", shift: int = 7):
    """Two-level fused-block rank, the n >= 2^31 path: the bit-plane rows of
    layout `key`, whose 8 checkpoint lanes are superblock-local (int32
    cannot overflow), plus fb2_base int64 [n_sup, 8], the global count
    before each superblock.  Lanes i are int64; rank = base[superblock of
    i, c] + local checkpoint + in-row popcount (_rank_planes).  (key,
    shift) is ("fb2_64", 6), ("fb2", 7) or ("fb2_256", 8): the nibble
    layout the planes were made from."""
    assert PLANE_SYMS[key] == 1 << shift, (key, shift)
    return _rank_planes(tx, i, c, key)


def _fb2_key(tx: TorchIndex):
    """(layout, shift) of the resident two-level rows, by the nibble layout
    their bit planes were made from (engine/device.PLANE_KEYS): the
    64-symbol/64B repack, the 256-symbol/128B rows, else the 128-symbol/96B
    build rows."""
    for key in ("fb2_64", "fb2_256", "fb2"):
        if PLANE_KEYS[key] in tx.arrays:
            return key, PLANE_SYMS[key].bit_length() - 1
    raise ValueError("no two-level rows in this view")


def lf_step_fblock2(tx: TorchIndex, lo, hi, c):
    """Batched LF over the two-level table: int64 range arithmetic."""
    key, shift = _fb2_key(tx)
    return _lf_step(lambda tx_, i, c_: rank_fblock2(tx_, i, c_, key, shift), tx, lo, hi, c)


FB2_KEYS = ("fb2_64", "fb2", "fb2_256")


def superblock_magic(per_blk: int) -> tuple[int, int]:
    """(mul, shift) with row // per_blk == (row * mul) >> shift for every
    row id in [0, 2^31): the rounded-up reciprocal of Granlund and
    Montgomery for 31-bit dividends, shift = 31 + ceil(log2 per_blk) and
    mul = ceil(2^shift / per_blk) < 2^32, whose error (mul * per_blk -
    2^shift < per_blk) times a row id stays below 2^shift.  The two-level
    kernels take a row's superblock so, without a division."""
    if not 1 <= per_blk < 1 << 31:
        raise ValueError(f"per_blk {per_blk} outside [1, 2^31)")
    shift = 31 + (per_blk - 1).bit_length()
    return -(-(1 << shift) // per_blk), shift


def rank_occ1(tx: TorchIndex, i, c):
    """Full-positional-occ rank: exactly ONE gathered element."""
    csafe = torch.clamp(c, min=0).long()
    v = tx.arrays["occ1_flat"][csafe * (tx.n + 1) + torch.clamp(i, 0, tx.n).long()]
    return torch.where(c < 0, 0, v.to(i.dtype))


def lf_step_occ1(tx: TorchIndex, lo, hi, c):
    """Batched LF at 2 gathered elements per lane-step."""
    return _lf_step(rank_occ1, tx, lo, hi, c)


def lf_step_dense(tx: TorchIndex, lo, hi, c):
    """Batched LF over the dense tables (`bwt4` + `occ_blk`)."""
    return _lf_step(rank_dense, tx, lo, hi, c)


def lf_step(tx: TorchIndex, lo, hi, c):
    """Batched RowBowt::LF(range, c) over the run-space tables: (lo', hi')
    with empty ranges as (1, 0)."""
    return _lf_step(rank, tx, lo, hi, c)


def lf_step_auto(tx: TorchIndex):
    """The LF step the index's tables support, in the JAX package's order:
    the 64B rows when resident, else the 96B rows, else the two-level rows of
    a big index, else occ1, else the dense tables, else run-space."""
    if "fblock64" in tx.arrays:
        return lf_step_fblock64
    if "fblock" in tx.arrays:
        return lf_step_fblock
    if any(PLANE_KEYS[k] in tx.arrays for k in FB2_KEYS):
        return lf_step_fblock2
    if "occ1_flat" in tx.arrays:
        return lf_step_occ1
    if tx.has_dense:
        return lf_step_dense
    return lf_step


def lf_step_w_loc_occ1(tx: TorchIndex, lo, hi, c, k):
    """Toehold LF at 4 gathered elements per lane-step: occ1 ranks + the dense
    tk1 table (tk1[c,i] = (SA[j]+n-1)%n for the last j<=i with BWT[j]==c) —
    exactly the reference's samples_last[run_of(last c before hi+1)]."""
    arr = tx.arrays
    n1 = tx.n + 1
    csafe = torch.clamp(c, min=0).long()
    occ1 = arr["occ1_flat"]
    o_lo = occ1[csafe * n1 + torch.clamp(lo, 0, tx.n).long()].to(lo.dtype)
    o_hi1 = occ1[csafe * n1 + torch.clamp(hi + 1, 0, tx.n).long()].to(lo.dtype)
    o_hi = occ1[csafe * n1 + torch.clamp(hi, 0, tx.n).long()].to(lo.dtype)
    c_before = torch.where(c < 0, 0, o_lo)
    c_inside = torch.where(c < 0, 0, o_hi1 - o_lo)
    nlo = _f_onehot(tx, c).to(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    trivial = (o_hi1 - o_hi) == 1  # BWT[hi] == c
    nk = torch.where(trivial, torch.where(k == 0, tx.n - 1, k - 1),
                     arr["tk1_flat"][csafe * tx.n + torch.clamp(hi, 0, tx.n - 1).long()]
                     .to(lo.dtype))
    return torch.where(empty, 1, nlo), torch.where(empty, 0, nhi), torch.where(empty, 0, nk)


def lf_step_w_loc(tx: TorchIndex, lo, hi, c, k):
    """Batched RowBowt::LF_w_loc over the run-space tables: LF + toehold
    maintenance (rowbowt.hpp:553-573).

    Requires the dense `ltk` table: ltk[c*R + r] = samples_last of the last
    c-run at or before run r (built by construct.build when SA samples are on).
    """
    arr = tx.arrays
    csafe = torch.clamp(c, min=0)
    n = tx.n
    r_hi1 = run_of(tx, torch.clamp(hi + 1, max=n - 1))
    # run containing hi itself (hi+1 may start a new run)
    r_hi = r_hi1 - ((hi + 1 < n) & (arr["run_start"][r_hi1.long()] == hi + 1)).to(r_hi1.dtype)
    c_before = rank(tx, lo, c)
    c_at_hi1 = rank_at_run(tx, hi + 1, c, torch.where(hi + 1 >= n, r_hi, r_hi1))
    c_inside = c_at_hi1 - c_before
    nlo = _F_of(tx, csafe).to(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    trivial = arr["run_head"][r_hi.long()] == c
    nk = torch.where(trivial, torch.where(k == 0, n - 1, k - 1),
                     arr["ltk"][csafe.long() * tx.R + r_hi.long()].to(lo.dtype))
    return torch.where(empty, 1, nlo), torch.where(empty, 0, nhi), torch.where(empty, 0, nk)


def bwt_sym(tx: TorchIndex, i):
    """BWT code at position i (batched) from the fused rows, no checkpoint
    read: one gathered int32 element per lane from the single-level rows'
    packed nibbles, or on the two-level rows one bit of each of three
    plane words (engine/device.plane_columns).  The superblock regions of
    the two-level rows are contiguous multiples of the row size, so the
    global row id is i >> shift.  Out-of-range i is clamped; callers mask.
    Returns int32."""
    arr = tx.arrays
    isafe = torch.clamp(i, 0, tx.n - 1)
    for key in ("fb2_64", "fb2_256", "fb2"):
        if PLANE_KEYS[key] in arr:
            syms = PLANE_SYMS[key]
            blk = (isafe >> (syms.bit_length() - 1)).long()
            off = isafe & (syms - 1)
            col = torch.from_numpy(plane_columns(syms)).to(i.device)[:, (off >> 5).long()].T
            P = arr[PLANE_KEYS[key]][blk[:, None], col].to(torch.int64) & _U32  # [B, 3]
            bit = (off & 31).to(torch.int64)[:, None]
            sym = ((P >> bit) & 1) << torch.arange(3, device=i.device)[None, :]
            return sym.sum(dim=1).to(torch.int32)
    for key, shift in (("fblock64", 6), ("fblock", 7)):
        if key in arr:
            tab = arr[key]
            break
    else:
        raise ValueError("bwt_sym needs an fblock-family table")
    blk = (isafe >> shift).long()
    off = isafe & ((1 << shift) - 1)
    w = tab[blk, (_FB_CKPT + (off >> 3)).long()].to(torch.int64) & _U32
    return ((w >> (4 * (off & 7))) & 15).to(torch.int32)


def phi_rows_rank(tx: TorchIndex, i):
    """The phi_delta entry of each position i on a big index's bitmap rows
    (bigindex.phi_pack_tables): one 64B row gather ([ckpt | 15 bit words]
    per 480 positions) + popcount gives the predecessor rank.  int64."""
    blk = torch.div(i, _PHI_POS, rounding_mode="floor")
    off = i - blk * _PHI_POS
    row = tx.arrays["phi_rows"][blk.long()]  # [B, 16] int32
    words = row[:, 1:].to(torch.int64) & _U32  # [B, 15]
    # count the bits with local index <= off: kn bits of word jw
    kn = (off[:, None] + 1
          - 32 * torch.arange(15, dtype=torch.int64, device=i.device)[None, :]).clamp(0, 32)
    mask = torch.where(kn >= 32, _U32, (torch.ones_like(kn) << kn) - 1)
    rk = row[:, 0].to(torch.int64) + _popcount32(words & mask).sum(dim=1) - 1
    return torch.clamp(rk, min=0)


def phi_step(tx: TorchIndex, i):
    """Batched ToeholdSA::phi (toehold_sa.hpp:56-72): one gather via the dense
    phi1 table (phi(SA[j]) = SA[j-1]; the result has phi1's dtype), on a big
    index over its breakpoint tables (i's dtype): phi is piecewise i + const
    between the SA-adjacency breakpoints (bigindex.py), else a predecessor
    searchsorted over the run-start samples pred_pos (i's dtype)."""
    arr = tx.arrays
    if "phi1" in arr:
        return arr["phi1"][torch.clamp(i, 0, tx.n - 1).long()]
    if "phi_rows" in arr:
        # one delta gather after the bitmap rank
        d = arr["phi_delta"][phi_rows_rank(tx, i)].to(i.dtype)
        return (i + d) % tx.n
    if "phi_at" in arr:
        # the breakpoint table itself: pred_pos[0] == 0, so rk >= 0
        pp = arr["pred_pos"]
        if "pp_off" in arr:
            shift, iters = tx.pp_bs
            rk = bucketed_lower_bound(pp, arr["pp_off"], shift, iters, i + 1) - 1
        else:
            rk = torch.searchsorted(pp, i.to(pp.dtype), right=True).to(i.dtype) - 1
        base = arr["phi_at"][rk].to(i.dtype)
        return (base + (i - pp[rk].to(i.dtype))) % tx.n
    # predecessor search over the run-start samples (toehold_sa.hpp:56-72):
    # the sample j = pred(i) at or below i, then SA[j's row - 1] + (i - j)
    pp = arr["pred_pos"]
    rk = _ss(pp, i, right=False)
    jr = torch.where(rk == 0, tx.R - 1, rk - 1).long()
    j = pp[jr].to(i.dtype)
    delta = torch.where(j < i, i - j, i + 1)
    # pred_to_run == 0 reads index -1: the last run's sample, as in JAX
    prev_sample = arr["samples_last"][arr["pred_to_run"][jr].long() - 1].to(i.dtype)
    return (prev_sample + delta) % tx.n


def markers_bounds(tx: TorchIndex, lo, hi):
    """(start offset, count) of the markers at BWT rows [lo, hi]: two gathers
    via the dense ma_start1 table (ma_start1[i] = markers in rows [0, i)), on
    a big index two probes of its run-pack or bucketed marker tables, else
    two binary searches over ma_row."""
    arr = tx.arrays
    if "ma_start1" in arr:
        ms = arr["ma_start1"]
        s = ms[torch.clamp(lo, 0, tx.n).long()]
        e = ms[torch.clamp(hi + 1, 0, tx.n).long()]
    elif "ma_rec" in arr:
        # run-pack rank (bigindex.marker_run_pack): 3 dependent gather levels
        s = _ms_runs(tx, torch.clamp(lo, 0, tx.n))
        e = _ms_runs(tx, torch.clamp(hi + 1, 0, tx.n))
    elif "ma_off" in arr:
        # bucketed lower bound (bigindex.marker_buckets): 1 bucket gather +
        # iters binary-search gathers
        s = _ms_bucketed(tx, torch.clamp(lo, 0, tx.n))
        e = _ms_bucketed(tx, torch.clamp(hi + 1, 0, tx.n))
    else:
        # binary search over the sorted marker rows (indexes without ma_start1)
        mr = arr["ma_row"]
        s = _ss(mr, torch.clamp(lo, 0, tx.n), right=False)
        e = _ss(mr, torch.clamp(hi + 1, 0, tx.n), right=False)
    return s, torch.clamp(e - s, min=0)


def bucketed_lower_bound(vals, off, shift: int, iters: int, q):
    """First index i with vals[i] >= q over a sorted value table, via its
    bucket table (bigindex.marker_buckets): off[b] bounds the search to q's
    2^shift-wide value bucket, then a STATIC `iters`-step branchless binary
    search finishes.  Returns q's dtype."""
    b = torch.clamp(q >> shift, 0, off.shape[0] - 2).long()
    lo = off[b].to(q.dtype)
    hi = off[b + 1].to(q.dtype)
    qv = q.to(vals.dtype)
    M1 = vals.shape[0] - 1
    for _ in range(iters):
        mid = (lo + hi) >> 1
        v = vals[torch.clamp(mid, 0, M1).long()]
        take = (v < qv) & (lo < hi)
        hi = torch.where(take | (lo >= hi), hi, mid)
        lo = torch.where(take, mid + 1, lo)
    return lo


def _ms_bucketed(tx: TorchIndex, i):
    """ma_start1[i] (count of CSR entries with row < i) via the bucket table."""
    shift, iters = tx.ma_bs
    return bucketed_lower_bound(tx.arrays["ma_row"], tx.arrays["ma_off"], shift, iters, i)


def _ms_runs(tx: TorchIndex, i):
    """ma_start1[i] via the run-pack tables (bigindex.marker_run_pack).

    j = last marker run with start <= i resolves as off[b] + (count of
    in-bucket run starts <= i) - 1; the count reads a STATIC tx.ma_rp[1]
    sd16 rows (64B each, 32 u16 start-deltas packed in 16 i32 lanes), then
    one 16B rec gather yields rank(i) = cum[j] + mult[j] * clip(i - start[j],
    0, len[j]).  j < 0 means no run precedes i: rank 0."""
    arr = tx.arrays
    off, sd, rec = arr["ma_roff"], arr["ma_sd16"], arr["ma_rec"]
    shift, nrows = tx.ma_rp
    isafe = torch.clamp(i, 0, tx.n).to(torch.int64)
    b = torch.clamp(isafe >> shift, max=off.shape[0] - 2).long()
    s = off[b].to(torch.int64)
    e = off[b + 1].to(torch.int64)
    qlo = (isafe & 0xFFFF)[:, None]
    r0 = s >> 5
    nr = sd.shape[0]
    lane2 = 2 * torch.arange(16, dtype=torch.int64, device=i.device)[None, :]
    cnt = torch.zeros_like(isafe)
    for j in range(nrows):
        w = sd[torch.clamp(r0 + j, max=nr - 1)].to(torch.int64)  # [B, 16]: 32 u16 deltas
        lo16 = w & 0xFFFF
        hi16 = (w >> 16) & 0xFFFF
        pos = ((r0 + j) << 5)[:, None] + lane2
        in_lo = (pos >= s[:, None]) & (pos < e[:, None])
        in_hi = (pos + 1 >= s[:, None]) & (pos + 1 < e[:, None])
        cnt = cnt + (in_lo & (lo16 <= qlo)).sum(dim=1) + (in_hi & (hi16 <= qlo)).sum(dim=1)
    jj = s + cnt - 1
    r = rec[torch.clamp(jj, 0, rec.shape[0] - 1)]  # [B, 2]
    start, packed = r[:, 0], r[:, 1]
    cum = packed & 0xFFFFFFFF
    ln = (packed >> 32) & 0xFFFFFF
    mu = (packed >> 56) & 0x7F
    rank = cum + mu * torch.minimum(torch.clamp(isafe - start, min=0), ln)
    return torch.where(jj < 0, 0, rank).to(i.dtype)


def _ms_nibble(tx: TorchIndex, i):
    """ma_start1[i] via the nibble-count fused rows (bigindex.
    marker_nibble_rank) in tx.arrays["ma_cnt64"]: one 64 B/16-lane row
    gather ([ckpt | 8 words of per-row 4-bit entry counts | 7 pad] per 64
    BWT rows) + a SWAR nibble sum of the counts below i's in-block offset.
    markers_bounds does not take this route (TorchIndex.from_big puts no
    ma_cnt64 on the device): it is the JAX package's opt-in RBT_MA_NIB
    bound, kept with its tests.  The words are int32 bit
    patterns, widened to int64 and masked to 32 bits (torch has no uint32
    shifts on the CPU)."""
    tab = tx.arrays["ma_cnt64"]  # [nb + 1, 16] int32 (64 B rows)
    nb = tab.shape[0] - 1
    isafe = torch.clamp(i, 0, tx.n).to(torch.int64)
    blk = torch.clamp(isafe >> 6, max=nb)
    off = isafe - (blk << 6)
    row = tab[blk]
    ck = row[:, 0].to(torch.int64)
    words = row[:, 1:9].to(torch.int64) & _U32  # [B, 8]
    kn = (off[:, None] - 8 * torch.arange(8, dtype=torch.int64, device=i.device)[None, :]
          ).clamp(0, 8)
    mask = torch.where(kn >= 8, _U32, (torch.ones_like(kn) << (4 * kn)) - 1)
    t = words & mask
    s1 = (t & 0x0F0F0F0F) + ((t >> 4) & 0x0F0F0F0F)
    per_word = ((s1 * 0x01010101) & _U32) >> 24  # sum of 4 bytes (<= 120)
    return (ck + per_word.sum(dim=1)).to(i.dtype)


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
