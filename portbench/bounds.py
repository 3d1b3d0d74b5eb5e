"""Frozen bound arithmetic of the port's kernels, against published peaks.

Copied from chip_smoke.py and held here, where later changes to the program
cannot move it: HBM_BYTES_PER_S, RANK_OPS (chip_smoke.py: 2439-2443),
plane_rank_ops (:2446-2451), k1_work (:2462-2510) and the bytes and
operations of k1_bound (:2513-2547), the walk's bytes and operations of
walk_times (:2395-2412, PHI_STEP_OPS :2231).  The latency term of those
bounds is left out: it was a dependent-load latency measured on one card,
not a published peak.  INT_OPS_PER_S is the int32 lanes' rate, half of
chip_smoke.py's 33.5 T/s, which counted an FMA as two operations.  A
kernel's bound is the larger of its bytes, each input byte read once and
each output byte written once, over the memory rate and its int32
operations over the int32 rate: the same for whatever kernel computes the
function.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 rate: 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper, GH100 SM), one
# operation a lane a cycle; the data sheet's 67 T/s fp32 figure counts an
# FMA as two and the SM has twice as many FP32 lanes
INT_OPS_PER_S = 132 * 64 * 1.98e9
RANK_OPS = 8 * 12 + 8  # int32 operations of one SWAR rank over a 64 B row: 8 words, checkpoint
# int32 operations of a walk step over each table (chip_smoke.PHI_STEP_OPS)
PHI_STEP_OPS = {"phi1": 4, "phi_rows": 4 + 15 * 3 + 4, "kval": 2}
PHI_ROW_POS = 480  # text positions a 64 B phi row covers (bigindex._PHI_POS)
# the rows K1 reads by layout: symbols a row and bytes a row (the two-level
# layouts as the bit planes the view holds: engine/device.PLANE_ROW words)
ROW_SYMS = {"fblock64": 64, "fblock": 128, "fb2_64": 64, "fb2": 128, "fb2_256": 256}
ROW_BYTES = {"fblock64": 64, "fblock": 96, "fb2_64": 64, "fb2": 96, "fb2_256": 128}
TWO_LEVEL = ("fb2_64", "fb2", "fb2_256")


def plane_rank_ops(syms: int) -> int:
    """int32 operations of one rank over a two-level bit-plane row of `syms`
    symbols: 8 a 32-symbol word and 8 for the checkpoint, the superblock's
    base and the sum."""
    return syms // 32 * 8 + 8


def k1_work(tx, q, ln, layout: str) -> dict:
    """What one batch asks of K1 with no ftab start, by a counting replay of
    the port's plain loop (its torch step, ops/rank.lf_step_auto, from
    ops/cuda_lf.lf_start): the reads' codes, active lane-steps, ranked steps
    (an absent code ends a lane without a load), row loads, distinct rows,
    the longest lane's steps."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    B, L = q.shape
    n, dt = tx.n, tx.idx_dtype
    shift = ROW_SYMS[layout].bit_length() - 1
    lo, hi, startj = cuda_lf.lf_start(tx, q, ln, use_ftab=False)
    lengths = ln.to(dt)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    steps = torch.zeros(B, dtype=torch.int64, device=q.device)
    ranked = two = torch.zeros((), dtype=torch.int64, device=q.device)
    rows = []
    step = R.lf_step_auto(tx)
    for j in range(L):
        c = q[:, L - 1 - j].to(dt)
        active = (~done) & (j >= startj) & (j < lengths)
        steps += active
        rk = active & (c >= 0) & (c < tx.A)
        differ = rk & (hi + 1 < n) & (((hi + 1) >> shift) != (lo >> shift))
        ranked = ranked + rk.sum()
        two = two + differ.sum()
        rows += [(lo >> shift)[rk], ((hi + 1) >> shift)[differ]]
        nlo, nhi = step(tx, lo, hi, c)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    return dict(codes=int(lengths.clamp(max=L).sum()), lane_steps=int(steps.sum()),
                ranked_steps=int(ranked), row_loads=int(ranked) + int(two),
                distinct_rows=int(torch.unique(torch.cat(rows)).numel()),
                longest_lane_steps=int(steps.max()) if B else 0)


def k1_bound(work: dict, B: int, L: int, A: int, layout: str, table_bytes: int = 0,
             record: bool = False) -> dict:
    """K1's bound for one batch of `work` (k1_work) over `layout` rows: the
    bytes (the reads' int32 codes, the lengths, F, the distinct rows,
    `table_bytes` more (the two-level rows' base table); lo and hi written,
    and with `record` the [L, B] int64 step record) over the memory rate,
    and the ranked steps' operations (two ranks a step: SWAR ranks of
    RANK_OPS, or over bit planes plane_rank_ops) over the int32 rate.
    Microseconds; bound_us is the larger."""
    lane_bytes = 8 if layout in TWO_LEVEL else 4
    out_bytes = L * B * 8 if record else 0
    nbytes = (work["codes"] * 4 + B * 4 + (A + 1) * lane_bytes
              + work["distinct_rows"] * ROW_BYTES[layout] + table_bytes
              + B * 2 * lane_bytes + out_bytes)
    step_ops = 2 * (plane_rank_ops(ROW_SYMS[layout]) if layout in TWO_LEVEL else RANK_OPS)
    ops = step_ops * work["ranked_steps"]
    byte_us = nbytes / HBM_BYTES_PER_S * 1e6
    ops_us = ops / INT_OPS_PER_S * 1e6
    return dict(bytes=nbytes, ops=ops, byte_us=byte_us, ops_us=ops_us,
                bound_us=max(byte_us, ops_us))


def walk_bound(route: str, lanes: int, flat: np.ndarray, offs: np.ndarray, hi: np.ndarray,
               breakpoints: np.ndarray | None = None, entry_bytes: int = 8) -> dict:
    """The walk's bound for one batch whose lanes' occurrences are
    flat[offs[b]:offs[b + 1]] (toehold first, then the chain): bytes (k or
    hi, size and off of every lane, 24 B; the positions written, 8 B each;
    the distinct table entries the walk reads: for "kval" each lane's
    segment kval[hi - size + 1 .. hi], for "phi1" the entry of each position
    stepped from, for "phi_rows" the 64 B phi row and the 8 B delta of each
    position stepped from, its rank among the sorted `breakpoints`) over the
    memory rate, and a step's operations (PHI_STEP_OPS) over the int32 rate.
    A lane's last position is not stepped from."""
    size = np.diff(offs)
    hits = int(flat.shape[0])
    stepped = np.ones(hits, dtype=bool)
    stepped[(offs[1:] - 1)[size > 0]] = False
    pos = flat[stepped]
    if route == "kval":
        live = size > 0
        lane = np.repeat(np.flatnonzero(live), size[live])
        j = np.arange(hits) - offs[:-1][lane]
        table = np.unique(hi[lane].astype(np.int64) - j).shape[0] * entry_bytes
        ops = hits * PHI_STEP_OPS["kval"]
    elif route == "phi1":
        table = np.unique(pos).shape[0] * entry_bytes
        ops = pos.shape[0] * PHI_STEP_OPS["phi1"]
    elif route == "phi_rows":
        rank = np.maximum(np.searchsorted(breakpoints, pos, side="right") - 1, 0)
        table = np.unique(pos // PHI_ROW_POS).shape[0] * 64 + np.unique(rank).shape[0] * 8
        ops = pos.shape[0] * PHI_STEP_OPS["phi_rows"]
    else:
        raise ValueError(f"no byte count for the walk route {route!r}")
    nbytes = lanes * 24 + hits * 8 + table
    byte_us = nbytes / HBM_BYTES_PER_S * 1e6
    ops_us = ops / INT_OPS_PER_S * 1e6
    return dict(bytes=nbytes, ops=ops, byte_us=byte_us, ops_us=ops_us,
                bound_us=max(byte_us, ops_us))
