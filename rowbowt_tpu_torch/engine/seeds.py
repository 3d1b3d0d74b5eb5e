"""Batched greedy seeding: the rb_markers / rb_locs query paths.

The counterpart of rowbowt_tpu/engine/seeds.py, lockstep versions of the
reference's data-dependent seeding loops:

- seeds_greedy_w_sample   == RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256)
- markers_greedy_seeding  == RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482),
  including the ftab kmer-shift restart scan (rowbowt.hpp:454-464)
- locate_from_longest_seed == RowBowt::locate_from_longest_seed (rowbowt.hpp:664-690)
- markers_lmem_lanes      == the inner loop of RowBowt::get_markers_lmems (rowbowt.hpp:341-404)

The per-read control flow (seed resets, the inner ftab restart loop) becomes
a per-lane state machine.  Each function is split into its machine, which
writes records (the seeds, and the ranges the markers are probed at), and a
shared tail in torch (one bulk marker probe, the expansion, the toeholds).
The machine runs as one kernel launch a batch on CUDA tensors, over fused
rows or the occ1, dense or run-space tables, the sampled machine with its
per-step toehold on an index without kval (ops/cuda_seeds.py,
csrc/seeds.cu); its plain twin, the `*_records_plain` function, is a Python
loop of L steps over [B] tensors: every step runs the LF step for all lanes
and selects per lane with masks, so no step reads a value back to the host.
The twin runs on CPU tensors only; on the card the kernel launches or the
call raises.  Variable-count outputs (seeds per read,
markers per seed) become fixed-size tables [B, S] / [B, S, K] plus
true-count vectors; overflow is visible as count > capacity.  Record tables
are built transposed ([S, B], [W, B]) and transposed once at the end, as in
the JAX version.
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_seeds
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops import update as U


def _toehold_by_kval(tx: TorchIndex, what: str) -> str:
    """How `what` finds its toeholds, in the JAX package's order: "kval" for
    one kval gather of each range (full-SA builds), "trajectory" for the
    trajectory resolve of a big (n >= 2^31) index
    (engine/locate.traj_resolve_toehold), "per_step" for the toehold carried
    through the loop by lf_step_w_loc_occ1 (tk1 resident) or lf_step_w_loc
    (run-space) on indexes built from run samples alone.  Raises for an
    index without SA samples."""
    if "kval" in tx.arrays:
        return "kval"
    if "cruns_keys" in tx.arrays:
        return "trajectory"
    if "samples_last" in tx.arrays:
        return "per_step"
    raise ValueError(f"{what}: the index has no toehold SA samples "
                     "(built with -x or without -s)")


def _w_loc_step(tx: TorchIndex):
    """The per-step toehold LF: over occ1 + tk1 when tk1 is resident, else
    run-space over ltk."""
    return R.lf_step_w_loc_occ1 if "tk1_flat" in tx.arrays else R.lf_step_w_loc


def _machine(qcodes, lengths, plain, launch):
    """A machine's records: plain(qcodes, lengths) on CPU tensors; on CUDA
    tensors the seeding kernel (launch(qcodes, lengths), int32 codes and
    lengths), which launches or raises; an error on any other device."""
    if qcodes.device.type == "cpu":
        return plain(qcodes, lengths)
    if qcodes.device.type != "cuda":
        raise ValueError(f"no seeding loop for device {qcodes.device}")
    return launch(qcodes.to(torch.int32), lengths.to(torch.int32))


def seeds_sample_records_plain(tx: TorchIndex, qcodes, lengths, min_length: int,
                               max_seeds: int, mode: str) -> dict:
    """The sampled machine of seeds_greedy_w_sample in torch, on any device
    (the seeding kernel's plain twin): {slo, shi, sqs, sqe [S, B], ns [B]},
    with the step record hi_rec [L, B] (each lane's pre-step hi) in
    "trajectory" mode and the per-step toeholds ssamp [S, B] in "per_step"
    mode."""
    big = mode == "trajectory"
    per_step = mode == "per_step"
    B, L = qcodes.shape
    S = max_seeds
    dt = tx.idx_dtype
    dev = qcodes.device
    m = lengths.to(dt)
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    plo, phi_ = lo, hi
    ei = m
    slo = torch.ones((S, B), dtype=dt, device=dev)
    shi = torch.zeros((S, B), dtype=dt, device=dev)
    sqs = torch.zeros((S, B), dtype=dt, device=dev)
    sqe = torch.zeros((S, B), dtype=dt, device=dev)
    ns = torch.zeros(B, dtype=dt, device=dev)
    hi_rec = torch.zeros((L, B), dtype=dt, device=dev) if big else None
    if per_step:
        # get_last_run_sample (toehold_sa.hpp:97-99)
        first_k = ((tx.arrays["samples_last"][tx.R - 1] + 1) % tx.n).to(dt)
        k = first_k.expand(B).clone()
        pk = torch.full((B,), -1, dtype=dt, device=dev)
        ssamp = torch.zeros((S, B), dtype=dt, device=dev)
        step = _w_loc_step(tx)
    else:
        lf = R.lf_step_auto(tx)

    def put(slot, rec, plo, phi_, qs, qe):
        U.tslot_set(slo, slot, rec, plo)
        U.tslot_set(shi, slot, rec, phi_)
        U.tslot_set(sqs, slot, rec, qs)
        U.tslot_set(sqe, slot, rec, qe)
        if per_step:
            U.tslot_set(ssamp, slot, rec, pk)

    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = j < m
        if big:
            hi_rec[j] = hi  # pre-step hi
        if per_step:
            nlo, nhi, nk = step(tx, lo, hi, c, k)
        else:
            nlo, nhi = lf(tx, lo, hi, c)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        # failure: emit (prev, qstart=m-j, qend=ei, ssamp=pk) if long enough
        emit = fail & (ei - (m - j) >= min_length)
        put(torch.clamp(ns, max=S - 1), emit & (ns < S), plo, phi_, m - j, ei)
        ns = ns + emit.to(dt)
        lo = torch.where(ok, nlo, torch.where(fail, 0, lo))
        hi = torch.where(ok, nhi, torch.where(fail, tx.n - 1, hi))
        plo = torch.where(ok, nlo, torch.where(fail, 0, plo))
        phi_ = torch.where(ok, nhi, torch.where(fail, tx.n - 1, phi_))
        if per_step:
            k = torch.where(ok, nk, torch.where(fail, first_k, k))
            pk = torch.where(ok, nk, pk)
        ei = torch.where(fail, m - j - 1, ei)
    # tail seed (rowbowt.hpp:252-254): qstart=0, qend=ei, from prev state
    emit = ei >= min_length
    put(torch.clamp(ns, max=S - 1), emit & (ns < S), plo, phi_, 0, ei)
    ns = ns + emit.to(dt)
    out = dict(slo=slo, shi=shi, sqs=sqs, sqe=sqe, ns=ns)
    if big:
        out["hi_rec"] = hi_rec
    if per_step:
        out["ssamp"] = ssamp
    return out


def seeds_greedy_w_sample(tx: TorchIndex, qcodes, lengths, min_length: int,
                          max_seeds: int = 8):
    """Batched RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256).

    Returns (slo, shi, sqs, sqe, ssamp) [B, S] and nseeds [B].  Seed i of
    lane b spans query offsets [sqs, sqe) (qend EXCLUSIVE) with BWT range
    (slo, shi) and toehold ssamp.  nseeds may exceed S (the earliest seeds
    are kept).  On a full-SA index the machine is the plain LF and the
    toehold of every record is one kval gather afterwards (SA[shi]).
    Degenerate full-range records under min_length=0 thus get SA[n-1], where
    the reference reports the previous seed's stale sample, as in the JAX
    version.  On a big index the machine also records each step's pre-step
    hi, and each seed's toehold is the trajectory resolve of its span of
    steps (each seed restarts from the full range).  On an index built from
    run samples alone the loop carries the toehold step by step
    (lf_step_w_loc, or lf_step_w_loc_occ1 over occ1 + tk1) and a seed
    records the sample of its last good step, as the reference does.
    """
    mode = _toehold_by_kval(tx, "seeds_greedy_w_sample")
    big = mode == "trajectory"
    m = lengths.to(tx.idx_dtype)
    rec = _machine(
        qcodes, lengths,
        lambda q, ln: seeds_sample_records_plain(tx, q, ln, min_length, max_seeds, mode),
        lambda q, ln: cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=min_length,
                                                S=max_seeds, record=big))
    slo, shi, sqs, sqe, ns = (rec[k] for k in ("slo", "shi", "sqs", "sqe", "ns"))
    if big:
        from rowbowt_tpu_torch.engine.locate import span_toeholds

        # seed [sqs, sqe) restarts from the full range: its steps are
        # m-sqe .. m-1-sqs, and its toehold is that span's resolve (SA[shi])
        ssamp = span_toeholds(tx, qcodes, rec["hi_rec"], m, m[None, :] - sqe,
                              m[None, :] - 1 - sqs)
        ssamp = torch.where(shi < slo, 0, ssamp)
    slo, shi, sqs, sqe = slo.t(), shi.t(), sqs.t(), sqe.t()
    if mode == "kval":
        ssamp = R.toehold_from_range(tx, slo, shi)
    else:
        ssamp = (rec["ssamp"] if mode == "per_step" else ssamp).t()
    return slo, shi, sqs, sqe, ssamp, ns


def locate_from_longest_seed(tx: TorchIndex, slo, shi, sqs, sqe, ssamp, ns,
                             max_hits: int):
    """Batched RowBowt::locate_from_longest_seed (rowbowt.hpp:664-690).

    Picks each lane's longest seed (the first wins ties, like the reference's
    strict > scan) and phi-walks its range; positions are corrected by
    -qstart.  Returns (locs [B, max_hits] pad -1, count [B]); lanes with no
    seeds return count 0."""
    from rowbowt_tpu_torch.engine.locate import locate

    B, S = slo.shape
    dev = slo.device
    valid = (torch.arange(S, dtype=ns.dtype, device=dev)[None, :]
             < torch.clamp(ns, max=S)[:, None])
    lens = torch.where(valid, sqe - sqs, -1)
    best = torch.argmax(lens, dim=1)
    rows = torch.arange(B, device=dev)
    blo = slo[rows, best]
    bhi = shi[rows, best]
    bqs = sqs[rows, best]
    bk = ssamp[rows, best]
    has = (ns > 0) & (bhi >= blo)
    locs, cnt = locate(tx, torch.where(has, blo, 1), torch.where(has, bhi, 0), bk,
                       max_hits=max_hits)
    locs = torch.where(locs >= 0, locs - bqs[:, None], -1)
    return locs, torch.where(has, cnt, 0)


def markers_greedy_records_plain(tx: TorchIndex, qcodes, lengths, wsize: int, max_range: int,
                                 max_seeds: int, ftk: int, W: int) -> dict:
    """The greedy machine of markers_greedy_seeding in torch, on any device
    (the seeding kernel's plain twin), from the ftab start of ftk-mers (0:
    none): {wlo, whi, wseed [W, B], nrec [B]}, the range of every window and
    seed-final probe and its owning seed slot (unwritten slots hold the
    empty (1, 0)), and {slo, shi, sqs, sqe [S, B], ns [B]}, the seeds, the
    final emission included."""
    B, L = qcodes.shape
    S = max_seeds
    dt = tx.idx_dtype
    dev = qcodes.device
    m = lengths.to(dt)
    n1 = tx.n - 1

    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), n1, dtype=dt, device=dev)
    i = torch.zeros(B, dtype=dt, device=dev)
    if ftk:
        kc = R.kmer_codes(tx, qcodes[:, L - ftk:])
        flo, fhi, hit = R.ftab_lookup(tx, kc)
        hit = hit & (m >= ftk)
        lo = torch.where(hit, flo.to(dt), lo)
        hi = torch.where(hit, fhi.to(dt), hi)
        i = torch.where(hit, ftk, 0).to(dt)
    plo, phi_ = lo, hi
    seed_ei = m
    window_ei = m

    # window records: the RANGE of every window / seed-final probe and its
    # owning seed slot; the probes run as ONE bulk markers_bounds after the
    # loop, and unwritten slots hold the empty (1, 0)
    wlo = torch.ones((W, B), dtype=dt, device=dev)
    whi = torch.zeros((W, B), dtype=dt, device=dev)
    wseed = torch.zeros((W, B), dtype=dt, device=dev)
    nrec = torch.zeros(B, dtype=dt, device=dev)
    slo = torch.ones((S, B), dtype=dt, device=dev)
    shi = torch.zeros((S, B), dtype=dt, device=dev)
    sqs = torch.zeros((S, B), dtype=dt, device=dev)
    sqe = torch.zeros((S, B), dtype=dt, device=dev)
    ns = torch.zeros(B, dtype=dt, device=dev)
    qflat = qcodes.reshape(-1).to(dt)  # row-major [B*L]: lane b col j at b*L+j
    lane_base = torch.arange(B, dtype=dt, device=dev) * L

    def record(slot, go, tlo, thi, owner):
        U.tslot_set(wlo, slot, go, tlo)
        U.tslot_set(whi, slot, go, thi)
        U.tslot_set(wseed, slot, go, owner)

    def put(slot, rec, plo, phi_, qs, qe):
        U.tslot_set(slo, slot, rec, plo)
        U.tslot_set(shi, slot, rec, phi_)
        U.tslot_set(sqs, slot, rec, qs)
        U.tslot_set(sqe, slot, rec, qe)

    lf = R.lf_step_auto(tx)
    # ftab-restart REPLAY state: a restart-hit lane consumes the kmer's k
    # chars one LF step at a time from the FULL range.  search_ftab's value
    # is exactly find_range of those chars, and its miss->full-range quirk
    # (rowbowt.hpp:757) is an empty range mid-replay -> hold FULL for the rest
    # of the replay.  i advances 1 per step either way, so L steps complete
    # the batch and every recorded (i, seed_ei, window_ei) equals the jump
    # formulation's.
    rp = torch.zeros(B, dtype=dt, device=dev)  # chars left to replay (0 = normal)
    rpmiss = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(L):
        active = i < m
        normal = active & (rp == 0)
        col = torch.clamp(L - 1 - i, 0, L - 1)
        c = qflat[(lane_base + col).long()]
        nlo, nhi = lf(tx, lo, hi, c)

        ok = normal & (nlo <= nhi)
        fail = normal & (nlo > nhi)

        # success path: window probe (rowbowt.hpp:472-478); failure path:
        # seed-final probe of prev (rowbowt.hpp:448); one record per step
        w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
        f_probe = fail & (seed_ei - (m - i) >= wsize)
        tlo = torch.where(fail, plo, nlo)
        thi = torch.where(fail, phi_, nhi)
        go = (w_trigger | f_probe) & ((thi - tlo + 1) <= max_range)
        record(torch.clamp(nrec, max=W - 1), go, tlo, thi, ns)
        nrec = nrec + go.to(dt)
        window_ei = torch.where(w_trigger, m - i - 1, window_ei)

        # failure: emit seed (prev, (m-i, seed_ei-1))
        put(torch.clamp(ns, max=S - 1), fail & (ns < S), plo, phi_, m - i, seed_ei - 1)
        ns = ns + fail.to(dt)
        # post-failure reset (rowbowt.hpp:450-453)
        plo = torch.where(fail, 0, plo)
        phi_ = torch.where(fail, n1, phi_)
        seed_ei = torch.where(fail, m - i - 1, seed_ei)
        window_ei = torch.where(fail, m - i - 1, window_ei)

        if ftk:
            # restart scan (rowbowt.hpp:454-464): search_ftab returns the FULL
            # range on a missing kmer (rowbowt.hpp:757), so the scan's hit
            # check passes on its first probe, always; the jump becomes a
            # k-step replay from the full range (rp/rpmiss above)
            hit = fail & (m - i - 1 >= ftk)
            to_full = fail & ~hit
            seed_ei = torch.where(hit, m - i - 1, seed_ei)
            window_ei = torch.where(hit, m - i - 1, window_ei)
            rstep = active & (rp > 0)
            held = rpmiss | (rstep & (nlo > nhi))  # miss: hold FULL hereafter
            rlo = torch.where(held, 0, nlo)
            rhi = torch.where(held, n1, nhi)
            lo = torch.where(ok, nlo, torch.where(
                hit | to_full, 0, torch.where(rstep, rlo, lo)))
            hi = torch.where(ok, nhi, torch.where(
                hit | to_full, n1, torch.where(rstep, rhi, hi)))
            plo = torch.where(ok, nlo, torch.where(
                hit, 0, torch.where(rstep, rlo, plo)))
            phi_ = torch.where(ok, nhi, torch.where(
                hit, n1, torch.where(rstep, rhi, phi_)))
            rpmiss = torch.where(hit, False, held)
            rp = torch.where(hit, ftk, torch.where(rstep, rp - 1, rp))
        else:
            lo = torch.where(ok, nlo, torch.where(fail, 0, lo))
            hi = torch.where(ok, nhi, torch.where(fail, n1, hi))
            plo = torch.where(ok, nlo, plo)
            phi_ = torch.where(ok, nhi, phi_)
        i = torch.where(active, i + 1, i)

    # final emission (rowbowt.hpp:477-481): fn(range, (m-i, seed_ei-1), mbuf)
    f_probe = (hi >= lo) & (seed_ei - (m - i) >= wsize)
    go = f_probe & ((hi - lo + 1) <= max_range)
    record(torch.clamp(nrec, max=W - 1), go, lo, hi, ns)
    nrec = nrec + go.to(dt)
    emit = m > 0
    put(torch.clamp(ns, max=S - 1), emit & (ns < S), lo, hi, m - i, seed_ei - 1)
    ns = ns + emit.to(dt)
    return dict(wlo=wlo, whi=whi, wseed=wseed, nrec=nrec, slo=slo, shi=shi, sqs=sqs, sqe=sqe,
                ns=ns)


def markers_greedy_seeding(tx: TorchIndex, qcodes, lengths, wsize: int,
                           max_range: int = 1 << 62, max_seeds: int = 8,
                           max_k: int = 16, use_ftab: bool = True,
                           values: bool = True):
    """Batched RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482).

    Per lane, seeds are emitted exactly at the reference's fn() callsites
    (rowbowt.hpp:449, 481) with their window-probed marker buffers:

    Returns:
      slo, shi   [B, S]    seed BWT range (prev_range / final range)
      sqs, sqe   [B, S]    fn's (m-i, seed_ei-1) pair: qend INCLUSIVE, may
                           wrap below qstart for degenerate tail seeds
      mvals      [B, S, K] packed markers per seed, chronological append order
                           (before sort/unique: apply engine.filters on the
                           host); with values=False these are ma_val ENTRY IDS
                           (resolve on the host: ma_val[ids], -1 = empty)
      mcnt       [B, S]    true marker count (> K means truncation)
      nseeds     [B]       true seed count (> S means truncation)
    """
    B, L = qcodes.shape
    S, K = max_seeds, max_k
    # each probe (window or seed-final) needs >= wsize fresh chars within its
    # seed, and a failure adds at most one extra probe per wsize span
    W = 2 * (L // max(wsize, 1)) + 4
    dt = tx.idx_dtype
    dev = qcodes.device
    max_range = min(int(max_range), torch.iinfo(dt).max)

    ftk = tx.ftab_k if (use_ftab and tx.has_ftab and L >= tx.ftab_k > 0) else 0
    if ftk and ftk - 1 > wsize:
        raise ValueError("wsize cannot be less than ftab k-1 (rowbowt.hpp:423-426)")
    rec = _machine(
        qcodes, lengths,
        lambda q, ln: markers_greedy_records_plain(tx, q, ln, wsize, max_range, S, ftk, W),
        lambda q, ln: cuda_seeds.launch_machine(tx, "greedy", q, ln, k=ftk, wsize=wsize,
                                                max_range=max_range, W=W, S=S))
    wlo, whi, wseed, nrec = (rec[k] for k in ("wlo", "whi", "wseed", "nrec"))
    # deferred bulk probe of every recorded window/seed range
    s_flat, cnt_flat = R.markers_bounds(tx, wlo.reshape(-1), whi.reshape(-1))
    ws = s_flat.reshape(W, B).to(dt)
    wc = cnt_flat.reshape(W, B).to(dt)

    # expansion: replay the chronological per-seed appends from the records,
    # accumulating ENTRY IDS in a flat [S*K, B] layout; the marker values
    # resolve in one gather at the end
    eflat = torch.zeros((S * K, B), dtype=dt, device=dev)
    evalid = torch.zeros((S * K, B), dtype=torch.bool, device=dev)
    used_s = torch.zeros((S, B), dtype=dt, device=dev)
    mcnt = torch.zeros((S, B), dtype=dt, device=dev)
    ma_val = tx.arrays["ma_val"]
    M = ma_val.shape[0]
    col_s = (torch.arange(S * K, dtype=dt, device=dev) // K)[:, None]  # seed slot per row
    col_k = (torch.arange(S * K, dtype=dt, device=dev) % K)[:, None]  # in-seed position
    for w in range(W):
        live = (w < nrec) & (wseed[w] < S)
        sl = torch.clamp(wseed[w], 0, S - 1)
        cnt = torch.where(live, wc[w], 0)
        u = U.tslot_get(used_s, sl)
        src = col_k - u[None, :]
        take = ((src >= 0) & (src < torch.clamp(cnt, max=K)[None, :])
                & live[None, :] & (col_s == sl[None, :]))
        pos = torch.clamp(ws[w][None, :] + torch.clamp(src, 0, K - 1), max=M - 1)
        eflat = torch.where(take, pos, eflat)
        evalid = evalid | take
        U.tslot_set(used_s, sl, live, torch.clamp(u + cnt, max=K))
        U.tslot_set(mcnt, sl, live, U.tslot_get(mcnt, sl) + cnt)
    if values:
        mvals = torch.where(evalid, ma_val[torch.clamp(eflat, 0, M - 1).long()], -1)
    else:
        # entry ids (-1 = empty): the caller resolves them against ma_val on
        # the host, which keeps the [S*K, B] value gather off the device
        mvals = torch.where(evalid, eflat, -1)
    mvals = mvals.reshape(S, K, B).permute(2, 0, 1)
    return (rec["slo"].t(), rec["shi"].t(), rec["sqs"].t(), rec["sqe"].t(), mvals, mcnt.t(),
            rec["ns"])


def markers_lmem_records_plain(tx: TorchIndex, qcodes, lengths, wsize: int, max_range: int,
                               ftk: int, W: int) -> dict:
    """The L-MEM machine of markers_lmem_lanes in torch, on any device (the
    seeding kernel's plain twin), from the ftab start of ftk-mers (0 where L
    is below the ftab's k): {wlo, whi [W, B], nrec [B]}, the range of every
    probe the lane makes (unwritten slots hold the empty (1, 0)), and its
    one seed {elo, ehi, eqs [B]}."""
    B, L = qcodes.shape
    dt = tx.idx_dtype
    dev = qcodes.device
    m = lengths.to(dt)

    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    i = torch.zeros(B, dtype=dt, device=dev)
    if ftk:
        kc = R.kmer_codes(tx, qcodes[:, L - ftk:])
        flo, fhi, hit = R.ftab_lookup(tx, kc)
        # search_ftab misses return the full range; the ftab jump happens for
        # every lane with m >= k (rowbowt.hpp:369-377)
        jump = m >= ftk
        use = jump & hit
        lo = torch.where(use, flo.to(dt), lo)
        hi = torch.where(use, fhi.to(dt), hi)
        i = torch.where(jump, ftk, 0).to(dt)
    window_ei = m
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    wlo = torch.ones((W, B), dtype=dt, device=dev)
    whi = torch.zeros((W, B), dtype=dt, device=dev)
    nrec = torch.zeros(B, dtype=dt, device=dev)
    elo = torch.ones(B, dtype=dt, device=dev)
    ehi = torch.zeros(B, dtype=dt, device=dev)
    eqs = torch.zeros(B, dtype=dt, device=dev)
    qflat = qcodes.reshape(-1).to(dt)  # row-major [B*L]: lane b col j at b*L+j
    lane_base = torch.arange(B, dtype=dt, device=dev) * L
    lf = R.lf_step_auto(tx)

    def record(tlo, thi, do, nrec):
        # the probe itself is deferred: its marker count is a pure function
        # of the range, so one bulk markers_bounds after the loop gives it
        go = do & ((thi - tlo + 1) <= max_range)
        slot = torch.clamp(nrec, max=W - 1)
        U.tslot_set(wlo, slot, go, tlo)
        U.tslot_set(whi, slot, go, thi)
        return nrec + go.to(dt)

    for _ in range(L):
        active = (~done) & (i < m)
        col = torch.clamp(L - 1 - i, 0, L - 1)
        c = qflat[(lane_base + col).long()]
        nlo, nhi = lf(tx, lo, hi, c)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        # failure: probe prev if i >= wsize, emit (prev, (m-i, m-1)), stop
        f_probe = fail & (i >= wsize)
        w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
        tlo = torch.where(fail, lo, nlo)  # prev_range is the pre-LF state
        thi = torch.where(fail, hi, nhi)
        nrec = record(tlo, thi, f_probe | w_trigger, nrec)
        window_ei = torch.where(w_trigger, m - i - 1, window_ei)
        elo = torch.where(fail, lo, elo)
        ehi = torch.where(fail, hi, ehi)
        eqs = torch.where(fail, m - i, eqs)
        done = done | fail
        lo = torch.where(ok, nlo, lo)
        hi = torch.where(ok, nhi, hi)
        i = torch.where(active, i + 1, i)
    # lanes that completed without failure: final probe + emit (rowbowt.hpp:399-403)
    fin = ~done
    nrec = record(lo, hi, fin & (hi >= lo) & (i >= wsize) & (m > 0), nrec)
    elo = torch.where(fin, lo, elo)
    ehi = torch.where(fin, hi, ehi)
    eqs = torch.where(fin, m - i, eqs)
    return dict(wlo=wlo, whi=whi, nrec=nrec, elo=elo, ehi=ehi, eqs=eqs)


def markers_lmem_lanes(tx: TorchIndex, qcodes, lengths, wsize: int,
                       max_range: int = 1 << 62, max_k: int = 16):
    """Batched inner loop of RowBowt::get_markers_lmems (rowbowt.hpp:341-404).

    One lane = one (read, start offset) pair: the caller expands a read of
    length m into m lanes holding its prefixes (lmem_expand).  Each lane runs
    ONE backward search until failure and emits exactly one seed: the failing
    prev_range or the completed final range (the reference's second fn call
    on the failure path passes an empty range, which out_fn drops,
    rb_markers.cpp:373).

    Requires the ftab (the reference exits without it, rowbowt.hpp:346-349);
    a missing kmer yields the full range (the search_ftab miss quirk), as in
    the reference.  Returns (elo, ehi, eqs [B], mvals [B, K], mcnt [B]); the
    seed's query span is (eqs, m-1).
    """
    B, L = qcodes.shape
    K = max_k
    dt = tx.idx_dtype
    dev = qcodes.device
    if not (tx.has_ftab and tx.ftab_k > 0):
        raise ValueError("ftab must be enabled! (rowbowt.hpp:346-349)")
    if tx.ftab_k - 1 > wsize:
        raise ValueError("wsize cannot be less than ftab k-1 (rowbowt.hpp:350-353)")
    ftk = tx.ftab_k if L >= tx.ftab_k else 0
    max_range = min(int(max_range), torch.iinfo(dt).max)
    W = L // max(wsize, 1) + 2
    rec = _machine(
        qcodes, lengths,
        lambda q, ln: markers_lmem_records_plain(tx, q, ln, wsize, max_range, ftk, W),
        lambda q, ln: cuda_seeds.launch_machine(tx, "lmem", q, ln, k=ftk, wsize=wsize,
                                                max_range=max_range, W=W, S=1))
    nrec = rec["nrec"]
    # the deferred bulk probe of every recorded range
    s_flat, cnt_flat = R.markers_bounds(tx, rec["wlo"].reshape(-1), rec["whi"].reshape(-1))
    ws = s_flat.reshape(W, B).to(dt)
    wc = cnt_flat.reshape(W, B).to(dt)

    # expansion: replay the chronological appends on [K, B] entry ids, one
    # ma_val gather at the end
    eb = torch.zeros((K, B), dtype=dt, device=dev)
    ev = torch.zeros((K, B), dtype=torch.bool, device=dev)
    cused = torch.zeros(B, dtype=dt, device=dev)
    ctot = torch.zeros(B, dtype=dt, device=dev)
    ma_val = tx.arrays["ma_val"]
    M = ma_val.shape[0]
    col_k = torch.arange(K, dtype=dt, device=dev)[:, None]
    for w in range(W):
        live = w < nrec
        cnt = torch.where(live, wc[w], 0)
        src = col_k - cused[None, :]
        take = (src >= 0) & (src < torch.clamp(cnt, max=K)[None, :]) & live[None, :]
        pos = torch.clamp(ws[w][None, :] + torch.clamp(src, 0, K - 1), max=M - 1)
        eb = torch.where(take, pos, eb)
        ev = ev | take
        cused = torch.where(live, torch.clamp(cused + cnt, max=K), cused)
        ctot = ctot + cnt
    cbuf = torch.where(ev, ma_val[torch.clamp(eb, 0, M - 1).long()], -1).t()
    return rec["elo"], rec["ehi"], rec["eqs"], cbuf, ctot


def lmem_expand(reads):
    """Expand reads into per-start-offset prefix lanes for markers_lmem_lanes.

    Returns (lane_reads, owner, koff): lane j holds reads[owner[j]][: len - koff[j]]
    in ascending koff order per read (the reference's outer k loop)."""
    lane_reads, owner, koff = [], [], []
    for r, b in enumerate(reads):
        mfull = len(b)
        for k in range(mfull):
            lane_reads.append(b[: mfull - k])
            owner.append(r)
            koff.append(k)
    return lane_reads, owner, koff
