"""rbt_markers — marker genotyping (rb_markers equivalent, src/rb_markers.cpp)
on an explicit torch device.

Per read: N-normalize, query BOTH strands with greedy seeding (or --lmem),
emit one line per seed in MarkerSeed::print_buf format (rb_markers.cpp:250-261):

    <name> <range_size> <+|-> <query_start> <query_len> <seq/pos/allele ...| .>

Output is byte-identical to `python -m rowbowt_tpu.cli.rbt_markers` and
mirrors the reference's filters: the standard path sorts+uniques markers per
seed gated by --min-range; --heuristic additionally applies
--clear-conflicting / --clear-identical per seed, the early strand stop, and
the --best-strand-only / --min-seed-length seed filters (rb_markers.cpp:
440-463, 504-506).  Output is in input-read order, and --heuristic starts
with the forward strand.

The greedy loop runs as torch ops on --device (default cuda, an error when
CUDA is absent; `--device cpu` for the CPU); marker values resolve from the
loop's entry ids on the host.  The index may be a two-level BigIndex
directory (n >= 2^31), which carries no ftab: `-f` then runs without it,
and `--lmem`, which needs it, refuses, as in the JAX CLI.  `--profile DIR` writes a torch.profiler trace
of the query loop to DIR.  The load and query seconds, a reads/s and seeds/s
meter, and the seconds of each stage of the query loop (`stages: {...}`,
common.StageClock) go to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from rowbowt_tpu_torch.alphabet import normalize_read
from rowbowt_tpu_torch.cli.common import (
    StageClock, Timer, device_index, eprint, iter_query_batches, load_index, pow2_at_least,
)
from rowbowt_tpu_torch.engine.filters import (
    MarkerSeed, _u64, assemble_seeds, heuristic_stop, keep_seeds_best_strand,
    keep_seeds_by_len,
)
from rowbowt_tpu_torch.engine.seeds import (
    lmem_expand, markers_greedy_seeding, markers_lmem_lanes,
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_markers", description=__doc__)
    p.add_argument("inpre")
    p.add_argument("fastq")
    p.add_argument("-w", "--wsize", type=int, default=10)
    p.add_argument("-r", "--max-range", type=int, default=1000)
    p.add_argument("-m", "--min-range", type=int, default=0)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for parity; batching replaces the pool")
    p.add_argument("-u", "--max-tasks", type=int, default=1024,
                   help="accepted for parity")
    p.add_argument("-l", "--read-len", type=int, default=101)
    p.add_argument("-y", "--min-seed-length", type=int, default=0)
    p.add_argument("-f", "--ftab", action="store_true")
    p.add_argument("--lmem", action="store_true")
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--heuristic", action="store_true")
    p.add_argument("--best-strand-only", action="store_true", dest="best_strand")
    p.add_argument("--clear-conflicting", action="store_true")
    p.add_argument("--clear-identical", action="store_true")
    p.add_argument("-x", "--fbb", action="store_true",
                   help="accepted for reference-CLI parity; the dense occ "
                        "tables are this design's fbb analog (see README)")
    p.add_argument("-b", "--batch-size", type=int, default=2048)
    p.add_argument("--max-seeds", type=int, default=8)
    p.add_argument("--max-markers", type=int, default=32)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the query loop to DIR "
                        "(a Chrome trace, with the card's kernels and copies on "
                        "a CUDA device; view with Perfetto or chrome://tracing)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and the queries "
                        "(default cuda; an error when CUDA is absent)")
    args = p.parse_args(argv)

    if args.overlap:
        eprint("overlapped seeds currently broken")  # rb_markers.cpp:121-124
        return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() "
                           "is False (pass --device cpu)")

    t = Timer()
    eprint("loading rowbowt + markers" + (" and ftab" if args.ftab else ""))
    idx = load_index(args.inpre, sa=False, ma=True, dl=False,
                     ft=args.ftab or args.lmem)
    if idx.ma_row is None:
        eprint("error: index has no marker array (build with -m)")
        return 1
    tx = device_index(idx, device, ma=True)
    eprint(f"loading rowbowt + markers took: {t.lap()} seconds")

    t = Timer()
    out = sys.stdout
    clock = StageClock(device)
    n_reads = n_seeds = 0

    def filter_and_print(name, seq_len, seeds_by_strand):
        """Per-read filter pipeline (rb_markers.cpp:365-382 standard,
        :440-463 + :504-506 heuristic) over [("+", seeds), ("-", seeds)]."""
        nonlocal n_seeds
        read_len = args.read_len if args.heuristic else seq_len
        seeds = []
        stopped = False
        for _, ss in seeds_by_strand:
            if stopped:
                break
            for ms in ss:
                if args.heuristic:
                    if ms.query_len < args.min_seed_length:
                        continue  # heuristic out_fn drop (rb_markers.cpp:447)
                    if args.clear_conflicting:
                        ms.clear_if_conflicting(read_len)
                    if args.clear_identical:
                        ms.filter_identical_pos()
                seeds.append(ms)
                if args.heuristic and args.best_strand and heuristic_stop(
                        ms, read_len, args.min_seed_length):
                    stopped = True
                    break
        if args.heuristic:
            if args.best_strand:
                seeds = keep_seeds_best_strand(seeds)
            if args.min_seed_length:
                seeds = keep_seeds_by_len(seeds, args.min_seed_length)
        n_seeds += len(seeds)
        return "".join(ms.print_buf() + "\n" for ms in seeds)

    from rowbowt_tpu_torch.cli.rbt_align import profile_to

    with contextlib.ExitStack() as stack:  # the trace flushes even if the loop raises
        if args.profile:
            stack.enter_context(profile_to(args.profile, device))
        run = _run_lmem if args.lmem else _run_greedy
        for n_reads, reads in run(args, idx, tx, clock):
            with clock("format"):
                out.write("".join(filter_and_print(*r) for r in reads))
    if args.profile:
        eprint(f"profiler trace written to {args.profile}")
    query_s = t.lap()
    eprint(f"counting markers took: {query_s} seconds")
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s, {n_seeds/query_s:,.0f} seeds/s")
    eprint(clock.line())
    return 0


def greedy_on_device(args, idx, tx, qc, lens, clock):
    """One greedy batch on tx.device: (slo, shi, sqs, sqe, mvals, mcnt, ns) as
    numpy arrays, the marker values resolved on the host from the loop's
    entry ids (which keeps the [S*K, B] value gather off the device and halves
    the copy back)."""
    with clock("h2d"):
        q = torch.from_numpy(np.ascontiguousarray(qc)).to(tx.device)
        ln = torch.from_numpy(np.ascontiguousarray(lens)).to(tx.device)
    with clock("greedy"):
        res = markers_greedy_seeding(
            tx, q, ln, wsize=args.wsize, max_range=args.max_range,
            max_seeds=args.max_seeds, max_k=args.max_markers, use_ftab=args.ftab,
            values=False)
    with clock("d2h"):
        slo, shi, sqs, sqe, mids, mcnt, ns = (t.cpu().numpy() for t in res)
    with clock("resolve"):
        mvals = np.where(mids >= 0,
                         idx.ma_val[np.clip(mids, 0, idx.ma_val.shape[0] - 1)], -1)
    return slo, shi, sqs, sqe, mvals, mcnt, ns


def _run_greedy(args, idx, tx, clock):
    """The greedy path: yields, per batch, (reads so far, [(name, read
    length, [("+", seeds), ("-", seeds)]) per read])."""
    # --heuristic --best-strand-only: the reference's heuristic worker only
    # computes the second strand when the first didn't stop early
    # (rb_markers.cpp:429-519).  Batched form: the forward strand first, then
    # ONE compacted reverse-strand batch holding only the reads that didn't
    # stop.  RBT_NO_STRAND_SKIP=1 forces the always-both-strands path.
    heur_skip = (args.heuristic and args.best_strand
                 and not os.environ.get("RBT_NO_STRAND_SKIP"))
    n_reads = 0
    for names, qc, lens in clock.iterate("parse", iter_query_batches(
        idx, args.fastq, args.batch_size, normalize=True, with_rc=not heur_skip,
    )):
        n_reads += len(names)
        if heur_skip:
            yield n_reads, _greedy_heuristic_batch(args, idx, tx, names, qc, lens, clock)
            continue
        res = greedy_on_device(args, idx, tx, qc, lens, clock)
        with clock("assemble"):
            reads = []
            for ri, name in enumerate(names):
                rl = int(lens[2 * ri])
                reads.append((name, rl, [
                    (strand, assemble_seeds(name, strand, rl, *(a[lane] for a in res),
                                            min_range=args.min_range, max_k=args.max_markers))
                    for lane, strand in ((2 * ri, "+"), (2 * ri + 1, "-"))]))
        yield n_reads, reads


def rc_lanes(idx, qc, lens):
    """Reverse complements of right-aligned code lanes, in code space: the
    complement table over the index codes of A/C/G/T, reversed and
    right-aligned again (-1 stays -1)."""
    L = qc.shape[1]
    comp = np.full(16, -1, dtype=qc.dtype)
    tab = idx.alpha.encode_table()
    for x, y in zip(b"ACGT", b"TGCA"):
        cx, cy = int(tab[x]), int(tab[y])
        if cx >= 0 and cy >= 0:
            comp[cx] = cy
    rc_left = np.where(qc[:, ::-1] >= 0, comp[np.maximum(qc[:, ::-1], 0)], -1)
    shift = (L - lens.astype(np.int64))[:, None]
    src = np.arange(L, dtype=np.int64)[None, :] - shift
    return np.where(src >= 0, np.take_along_axis(rc_left, np.clip(src, 0, L - 1), 1), -1)


def _greedy_heuristic_batch(args, idx, tx, names, qc, lens, clock):
    """One --heuristic --best-strand-only batch with the strand skip:
    [(name, read length, [("+", seeds), ("-", seeds)]) per read]."""
    K = args.max_markers
    f = greedy_on_device(args, idx, tx, qc, lens, clock)
    read_len = args.read_len
    with clock("assemble"):
        fwd_seeds = []
        need_rc = []
        for ri, name in enumerate(names):
            ss = assemble_seeds(name, "+", int(lens[ri]), *(a[ri] for a in f),
                                min_range=args.min_range, max_k=K)
            fwd_seeds.append(ss)
            stopped = any(
                ms.query_len >= args.min_seed_length
                and heuristic_stop(ms, read_len, args.min_seed_length)
                for ms in ss)
            if not stopped:
                need_rc.append(ri)

    rc_seeds = {ri: [] for ri in range(len(names))}
    if need_rc:
        with clock("rc"):
            rc = rc_lanes(idx, qc[need_rc], lens[need_rc])
            sublens = lens[need_rc]
            # lanes bucketed to powers of two
            pad = pow2_at_least(len(need_rc), floor=min(64, args.batch_size)) - len(need_rc)
            if pad:
                rc = np.concatenate([rc, np.full((pad, rc.shape[1]), -1, rc.dtype)])
                sublens = np.concatenate([sublens, np.zeros(pad, sublens.dtype)])
        r = greedy_on_device(args, idx, tx, rc, sublens, clock)
        with clock("assemble"):
            for j, ri in enumerate(need_rc):
                rc_seeds[ri] = assemble_seeds(
                    names[ri], "-", int(lens[ri]), *(a[j] for a in r),
                    min_range=args.min_range, max_k=K)
    return [(name, int(lens[ri]), [("+", fwd_seeds[ri]), ("-", rc_seeds[ri])])
            for ri, name in enumerate(names)]


def _run_lmem(args, idx, tx, clock):
    """--lmem: one lane per (read, strand, start offset) prefix; each lane
    emits at most one seed (rowbowt.hpp:341-404).  Yields like _run_greedy."""
    from rowbowt_tpu_torch.alphabet import revcomp
    from rowbowt_tpu_torch.engine.batch import encode_batch
    from rowbowt_tpu_torch.io.fastq import batched, read_seqs

    K = args.max_markers
    n_reads = 0
    for recs in clock.iterate("parse", batched(read_seqs(args.fastq), args.batch_size)):
        n_reads += len(recs)
        with clock("expand"):
            strand_seqs = []  # (rec idx, strand, normalized seq)
            for ri, (_, seq, _) in enumerate(recs):
                s = normalize_read(seq)
                strand_seqs.append((ri, "+", s))
                strand_seqs.append((ri, "-", revcomp(s)))
            lane_reads, owner, _ = lmem_expand([s.tobytes() for _, _, s in strand_seqs])
            L = pow2_at_least(max((len(b) for b in lane_reads), default=1))
            qc, lens = encode_batch(idx, lane_reads, pad_to=L)
        with clock("h2d"):
            q, ln = (torch.from_numpy(a).to(tx.device) for a in (qc, lens))
        with clock("lmem"):
            res = markers_lmem_lanes(tx, q, ln, wsize=args.wsize,
                                     max_range=args.max_range, max_k=K)
        with clock("d2h"):
            elo, ehi, eqs, mvals, mcnt = (t.cpu().numpy() for t in res)
        with clock("assemble"):
            # group lanes back per (read, strand) in koff order
            per_rec: dict[int, list] = {ri: [("+", []), ("-", [])] for ri in range(len(recs))}
            for j, own in enumerate(owner):
                ri, strand, s = strand_seqs[own]
                if ehi[j] < elo[j]:
                    continue  # out_fn drops empty ranges
                name = recs[ri][0]
                qs, qe = int(eqs[j]), len(lane_reads[j]) - 1
                query_start = len(s) - qs - 1 if strand == "-" else qs
                markers: list[int] = []
                rs = _u64(int(ehi[j]) - int(elo[j]) + 1)
                if rs >= args.min_range and int(mcnt[j]) > 0:
                    markers = sorted({int(v) for v in mvals[j, : min(int(mcnt[j]), K)]
                                      if v != -1})
                ms = MarkerSeed(name, strand, rs, query_start,
                                _u64(qe - qs + 1), markers)
                per_rec[ri][0 if strand == "+" else 1][1].append(ms)
        yield n_reads, [(name, len(seq), per_rec[ri]) for ri, (name, seq, _) in enumerate(recs)]


if __name__ == "__main__":
    sys.exit(main())
