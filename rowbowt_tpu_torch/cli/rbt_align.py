"""rbt_align — per-read count / locate / markers (rb_align equivalent) on an
explicit torch device.

Output is byte-identical to rb_align's rb_report (src/rb_align.cpp:118-145)
and to `python -m rowbowt_tpu.cli.rbt_align`:
    <name> (<s>,<e>), count=<n>
    \\tlocs: <l>/<doc>:<off> ...          (-s; every occurrence unless
                                           --max-hits caps them)
    \\tmarkers: <pos>/<allele> ...        (-m; or the no-markers notice)
with the reference's quirks: an empty range prints (1,0) count=0, locate
order is toehold first then the phi chain, marker positions are 0-based.
Load time and query time go to stderr as "<load_s> <query_s>"
(rb_align.cpp:164-192), then the reads/s and LF-steps/s meter.

On a CUDA device the LF loop is the hand-written kernel K1 (the tables
kernel over the occ1, dense or run-space tables for an index without
fused-block rows); `--device cpu` runs the plain torch loop.  The index may be a
two-level BigIndex directory (n >= 2^31), where K1 runs over its int64 lanes
and `-s` takes each toehold from the search's trajectory; an index without
kval carries it step by step.  Locate and markers run on the real reads of
each batch only, never on the length-0 lanes that pad the last batch.  `-o` and
`-x` are accepted and unused, as in the JAX CLI; `--profile DIR` writes a
torch.profiler trace of the query loop to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from rowbowt_tpu_torch.cli.common import (
    Timer, device_index, eprint, iter_query_batches, load_index, pow2_at_least,
)
from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold, locate_ragged, resolve_docs
from rowbowt_tpu_torch.engine.markers import markers_for_ranges
from rowbowt_tpu_torch.index import marker_allele, marker_pos

NO_MARKERS = "no markers (consider building the marker array with a larger window size)"


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_align", description=__doc__)
    p.add_argument("inpre", help="index prefix (directory)")
    p.add_argument("fastq")
    p.add_argument("-o", "--output-prefix", dest="outpre", default=None)
    p.add_argument("-s", "--sam", action="store_true",
                   help="also locate (loads toehold SA + doc list)")
    p.add_argument("-m", "--markers", action="store_true",
                   help="also report markers over the final range")
    p.add_argument("-x", "--fbb", action="store_true",
                   help="accepted for reference-CLI parity; the index "
                        "self-describes its backend, so this is a no-op here "
                        "(rank-only -x indexes simply lack the toehold SA)")
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("--max-hits", type=int, default=None,
                   help="cap located occurrences (default: unbounded)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the query loop to DIR "
                        "(a Chrome trace, with the card's kernels and copies on "
                        "a CUDA device; view with Perfetto or chrome://tracing)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and the queries "
                        "(default cuda; an error when CUDA is absent)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() "
                           "is False (pass --device cpu for the plain loop)")

    t_load = Timer()
    idx = load_index(args.inpre, sa=args.sam, ma=args.markers, dl=args.sam)
    if args.sam and idx.samples_last is None:
        eprint("error: index has no toehold SA (built with -x or without -s); "
               "locate is unavailable — mirror of fbb_string's no-select limit "
               "(fbb_string.hpp:55-59)")
        return 1
    if args.markers and idx.ma_row is None:
        eprint("error: index has no marker array (build with -m); "
               "marker queries are unavailable")
        return 1
    tx = device_index(idx, device, sa=args.sam, ma=args.markers)
    load_s = t_load.lap()

    out = sys.stdout
    t_query = Timer()
    with contextlib.ExitStack() as stack:  # the trace flushes even if the loop raises
        if args.profile:
            stack.enter_context(profile_to(args.profile, device))
        n_reads, n_chars = _query_loop(args, idx, tx, out)
    if args.profile:
        eprint(f"profiler trace written to {args.profile}")
    query_s = t_query.lap()
    # the reference's "<load_s> <query_s>" stderr line (rb_align.cpp:164-192),
    # plus the reads/s and LF-steps/s meter
    eprint(f"{load_s} {query_s}")
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s, "
               f"{n_chars/query_s/1e6:,.1f} M LF-steps/s")
    return 0


def profile_to(trace_dir: str, device: torch.device):
    """A torch.profiler context that writes a Chrome trace
    (<host>_<pid>.<ns>.pt.trace.json) into trace_dir when it exits: host ops,
    plus the card's kernels and copies on a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))


def locate_hits(tx, lo, hi, k, max_hits):
    """Every lane's occurrences (toehold first, then the phi chain) with their
    documents: (flat positions, offsets [B+1], doc ids, offsets in the doc),
    numpy arrays.  Without a doc list the doc id is 0 and the offset the raw
    position."""
    flat, offs = locate_ragged(tx, lo, hi, k, max_hits=max_hits)
    return (flat, offs, *hit_docs(tx, flat))


def hit_docs(tx, flat):
    """(doc ids, offsets in the doc) of the text positions `flat`, numpy
    arrays: without a doc list, doc 0 and the raw position."""
    if "doc_starts" in tx.arrays and flat.size:
        d, off = resolve_docs(tx, torch.from_numpy(flat).to(tx.device))
        return d.cpu().numpy(), off.cpu().numpy()
    return np.zeros_like(flat), flat


def format_locs(doc_names, flat, offs, docs, doff):
    """The `\\tlocs: ` line of each lane."""
    entries = [f"{l}/{doc_names[d] if doc_names else '?'}:{o} "
               for l, d, o in zip(flat.tolist(), docs.tolist(), doff.tolist())]
    offs = offs.tolist()
    return ["\tlocs: " + "".join(entries[offs[b]:offs[b + 1]]) + "\n"
            for b in range(len(offs) - 1)]


def probe_markers(tx, lo, hi):
    """(vals [B, K], count [B]) numpy arrays holding every marker of each
    range: a probe 64 wide, then a re-probe at the widest count (rounded up
    to a power of two) when a lane has more."""
    vals, cnt = markers_for_ranges(tx, lo, hi, max_k=64)
    vals, cnt = vals.cpu().numpy(), cnt.cpu().numpy()
    if cnt.max(initial=0) > vals.shape[1]:
        vals, cnt = markers_for_ranges(tx, lo, hi,
                                       max_k=pow2_at_least(int(cnt.max()), floor=64))
        vals, cnt = vals.cpu().numpy(), cnt.cpu().numpy()
    return vals, cnt


def format_markers(vals, cnt):
    """The `\\tmarkers: ` line of each lane.  Only the lanes that have markers
    are decoded: most reads have none."""
    lines = [f"\tmarkers: {NO_MARKERS}\n"] * len(cnt)
    for b in np.flatnonzero(cnt).tolist():
        v = vals[b, :cnt[b]]
        lines[b] = "\tmarkers: " + "".join(
            f"{p}/{a} " for p, a in zip(marker_pos(v).tolist(), marker_allele(v).tolist())) + "\n"
    return lines


def _query_loop(args, idx, tx, out):
    n_reads = 0
    n_chars = 0
    for names, qc, lens in iter_query_batches(idx, args.fastq, args.batch_size):
        nr = len(names)
        n_reads += nr
        n_chars += int(np.asarray(lens).sum())
        q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
        if args.sam:
            lo, hi, k = find_ranges_w_toehold(tx, q, ln)
        else:
            lo, hi = find_ranges(tx, q, ln)
        # the real lanes only: a length-0 pad lane's range is the whole BWT
        lo, hi = lo[:nr], hi[:nr]
        # (1,0) -> count=0 (rb_align.cpp:122)
        cols = [[f"{name} ({s},{e}), count={e - s + 1 if e >= s else 0}\n"
                 for name, s, e in zip(names, lo.tolist(), hi.tolist())]]
        if args.sam:
            cols.append(format_locs(idx.doc_names,
                                    *locate_hits(tx, lo, hi, k[:nr], args.max_hits)))
        if args.markers:
            cols.append(format_markers(*probe_markers(tx, lo, hi)))
        out.write("".join("".join(parts) for parts in zip(*cols)))
    return n_reads, n_chars


if __name__ == "__main__":
    sys.exit(main())
