"""rbt_locs — locate-then-positional-markers (rb_locs / rb_markers_tsa
equivalent, src/rb_markers_tsa.cpp:76-128) on an explicit torch device.

Greedy-seed locate via the toehold SA, then look up markers by TEXT position
span [l, l+readlen-1] in the positional marker index (<inpre>.midx.npz, built
by rbt_midx).  Output per read (rb_markers_tsa.cpp:76-88), byte-identical to
`python -m rowbowt_tpu.cli.rbt_locs`:

    <name>[ <seq>/<pos>/<allele>]...

The seeding, locate and marker probe run as torch ops on --device (default
cuda, an error when CUDA is absent; `--device cpu` for the CPU).  The index
may be a two-level BigIndex directory (n >= 2^31), with `<dir>.midx.npz`
beside it.  The load
and query seconds, a reads/s meter and the seconds of each stage of the query
loop (`stages: {...}`, common.StageClock) go to stderr.
"""

from __future__ import annotations

import argparse
import sys

import torch

from rowbowt_tpu_torch.cli.common import (
    StageClock, Timer, device_index, eprint, iter_query_batches, load_index, pow2_at_least,
)
from rowbowt_tpu_torch.engine.seeds import locate_from_longest_seed, seeds_greedy_w_sample
from rowbowt_tpu_torch.index import marker_allele, marker_pos, marker_seq
from rowbowt_tpu_torch.midx import PosMarkers, at_ranges_batched


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_locs", description=__doc__)
    p.add_argument("inpre")
    p.add_argument("fastq")
    p.add_argument("-w", "--wsize", type=int, default=19,
                   help="greedy seed min length")
    p.add_argument("-m", "--max-hits", type=int, default=4)
    p.add_argument("-o", "--output-prefix", dest="outpre", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and the queries "
                        "(default cuda; an error when CUDA is absent)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() "
                           "is False (pass --device cpu)")
    t_load = Timer()
    idx = load_index(args.inpre, sa=True, dl=True)
    midx_path = args.inpre.rstrip("/") + ".midx.npz"
    try:
        midx = PosMarkers.load(midx_path)
    except FileNotFoundError:
        eprint(f"error: positional marker index not found: {midx_path} "
               "(build it with rbt_midx or rbt_build -m)")
        return 1
    if idx.samples_last is None:
        eprint("error: index has no toehold SA (build with -s); "
               "rbt_locs needs locate support")
        return 1
    tx = device_index(idx, device, sa=True)
    mpos, mval = midx.device(device)
    eprint(f"loading the index took: {t_load.lap()} seconds")

    out = sys.stdout
    clock = StageClock(device)
    t_query = Timer()
    n_reads = 0
    for names, qc, lens in clock.iterate("parse", iter_query_batches(
            idx, args.fastq, args.batch_size)):
        n_reads += len(names)
        with clock("h2d"):
            q, lens_d = (torch.from_numpy(a).to(device) for a in (qc, lens))
        with clock("seeds"):
            res = seeds_greedy_w_sample(tx, q, lens_d, min_length=args.wsize)
        with clock("locate"):
            locs, cnt = locate_from_longest_seed(tx, *res, max_hits=args.max_hits)
        # every (read, location) pair probes the positional markers in one
        # [B*max_hits] batch (rle_window_arr::at_range per hit,
        # rb_markers_tsa.cpp:82); a lane with more markers than the width
        # widens the probe
        with clock("probe"):
            H = locs.shape[1]
            flat_l = locs.reshape(-1)
            flat_r = flat_l + torch.repeat_interleave(lens_d, H) - 1
            safe = flat_l >= 0
            mk = 8
            while True:
                vals, mcnt = at_ranges_batched(mpos, mval, torch.where(safe, flat_l, 0),
                                               torch.where(safe, flat_r, -1), mk)
                mcnt_h = mcnt.cpu().numpy()
                if mcnt_h.max(initial=0) <= mk:
                    break
                mk = pow2_at_least(int(mcnt_h.max()), floor=mk)
        with clock("d2h"):
            cnt_h, vals_h = cnt.cpu().numpy(), vals.cpu().numpy()
        with clock("format"):
            out.write(format_locs_lines(names, cnt_h, vals_h, mcnt_h, H))
    query_s = t_query.lap()
    eprint(f"locating markers took: {query_s} seconds")
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s")
    eprint(clock.line())
    return 0


def format_locs_lines(names, cnt, vals, mcnt, H: int) -> str:
    """One `<name>[ <seq>/<pos>/<allele>]...` line per read: the markers of
    each of its cnt[b] hits (rows b*H + j of vals/mcnt), hit by hit."""
    lines = []
    for b, name in enumerate(names):
        parts = [name]
        for j in range(int(cnt[b])):
            row = b * H + j
            v = vals[row, :int(mcnt[row])]
            parts += [f" {s}/{p}/{a}" for s, p, a in zip(
                marker_seq(v).tolist(), marker_pos(v).tolist(), marker_allele(v).tolist())]
        lines.append("".join(parts) + "\n")
    return "".join(lines)


if __name__ == "__main__":
    sys.exit(main())
