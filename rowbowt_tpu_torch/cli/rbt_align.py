"""rbt_align — per-read count (rb_align equivalent) on an explicit torch device.

Output is byte-identical to rb_align's rb_report (src/rb_align.cpp:118-145)
and to `python -m rowbowt_tpu.cli.rbt_align` in count mode:
    <name> (<s>,<e>), count=<n>
with the reference's quirk that an empty range prints (1,0) count=0.  Load
time and query time go to stderr as "<load_s> <query_s>"
(rb_align.cpp:164-192), then the reads/s and LF-steps/s meter.

On a CUDA device the LF loop is the hand-written kernel K1; `--device cpu`
runs the plain torch loop.  Locate (-s) and markers (-m) are not yet ported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from rowbowt_tpu_torch.cli.common import (
    Timer, device_index, eprint, iter_query_batches, load_index,
)

NOT_PORTED = "not yet ported in rowbowt_tpu_torch"


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_align", description=__doc__)
    p.add_argument("inpre", help="index prefix (directory)")
    p.add_argument("fastq")
    p.add_argument("-s", "--sam", action="store_true",
                   help=f"also locate ({NOT_PORTED}: ROADMAP M2)")
    p.add_argument("-m", "--markers", action="store_true",
                   help=f"also report markers ({NOT_PORTED}: ROADMAP M3)")
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and the queries "
                        "(default cuda; an error when CUDA is absent)")
    args = p.parse_args(argv)

    if args.sam or args.markers:
        flag = "-s (locate, ROADMAP M2)" if args.sam else "-m (markers, ROADMAP M3)"
        eprint(f"error: {flag} is {NOT_PORTED}")
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() "
                           "is False (pass --device cpu for the plain loop)")

    t_load = Timer()
    idx = load_index(args.inpre)
    tx = device_index(idx, device)
    load_s = t_load.lap()

    out = sys.stdout
    t_query = Timer()
    n_reads, n_chars = _query_loop(args, idx, tx, out)
    query_s = t_query.lap()
    # the reference's "<load_s> <query_s>" stderr line (rb_align.cpp:164-192),
    # plus the reads/s and LF-steps/s meter
    eprint(f"{load_s} {query_s}")
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s, "
               f"{n_chars/query_s/1e6:,.1f} M LF-steps/s")
    return 0


def _query_loop(args, idx, tx, out):
    from rowbowt_tpu_torch.engine.count import find_ranges

    n_reads = 0
    n_chars = 0
    for names, qc, lens in iter_query_batches(idx, args.fastq, args.batch_size):
        n_reads += len(names)
        n_chars += int(np.asarray(lens).sum())
        lo, hi = find_ranges(tx, torch.from_numpy(qc).to(tx.device),
                             torch.from_numpy(lens).to(tx.device))
        lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
        lines = []
        for b, name in enumerate(names):
            s, e = int(lo_h[b]), int(hi_h[b])
            cnt = e - s + 1 if e >= s else 0  # (1,0) -> 0 (rb_align.cpp:122)
            lines.append(f"{name} ({s},{e}), count={cnt}\n")
        out.write("".join(lines))
    return n_reads, n_chars


if __name__ == "__main__":
    sys.exit(main())
