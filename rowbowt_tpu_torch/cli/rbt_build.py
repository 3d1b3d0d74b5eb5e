"""rbt_build — build a serialized index (rb_build equivalent, src/rb_build.cpp).

Two input modes:
  raw prefix mode (the reference's contract, rb_build.cpp:83-95):
      rbt_build [-s] [-l] [-f] [-k K] [-o OUT] <prefix>
    consumes <prefix>.bwt [.ssa .esa] [.docs] produced by pfbwt-f.
  native mode (replaces the out-of-repo pfbwt-f + vcf_to_bwt.py pipeline):
      rbt_build --fasta ref.fa [--vcf panel.vcf.gz] [--samples s1,s2] \
                [--wsize W] [-s] [-m] [-l] [-f] [-k K] -o OUT
    builds the haplotype-panel text + markers + docs in-process (native SA-IS).

--ftab-only rebuilds just the ftab of an existing index (rb_build.cpp:34-37).
The output is a directory holding the dense device tables (the index IS the
checkpoint, like the reference's .rbwt/.tsa/.mab/.docs/.ftab file set).

The port's copy of rowbowt_tpu/cli/rbt_build.py: the same flags, stderr lines
and outputs, and an index that loads in either package.  Building is host
code (numpy and the native SA-IS), so there is no --device.
"""

from __future__ import annotations

import argparse
import sys

from rowbowt_tpu_torch.cli.common import Timer, eprint


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_build", description=__doc__)
    p.add_argument("prefix", nargs="?", help="raw pfbwt-f input prefix")
    p.add_argument("-o", "--output-prefix", dest="out", default=None)
    p.add_argument("-s", "--tsa", action="store_true", help="build toehold SA")
    p.add_argument("-m", "--ma", action="store_true", help="build marker array")
    p.add_argument("-l", "--dl", action="store_true", help="build doc list")
    p.add_argument("-f", "--ft", action="store_true", help="build ftab")
    p.add_argument("-k", type=int, default=10, help="ftab k (default 10)")
    p.add_argument("--ftab-only", action="store_true",
                   help="rebuild only the ftab of an existing index")
    p.add_argument("--fasta", help="native mode: reference FASTA")
    p.add_argument("--vcf", help="native mode: VCF for the haplotype panel")
    p.add_argument("--samples", help="native mode: comma-separated sample subset")
    p.add_argument("--wsize", type=int, default=10,
                   help="marker window size (native mode, default 10)")
    p.add_argument("-x", "--fbb", action="store_true",
                   help="rank-only backend (the reference's fbb_string, "
                        "rowbowt_io.hpp:91-125): no toehold SA is built, so "
                        "count/markers work but locate does not; smaller index")
    p.add_argument("--no-dense", action="store_true",
                   help="skip dense occ tables (smallest index, slower queries)")
    p.add_argument("--emit-ref", metavar="PREFIX",
                   help="also emit the index in the reference's serialized "
                        "formats (PREFIX.rbwt/.tsa/.mab/.docs, "
                        "rowbowt_io.hpp:49-125)")
    args = p.parse_args(argv)

    from rowbowt_tpu_torch.index import RbtIndex

    t = Timer()
    if args.ftab_only:
        out = args.out or args.prefix
        if out is None:
            p.error("--ftab-only needs an index prefix")
        idx = RbtIndex.load(out)
        from rowbowt_tpu_torch.engine.naive import build_ftab_dense

        idx.ftab = build_ftab_dense(idx, args.k)
        idx.ftab_k = args.k
        idx.save(out)
        eprint(f"ftab rebuilt in {t.lap():.2f}s")
        return 0

    ftab_k = args.k if args.ft else 0
    if args.fbb and args.tsa:
        # mirror the reference's warning (rowbowt_io.hpp:106-108)
        eprint("Warning: fbb backend does not support the toehold suffix array")
        args.tsa = False
    if args.fasta:
        from rowbowt_tpu_torch.construct import build_panel
        from rowbowt_tpu_torch.construct.build import build_index_from_panel

        out = args.out
        if out is None:
            p.error("native mode requires -o/--output-prefix")
        eprint(f"constructing from {args.fasta}"
               + (f" + {args.vcf}" if args.vcf else ""))
        panel = build_panel(
            args.fasta, args.vcf, wsize=args.wsize,
            samples=args.samples.split(",") if args.samples else None,
        )
        idx = build_index_from_panel(
            panel, with_sa_samples=args.tsa, ftab_k=ftab_k,
            dense=not args.no_dense,
        )
        if args.ma:
            # also emit the positional marker index for rbt_locs
            from rowbowt_tpu_torch.midx import PosMarkers

            PosMarkers.from_panel(panel).save(out.rstrip("/") + ".midx.npz")
        else:
            idx.ma_row = idx.ma_val = None
        if not args.dl:
            idx.doc_starts = None
            idx.doc_names = None
    else:
        if args.prefix is None:
            p.error("provide a raw input prefix or --fasta")
        import os

        if not os.path.exists(args.prefix + ".bwt") and os.path.exists(
                args.prefix + ".rbwt"):
            # serialized reference index (rb_build output): .rbwt [.tsa .docs]
            from rowbowt_tpu_torch.construct.sdslio import load_serialized_index

            eprint(f"constructing from serialized {args.prefix}.rbwt")
            idx = load_serialized_index(
                args.prefix, ftab_k=ftab_k, dense=not args.no_dense,
                with_sa=args.tsa, with_docs=args.dl, with_ma=args.ma,
            )
        else:
            from rowbowt_tpu_torch.construct.rawio import build_index_from_raw

            eprint(f"constructing from raw {args.prefix}.bwt")
            idx = build_index_from_raw(
                args.prefix, with_sa=args.tsa, with_docs=args.dl,
                with_ma=args.ma, ftab_k=ftab_k, dense=not args.no_dense,
            )
        if args.ma and idx.ma_row is None:
            eprint(f"warning: -m requested but no {args.prefix}.mab found; "
                   "index built without markers")
        out = args.out or args.prefix + ".rbtidx"

    idx.save(out)
    if args.emit_ref:
        from rowbowt_tpu_torch.construct.sdslwrite import save_reference_format

        paths = save_reference_format(idx, args.emit_ref)
        eprint(f"emitted reference-format {', '.join(paths)}")
    if idx.ftab is not None:
        # also emit the reference's text serialization ("kmer s e" lines,
        # ftab.hpp:30-34) so the reference's rb_align can consume our ftab
        from rowbowt_tpu_torch.construct.rawio import write_ftab_text

        write_ftab_text(idx.ftab, idx.ftab_k, out.rstrip("/") + ".ftab")
    eprint(f"built index (n={idx.n}, R={idx.R}) -> {out} in {t.lap():.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
