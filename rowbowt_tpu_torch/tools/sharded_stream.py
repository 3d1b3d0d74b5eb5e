"""Streamed FASTQ over a SHARDED index on a (dp x idx) mesh of processes.

The port of scripts/sharded_stream.py (the config-5 deployment): every process
runs this same program; each streams its own FASTQ shard (no cross-process
input path), the index is position-sharded over the 'idx' axis
(parallel/sharded_dense.py) and replicated over 'dp'; each process writes
its own shard's results in its own input order.  One process is one rank on
one device, so --n-idx must divide the number of processes.

    python -m rowbowt_tpu_torch.tools.sharded_stream IDX_PREFIX READS.fq \\
        [--n-idx 2] [--batch-size 4096] [-m | --greedy] \\
        [--coordinator host0:1234 --num-processes N --process-id i
         [--hosted-coordinator]] [--device cuda] [--backend nccl|gloo]

A single process without --coordinator runs with no process group (the
index whole on its device).  Process 0 hosts the coordinator's store, unless
--hosted-coordinator: then the caller that starts the processes hosts it
(parallel/multihost.host_store, which holds its port from the moment it is
chosen) and every process joins it.  --backend defaults to nccl on cuda and gloo on
cpu; several processes on one card need gloo (NCCL refuses two ranks on one
device).  Processes that stream different numbers of batches, or use
different batch sizes, raise on every rank with the sizes named.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inpre")
    p.add_argument("fastq", help="this process's FASTQ shard")
    p.add_argument("--n-idx", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("-m", "--markers", action="store_true")
    p.add_argument("--greedy", action="store_true",
                   help="greedy-seeding genotyping (the rb_markers "
                        "production path), fwd+revcomp per read")
    p.add_argument("--wsize", type=int, default=10)
    p.add_argument("--max-range", type=int, default=1000)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--hosted-coordinator", action="store_true",
                   help="the store at --coordinator is hosted by the caller "
                        "(multihost.host_store): process 0 joins it too")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: card process_id %% cards; "
                        "an error when CUDA is absent)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default nccl on cuda, gloo on cpu)")
    args = p.parse_args(argv)

    from rowbowt_tpu_torch.parallel import multihost as mh

    device = mh.init(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend, device=args.device, hosted=args.hosted_coordinator)
    try:
        return _stream(args, device)
    finally:
        mh.shutdown()


def _stream(args, device) -> int:
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.parallel import multihost as mh
    from rowbowt_tpu_torch.parallel.sharded_dense import ShardedDenseIndex

    want_ma = args.markers or args.greedy

    t0 = time.perf_counter()
    mesh = mh.global_mesh(device, n_idx=args.n_idx)
    if BigIndex.is_big_dir(args.inpre):
        # the big two-level artifact: its superblock layout IS the shard
        # layout (n_idx must equal n_sup); O(R)/O(M) aux tables replicate
        idx = BigIndex.load(args.inpre)
        if args.n_idx != idx.n_sup:
            print(f"error: big artifact is packed for n_idx == {idx.n_sup} "
                  f"(its superblock count); got --n-idx {args.n_idx}",
                  file=sys.stderr)
            return 1
        if want_ma and not idx.has_markers:
            print("error: index has no marker array (build with -m)",
                  file=sys.stderr)
            return 1
        sdx = idx.sharded_index()
    else:
        # no stream mode locates: the SA samples, document list and ftab
        # stay on disk (the JAX script loads them and reads none)
        idx = RbtIndex.load(args.inpre, with_sa=False, with_ma=want_ma, with_dl=False,
                            with_ft=False)
        if want_ma and idx.ma_row is None:
            print("error: index has no marker array (build with -m)",
                  file=sys.stderr)
            return 1
        sdx = ShardedDenseIndex.build(idx, n_idx=args.n_idx)
        if want_ma and sdx.ms2 is None:
            print("error: index markers lack the dense ma_start1 table "
                  "(rebuild with dense=True)", file=sys.stderr)
            return 1
    tables = sdx.device_put(mesh)

    comp = None
    if args.greedy:
        # complement table over index codes for the revcomp lanes
        tab = idx.alpha.encode_table()
        comp = np.full(16, -1, dtype=np.int64)
        for x, y in zip(b"ACGT", b"TGCA"):
            cx, cy = int(tab[x]), int(tab[y])
            if cx >= 0 and cy >= 0:
                comp[cx] = cy

    load_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with contextlib.closing(iter_query_batches(idx, args.fastq, args.batch_size)) as batches:
        reads = _loop(args, mesh, sdx, tables, batches, comp, sys.stdout)
    sys.stdout.flush()
    # this process's meter on stderr, as the CLIs print theirs: load and
    # query seconds, its reads, the idx all-reduces, the peak device memory
    print("stream: " + json.dumps({
        "rank": mesh.rank, "load_s": load_s, "query_s": time.perf_counter() - t0,
        "reads": reads, "allreduces": mesh.allreduces, "allreduce_s": mesh.allreduce_s,
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else None)}), file=sys.stderr)
    return 0


def _loop(args, mesh, sdx, tables, batches, comp, out) -> int:
    """The stream's batches; returns this process's reads."""
    from rowbowt_tpu_torch.index import marker_allele, marker_pos
    from rowbowt_tpu_torch.parallel import multihost as mh
    from rowbowt_tpu_torch.parallel.sharded_dense import (
        find_ranges_sharded_dense,
        find_ranges_w_markers_sharded_dense,
        markers_greedy_seeding_sharded_dense,
    )

    step = reads = 0
    while True:
        # every process agrees on the next step: a batch each, or the end
        nxt = next(batches, None)
        Lg = mh.agree_batch(mesh, None if nxt is None else nxt[1], step)
        if Lg is None:
            return reads
        step += 1
        names, qc, lens = nxt
        B = len(names)
        reads += B
        if qc.shape[1] < Lg:  # right-aligned codes: pad on the left
            qc = np.concatenate([np.full((qc.shape[0], Lg - qc.shape[1]), -1, qc.dtype), qc],
                                axis=1)
        if args.greedy:
            # fwd+rc interleaved lanes (rb_markers.cpp:396-400); reads are
            # right-aligned so the reversed read stays right-aligned for
            # full-width lanes and re-right-aligns otherwise
            L = qc.shape[1]
            fwd = qc.astype(np.int64)
            rc = np.full_like(fwd, -1)
            for b in range(B):
                m = int(lens[b])
                r = fwd[b, L - m:]
                rc[b, L - m:] = comp[np.maximum(r[::-1], 0)]
                rc[b, L - m:][r[::-1] < 0] = -1
            inter = np.full((2 * qc.shape[0], L), -1, dtype=np.int32)
            inter[0::2] = fwd
            inter[1::2] = rc
            ilens = np.repeat(lens, 2)
            gqc = mh.host_batch_to_global(mesh, inter)
            glen = mh.host_batch_to_global(mesh, ilens.astype(np.int32))
            slo, shi, sqs, sqe, mvals, mcnt, ns = \
                markers_greedy_seeding_sharded_dense(
                    mesh, sdx, tables, gqc, glen, wsize=args.wsize,
                    max_range=args.max_range)
            ns_h = mh.my_rows(mesh, ns, inter.shape[0])
            mv_h = mh.my_rows(mesh, mvals, inter.shape[0])
            mc_h = mh.my_rows(mesh, mcnt, inter.shape[0])
            for b, name in enumerate(names):
                for strand, lane in (("+", 2 * b), ("-", 2 * b + 1)):
                    got = []
                    for s_ in range(mv_h.shape[1]):
                        k = min(int(mc_h[lane, s_]), mv_h.shape[2])
                        got += [int(v) for v in mv_h[lane, s_, :k] if v >= 0]
                    parts = [f"{name} {strand} seeds={int(ns_h[lane])}"
                             " markers: "] + [
                        f"{int(marker_pos(np.int64(v)))}/"
                        f"{int(marker_allele(np.int64(v)))} " for v in got]
                    out.write("".join(parts) + "\n")
            continue
        gqc = mh.host_batch_to_global(mesh, qc.astype(np.int32))
        glen = mh.host_batch_to_global(mesh, lens.astype(np.int32))
        if args.markers:
            lo, hi, buf, used, ovf = find_ranges_w_markers_sharded_dense(
                mesh, sdx, tables, gqc, glen, wsize=args.wsize, max_k=32)
            buf_h = mh.my_rows(mesh, buf, qc.shape[0])
            used_h = mh.my_rows(mesh, used, qc.shape[0])
        else:
            lo, hi = find_ranges_sharded_dense(mesh, sdx, tables, gqc, glen)
        # every process WRITES ITS OWN shard's results, in its own input
        # order (only this process knows its read names)
        lo_h = mh.my_rows(mesh, lo, qc.shape[0])
        hi_h = mh.my_rows(mesh, hi, qc.shape[0])
        for b, name in enumerate(names):
            s, e = int(lo_h[b]), int(hi_h[b])
            cnt = e - s + 1 if e >= s else 0
            out.write(f"{name} ({s},{e}), count={cnt}\n")
            if args.markers:
                K = buf_h.shape[1]
                got = [int(x) for x in buf_h[b, K - int(used_h[b]):]]
                parts = ["\tmarkers: "] + [
                    f"{int(marker_pos(np.int64(v)))}/"
                    f"{int(marker_allele(np.int64(v)))} " for v in got]
                out.write("".join(parts) + "\n")


if __name__ == "__main__":
    sys.exit(main())
