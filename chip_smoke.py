#!/usr/bin/env python3
"""Smoke run of the rowbowt_tpu_torch rbt_build, rbt_align, rbt_markers and
rbt_locs paths on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, then the kernel record
    python3 chip_smoke.py k1 parity       # only the named phases, in that order
                                          # (probes, parity, k1, phi_chain,
                                          # pfp_big, build_small, nodense_chr,
                                          # raw_chr, big_chr, greedy,
                                          # heuristic, lmem, locs, parallel_dp,
                                          # parallel_sharded, parallel_stream)

Builds the LF kernels (csrc/lf.cu: K1 and the tables kernel of an index
without fused rows), the gather probes P1-P3
(csrc/gather_probe.cu), the phi walk of rbt_align -s (csrc/phi_walk.cu) and
the seeding machines of rbt_markers and rbt_locs (csrc/seeds.cu), each with
nvcc for sm_90a, and the host library (SA-IS, FASTQ reader, BWT merge, PFP
and the CPU engine, g++), all five side by side, then starts
phase pfp_big's host build (a PFP panel above 2^31) in a child process
beside the phases before it (phase build_small's builds the same, and
phase raw_chr's after build_cli), and runs:

  1. device: the card's name and `nvidia-smi` name and power limit;
  2. build: seconds taken by each build, and nvcc's register reports (for
     the two-level instances also the lanes resident at once, and the
     machine instructions of lf.cu's step loops by cuobjdump: the two-level
     search's and the single-level K1's, its toehold instance's included);
  3. probes: the port's gather probe tool (`python -m
     rowbowt_tpu_torch.tools.gather_probe`) in this process, with its launch
     counts read, and once as a subprocess; P1-P3 against their plain twins
     and the numpy expectations at the tool's shapes, both timed per call
     with CUDA events, beside the one PyTorch call that computes P1 and P2,
     and each kernel alone (CUDA events just around its launch); P3 in each
     of its designs (the first design, and 1, 2 and 4 chains a thread), each
     equal to its plain twin and timed alone in turns, the L2's random-load
     rate from the same 4 MB table (the faster of P1 over 2^22 random
     indices and P3 over 2^20 lanes, which fill every SM), the
     dependent-load latency over that table, and P3's bound, the larger of
     its chain's latency and its loads over that rate; then at the edges of
     the 16-byte path (ragged, tiny, empty and 4-byte-aligned inputs, P2
     widths 1, 3, 100, 128) and every P3 design at ragged lane counts;
  4. parity: on the small synthetic panel (1 Mbp reference + 7 haplotypes,
     n ~ 8.0 M, ftab k = 10), 16,384 reads (with absent codes, reads shorter
     than k and length-0 lanes) through K1 and through `find_ranges_plain` on
     the card, for the 64B and 96B row layouts with the ftab on and off:
     every (lo, hi) equal; 1,000 of them also equal to a host run-space
     search that never reads the row tables; then K1 == plain in each
     layout at the edges of its staging and ftab start (widths 1, k - 1, k,
     99, 100, two views off a 16-byte boundary, one lane, and L = 3,072,
     which is not staged); then K1 over the two-level rows of the same BWT
     (BigIndex.from_codes, n_sup = 4: the bit planes made from fb2_64, fb2
     and fb2_256, each equal to its nibble rows through
     engine/device.nibbles_of_planes) against the
     plain loop and the single-level rows' ranges, on the batch and at the
     same edges, and its record launch (lo, hi and the [L, B] step record) against the torch
     loop that records (cuda_lf.find_ranges_record_plain) there too; then
     the phi walk kernel against its plain twin (the torch walk) on the
     batch's -s toeholds over the dense index's phi1, over its BigIndex
     view's phi rows and over the predecessor search of the index without
     phi1, capped at 8 hits and uncapped on lanes of at most 4,096, and over
     the breakpoint table of the BigIndex with its phi rows withheld
     (phi_at) to the same positions, and the kval kernel (the dense
     index's lanes with their hi) against kval_walk_plain and the same
     positions; then K1's toehold launch against
     its plain twin (the torch loop of the per-step toehold) and the full-SA
     index's toeholds on the raw tables of the same BWT (no kval), over
     tk1 and over ltk, on the batch and at the edges of k1_edges; then the
     tables kernel over the same BWT's tables without fused rows in each
     rank policy (run-space with ltk, dense bwt4/occ_blk with ltk, occ1
     with tk1): its count search, with the ftab and without, against its
     plain twin and K1's ranges, and its toehold search against its plain
     twin and the full-SA toeholds, on the batch and at every edge (over
     the run-space tables with the run records and without, and over a
     bucket directory of one bucket, the largest iters); then
     the seeding kernel (seeds_parity) against its plain twins, every
     record table, in each machine (greedy, lmem, sample) over the dense
     index's fblock64 rows and its BigIndex view's fb2_64 rows (the
     sampled machine with its step record there; greedy and the sampled
     machine also over the fb2 and fb2_256 planes), with the ftab start and
     without, at the engines' capacities and at capacities that overflow
     (2 seeds, 2-3 records, max_range 20, min_length 0), on the batch,
     4,096 random-code lanes and the edges of k1_edges; the sampled
     machine's per-step toehold over the raw tables' fused rows (tk1, ltk);
     and every machine over each rank policy's tables (run-space, dense,
     occ1; the sampled machine with its per-step toehold, and with kval;
     over the run-space tables with the run records and without, and over
     the one-bucket directory);
  5. build_cli: the chr panel (20 Mbp reference + 7 haplotypes, 60,000
     variants, n ~ 160 M) written as a FASTA and a gzipped VCF of 7 haploid
     samples, parsed back to bench.py's text, documents and markers, and
     built once by `rbt_build_torch --fasta --vcf -s -m -l -f -k 10` in a
     child process started with the run, beside probes and parity (SA
     samples, markers at every site of every document with window 10, the
     document list, the ftab, `idx.midx.npz`): build seconds, peak RSS,
     index GB;
  6. main: the port's `rbt_align` count mode answers 262,144 reads of 100 bp
     in 65,536-read batches; its lines are counted and every range checked
     against `find_ranges_plain`; the CLI's own load and query seconds and its
     meter are recorded, its stages timed one by one, and the count call
     (K1 and its wrapper) and the plain loop over the four batches with CUDA
     events;
  7. k1_step1 and k1: K1 at chr on the same four batches, equal to the
     plain loop, its call time and device time alone, with and without the
     ftab; the work the batches need (a counting replay of the plain loop),
     P3's dependent-load latency on 32 lanes, the bound and the share of it
     K1 reaches;
  8. locate: `rbt_align -s` on the first 200,000 of those reads (the last
     batch is mostly padding); every read's ranges, hit count, distinct
     positions, text at each position, toehold and document offsets checked
     on the host; one kval walk launch a batch, no chain and no torch walk; stages
     timed one by one, the phi walk (walk_s), the document resolve (docs_s)
     and the locs text (text_s) apart;
  9. markers: `rbt_align -m` on the same reads; every read's markers checked
     against the host CSR without ma_start1; stages timed one by one;
 10. phi_chain: P3 over the chr phi1 table from one batch's toeholds, 100
     steps, against its plain twin, and the walk kernel (`locate`: the chain
     over phi1) on the same lanes against the torch walk; then the walk of
     rbt_align -s on the -s batches' real lanes (the kval kernel, each
     lane's hi handed) against its plain twins, timed per call and alone
     beside the empty kernel's floor, its bound (bytes alone: no chain) and
     share;
 11. greedy: `rbt_markers -f -b 32768` on the first 32,768 reads (both
     strands: 65,536 lanes in one batch, one launch of the greedy machine);
     every line of the first 8,192
     reads equal to the same CLI's with `--device cpu -b 8192`, the first 1,000 reads'
     lines equal to the scalar oracle's (engine/naive); reads/s, seeds/s,
     markers/s and the CLI's own stage seconds; then seeds_times: the
     greedy machine on that batch, lmem on the --lmem run's batch and
     sample on rbt_locs', each against its plain twin (the torch loop),
     call ms in turns, device µs alone, work, bound and share;
 12. heuristic: `--heuristic --best-strand-only -y 19 --clear-conflicting
     --clear-identical` on the same reads, with the strand skip and with
     RBT_NO_STRAND_SKIP=1: the same lines; the share of reads whose second
     strand was skipped; two greedy launches a batch (the forward strands,
     the compacted second strands);
 13. lmem: `--lmem` on the first 1,000 reads (one lmem launch); the first
     100 reads' lines equal to the oracle's;
 14. locs: `rbt_locs -b 32768` on the first 32,768 reads with the positional
     marker index that build_cli saved (one launch of the sampled
     machine); the first 1,000 lines equal to the oracle's greedy seeds,
     longest-seed locate (4 hits) and text-span marker lookup;
 14a. raw_chr: the chr index written as raw `.bwt/.ssa/.esa/.docs` and a
     `.mab` (write_mab) after phase 5, built from the prefix by
     `rbt_build_torch <prefix> -s -m -l` in a child process beside phases
     6-14 (fused rows, predecessor-built phi1, no kval; n above
     OCC1_MAX_N, so no occ1/tk1): rbt_align count, -s and -m print the lines
     of phases 6, 8 and 9; K1 once a batch of count and -m, its toehold
     launch (the per-step toehold over ltk) once a batch of -s; build
     seconds, peak RSS; the toehold launch against its plain twin and dense
     chr's toehold on every -s batch, the search + toehold stage with the
     torch loop and with the kernel in turns, and on one batch its call ms
     beside the twin's, its time alone beside K1's count instance alone on
     the same batch, work and bound, and the walk kernel over its phi1 (the
     chain) on the -s batches' real lanes (walk_times); then rbt_locs
     prints phase 14's lines with the sampled machine's per-step toehold
     over the fused rows (one launch a batch), timed on one batch
     (seeds_times);
 14b. nodense_chr: the chr index without fblock, kval, phi1 and ma_start1
     (what --no-dense writes): count and -m (the tables kernel's run-space
     count search once a batch; -m then the ma_row binary search) and -s
     (its toehold search once a batch, the walk kernel over the
     predecessor search) print the same lines; reads/s beside the dense
     index's; the count search on the count batches and the toehold search
     on the -s batches against their plain twins (the torch loops that
     ran on the card before the tables kernel), the stage before and after
     in turns, one
     batch timed per call and alone, its work, bound and share
     (tables_times); the walk kernel on the -s batches' lanes against the
     torch walk (walk_times); then rbt_markers -f, --heuristic and --lmem
     and rbt_locs print the lines of phases 11-14 with the seeding kernel
     over the run-space tables (greedy, L-MEM, and the sampled machine
     with its per-step toehold over ltk), one launch a batch (two for
     --heuristic), each machine timed on one batch of its path
     (seeds_times); every CLI's load reports the run-space tables it
     built (required); last, the directory's spans side by side on one
     batch of each of those five paths, each equal to the default span's
     (run_span_times);
 14c. big_chr: the chr panel's BigIndex view (n_sup = 4, locate tables as
     bench.py derives them, marker CSR, document list), saved as a big
     directory with the chr `idx.midx.npz` beside it: rbt_align count, -s
     and -m on it print the dense index's lines (phases 6, 8, 9), each with
     its stages timed one by one; rbt_markers -f (no ftab on a big index;
     one greedy launch) the dense index's lines without -f on the first
     8,192 reads and the oracle's on 1,000 reads; rbt_locs the lines of
     phase 14 (one launch of the sampled machine with its step record,
     timed on that batch against its twin); then K1 over
     fb2_64's bit planes on the first two of the main path's batches
     against the plain loop and against K1 over fblock64 (no ftab), call
     and device times, the bound (the planes' bytes, and the operations of
     lf.cu's step loop by cuobjdump where the build phase counted it) and
     its share, and K1 over the 96 B fb2 planes against the plain loop;
     the record launch (rbt_align -s's route: one a batch, no torch record
     loop) against its plain twin on those batches and at k1_edges over
     fb2_64, its call and device times beside K1's, the toehold's
     resolve and the bound with the record's bytes; the -m lines over the
     two marker routes of from_big (run pack, bucketed CSR) and the bounds
     of the nibble-count rows beside them, their seconds and table GB;
     the walk kernel over the phi rows on the -s batches' real lanes
     against its plain twin, timed per call and alone, with the longest
     lane's steps, the dependent-load latency of tables of the phi rows'
     and deltas' sizes, its bound and share;
 14d. pfp_big: the giant panel's widths (19.5 Mbp reference, 19,500 sites,
     W = 10, p = 100) with 112 haplotypes, n = 2,203,501,131, built by
     tools/build_giant_index.build in the child process (256-symbol rows;
     PFP and assembly seconds, peak RSS, n, R, M, parse stats) and assembled
     again with 128-symbol rows (fb2, fb2_64); K1 on the build tool's 65,536
     reads and on 65,536 random-code lanes over fb2_256, fb2_64 and fb2
     against the plain loop, the layouts' ranges equal, one launch a batch,
     the host rank over the 96 B rows on 256 lanes, final bounds above 2^31
     counted; each layout's bit-plane bytes and repack seconds, and its
     bound when phase k1 ran before; the CPU engine and the analytic counts
     on the first reads;
     rbt_align count, -s and -m and rbt_markers -f (one greedy launch over
     fb2_256) on the directory against
     the analytic oracle (counts, occurrence sets, marker multisets) and the
     CPU engine (locate, markers, greedy seeds); stages, reads/s; the
     record launch against its plain twin over every layout and lane set,
     timed over fb2_256 (-s's route: one record launch, no torch record
     loop, one walk kernel launch, no torch walk); the marker routes and the
     nibble rows' bounds, and the walk kernel's times and bound, as in
     big_chr;
 14e. build_small: the small panel through rbt_build_torch in every mode
     (native with --emit-ref, -x, --no-dense, the raw prefix with occ1 + tk1,
     the serialized .rbwt files, --ftab-only, a FASTA with IUPAC codes: 13
     codes, bwt4/occ_blk), each index's tables held against the dense one's
     and its rbt_align count, -s and -m lines against the dense index's (the
     13-code index against its --device cpu run and the scalar oracle);
     rbt_markers -f and rbt_locs on the raw index (one greedy launch; one
     launch of the sampled machine with its per-step toehold over the rows
     and tk1); rbt_markers -f and rbt_locs on the 13-code index (one launch
     each over its dense tables, the first 2,048 reads' lines equal to the
     --device cpu run's); the seeding engines on the raw index without its
     rows (greedy and the per-step sampled machine over occ1 and tk1, equal
     to the same index with its rows); those four instances timed on one
     batch (seeds_times); rbt_align -s over the PFP directory's breakpoint
     table (its phi rows withheld: one walk kernel launch over phi_at, the
     dense index's lines), the walk timed (walk_times); the routes of the tables
     kernel (--no-dense: run-space, the 13-code index: dense, the raw index
     without its fused rows: occ1, count and toehold against K1's); the
     dense and occ1 searches timed against their twins on one batch;
     then the pangenome builders' routes: the panel through the merge
     (merge_construct, from_codes, attach_locate, attach_markers) and through
     PFP (pfp_construct, assemble_bigindex), each a BigIndex directory whose
     rbt_align count lines are the dense index's, its -s and -m lines equal
     as sets (PFP's byte for byte);
 15. trace: `rbt_align -s --profile` on the reads of phase 8: the same lines,
     a trace that names K1's kernel, and the card's busy seconds in it
     against the CLI's query seconds;
 16. greedy_trace: `rbt_markers -f --profile` on the reads of phase 11: the
     same lines, the card's busy share, kernel launches per batch (below a
     tenth of the torch loop's 37,404) and the largest device items;
 17. parallel_dp: main's reads split over 4 ranks (processes on cuda:0 over
     gloo, rowbowt_tpu_torch/parallel), the chr count tables replicated, K1
     on every rank: the gathered ranges equal phase main's; then one rank
     over NCCL gives them too;
 18. parallel_sharded: chr R-sharded over 4 ranks and position-sharded at
     (1, 4) and (2, 2), the big_chr directory over 4 ranks and the pfp_big
     directory (above 2^31) over 3 through BigIndex.sharded_index: count,
     toehold, locate, window markers and greedy seeding, every gathered
     buffer equal to the single-device engine's; then
     tools/dryrun_multichip on 4 ranks;
 19. parallel_stream: tools/sharded_stream as 2 processes (count, -m,
     --greedy against the single-device engine) and as 4 on the big_chr
     directory, all at once, each process printing its own reads' lines.
Each multi-rank phase records reads/s over the query seconds, the
all-reduces a step and their microseconds, and each rank's load seconds
and peak device memory.
Phases 11-14 count K1's
launches (0 expected, not required) and require the seeding kernel's
(cuda_seeds.LAUNCHES_SEED, by route: one a batch, two for --heuristic;
raw_chr, nodense_chr and build_small the same over their indexes; no
seeding loop runs in torch on the card); big_chr
counts the two-level K1's (cuda_lf.LAUNCHES_FB2): one a batch of its count
and -m runs, none in -s, whose toehold search is the record launch
(cuda_lf.LAUNCHES_REC, one a batch, and no run of the torch record loop,
cuda_lf.RECORDS_PLAIN); pfp_big the same on its panel.  raw_chr,
nodense_chr and build_small count every route of the search (K1, K1 over
the two-level rows, the record launch, the toehold launch
(cuda_lf.LAUNCHES_TOE: rbt_align -s on an index without kval but with
fused rows, raw_chr and the small raw and serialized indexes), and the
tables kernel over an index without fused rows by rank policy and
instance (cuda_lf.LAUNCHES_TAB and LAUNCHES_TAB_TOE: count, -m and the -s
search of nodense_chr and of the small --no-dense, 13-code and
raw-without-rows indexes; no wrapper runs a torch search on the card), set
to 0 before each run, and require each.  The phi walk's launches are
counted the same way (cuda_phi.LAUNCHES, the chain on every phi route, and
cuda_phi.LAUNCHES_KVAL, the kval kernel): rbt_align -s launches one of
them once a batch on every index the whole run queries, the kval kernel
on dense chr and the small dense index, the chain elsewhere, nodense_chr's
predecessor search and build_small's breakpoint table included.

Every phase prints one JSON line.  Any failure raises, so the exit code is
non-zero and the last line is never printed.  The last three lines of a
whole run are the kernel record (with each kernel's bound), the card's name
and power limit, and {"ok": true, "device": {...}}.  Needs one CUDA card;
exits non-zero without one.  Uses no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
WORK = os.path.join(HERE, ".cache", "chip_smoke")  # gitignored scratch

# bench.py's synthetic panel configs: same text recipe and seeds
SMALL = dict(ref_len=1_000_000, n_haps=7, n_vars=3_000, seed=1234)
CHR = dict(ref_len=20_000_000, n_haps=7, n_vars=60_000, seed=4321)
FTAB_K = 10
MA_WSIZE = 10  # marker window, and the SEP run between documents (bench.py)
READ_LEN = 100
N_READS = 262_144
N_LOCATE = 200_000  # reads of the -s and -m runs: the last batch is 3,392 reads + 62,144 pads
BATCH = 65_536
PARITY_LANES = 16_384  # reads of phase parity's edge-case batch
N_HOST = 1_000  # lanes also checked against the host run-space search
PHI_STEPS = 100
N_GREEDY = 32_768  # reads of the rbt_markers and rbt_locs runs: one batch
GREEDY_BATCH = 32_768  # reads a batch: 65,536 lanes with both strands
N_GREEDY_CPU = 8_192  # reads also run with --device cpu (phase greedy) and without -f (big_chr)
N_ORACLE = 1_000  # reads checked against engine/naive
N_LMEM = 1_000
N_LMEM_ORACLE = 100
N_SUP_CHR = 4  # superblocks of the chr panel's BigIndex view (phase big_chr)
# phase pfp_big: the giant panel's widths (tools/build_giant_index.py) with 112 haplotypes
# of its 512, so n = 113 x 19,500,010 + 1 = 2,203,501,131 > 2^31; 65,536 reads, one batch
PFP_BIG = dict(ref_len=19_500_000, n_haps=112, n_vars=19_500, seed=424_242, w=MA_WSIZE,
               pfp_p=100, n_reads=BATCH, read_len=READ_LEN, n_parity=512)
PFP_BIG_LANE_SEED = 2024  # its random-code lanes
N_PFP_LOCATE = 16_384  # reads of its rbt_align -s run
N_PFP_CPU = 2_048  # reads also through the CPU engine (cpu_backend)
N_BIG_HOST = 256  # lanes also checked against the host rank over the 96 B rows


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **kv}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def panel_draw(cfg):
    """The random draws of bench.py's synthetic pangenome (bench.py:54-94), in
    its order: the reference, the sorted variant sites, the alternative base
    of each, and for each haplotype which sites carry it ([n_haps, n_vars])."""
    rng = np.random.default_rng(cfg["seed"])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=cfg["ref_len"])
    var_pos = np.sort(rng.choice(cfg["ref_len"], size=cfg["n_vars"], replace=False))
    var_alt = rng.choice(acgt, size=cfg["n_vars"])
    carry = np.stack([rng.random(cfg["n_vars"]) < 0.5 for _ in range(cfg["n_haps"])])
    return ref, var_pos, var_alt, carry


def panel(cfg):
    """bench.py's synthetic pangenome (bench.py:54-94): the reference and its
    haplotypes carrying random SNPs, each document followed by 10 SEP bytes,
    one final TERM.  Returns (text, doc_starts, markers): a marker at every
    variant site of every document, allele 1 where the haplotype carries the
    drawn alternative base."""
    from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
    from rowbowt_tpu_torch.construct.panel import Marker

    ref, var_pos, var_alt, carry = panel_draw(cfg)
    sep = np.full(MA_WSIZE, SEP_BYTE, dtype=np.uint8)
    parts, doc_starts, markers = [], [], []

    def add_doc(seq, alleles):
        start = sum(len(p) for p in parts)
        doc_starts.append(start)
        markers.extend(Marker(text_pos=start + p, seq=0, pos=p, allele=a)
                       for p, a in zip(var_pos.tolist(), alleles.tolist()))
        parts.extend([seq, sep])

    add_doc(ref, np.zeros(cfg["n_vars"], dtype=np.int64))
    for h in range(cfg["n_haps"]):
        hap = ref.copy()
        hap[var_pos[carry[h]]] = var_alt[carry[h]]
        add_doc(hap, carry[h].astype(np.int64))
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    return np.concatenate(parts), np.array(doc_starts, dtype=np.int64), markers


def write_panel_files(cfg, d: str, iupac: int = 0) -> tuple[str, str]:
    """The panel of `cfg` as the files a user builds from: a FASTA of one
    contig `chr` (the reference) and a gzipped VCF of its SNPs with one
    haploid sample a haplotype (hap0, hap1, ...; GT 1 where the haplotype
    carries the site's alternative base).  iupac > 0 puts that many IUPAC
    codes (N, R, Y, K, M, S, W) into the FASTA at seeded positions away from
    the sites.  Returns (fasta path, vcf path)."""
    import gzip

    ref, var_pos, var_alt, carry = panel_draw(cfg)
    if iupac:
        rng = np.random.default_rng(cfg["seed"] + 7)
        free = np.setdiff1d(np.arange(ref.shape[0]), var_pos)
        ref = ref.copy()
        ref[rng.choice(free, size=iupac, replace=False)] = rng.choice(
            np.frombuffer(b"NRYKMSW", dtype=np.uint8), size=iupac)
    os.makedirs(d, exist_ok=True)
    fa, vcf = os.path.join(d, "ref.fa"), os.path.join(d, "panel.vcf.gz")
    with open(fa, "wb") as f:
        f.write(b">chr synthetic\n")
        f.write(b"\n".join(ref[i:i + 80].tobytes() for i in range(0, ref.shape[0], 80)) + b"\n")
    samples = [f"hap{h}" for h in range(carry.shape[0])]
    gts = np.where(carry, "1", "0").T  # [n_vars, n_haps]
    with gzip.open(vcf, "wt", compresslevel=1) as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=chr>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        f.writelines(f"chr\t{p + 1}\t.\t{chr(r)}\t{chr(a)}\t.\tPASS\t.\tGT\t{chr(9).join(g)}\n"
                     for p, r, a, g in zip(var_pos.tolist(), ref[var_pos].tolist(),
                                           var_alt.tolist(), gts.tolist()))
    return fa, vcf


def sample_reads(text: np.ndarray, rng, n_reads: int) -> np.ndarray:
    """bench.py's reads: ACGT-only windows of the text, 20% with one substitution."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, len(text) - READ_LEN - 1, size=n_reads)
    reads = text[starts[:, None] + np.arange(READ_LEN)[None, :]]
    bad = ~np.isin(reads, acgt).all(axis=1)
    for i in np.flatnonzero(bad):
        while True:
            s = int(rng.integers(0, len(text) - READ_LEN - 1))
            r = text[s:s + READ_LEN]
            if np.isin(r, acgt).all():
                reads[i] = r
                break
    mut = rng.random(n_reads) < 0.2
    mpos = rng.integers(0, READ_LEN, size=n_reads)
    mchar = rng.choice(acgt, size=n_reads)
    reads[np.arange(n_reads)[mut], mpos[mut]] = mchar[mut]
    return reads


def edge_lanes(idx, reads: np.ndarray, rng):
    """Right-aligned [B, 128] codes from `reads`, with edge cases mixed in:
    an 'N' (absent from the index: code -1), reads shorter than the ftab k,
    reads of random length, and length-0 lanes."""
    from rowbowt_tpu_torch.engine.batch import encode_batch

    B = reads.shape[0]
    reads = reads.copy()
    kind = rng.random(B)
    lens = np.full(B, READ_LEN)
    with_n = kind < 0.05
    reads[np.flatnonzero(with_n), rng.integers(0, READ_LEN, size=int(with_n.sum()))] = ord("N")
    short = (kind >= 0.05) & (kind < 0.10)
    lens[short] = rng.integers(1, FTAB_K, size=int(short.sum()))
    ragged = (kind >= 0.10) & (kind < 0.20)
    lens[ragged] = rng.integers(FTAB_K, READ_LEN, size=int(ragged.sum()))
    lens[kind >= 0.98] = 0
    seqs = [reads[b, READ_LEN - lens[b]:].tobytes() for b in range(B)]
    qc, qlens = encode_batch(idx, seqs, pad_to=128)
    in_read = np.arange(qc.shape[1])[None, :] >= qc.shape[1] - qlens[:, None]
    counts = {"absent_code": int(((qc < 0) & in_read).any(axis=1).sum()),
              "shorter_than_k": int(((qlens > 0) & (qlens < FTAB_K)).sum()),
              "length_0": int((qlens == 0).sum())}
    return qc, qlens, counts


def host_ranges(idx, qc: np.ndarray, lens: np.ndarray, use_ftab: bool):
    """Batched backward search on the host over the run tables alone
    (engine/naive._lf_range_vec), the ftab start read from idx.ftab."""
    from rowbowt_tpu_torch.engine import naive

    B, L = qc.shape
    lo = np.zeros(B, np.int64)
    hi = np.full(B, idx.n - 1, np.int64)
    startj = np.zeros(B, np.int64)
    k = idx.ftab_k
    if use_ftab and idx.ftab is not None and L >= k > 0:
        base = np.full(idx.A + 1, -1, np.int64)  # code -> 2-bit base; base[-1] = -1
        base[naive.acgt_code_array(idx)] = np.arange(4)
        bases = base[qc[:, L - k:]]
        kmer = (bases * 4 ** np.arange(k - 1, -1, -1)).sum(axis=1)
        hit = (bases >= 0).all(axis=1) & (lens >= k)
        hit[hit] = idx.ftab[kmer[hit], 0] >= 0
        lo[hit], hi[hit], startj[hit] = idx.ftab[kmer[hit], 0], idx.ftab[kmer[hit], 1], k
    done = np.zeros(B, bool)
    for j in range(L):
        c = qc[:, L - 1 - j]
        active = ~done & (j >= startj) & (j < lens)
        nlo, nhi = np.ones(B, np.int64), np.zeros(B, np.int64)
        for code in range(idx.A):
            m = active & (c == code)
            nlo[m], nhi[m] = naive._lf_range_vec(idx, lo[m], hi[m], code)
        lo = np.where(active, nlo, lo)
        hi = np.where(active, nhi, hi)
        done |= active & (nlo > nhi)
    return lo, hi


def cuda_ms(fns, cycles: int) -> float:
    """Mean milliseconds per call of the fns on the card, by CUDA events, over
    `cycles` passes through the list after one warm-up pass."""
    import torch

    for fn in fns:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(cycles):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (cycles * len(fns))


def in_turns(plain, kernel, plain_cycles: int, kernel_cycles: int):
    """(kernel ms, plain ms) per call, timed plain, kernel, kernel, plain."""
    p = cuda_ms(plain, plain_cycles)
    k = (cuda_ms(kernel, kernel_cycles) + cuda_ms(kernel, kernel_cycles)) / 2
    return k, (p + cuda_ms(plain, plain_cycles)) / 2


SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock, more than any wrapper's host time


def start_event(start) -> None:
    """Record CUDA event `start` behind a spin of SPIN_CYCLES on the card."""
    import torch

    torch.cuda._sleep(SPIN_CYCLES)
    start.record()


def kernel_event_us(fns, passes: int) -> float:
    """Mean device microseconds of one kernel of each call, from two CUDA
    events that each fn(start, end) records just before and just after its
    kernel's launch, over `passes` passes through the list after a warm-up
    pass.  Before its start event each call queues a spin of SPIN_CYCLES on
    the card (start_event), so the host has queued the kernel by the time
    the card reaches the event, and the events time the kernel, not the
    host, even where the call is bound by the host; the first timed call
    is left out."""
    import torch

    for fn in fns:
        fn(None, None)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(passes * len(fns) + 1)]
    torch.cuda.synchronize()
    for i, (start, end) in enumerate(pairs):
        fns[i % len(fns)](start, end)
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs[1:]) * 1e3 / (len(pairs) - 1)


def around(fn):
    """fn() as a call for kernel_event_us: CUDA events start and end, when
    given, recorded just before (behind the spin) and just after it."""
    def call(start, end):
        if start is not None:
            start_event(start)
        out = fn()
        if end is not None:
            end.record()
        return out
    return call


def profiled_kernel_us(fns, passes: int, kernels: tuple[str, ...]) -> dict:
    """{kernel: mean µs a launch} from one torch.profiler trace of `passes`
    passes through fns, each launching one kernel named in `kernels` (a
    template's name or a function's); a kernel whose record count is not
    one per launch maps to None (the profiler in a long process has been
    seen to drop and repeat records)."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "kernel_us.pt.trace.json")
    prof.export_chrome_trace(path)
    events = device_events(path, ("kernel",))
    os.remove(path)
    launches = passes * len(fns) // len(kernels)
    out = {}
    for name in kernels:
        durs = [dur for ev_name, _, dur in events
                if name + "<" in ev_name or name + "(" in ev_name]
        out[name] = sum(durs) / len(durs) if len(durs) == launches else None
    return out


@contextlib.contextmanager
def timed(stages: dict, name: str):
    """Host-clock seconds of the block, closed by a device synchronize."""
    import torch

    t = time.perf_counter()
    yield
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t


GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a Chrome trace


def device_events(trace_path: str, cats=GPU_CATS) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every event of the categories `cats`
    (by default every kernel, copy and memset) that a torch.profiler Chrome
    trace recorded on the card."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in cats]


def busy_us(events) -> float:
    """Microseconds in which the card ran at least one of the events."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        total += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return total


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max().item()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, numpy=np.__version__)
    return {"name": name, "nvidia_smi": smi}


def phase_build() -> None:
    """The four nvcc builds and the g++ build, started together; the tables
    steps' threads a lane of the built lf.cu equal to cuda_lf.lane_threads;
    no instance of lf.cu, phi_walk.cu or seeds.cu spills (ptxas)."""
    import torch

    from rowbowt_tpu_torch.construct import sa
    from rowbowt_tpu_torch.ops import cuda_gather, cuda_lf, cuda_phi, cuda_seeds

    def seconds(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    builds = {"nvcc_lf": cuda_lf.build, "nvcc_gather_probe": cuda_gather.build,
              "nvcc_phi_walk": cuda_phi.build, "nvcc_seeds": cuda_seeds.build,
              "host": sa._load_native}
    with ThreadPoolExecutor(len(builds)) as ex:
        futures = {name: ex.submit(seconds, fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in futures.items()}
    check(done["host"][0] is not None, f"host library did not build: {sa._NATIVE_ERROR}")
    built = {p: cuda_lf.build().rbt_lane_threads(code) for p, code in cuda_lf._POLICY_CODE.items()}
    check(built == {p: cuda_lf.lane_threads(p) for p in built},
          f"csrc/lf_tables.cuh lane_threads {built} != cuda_lf.lane_threads")
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            for name, log in (("lf", cuda_lf.BUILD_LOG), ("gather_probe", cuda_gather.BUILD_LOG),
                              ("phi_walk", cuda_phi.BUILD_LOG), ("seeds", cuda_seeds.BUILD_LOG))}
    # registers and spills of every instance of the three kernel files; none
    # may spill (csrc/lf_rank.cuh Bounds)
    inst = {name: ptxas_instances(log) for name, log in (
        ("lf", cuda_lf.BUILD_LOG), ("phi_walk", cuda_phi.BUILD_LOG),
        ("seeds", cuda_seeds.BUILD_LOG))}
    spilling = {name: [k for k, v in found.items()
                       if v.get("spill_stores") or v.get("spill_loads")]
                for name, found in inst.items()}
    # the two-level instances: registers, the lanes resident at once on the
    # card, and the machine instructions of the search's step loop
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    two_level = {}
    for name, threads in (("lf", 512), ("seeds", 256)):
        for k, v in inst[name].items():
            if "lf_count2_kernel" in k or any(
                    m in k for m in ("seed_machine_kernel<long", "seed_machine_kernelIl")):
                two_level[k] = dict(registers=v.get("registers"),
                                    resident_lanes=resident_lanes(v.get("registers", 255),
                                                                  threads, sms))
    for kernel in ("lf_count2_kernel", "lf_count_kernel"):
        STEP_LOOPS.update(loop_instructions(cuda_lf.build()._name, kernel))
    emit("build", seconds={name: s for name, (_, s) in done.items()}, ptxas=regs,
         seeds_instances=inst["seeds"], lf_instances=inst["lf"],
         phi_walk_instances=inst["phi_walk"], seeds_spilling=spilling["seeds"],
         spilling=spilling, two_level=two_level, step_loops=STEP_LOOPS)
    check(not any(spilling.values()), f"instances that spill: {spilling}")


def resident_lanes(registers: int, threads: int, sms: int) -> int:
    """Lanes (two threads each) resident at once on `sms` SMs for a kernel
    of `registers` registers a thread in blocks of `threads`: the blocks an
    SM's 65,536 registers hold (a warp's registers allotted in units of 256)
    and its 2,048 threads allow."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65_536 // (per_warp * (threads // 32)), 2_048 // threads)
    return sms * blocks * threads // 2


# {kernel instance: its step loop's machine instructions} of lf.cu's
# two-level search (phase build, loop_instructions)
STEP_LOOPS = {}


def loop_instructions(lib_path: str, kernel: str) -> dict:
    """{instance of `kernel`: instructions of its longest loop} in a
    library's machine code (cuobjdump -sass): the span from a backward
    branch's target to the branch, the search's step loop, with its POPC
    and LDG counts; names demangled where c++filt is on PATH; {} where
    cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel not in name:
            continue
        ins = []
        for ln in body.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
        best = (0, 0, 0)
        for at, op in ins:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if b and int(b.group(1), 16) < at:
                loop = [o for a, o in ins if int(b.group(1), 16) <= a <= at]
                if len(loop) > best[0]:
                    best = (len(loop), sum("POPC" in o for o in loop),
                            sum("LDG" in o for o in loop))
        out[name.strip()] = dict(instructions=best[0], popc=best[1], ldg=best[2])
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), capture_output=True, text=True,
                               check=True).stdout.splitlines()
        out = {pretty.replace("(anonymous namespace)::", ""): v
               for pretty, v in zip(names, out.values())}
    return out


def step_loop(syms: int, rec: bool, loops: dict | None = None) -> int | None:
    """Instructions of the step loop of the staged two-level search over
    `syms`-symbol rows, with the record where `rec`, in `loops` ({instance:
    loop_instructions' entry}; STEP_LOOPS, the build phase's, by default):
    lf_count2_kernel's over bit planes; None where `loops` has none."""
    r = "true" if rec else "false"
    names = (f"lf_count2_kernel<{syms}, true, {r}>",
             f"lf_count2_kernelILi{syms}ELb1ELb{int(rec)}E")  # not demangled
    for k, v in (STEP_LOOPS if loops is None else loops).items():
        if any(name in k for name in names):
            return v["instructions"]
    return None


def k1_loop(syms: int, toe: bool, loops: dict | None = None) -> int | None:
    """Instructions of the step loop of the staged single-level K1 over
    `syms`-symbol rows, its toehold instance where `toe`, in `loops` (as
    step_loop takes them): lf_count_kernel<SYMS, STAGE, TOE>, or an earlier
    design's lf_count_kernel<int, SYMS, STAGE, REC, TOE>; None where
    `loops` has neither."""
    t = "true" if toe else "false"
    names = (f"lf_count_kernel<{syms}, true, {t}>",
             f"lf_count_kernel<int, {syms}, true, false, {t}>",
             # not demangled
             f"lf_count_kernelILi{syms}ELb1ELb{int(toe)}E",
             f"lf_count_kernelIiLi{syms}ELb1ELb0ELb{int(toe)}E")
    for k, v in (STEP_LOOPS if loops is None else loops).items():
        if any(name in k for name in names):
            return v["instructions"]
    return None


def ptxas_instances(log: str) -> dict:
    """{kernel instance: registers, stack frame and spill bytes} from nvcc's
    -Xptxas -v report, the names demangled where c++filt is on PATH."""
    out, name, props = {}, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif "Function properties for" in ln:
            props = ln.split("Function properties for")[1].strip()
        elif name and props == name and "bytes stack frame" in ln:
            stack, stores, loads = (int(w) for w in re.findall(r"(\d+) bytes", ln)[:3])
            out[name].update(stack=stack, spill_stores=stores, spill_loads=loads)
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), capture_output=True, text=True,
                               check=True).stdout.splitlines()
        out = {pretty.replace("(anonymous namespace)::", ""): v
               for pretty, v in zip(names, out.values())}
    return out


def probe_cases(device):
    """({name: (kernel, plain, steps)}, numpy expectations, tab) of P1-P3 at
    the probe tool's shapes and inputs."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather as G
    from rowbowt_tpu_torch.tools import gather_probe as gp

    tab_np, idx_np, idxB_np = gp.make_inputs()
    expect = gp.expectations(tab_np, idx_np, idxB_np)
    tab = torch.from_numpy(tab_np.reshape(gp.T // 128, 128)).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    idxB = torch.from_numpy(idxB_np).to(device)
    cases = {
        "gather_rows": (lambda: G.gather_rows(tab, idx), lambda: G.gather_rows_plain(tab, idx), 1),
        "gather_cols": (lambda: G.gather_cols(tab, idxB),
                        lambda: G.gather_cols_plain(tab, idxB), 1),
        "gather_chain": (lambda: G.gather_chain(tab, idx, gp.STEPS),
                         lambda: G.gather_chain_plain(tab, idx, gp.STEPS), gp.STEPS),
    }
    return cases, expect, tab_np


def probe_library_calls(device) -> dict:
    """The one PyTorch call that computes P1 (`tab.reshape(-1)[idx]`) and P2
    (`torch.gather`, its index widened to int64 outside the call) at the probe
    tool's shapes; P3 has no single call."""
    import torch

    from rowbowt_tpu_torch.tools import gather_probe as gp

    tab_np, idx_np, idxB_np = gp.make_inputs()
    tab = torch.from_numpy(tab_np.reshape(gp.T // 128, 128)).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    idxB = torch.from_numpy(idxB_np).to(device).long()
    return {"gather_rows": lambda: tab.reshape(-1)[idx],
            "gather_cols": lambda: torch.gather(tab, 0, idxB)}


def probe_byte_us() -> dict:
    """{name: µs} of P1-P3 at the probe tool's shapes: the bytes each must
    move (the index read once, the distinct table elements it reads, the
    output written once) over the card's memory rate.  P3's bound also has
    its chain's latency and its loads over the L2's random-load rate
    (chain_designs)."""
    from rowbowt_tpu_torch.tools import gather_probe as gp

    tab_np, idx_np, idxB_np = gp.make_inputs()
    cols = np.arange(idxB_np.shape[1])[None, :]
    chain, i = [idx_np], idx_np
    for _ in range(gp.STEPS - 1):
        i = tab_np[i]
        chain.append(i)
    distinct = {"gather_rows": np.unique(idx_np).size,
                "gather_cols": np.unique(idxB_np * idxB_np.shape[1] + cols).size,
                "gather_chain": np.unique(np.concatenate(chain)).size}
    out = {}
    for name, d in distinct.items():
        n = idxB_np.size if name == "gather_cols" else idx_np.size
        out[name] = (2 * n + d) * 4 / HBM_BYTES_PER_S * 1e6
    return out


PROBE_KERNELS = {"gather_rows": "gather_vec_kernel", "gather_cols": "gather_vec_kernel",
                 "gather_chain": "gather_chain_kernel"}


def phase_probes(device) -> dict:
    """The probe tool's path (counts set to 0 just before, read just after),
    the tool as a subprocess, then P1-P3 against their plain twins, timed per
    call and alone (CUDA events just around the launch, and one profiler
    trace as a check, as K1 in phase k1), and at the edges of the 16-byte
    path."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather as G
    from rowbowt_tpu_torch.tools import gather_probe as gp

    for name in G.LAUNCHES:
        G.LAUNCHES[name] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = gp.main(["--device", str(device)])
    launches = dict(G.LAUNCHES)
    check(len(lines) == 3 and all(": ok=True " in ln for ln in lines),
          f"the probe tool printed {lines}")
    check(all(v > 0 for v in launches.values()), f"a probe kernel never launched: {launches}")
    proc = subprocess.run([sys.executable, "-m", "rowbowt_tpu_torch.tools.gather_probe"],
                          cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                          capture_output=True, text=True, timeout=300)
    sub = proc.stdout.splitlines()
    check(proc.returncode == 0 and len(sub) == 3 and all(": ok=True " in ln for ln in sub),
          f"python -m rowbowt_tpu_torch.tools.gather_probe exited {proc.returncode}: "
          f"{proc.stdout}{proc.stderr[-2000:]}")

    cases, expect, tab_np = probe_cases(device)
    library = probe_library_calls(device)
    res = {}
    for (name, (kernel, plain, steps)), want_np in zip(cases.items(), expect):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        check(err == 0, f"{name} != its plain twin: max |err| {err}")
        check(np.array_equal(got.cpu().numpy(), want_np), f"{name} != the numpy expectation")
        k_ms, p_ms = in_turns([plain], [kernel], 20 if steps > 1 else 200, 200)
        lib = library.get(name)
        per_elem = steps * got.numel()
        res[name] = dict(launches=launches[name], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         library_ms=cuda_ms([lib], 200) if lib else None,
                         device_us=kernel_event_us([around(kernel)], 20 if steps > 1 else 200),
                         profiled_us=profiled_kernel_us([kernel], 20 if steps > 1 else 200,
                                                        (PROBE_KERNELS[name],))[PROBE_KERNELS[name]],
                         us_per_step=k_ms * 1e3 / steps, plain_us_per_step=p_ms * 1e3 / steps,
                         ns_per_elem=k_ms * 1e6 / per_elem, plain_ns_per_elem=p_ms * 1e6 / per_elem)
    designs = chain_designs(device, tab_np)
    res["gather_chain"]["max_abs_err"] = max(res["gather_chain"]["max_abs_err"],
                                             designs.pop("max_abs_err"))
    res["gather_chain"].update(designs)
    edges = probe_edges(device, tab_np)
    for name, err in edges.pop("max_abs_err").items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    emit("probes", tool=lines, subprocess=sub, edges=edges, **res)
    return res


RATE_LOADS = 1 << 22  # P1's independent loads that measure the L2's random-load rate
SAT_LANES = 1 << 20  # P3's lanes that fill every SM, for the same rate from its chains
LATENCY_LANES, LATENCY_STEPS = 32, 10_000  # P3 that measures a dependent load's latency


def dependent_latency_us(device, tab) -> float:
    """Microseconds of one dependent load from the int32 table `tab`: P3 on
    LATENCY_LANES lanes (one warp), LATENCY_STEPS steps a call, CUDA events
    over the call.  Every index must lie in the table."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather as G

    rng = np.random.default_rng(5)
    start = torch.from_numpy(rng.integers(0, tab.numel(), LATENCY_LANES,
                                          dtype=np.int32)).to(device)
    return cuda_ms([lambda: G.gather_chain(tab, start, LATENCY_STEPS)], 5) * 1e3 / LATENCY_STEPS


def random_cycle(device, n: int):
    """int32 [n]: one random cycle through all n entries, so that a chain
    from any entry reads a new random address every step."""
    import torch

    perm = torch.randperm(n, device=device, generator=torch.Generator(device=device)
                          .manual_seed(5))
    cycle = torch.empty(n, dtype=torch.int32, device=device)
    cycle[perm] = perm.roll(-1).to(torch.int32)
    return cycle


def chain_designs(device, tab_np: np.ndarray) -> dict:
    """P3 at the probe tool's shape in each of its designs (cuda_gather.
    CHAIN_DESIGNS: the first design and C = 1, 2, 4 chains a thread), each
    equal to its plain twin, the kernels alone by CUDA events in turns (the
    designs in order, then backwards) and per call; the rate at which the L2
    serves random 4-byte loads from the same 4 MB table, the faster of P1
    over RATE_LOADS random indices and P3 (its wrapper's design) over
    SAT_LANES lanes, which fill every SM; the dependent-load latency over
    that table; and P3's bound, the larger of the chain's latency (steps x
    latency) and its loads over that rate (`bound_us_by` says which)."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather as G
    from rowbowt_tpu_torch.tools import gather_probe as gp

    _, idx_np, _ = gp.make_inputs()
    tab = torch.from_numpy(tab_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    want = G.gather_chain_plain(tab, idx, gp.STEPS)
    designs = list(G.CHAIN_DESIGNS)
    calls = {d: (lambda d=d: G.gather_chain_as(tab, idx, gp.STEPS, d)) for d in designs}
    err = 0
    for d in designs:
        got = calls[d]()
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got], [want]))
    check(err == 0, f"a P3 design != the plain twin: max |err| {err}")
    each = {d: [] for d in designs}
    for d in designs + designs[::-1]:
        each[d].append(kernel_event_us([around(calls[d])], 20))
    out = {}
    for d, v in each.items():
        chains, l1, threads = G.CHAIN_DESIGNS[d]
        out[d] = dict(chains=chains, l1=l1, device_us=sum(v) / len(v), device_us_each=v,
                      call_ms=cuda_ms([calls[d]], 200),
                      threads=threads or G.chain_plan(idx.numel(), chains,
                                                      G._sm_count(device.index)))
    rng = np.random.default_rng(6)
    ridx = torch.from_numpy(rng.integers(0, tab.numel(), RATE_LOADS, dtype=np.int32)).to(device)
    rate_us = kernel_event_us([around(lambda: G.gather_rows(tab, ridx))], 20)
    sidx = torch.from_numpy(rng.integers(0, tab.numel(), SAT_LANES, dtype=np.int32)).to(device)
    sat_us = kernel_event_us([around(lambda: G.gather_chain(tab, sidx, gp.STEPS))], 5)
    # the faster of the two is the L2's random-load rate: a valid bound
    rates = {"p1": RATE_LOADS / (rate_us * 1e-6), "p3_full": SAT_LANES * gp.STEPS / (sat_us * 1e-6)}
    rate_by = max(rates, key=rates.get)
    lat_us = dependent_latency_us(device, tab)
    loads = idx.numel() * gp.STEPS
    latency_bound, rate_bound = gp.STEPS * lat_us, loads / rates[rate_by] * 1e6
    best = min(out, key=lambda d: out[d]["device_us"])
    return dict(max_abs_err=err, designs=out, design=G.CHAIN, fastest=best,
                rate_loads=RATE_LOADS, rate_us=rate_us, full_lanes=SAT_LANES, full_us=sat_us,
                loads_per_s=rates, l2_rate_by=rate_by,
                us_per_dependent_step=lat_us, loads=loads, latency_bound_us=latency_bound,
                rate_bound_us=rate_bound, bound_us=max(latency_bound, rate_bound),
                bound_us_by="latency" if latency_bound >= rate_bound else "l2_rate",
                share=max(latency_bound, rate_bound) / out[G.CHAIN]["device_us"])


def probe_edges(device, tab_np: np.ndarray) -> dict:
    """P1-P3 at the edges of the 16-byte path, each equal to its plain twin
    and to numpy: P1 at ragged and tiny sizes and on the 4-byte-aligned view
    idx[1:]; P2 at widths 1, 3, 100 and 128 with 1 and 256 rows, and on a
    4-byte-aligned row-offset view; empty inputs.  Each call with outputs
    launches its kernel once; an empty one launches nothing."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather as G

    rng = np.random.default_rng(7)
    T = tab_np.size
    flat = torch.from_numpy(tab_np).to(device)
    cases = []  # (label, wrapper name, kernel, plain, numpy expectation, the idx used)
    for B in (0, 1, 3, 4, 5, 32_767, 32_768, 32_769):
        i = rng.integers(0, T, B, dtype=np.int32)
        idx = torch.from_numpy(i).to(device)
        cases.append((f"rows B={B}", "gather_rows", lambda idx=idx: G.gather_rows(flat, idx),
                      lambda idx=idx: G.gather_rows_plain(flat, idx), tab_np[i], idx))
    i = rng.integers(0, T, 32_769, dtype=np.int32)
    view = torch.from_numpy(i).to(device)[1:]
    cases.append(("rows idx[1:]", "gather_rows", lambda: G.gather_rows(flat, view),
                  lambda: G.gather_rows_plain(flat, view), tab_np[i[1:]], view))
    for cols in (1, 3, 100, 128):
        rows = T // cols
        tab_c = tab_np[:rows * cols].reshape(rows, cols)
        tab = flat[:rows * cols].view(rows, cols)
        # the view idx[1:] of a [257, 3] idx starts 12 bytes past an aligned address
        for K, skip in ((0, 0), (1, 0), (256, 0)) + (((257, 1),) if cols == 3 else ()):
            i = rng.integers(0, rows, (K, cols), dtype=np.int32)
            idx = torch.from_numpy(i).to(device)[skip:]
            cases.append((f"cols C={cols} K={K - skip}" + (" idx[1:]" if skip else ""),
                          "gather_cols", lambda tab=tab, idx=idx: G.gather_cols(tab, idx),
                          lambda tab=tab, idx=idx: G.gather_cols_plain(tab, idx),
                          tab_c[i[skip:], np.arange(cols)[None, :]], idx))
    for B in (0, 5):
        i = rng.integers(0, T, B, dtype=np.int32)
        idx = torch.from_numpy(i).to(device)
        want = i.copy()
        for _ in range(3):
            want = tab_np[want]
        cases.append((f"chain B={B}", "gather_chain", lambda idx=idx: G.gather_chain(flat, idx, 3),
                      lambda idx=idx: G.gather_chain_plain(flat, idx, 3), want, idx))
    # every P3 design at lane counts that leave a thread's last chains empty
    for design in G.CHAIN_DESIGNS:
        for B in (1, 5, 4_099):
            i = rng.integers(0, T, B, dtype=np.int32)
            idx = torch.from_numpy(i).to(device)
            want = i.copy()
            for _ in range(3):
                want = tab_np[want]
            cases.append((f"chain {design} B={B}", "gather_chain",
                          lambda idx=idx, d=design: G.gather_chain_as(flat, idx, 3, d),
                          lambda idx=idx: G.gather_chain_plain(flat, idx, 3), want, idx))
    errs = {"gather_rows": 0, "gather_cols": 0, "gather_chain": 0}
    vector = 0
    for label, name, kernel, plain, want_np, idx in cases:
        before = G.LAUNCHES[name]
        got = kernel()
        launched = G.LAUNCHES[name] - before
        want = plain()
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        check(err == 0, f"{label}: kernel != its plain twin, max |err| {err}")
        check(got.shape == want.shape and np.array_equal(got.cpu().numpy(), want_np),
              f"{label}: kernel != the numpy expectation")
        check(launched == (got.numel() > 0), f"{label}: {launched} launches counted")
        aligned = idx.data_ptr() % 16 == 0
        check(aligned != ("idx[1:]" in label) or idx.numel() == 0,
              f"{label}: idx is {'' if aligned else 'not '}16-byte aligned")
        vector += aligned and name != "gather_chain" and got.numel() >= G.VEC
        errs[name] = max(errs[name], err)
    return dict(cases=len(cases), vector_path_cases=vector, labels=[c[0] for c in cases],
                max_abs_err=errs)


def k1_edges(qc: np.ndarray, lens: np.ndarray, device, lanes: int = 4_099):
    """[(label, qcodes, lengths)] at the edges of K1's staging and ftab start:
    widths L of 1, k - 1, k, 99 and 100 (the last L codes of each read,
    lengths cut to L), a view one row into an L = 99 batch and a view one
    code into a flat L = 100 buffer (both 4-byte aligned only: the per-code
    staging path), a batch of one lane, and 512 lanes of L = 3,072 (the reads
    left-padded with -1), too wide for even one warp's codes to be staged,
    so that launch_plan has the kernel read them from global memory."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    out = []
    for L in (1, FTAB_K - 1, FTAB_K, 99, 100):
        q = np.ascontiguousarray(qc[:lanes, qc.shape[1] - L:])
        out.append((f"L={L}", torch.from_numpy(q).to(device),
                    torch.from_numpy(np.minimum(lens[:lanes], L)).to(device)))
    q = torch.from_numpy(np.ascontiguousarray(qc[:lanes + 1, qc.shape[1] - 99:])).to(device)
    out.append(("L=99 q[1:]", q[1:],
                torch.from_numpy(np.minimum(lens[1:lanes + 1], 99)).to(device)))
    flat = torch.from_numpy(np.concatenate([[-1], qc[:lanes, qc.shape[1] - 100:].ravel()])
                            .astype(np.int32)).to(device)
    out.append(("L=100 one code in", flat[1:].view(lanes, 100),
                torch.from_numpy(np.minimum(lens[:lanes], 100)).to(device)))
    out.append(("1 lane", torch.from_numpy(qc[:1]).to(device),
                torch.from_numpy(lens[:1]).to(device)))
    wide = np.full((512, 3_072), -1, np.int32)
    wide[:, -qc.shape[1]:] = qc[:512]
    check(not cuda_lf.launch_plan(*wide.shape, 1)[1], "L = 3,072 would be staged")
    out.append(("L=3072 unstaged", torch.from_numpy(wide).to(device),
                torch.from_numpy(lens[:512]).to(device)))
    for label, q, _ in out:
        unaligned = label in ("L=99 q[1:]", "L=100 one code in")
        check(q.is_contiguous() and (q.data_ptr() % 16 != 0) == unaligned,
              f"{label}: qcodes at {q.data_ptr() % 16} bytes past a 16-byte boundary")
    return out


def codes_of(idx) -> np.ndarray:
    """The BWT codes of an index (uint8), from its run tables."""
    return np.repeat(np.asarray(idx.run_head).astype(np.uint8), idx.run_lengths())


def parity_inputs(device, cfg=SMALL, n_lanes=PARITY_LANES) -> dict:
    """What phase parity checks its kernels on: the small panel's index
    (with SA samples: kval and phi1 for the walk), its BWT codes, the
    edge-case batch of n_lanes reads (host qc, lens and on the card q, ln;
    every edge case present) and k1_edges' cases.  The same seed gives the
    same inputs in every process."""
    import torch

    from rowbowt_tpu_torch.construct.build import build_index

    t0 = time.perf_counter()
    text = panel(cfg)[0]
    idx = build_index(text, ftab_k=FTAB_K)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(cfg["seed"] + 1)
    qc, lens, counts = edge_lanes(idx, sample_reads(text, rng, n_lanes), rng)
    check(all(v > 0 for v in counts.values()), f"edge cases missing: {counts}")
    return dict(idx=idx, codes=codes_of(idx), build_s=build_s, qc=qc, lens=lens, counts=counts,
                q=torch.from_numpy(qc).to(device), ln=torch.from_numpy(lens).to(device),
                edges=k1_edges(qc, lens, device))


def seeds_parity_child(out_path: str) -> None:
    """seeds_parity in a child process of its own on cuda:0 (started by
    phase parity, beside its other checks: the plain twins are host-bound
    torch loops, one core each), over parity_inputs' inputs and raw_tables;
    its result pickled into out_path."""
    import pickle

    import torch

    device = torch.device("cuda", 0)
    inp = parity_inputs(device)
    idx, codes = inp["idx"], inp["codes"]
    raw = {route: raw_tables(idx, codes, route) for route in ("tk1", "ltk")}
    res = seeds_parity(device, idx, codes, inp["q"], inp["ln"], inp["edges"], raw)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def phase_parity(device, cfg=SMALL, n_lanes=PARITY_LANES) -> dict:
    """K1 == find_ranges_plain on the card, both layouts, ftab on and off, on
    the edge-case batch and at the edges of k1_edges; the walk, toehold and
    tables kernels against their twins; and, in two child processes
    started first, on the same inputs: K1 over the two-level rows and its
    record launch (fb2_parity_child) and the seeding kernel
    (seeds_parity_child) against their twins.  Returns {kernel: max |err|}."""
    import pickle

    paths = {target: os.path.join(WORK, f"{target.__name__}.pkl")
             for target in (seeds_parity_child, fb2_parity_child)}
    children = [spawn_child(target, path) for target, path in paths.items()]
    try:
        out = parity_checks(device, parity_inputs(device, cfg, n_lanes), n_lanes)
        for child in children:
            child.join()
    finally:
        for child in children:
            stop_child(dict(proc=child))
    for child in children:
        check(child.exitcode == 0, f"{child.name} exited {child.exitcode}")
    res = {}
    for target, path in paths.items():
        with open(path, "rb") as f:
            res[target] = pickle.load(f)
    seeds, fb2 = res[seeds_parity_child], res[fb2_parity_child]
    emit("parity", **out["emit"], **fb2["emit"], seeds_parity=seeds)
    return {**out["errs"], **fb2["errs"], **seeds["errs"]}


def fb2_parity_child(out_path: str) -> None:
    """fb2_parity in a child process of its own on cuda:0 (started by phase
    parity, beside its other checks: the plain twins are host-bound torch
    loops, one core each), over parity_inputs' inputs; its result pickled
    into out_path."""
    import pickle

    import torch

    device = torch.device("cuda", 0)
    res = fb2_parity(device, parity_inputs(device))
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def fb2_parity(device, inp: dict) -> dict:
    """K1 over the two-level rows of parity_inputs' BWT (n_sup = 4: fb2_64,
    fb2 and fb2_256, no ftab) on the edge-case batch and at k1_edges' edges
    against its plain twin, its ranges also equal to the single-level
    rows', and the record launch over each against its twin, each layout's
    bit planes on the card equal to its nibble rows: {"errs": {kernel: max
    |err|}, "emit": phase parity's fields}."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import PLANE_SYMS, TorchIndex, nibbles_of_planes
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, codes, q, ln, edges = (inp[k] for k in ("idx", "codes", "q", "ln", "edges"))
    t0 = time.perf_counter()
    edge_nonempty = {}
    tx = TorchIndex.from_index(idx, device)
    single = [find_ranges(tx, qe, le, use_ftab=False) for _, qe, le in [("", q, ln)] + edges]
    err2, err3, layouts = 0, 0, []
    launches0, rec0 = cuda_lf.LAUNCHES_FB2, cuda_lf.LAUNCHES_REC
    planes = {}
    for block, fb64 in ((128, True), (128, False), (256, False)):
        big = BigIndex.from_codes(codes, idx.alpha, n_sup=4, block=block)
        tx = TorchIndex.from_big(big, device, fb64=fb64)
        layout = cuda_lf.row_layout(tx)
        layouts.append(layout)
        # the bit planes the card holds give back the nibble rows they were
        # made from
        rows = cuda_lf.rows_of(tx, layout)
        nib = big._fb2_64() if layout == "fb2_64" else big.fb2
        back = nibbles_of_planes(rows, PLANE_SYMS[layout], tx.n).cpu().numpy()
        check(np.array_equal(back, nib), f"the bit planes of {layout} != its nibble rows")
        planes[layout] = dict(row_bytes=rows.shape[1] * 4, nibble_row_bytes=nib.shape[1] * 4,
                              bytes=tx.planes_bytes, s=tx.planes_s)
        for (label, qe, le), one in zip([("batch", q, ln)] + edges, single):
            got = find_ranges(tx, qe, le)
            want = cuda_lf.find_ranges_plain(tx, qe, le)
            torch.cuda.synchronize()
            e = max(max_abs_err(got, want), max_abs_err(got, one))
            check(e == 0, f"K1 over {layout} != plain or the single-level rows at {label}: "
                  f"max |err| {e}")
            err2 = max(err2, e)
            edge_nonempty[f"{layout},{label}"] = int((got[1] >= got[0]).sum().item())
            e = held_record(tx, qe, le, got)
            check(e == 0, f"the record launch over {layout} != its plain twin at {label}: "
                  f"max |err| {e}")
            err3 = max(err3, e)
        del tx
    want_fb2 = 3 * (1 + len(edges))
    launches2 = cuda_lf.LAUNCHES_FB2 - launches0
    check(launches2 == want_fb2, f"expected {want_fb2} two-level K1 launches, counted "
          f"{launches2}")
    launches3 = cuda_lf.LAUNCHES_REC - rec0
    check(launches3 == want_fb2, f"expected {want_fb2} record launches, counted {launches3}")
    fields = dict(fb2_layouts=layouts, fb2_launches=launches2, fb2_max_abs_err=err2,
                  planes=planes, fb2_edge_nonempty=edge_nonempty,
                  fb2_s=time.perf_counter() - t0, rec_launches=launches3, rec_max_abs_err=err3)
    return dict(errs={"lf_count_fb2": err2, "lf_count_fb2_rec": err3}, emit=fields)


def parity_checks(device, inp: dict, n_lanes: int) -> dict:
    """Phase parity's checks but the seeding kernel's and the two-level
    search's, on parity_inputs' `inp`: {"errs": {kernel: max |err|},
    "emit": the phase line's fields}."""
    import torch

    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, codes, qc, lens, q, ln, edges = (inp[k] for k in ("idx", "codes", "qc", "lens", "q",
                                                            "ln", "edges"))
    err = 0
    launches0 = cuda_lf.LAUNCHES
    results = {}
    edge_nonempty = {}
    t0 = time.perf_counter()
    for fb64 in (True, False):
        tx = TorchIndex.from_index(idx, device, fb64=fb64)
        for use_ftab in (True, False):
            got = find_ranges(tx, q, ln, use_ftab=use_ftab)
            want = cuda_lf.find_ranges_plain(tx, q, ln, use_ftab=use_ftab)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"K1 != plain (fb64={fb64}, ftab={use_ftab}): max |err| {e}")
            # a ragged lane count (not a multiple of a block's lanes)
            # against the host run-space search
            sub = find_ranges(tx, q[:N_HOST], ln[:N_HOST], use_ftab=use_ftab)
            hlo, hhi = host_ranges(idx, qc[:N_HOST], lens[:N_HOST], use_ftab)
            check(np.array_equal(sub[0].cpu().numpy(), hlo)
                  and np.array_equal(sub[1].cpu().numpy(), hhi),
                  f"K1 != host run-space search (fb64={fb64}, ftab={use_ftab})")
            err = max(err, e)
            cfg_name = f"fb64={fb64},ftab={use_ftab}"
            results[cfg_name] = int((got[1] >= got[0]).sum().item())
            for label, qe, le in edges:
                got = find_ranges(tx, qe, le, use_ftab=use_ftab)
                want = cuda_lf.find_ranges_plain(tx, qe, le, use_ftab=use_ftab)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"K1 != plain at {label} ({cfg_name}): max |err| {e}")
                err = max(err, e)
                edge_nonempty[f"{cfg_name},{label}"] = int((got[1] >= got[0]).sum().item())
    launches = cuda_lf.LAUNCHES - launches0
    want_k1 = 4 * (2 + len(edges))
    check(launches == want_k1, f"expected {want_k1} K1 launches, counted {launches}")
    k1_s, t0 = time.perf_counter() - t0, time.perf_counter()
    walk = walk_parity(device, idx, codes, q, ln)
    walk_s = time.perf_counter() - t0
    # the full-SA index's toeholds and the raw tables, shared by the toehold
    # launch's and the tables kernel's checks
    cases = [("batch", q, ln)] + edges
    tx = TorchIndex.from_index(idx, device)
    single = [find_ranges(tx, qe, le, use_ftab=False) for _, qe, le in cases]
    kval = [find_ranges_w_toehold(tx, qe, le) for _, qe, le in cases]
    del tx
    raw = {route: raw_tables(idx, codes, route) for route in ("tk1", "ltk")}
    toe = toehold_parity(device, raw, cases, kval)
    tab = tables_parity(device, idx, codes, raw["tk1"], cases, single, kval)
    fields = dict(n=idx.n, R=idx.R, build_s=inp["build_s"], lanes=n_lanes,
                  edge_cases=inp["counts"], nonempty=results,
                  edges=[label for label, _, _ in edges], edge_nonempty=edge_nonempty,
                  host_checked=N_HOST, launches=launches, max_abs_err=err,
                  k1_s=k1_s, walk_s=walk_s, walk=walk, toehold=toe, tables=tab)
    errs = {"lf_count": err, "lf_toehold": toe["max_abs_err"],
            **{f"lf_tables_{name}": e for name, e in tab["errs"].items()},
            "phi_walk_phi1": walk["max_abs_err"]["phi1"],
            "phi_walk_kval": walk["max_abs_err"]["kval"],
            "phi_walk_rows": walk["max_abs_err"]["phi_rows"],
            "phi_walk_pred": walk["max_abs_err"]["pred"],
            "walk_phi_at": walk["max_abs_err"]["phi_at"]}
    return dict(errs=errs, emit=fields)


def raw_tables(idx, codes, route: str):
    """idx (built with the full SA) with the tables a raw build of its BWT
    and run samples has (phase build_small holds the two equal): no kval,
    and occ1 + tk1 for route "tk1", neither for route "ltk" (a raw build
    above OCC1_MAX_N)."""
    from rowbowt_tpu_torch.construct.build import build_occ1, build_tk1_from_runs

    if route == "ltk":
        return dataclasses.replace(idx, kval=None, occ1=None, tk1=None)
    c = codes.astype(np.int64)
    occ1 = build_occ1(c, idx.A)
    tk1 = build_tk1_from_runs(c, idx.run_start, idx.samples_last, idx.A, occ1.dtype)
    return dataclasses.replace(idx, kval=None, occ1=occ1, tk1=tk1)


def toehold_parity(device, raw: dict, cases: list, kval: list) -> dict:
    """K1's toehold launch (cuda_lf.find_ranges_toehold) against its plain
    twin (the torch loop of lf_step_w_loc_occ1 or lf_step_w_loc on the card)
    on the small panel's raw tables ({route: raw_tables}), over tk1 and over
    ltk, on the edge batch and at every k1_edges edge (`cases`, 64-symbol
    rows), and on the batch over the 96 B rows: lo, hi and k equal, and
    equal to the full-SA index's toeholds (`kval`, per case); over ltk and
    the 64-symbol rows the resolve through each directory of
    resolve_variants.  One launch a call."""
    import torch

    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    errs, calls, nonempty = {}, 0, {}
    reset_counts()
    for route in ("tk1", "ltk"):
        for fb64 in (True, False):
            tx = TorchIndex.from_index(raw[route], device, fb64=fb64)
            check(cuda_lf.toehold_route(tx) == route and "kval" not in tx.arrays,
                  f"the raw tables' toehold route: {cuda_lf.toehold_route(tx)}")
            name = f"{route},{'fblock64' if fb64 else 'fblock'}"
            errs[name] = 0
            views = resolve_variants(tx) if route == "ltk" and fb64 else [("", tx)]
            for (label, qe, le), want_k in zip(cases if fb64 else cases[:1], kval):
                want = cuda_lf.find_ranges_toehold_plain(tx, qe, le)
                for tag, view in views:
                    got = cuda_lf.find_ranges_toehold(view, qe, le)
                    torch.cuda.synchronize()
                    e = max(max_abs_err(got, want), max_abs_err(got, want_k))
                    check(e == 0, f"the toehold launch ({name} {tag}) != its plain twin or the "
                          f"kval toeholds at {label}: max |err| {e}")
                    errs[name] = max(errs[name], e)
                    calls += 1
                nonempty[f"{name},{label}"] = int((got[1] >= got[0]).sum().item())
            if len(views) > 1:
                nonempty["ltk_variants"] = [tag for tag, _ in views]
            del tx, views
    counts = route_counts()
    check(counts == launch_counts(toe=calls),
          f"toehold parity routes: {counts} for {calls} calls")
    return dict(max_abs_err=max(errs.values()), errs=errs, launches=counts["toe"],
                nonempty=nonempty, wall_s=time.perf_counter() - t0)


def table_indexes(idx, codes, raw_tk1) -> dict:
    """{policy: idx with the tables of an index without fused rows}: "runs"
    (a --no-dense build: run-space tables and ltk), "dense" (bwt4 and
    occ_blk, which an alphabet of 9-16 codes takes; ltk) and "occ1" (a raw
    build's occ1 and tk1, `raw_tk1` (raw_tables), without its fused rows);
    none with kval or phi1."""
    from rowbowt_tpu_torch.construct.build import build_dense_tables

    bare = dict(fblock=None, kval=None, phi1=None)
    bwt4, occ_blk = build_dense_tables(codes.astype(np.int64), idx.A)
    return {"runs": dataclasses.replace(idx, occ1=None, tk1=None, **bare),
            "dense": dataclasses.replace(idx, occ1=None, tk1=None, bwt4=bwt4, occ_blk=occ_blk,
                                         **bare),
            "occ1": dataclasses.replace(raw_tk1, **bare)}


def tables_parity(device, idx, codes, raw_tk1, cases, single, kval) -> dict:
    """The tables kernel (cuda_lf.launch_tables, through find_ranges and
    find_ranges_toehold) on the small panel's tables of each rank policy
    (table_indexes), count with the ftab and without and toehold, on the
    edge batch and at every k1_edges edge: equal to its plain twin, the
    count to K1's ranges on the fused rows (`single`, per case) and the
    toehold to the full-SA index's (`kval`, per case); over the run-space
    tables so with the run records and without, and over a directory of one
    bucket (run_variants).  The unstaged edge
    (L = 3,072), whose code path no policy changes, runs on the run-space
    tables only.  One launch a call, counted in its policy's instance; no
    other route.  Returns max |err| per instance ("<policy>" the count,
    "<policy>_toehold")."""
    import torch

    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    errs, nonempty, calls = {}, {}, {}
    reset_counts()

    for policy, tab in table_indexes(idx, codes, raw_tk1).items():
        tx = TorchIndex.from_index(tab, device)
        check(cuda_lf.table_policy(tx) == policy and tx.has_ftab and "kval" not in tx.arrays,
              f"the {policy} tables: policy {cuda_lf.table_policy(tx)}")
        errs[policy] = errs[f"{policy}_toehold"] = 0
        ran = [(c, one, k) for c, one, k in zip(cases, single, kval)
               if policy == "runs" or c[0] != "L=3072 unstaged"]
        # over the run-space tables without the records too, and a directory
        # of one bucket; a toehold over ltk through each of resolve_variants
        views = (run_variants(tx) if policy == "runs" else resolve_variants(tx)
                 if cuda_lf.toehold_route(tx) == "ltk" else [(policy, tx)])
        for (label, qe, le), one, want_k in ran:
            for use_ftab in (True, False):
                want = cuda_lf.find_ranges_plain(tx, qe, le, use_ftab=use_ftab)
                for tag, view in views:
                    got = cuda_lf.find_ranges(view, qe, le, use_ftab=use_ftab)
                    torch.cuda.synchronize()
                    e = max(max_abs_err(got, want), max_abs_err(got, one))
                    check(e == 0, f"the {policy} tables kernel ({tag}) != its plain twin or K1 "
                          f"at {label} (ftab={use_ftab}): max |err| {e}")
                    errs[policy] = max(errs[policy], e)
            want = cuda_lf.find_ranges_toehold_plain(tx, qe, le)
            for tag, view in views:
                got = cuda_lf.find_ranges_toehold(view, qe, le)
                torch.cuda.synchronize()
                e = max(max_abs_err(got, want), max_abs_err(got, want_k))
                check(e == 0, f"the {policy} tables kernel's toehold ({tag}) != its plain twin "
                      f"or the kval toeholds at {label}: max |err| {e}")
                errs[f"{policy}_toehold"] = max(errs[f"{policy}_toehold"], e)
            nonempty[f"{policy},{label}"] = int((got[1] >= got[0]).sum().item())
        calls[f"tab_{policy}"] = 2 * len(ran) * len(views)
        calls[f"tab_toe_{policy}"] = len(ran) * len(views)
        if len(views) > 1:
            nonempty[f"{policy}_variants"] = [tag for tag, _ in views]
        del tx, views
    check(route_counts() == launch_counts(**calls),
          f"tables parity routes: {route_counts()} for {calls}")
    return dict(max_abs_err=max(errs.values()), errs=errs, launches=calls, nonempty=nonempty,
                wall_s=time.perf_counter() - t0)


WALK_PARITY_MAX = 4_096  # the uncapped walk's lanes: ranges of at most this many hits


def walk_parity(device, idx, codes, q, ln) -> dict:
    """The walk kernel against its plain twin (cuda_phi.phi_walk_plain on the
    card) on the edge batch's -s toeholds: over the dense index's phi1, over
    the phi rows of the same BWT's BigIndex (n_sup = 4, locate tables from
    kval) and over the predecessor search of the dense index without phi1
    (what --no-dense keeps), with max_hits 8 on every lane and uncapped on
    the lanes of at most WALK_PARITY_MAX hits; the indexes' toeholds equal,
    and every route's positions the phi1 route's; the kval kernel (the
    dense index's lanes with their hi, kval[hi - j]) against
    kval_walk_plain and the phi1 route's positions.  The BigIndex with its
    phi rows withheld (the breakpoint table phi_at of 2^31 or more
    breakpoints, searched through its bucket table pp_off) walks in the
    kernel's phi_at route, one launch a call through phi_walk, against its
    plain twin and the phi1 route's positions the same way."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold
    from rowbowt_tpu_torch.ops import cuda_phi

    def operands(lo, hi, k, cap):
        size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
        if cap is None:
            keep = size <= WALK_PARITY_MAX
            k, size, hi = k[keep], size[keep], hi[keep]
        else:
            size = size.clamp(max=cap)
        return k, size, torch.cumsum(size, 0) - size, int(size.sum()), hi

    big = BigIndex.from_codes(codes, idx.alpha, n_sup=4)
    big.attach_locate(codes, np.asarray(idx.kval).astype(np.uint32))
    pred = TorchIndex.from_index(dataclasses.replace(idx, phi1=None), device)
    check("pred_off" in pred.arrays, "the load of an index without phi1 built no pred_off")
    txs = {"phi1": TorchIndex.from_index(idx, device),
           "phi_rows": TorchIndex.from_big(big, device, with_locate=True, with_markers=False),
           "pred": pred}
    check(all(cuda_phi.walk_route(tx) == route for route, tx in txs.items()),
          f"walk routes {[cuda_phi.walk_route(tx) for tx in txs.values()]}")
    ranges = {route: find_ranges_w_toehold(tx, q, ln) for route, tx in txs.items()}
    e = max(max_abs_err(ranges["phi1"], ranges[r]) for r in ("phi_rows", "pred"))
    check(e == 0, f"the -s toeholds of the dense index != its BigIndex's or its own without "
          f"phi1: max |err| {e}")
    reset_counts()
    errs, hits, kernel_out = {}, {}, {}
    for route, tx in txs.items():
        errs[route] = 0
        for cap in (8, None):
            k, size, off, total, _ = operands(*ranges[route], cap)
            got = cuda_phi.launch_walk(tx, k, size, off, torch.empty(
                total, dtype=torch.int64, device=device))
            want = cuda_phi.phi_walk_plain(tx, k, size, off, torch.full(
                (total,), -1, dtype=torch.int64, device=device))
            torch.cuda.synchronize()
            errs[route] = max(errs[route], max_abs_err([got], [want]))
            if route != "phi1":
                errs[route] = max(errs[route], max_abs_err([got], [kernel_out[cap]]))
            hits[f"{route},{cap}"] = total
            kernel_out.setdefault(cap, got)
        check(errs[route] == 0, f"the walk kernel over {route} != its plain twin or the phi1 "
              f"route on the small panel: max |err| {errs[route]}")
    launches = walk_counts()
    check(launches == dict(walk=6, kval=0), f"walk launches {launches}, expected 6 chains")
    # the kval route: the dense index's toeholds are kval[hi], so the kval
    # kernel, handed each lane's hi, walks kval[hi - j] with no chain:
    # equal to its plain twin and to the phi1 chain's positions
    errs["kval"] = 0
    for cap in (8, None):
        k, size, off, total, hi = operands(*ranges["phi1"], cap)
        got = cuda_phi.launch_walk(txs["phi1"], k, size, off, torch.empty(
            total, dtype=torch.int64, device=device), hi)
        want = cuda_phi.kval_walk_plain(txs["phi1"], hi, size, off, torch.full(
            (total,), -1, dtype=torch.int64, device=device))
        torch.cuda.synchronize()
        errs["kval"] = max(errs["kval"], max_abs_err([got], [want]),
                           max_abs_err([got], [kernel_out[cap]]))
    check(errs["kval"] == 0, f"the kval walk kernel != its plain twin or the phi1 route on the "
          f"small panel: max |err| {errs['kval']}")
    kval_launches = walk_counts()["kval"]
    check(kval_launches == 2, f"kval walk launches {kval_launches}, expected 2")
    # the predecessor walk over directories of 2-position buckets (most
    # empty) and of one bucket (a binary search over all of pred_pos)
    pred_bs = {"loaded": list(pred.pred_bs)}
    for shift in (1, 62):
        view = pred.with_pred_directory(shift)
        tag = f"shift={shift},iters={view.pred_bs[1]}"
        pred_bs[tag] = list(view.pred_bs)
        for cap in (8, None):
            k, size, off, total, _ = operands(*ranges["pred"], cap)
            got = cuda_phi.launch_walk(view, k, size, off, torch.empty(
                total, dtype=torch.int64, device=device))
            want = cuda_phi.phi_walk_plain(view, k, size, off, torch.full(
                (total,), -1, dtype=torch.int64, device=device))
            torch.cuda.synchronize()
            e = max(max_abs_err([got], [want]), max_abs_err([got], [kernel_out[cap]]))
            check(e == 0, f"the walk kernel over pred at {tag} != its plain twin or the phi1 "
                  f"route: max |err| {e}")
        del view
    shift_launches = walk_counts()["walk"] - launches["walk"]
    check(shift_launches == 4, f"the pred walk over forced spans: {shift_launches} launches, "
          f"expected 4")
    launches = walk_counts()
    big._phi_pack = lambda: (None, None)
    tx_at = TorchIndex.from_big(big, device, with_locate=True, with_markers=False)
    check(cuda_phi.walk_route(tx_at) == "phi_at" and "pp_off" in tx_at.arrays,
          "the BigIndex without phi rows has no breakpoint table")
    errs["phi_at"] = 0
    for cap in (8, None):
        k, size, off, total, _ = operands(*ranges["phi_rows"], cap)
        got = cuda_phi.phi_walk(tx_at, k, size, off, torch.empty(total, dtype=torch.int64,
                                                                   device=device))
        want = cuda_phi.phi_walk_plain(tx_at, k, size, off, torch.full(
            (total,), -1, dtype=torch.int64, device=device))
        torch.cuda.synchronize()
        errs["phi_at"] = max(errs["phi_at"], max_abs_err([got], [want]),
                             max_abs_err([got], [kernel_out[cap]]))
    check(errs["phi_at"] == 0, f"the walk kernel over phi_at != its plain twin or the phi1 "
          f"route: max |err| {errs['phi_at']}")
    at_launches = walk_counts()["walk"] - launches["walk"]
    check(at_launches == 2, f"the phi_at walk on the card: {at_launches} launches, expected 2")
    pp_bs = list(tx_at.pp_bs)
    del txs, tx_at, pred
    return dict(max_abs_err=errs, hits=hits, launches=launches["walk"],
                kval_launches=kval_launches, phi_at_launches=at_launches, pp_bs=pp_bs,
                pred_bs=pred_bs)


def held_record(tx, q, ln, ranges=None) -> int:
    """max |err| of the record launch (cuda_lf.find_ranges_record: lo, hi and
    the [L, B] step record) against its plain twin on the card, and of its
    (lo, hi) against `ranges` (K1's without the record) when given."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    got = cuda_lf.find_ranges_record(tx, q, ln)
    want = cuda_lf.find_ranges_record_plain(tx, q, ln)
    torch.cuda.synchronize()
    check(got[2].shape == (q.shape[1], q.shape[0]) and got[2].dtype == torch.int64,
          f"step record of shape {tuple(got[2].shape)}, {got[2].dtype}")
    return max(max_abs_err(got, want), max_abs_err(got[:2], ranges) if ranges else 0)


def write_fastq(path: str, reads: np.ndarray, first: int = 0) -> None:
    """reads as a FASTQ file, named r<first>, r<first + 1>, ..."""
    with open(path, "wb") as f:
        for i in range(reads.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (first + i, reads[i].tobytes(), b"I" * READ_LEN))


@contextlib.contextmanager
def peak_rss(out: dict, key: str = "peak_rss_gb"):
    """out[key]: the peak resident set (GB) of this process while the block
    runs, sampled from /proc/self/status every 20 ms (ru_maxrss keeps the
    peak of the whole process, an earlier phase's too)."""
    import threading

    def rss() -> int:
        with open("/proc/self/status") as f:
            return next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:")) * 1024

    stop, peak = threading.Event(), [rss()]

    def sample():
        while not stop.wait(0.02):
            peak[0] = max(peak[0], rss())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join()
        out[key] = max(peak[0], rss()) / 1e9


def dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9


def chr_build(out_path: str, cfg=CHR) -> None:
    """Phase build_cli's host work, in a spawned child process beside the
    card's phases (start_chr_build): the chr panel written as a FASTA and a
    gzipped VCF, checked to parse back (construct.build_panel) to
    panel(cfg)'s text, documents and markers, then built by `rbt_build_torch
    --fasta --vcf -s -m -l -f -k 10` (build seconds, peak RSS); its times
    and stderr pickled into out_path."""
    import pickle

    from rowbowt_tpu_torch.construct import build_panel

    t0 = time.perf_counter()
    fa, vcf = write_panel_files(cfg, os.path.join(WORK, "panel"))
    write_s = time.perf_counter() - t0
    t = time.perf_counter()
    text, doc_starts, markers = panel(cfg)
    parsed = build_panel(fa, vcf, wsize=MA_WSIZE)
    check(np.array_equal(parsed.text, text), "build_panel's text != panel(CHR)'s")
    check(np.array_equal(parsed.doc_starts, doc_starts), "build_panel's doc_starts differ")
    check([(m.text_pos, m.seq, m.pos, m.allele) for m in parsed.markers]
          == [(m.text_pos, m.seq, m.pos, m.allele) for m in markers],
          "build_panel's markers != panel(CHR)'s")
    panel_check_s = time.perf_counter() - t
    del parsed, markers, text
    mem: dict = {}
    with peak_rss(mem):
        build_s, _, err = run_main("rbt_build", ["--fasta", fa, "--vcf", vcf, "-s", "-m", "-l",
                                                 "-f", "-k", str(FTAB_K), "-o",
                                                 os.path.join(WORK, "idx")],
                                   os.path.join(WORK, "build_out.txt"))
    with open(out_path, "wb") as f:
        pickle.dump(dict(write_s=write_s, panel_check_s=panel_check_s, build_s=build_s, err=err,
                         peak_rss_gb=mem["peak_rss_gb"], wall_s=time.perf_counter() - t0), f)


def start_chr_build() -> dict:
    """chr_build in a spawned child process (no CUDA, no torch state of this
    process); phase build_cli joins it."""
    path = os.path.join(WORK, "chr_build.pkl")
    return dict(proc=spawn_child(chr_build, path), path=path)


def build_cli(cfg=CHR, child: dict | None = None) -> dict:
    """Phase build_cli: chr_build's child (started here where `child` is
    None) joined, its index loaded and checked (with its `idx.midx.npz`
    against the panel's markers), and the reads' FASTQ files written.  The
    later phases use this index and those files."""
    import pickle

    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.midx import PosMarkers

    t0 = time.perf_counter()
    child = child or start_chr_build()
    text, _, markers = panel(cfg)
    pm = markers_by_text_pos(markers)
    del markers
    child["proc"].join()
    check(child["proc"].exitcode == 0, f"chr_build's child exited {child['proc'].exitcode}")
    with open(child["path"], "rb") as f:
        built = pickle.load(f)
    err = built["err"]
    paths = {x: os.path.join(WORK, x) for x in ("idx", "reads.fq", "locate.fq", "greedy.fq",
                                                "greedy_cpu.fq", "lmem.fq", "out.txt")}
    check(err.splitlines()[-1].startswith("built index (n="), f"rbt_build said {err[-200:]!r}")
    t = time.perf_counter()
    idx = RbtIndex.load(paths["idx"])
    load_s = time.perf_counter() - t
    check(idx.n == text.shape[0] and idx.kval is not None and idx.ftab_k == FTAB_K
          and idx.fblock is not None and idx.ma_start1 is not None, "rbt_build's index tables")
    cli_pm = PosMarkers.load(paths["idx"] + ".midx.npz")
    check(np.array_equal(cli_pm.pos, pm.pos) and np.array_equal(cli_pm.val, pm.val),
          "rbt_build -m's idx.midx.npz != the panel's positional markers")
    reads = sample_reads(text, np.random.default_rng(cfg["seed"] + 1), N_READS)
    write_fastq(paths["reads.fq"], reads)
    write_fastq(paths["locate.fq"], reads[:N_LOCATE])
    write_fastq(paths["greedy.fq"], reads[:N_GREEDY])
    write_fastq(paths["greedy_cpu.fq"], reads[:N_GREEDY_CPU])
    write_fastq(paths["lmem.fq"], reads[:N_LMEM])
    emit("build_cli", n=idx.n, R=idx.R, M=int(idx.ma_val.shape[0]), docs=len(idx.doc_names),
         ref_len=cfg["ref_len"], files_write_s=built["write_s"],
         panel_check_s=built["panel_check_s"], build_s=built["build_s"],
         peak_rss_gb=built["peak_rss_gb"], load_s=load_s, child_wall_s=built["wall_s"],
         index_gb=dir_gb(paths["idx"]), ftab_text_mb=os.path.getsize(paths["idx"] + ".ftab") / 1e6,
         cli_stderr=err.splitlines(), setup_s=time.perf_counter() - t0)
    return dict(idx=idx, text=text, reads=reads, paths=paths, build_s=built["build_s"], pm=pm)


def markers_by_text_pos(markers):
    """PosMarkers.from_panel over the panel's markers, packed in bulk."""
    from rowbowt_tpu_torch.midx import PosMarkers

    cols = {k: np.fromiter((getattr(m, k) for m in markers), np.int64, len(markers))
            for k in ("text_pos", "seq", "pos", "allele")}
    packed = (cols["seq"] << 48) | (cols["pos"] << 8) | cols["allele"]  # index.pack_marker
    return PosMarkers.from_pairs(cols["text_pos"], packed)


def run_main(tool: str, argv: list[str], out_path: str):
    """`python -m rowbowt_tpu_torch.cli.<tool> argv` as a user calls it, in
    this process, stdout to out_path.  Returns (wall seconds, its stdout, its
    stderr)."""
    import importlib

    main_fn = importlib.import_module(f"rowbowt_tpu_torch.cli.{tool}").main
    err_buf = io.StringIO()
    t = time.perf_counter()
    with open(out_path, "w") as out, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err_buf):
        rc = main_fn(argv)
    wall = time.perf_counter() - t
    sys.stderr.write(err_buf.getvalue())
    check(rc == 0, f"{tool} {' '.join(argv)} exited {rc}")
    with open(out_path) as f:
        return wall, f.read(), err_buf.getvalue()


def run_tables_line(err: str) -> dict | None:
    """The `run tables: {...}` line of a CLI's load (cli/common.
    device_index: the run-space tables' bytes and seconds), or None."""
    line = next((ln for ln in err.splitlines() if ln.startswith("run tables: ")), None)
    return json.loads(line[len("run tables: "):]) if line else None


def run_cli(argv: list[str], out_path: str):
    """The port's rbt_align.  Returns ({cli_load_s, cli_query_s, cli_meter,
    cli_wall_s, cli_run_tables}, its stdout, its stderr)."""
    wall, out, err = run_main("rbt_align", argv, out_path)
    # the CLI's own "<load_s> <query_s>" line and its meter line
    err_lines = err.splitlines()
    load_s, query_s = (float(x) for x in next(ln for ln in err_lines if ln[:1].isdigit()).split())
    meter = next(ln for ln in err_lines if ln.startswith("meter:"))
    return dict(cli_load_s=load_s, cli_query_s=query_s, cli_meter=meter,
                cli_wall_s=wall, cli_run_tables=run_tables_line(err)), out, err


def run_seeding_cli(tool: str, argv: list[str], out_path: str, env: dict | None = None):
    """The port's rbt_markers or rbt_locs, with `env` set in os.environ for
    the call.  Returns ({cli_load_s, cli_query_s, cli_meter, cli_wall_s,
    cli_stages, cli_run_tables}, its stdout, its stderr) from the CLI's "...
    took: <s> seconds", "meter:", "stages:" and "run tables:" lines."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        wall, out, err = run_main(tool, argv, out_path)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    took = [float(ln.split("took: ")[1].split()[0]) for ln in err.splitlines() if " took: " in ln]
    meter = next(ln for ln in err.splitlines() if ln.startswith("meter:"))
    stages = json.loads(next(ln for ln in err.splitlines() if ln.startswith("stages: "))[8:])
    return dict(cli_load_s=took[0], cli_query_s=took[1], cli_meter=meter, cli_wall_s=wall,
                cli_stages=stages, cli_run_tables=run_tables_line(err)), out, err


def count_lines(names, lo, hi) -> list[str]:
    return [f"{name} ({s},{e}), count={e - s + 1 if e >= s else 0}\n"
            for name, s, e in zip(names, lo.tolist(), hi.tolist())]


def phase_main(device, card: dict, chr_: dict) -> dict:
    """The port's rbt_align count mode on the chr index, then K1 vs plain timings."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    # the main path: reset the count, run the CLI, read the count
    cuda_lf.LAUNCHES = 0
    cli, out_text, _ = run_cli([paths["idx"], paths["reads.fq"], "-b", str(BATCH),
                             "--device", str(device)], paths["out.txt"])
    launches = cuda_lf.LAUNCHES
    check(launches == N_READS // BATCH, f"K1 launched {launches} times in the main path")
    lines = out_text.splitlines(keepends=True)
    check(len(lines) == N_READS, f"rbt_align printed {len(lines)} lines")

    # the CLI's stages one by one on the same file (host clock; each device
    # stage ends in a synchronize): where the main path's time goes
    stages = {}
    with timed(stages, "load_s"):
        loaded = RbtIndex.load(paths["idx"], with_sa=False, with_ma=False, with_dl=False,
                               with_ft=False)
        tx = TorchIndex.from_index(loaded, device)
    with timed(stages, "parse_s"):
        batches = list(iter_query_batches(loaded, paths["reads.fq"], BATCH))
    with timed(stages, "h2d_s"):
        dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
               for _, qc, lens in batches]
    with timed(stages, "lf_s"):
        ranges = [find_ranges(tx, q, ln) for q, ln in dev]
    with timed(stages, "d2h_s"):
        host = [(lo.cpu().numpy(), hi.cpu().numpy()) for lo, hi in ranges]
    with timed(stages, "format_s"):
        text_out = "".join("".join(count_lines(names, lo, hi))
                           for (names, _, _), (lo, hi) in zip(batches, host))
    check(out_text == text_out, "rbt_align output != the staged run's lines")

    # every batch: the CLI's ranges == the plain loop on the card
    plain_out = [cuda_lf.find_ranges_plain(tx, q, ln) for q, ln in dev]
    err = max(max_abs_err((torch.from_numpy(lo), torch.from_numpy(hi)), (plo.cpu(), phi.cpu()))
              for (lo, hi), (plo, phi) in zip(host, plain_out))
    check(err == 0, f"rbt_align ranges != plain loop: max |err| {err}")
    nonempty = sum(int((hi >= lo).sum()) for lo, hi in host)

    # the count call (K1 and its wrapper) vs the plain loop over the four
    # distinct batches (distinct reads, so the L2 holds only what a real run
    # would reuse), in turns: plain, K1, K1, plain; CUDA events per call.  The
    # kernel's device time alone is phase k1's.
    n_chars = sum(int(lens.sum()) for _, _, lens in batches)
    k1_ms, plain_ms = in_turns([lambda q=q, ln=ln: cuda_lf.find_ranges_plain(tx, q, ln)
                                for q, ln in dev],
                               [lambda q=q, ln=ln: find_ranges(tx, q, ln) for q, ln in dev], 1, 5)
    tx96 = TorchIndex.from_index(loaded, device, fb64=False)
    k1_fb96_ms = cuda_ms([lambda q=q, ln=ln: find_ranges(tx96, q, ln) for q, ln in dev], 5)
    txf = TorchIndex.from_index(dataclasses.replace(loaded, ftab=idx.ftab, ftab_k=idx.ftab_k),
                                device)  # with the ftab start
    k1_ftab_ms = cuda_ms([lambda q=q, ln=ln: find_ranges(txf, q, ln) for q, ln in dev], 5)
    per_batch = n_chars / len(dev)
    res = dict(n=idx.n, R=idx.R, reads=N_READS, batch=BATCH, **cli,
               cli_reads_per_s=N_READS / cli["cli_query_s"],
               cli_lf_steps_per_s=n_chars / cli["cli_query_s"],
               cli_reads_per_s_with_load=N_READS / cli["cli_wall_s"],
               launches=launches, max_abs_err=err, nonempty=nonempty, stages=stages,
               table_mb=tx.arrays["fblock64"].numel() * 4 / 1e6,
               qcodes_width=int(dev[0][0].shape[1]),
               k1_call_ms=k1_ms, plain_ms=plain_ms, k1_fb96_call_ms=k1_fb96_ms,
               k1_ftab_call_ms=k1_ftab_ms, k1_call_reads_per_s=BATCH / (k1_ms / 1e3),
               k1_call_lf_steps_per_s=per_batch / (k1_ms / 1e3),
               plain_reads_per_s=BATCH / (plain_ms / 1e3),
               plain_lf_steps_per_s=per_batch / (plain_ms / 1e3),
               card=card["nvidia_smi"])
    emit("main", **res)
    res["lines"] = lines
    res["lo"] = np.concatenate([lo for lo, _ in host])
    res["hi"] = np.concatenate([hi for _, hi in host])
    return res


def parse_locs(lines: list[str]):
    """(hits per line, positions, doc names, offsets in the doc) of `\tlocs: ` lines."""
    counts, pos, docs, doff = [], [], [], []
    for ln in lines:
        check(ln.startswith("\tlocs: "), f"not a locs line: {ln[:80]!r}")
        toks = ln[7:].split()
        counts.append(len(toks))
        for t in toks:
            p, rest = t.split("/", 1)
            d, o = rest.rsplit(":", 1)
            pos.append(int(p))
            docs.append(d)
            doff.append(int(o))
    return (np.array(counts, dtype=np.int64), np.array(pos, dtype=np.int64), docs,
            np.array(doff, dtype=np.int64))


def check_locs(idx, text, reads, lo, hi, counts, pos, docs, doff) -> None:
    """Every read's printed occurrences against the text, the SA and the
    document list, on the host."""
    n = idx.n
    sizes = np.where(hi >= lo, hi - lo + 1, 0)
    check(np.array_equal(counts, sizes), "a read's located hits != its count")
    rid = np.repeat(np.arange(counts.shape[0]), counts)
    check(np.unique(rid * n + pos).size == pos.size, "a position repeats within a read")
    check(((pos >= 0) & (pos < n)).all(), "a position lies outside the text")
    for a in range(0, pos.size, 1 << 20):  # the text at each position is the read
        p, r = pos[a:a + (1 << 20)], rid[a:a + (1 << 20)]
        win = text[np.minimum(p[:, None] + np.arange(READ_LEN)[None, :], n - 1)]
        check((win == reads[r]).all(), "the text at a located position != the read")
    offs = np.concatenate([[0], np.cumsum(counts)])
    found = sizes > 0
    check(np.array_equal(pos[offs[:-1][found]], idx.kval[hi[found]]),
          "a read's first position != SA[e] (the toehold)")
    d = np.searchsorted(idx.doc_starts, pos, side="right") - 1
    name_id = {name: i for i, name in enumerate(idx.doc_names)}
    check(np.array_equal(np.array([name_id[x] for x in docs]), d),
          "a printed document != the doc list's")
    check(np.array_equal(doff, pos - idx.doc_starts[d]), "a printed doc offset is wrong")


def phase_locate(device, card: dict, chr_: dict, count: dict) -> dict:
    """The port's rbt_align -s on the first N_LOCATE reads, checked on the host."""
    import torch

    from rowbowt_tpu_torch.cli import rbt_align
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.locate import (
        find_ranges_w_toehold, locate_ragged, resolve_docs,
    )
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    reset_counts()
    cli, out_text, _ = run_cli([paths["idx"], paths["locate.fq"], "-s", "-b", str(BATCH),
                             "--device", str(device)], paths["out.txt"])
    launches, walks = cuda_lf.LAUNCHES, walk_counts()
    n_batches = -(-N_LOCATE // BATCH)
    check(launches == n_batches, f"K1 launched {launches} times in the -s run")
    check(walks == dict(walk=0, kval=n_batches),
          f"-s walks: {walks} (one kval walk launch a batch, no chain, no torch walk)")
    lines = out_text.splitlines(keepends=True)
    check(len(lines) == 2 * N_LOCATE, f"rbt_align -s printed {len(lines)} lines")
    check(lines[0::2] == count["lines"][:N_LOCATE], "the -s run's ranges != the count run's")
    counts, pos, docs, doff = parse_locs(lines[1::2])
    check_locs(idx, chr_["text"], chr_["reads"][:N_LOCATE], count["lo"][:N_LOCATE],
               count["hi"][:N_LOCATE], counts, pos, docs, doff)

    stages = {}
    with timed(stages, "load_s"):
        loaded = RbtIndex.load(paths["idx"], with_sa=True, with_ma=False, with_dl=True,
                               with_ft=False)
        tx = TorchIndex.from_index(loaded, device)
    with timed(stages, "parse_s"):
        batches = list(iter_query_batches(loaded, paths["locate.fq"], BATCH))
    with timed(stages, "h2d_s"):
        dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device), len(names))
               for names, qc, lens in batches]
    with timed(stages, "lf_toehold_s"):
        ranges = [tuple(t[:nr] for t in find_ranges_w_toehold(tx, q, ln)) for q, ln, nr in dev]
    with timed(stages, "walk_s"):
        located = [locate_ragged(tx, lo, hi, k) for lo, hi, k in ranges]
    with timed(stages, "docs_s"):
        resolved = [tuple(t.cpu().numpy() for t in resolve_docs(tx, torch.from_numpy(flat)
                                                                .to(device)))
                    for flat, _ in located]
    with timed(stages, "text_s"):
        cols = [rbt_align.format_locs(loaded.doc_names, flat, offs, d, o)
                for (flat, offs), (d, o) in zip(located, resolved)]
    with timed(stages, "format_s"):
        text_out = "".join(
            "".join(a + b for a, b in zip(count_lines(names, lo.cpu().numpy(), hi.cpu().numpy()),
                                          col))
            for (names, _, _), (lo, hi, _), col in zip(batches, ranges, cols))
    check(out_text == text_out, "rbt_align -s output != the staged run's lines")
    hits = int(counts.sum())
    res = dict(reads=N_LOCATE, batch=BATCH,
               pad_lanes=n_batches * BATCH - N_LOCATE, **cli,
               cli_reads_per_s=N_LOCATE / cli["cli_query_s"],
               cli_reads_per_s_with_load=N_LOCATE / cli["cli_wall_s"],
               hits=hits, cli_hits_per_s=hits / cli["cli_query_s"],
               located_reads=int((counts > 0).sum()), max_hits_per_read=int(counts.max()),
               launches=launches, walks=walks, stages=stages, card=card["nvidia_smi"])
    emit("locate", **res)
    res["tx"], res["ranges"], res["out_text"] = tx, ranges, out_text
    return res


def phase_trace(device, card: dict, chr_: dict, loc: dict) -> dict:
    """`rbt_align -s --profile` on the locate reads, after the timed -s run:
    the same output, a trace that names K1's kernel, and the card's busy
    seconds (the union of its kernels, copies and memsets) against the
    CLI's query seconds."""
    paths = chr_["paths"]
    trace_dir = os.path.join(WORK, "trace")
    cli, out_text, err = run_cli([paths["idx"], paths["locate.fq"], "-s", "-b", str(BATCH),
                                  "--device", str(device), "--profile", trace_dir],
                                 paths["out.txt"])
    check(out_text == loc["out_text"], "rbt_align -s --profile output != the -s run's")
    check(f"profiler trace written to {trace_dir}" in err.splitlines(),
          "rbt_align --profile did not report its trace")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    check(len(traces) == 1, f"expected one trace in {trace_dir}, found {traces}")
    path = os.path.join(trace_dir, traces[0])
    events = device_events(path)
    by_name: dict = {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur
    k1 = [name for name in by_name if "lf_count_kernel" in name]
    check(bool(k1), "the -s trace names no K1 kernel (lf_count_kernel)")
    busy_s = busy_us(events) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = dict(reads=N_LOCATE, **cli, trace_mb=os.path.getsize(path) / 1e6,
               device_events=len(events), k1_kernel=k1[0],
               k1_s=sum(by_name[name] for name in k1) / 1e6, device_busy_s=busy_s,
               busy_share_of_query=busy_s / cli["cli_query_s"],
               top_device_s={name[:80]: us / 1e6 for name, us in top},
               card=card["nvidia_smi"])
    emit("trace", **res)
    return res


def expected_marker_lines(idx, lo, hi) -> list[str]:
    """Each range's markers from the host CSR alone (no ma_start1): the
    entries of rows [lo, hi] are ma_val[searchsorted(ma_row, lo) :
    searchsorted(ma_row, hi + 1)]."""
    from rowbowt_tpu_torch.cli.rbt_align import NO_MARKERS
    from rowbowt_tpu_torch.index import marker_allele, marker_pos

    s = np.searchsorted(idx.ma_row, lo, side="left")
    e = np.maximum(np.searchsorted(idx.ma_row, hi + 1, side="left"), s)
    out = []
    for a, b in zip(s.tolist(), e.tolist()):
        v = idx.ma_val[a:b]
        out.append("\tmarkers: " + ("".join(f"{p}/{al} " for p, al in
                                            zip(marker_pos(v).tolist(),
                                                marker_allele(v).tolist()))
                                    if b > a else NO_MARKERS) + "\n")
    return out


def phase_markers(device, card: dict, chr_: dict, count: dict) -> dict:
    """The port's rbt_align -m on the first N_LOCATE reads, checked on the host."""
    import torch

    from rowbowt_tpu_torch.cli import rbt_align
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    cuda_lf.LAUNCHES = 0
    cli, out_text, _ = run_cli([paths["idx"], paths["locate.fq"], "-m", "-b", str(BATCH),
                             "--device", str(device)], paths["out.txt"])
    launches = cuda_lf.LAUNCHES
    n_batches = -(-N_LOCATE // BATCH)
    check(launches == n_batches, f"K1 launched {launches} times in the -m run")
    lines = out_text.splitlines(keepends=True)
    check(len(lines) == 2 * N_LOCATE, f"rbt_align -m printed {len(lines)} lines")
    check(lines[0::2] == count["lines"][:N_LOCATE], "the -m run's ranges != the count run's")
    want = expected_marker_lines(idx, count["lo"][:N_LOCATE], count["hi"][:N_LOCATE])
    check(lines[1::2] == want, "a read's printed markers != the host CSR's")
    n_markers = sum(len(ln.split()) - 1 for ln in want if not ln.endswith(rbt_align.NO_MARKERS + "\n"))

    stages = {}
    with timed(stages, "load_s"):
        loaded = RbtIndex.load(paths["idx"], with_sa=False, with_ma=True, with_dl=False,
                               with_ft=False)
        tx = TorchIndex.from_index(loaded, device)
    with timed(stages, "parse_s"):
        batches = list(iter_query_batches(loaded, paths["locate.fq"], BATCH))
    with timed(stages, "h2d_s"):
        dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device), len(names))
               for names, qc, lens in batches]
    with timed(stages, "lf_s"):
        ranges = [tuple(t[:nr] for t in find_ranges(tx, q, ln)) for q, ln, nr in dev]
    with timed(stages, "probe_s"):
        probed = [rbt_align.probe_markers(tx, lo, hi) for lo, hi in ranges]
    with timed(stages, "format_s"):
        text_out = "".join(
            "".join(a + b for a, b in zip(count_lines(names, lo.cpu().numpy(), hi.cpu().numpy()),
                                          rbt_align.format_markers(vals, cnt)))
            for (names, _, _), (lo, hi), (vals, cnt) in zip(batches, ranges, probed))
    check(out_text == text_out, "rbt_align -m output != the staged run's lines")
    res = dict(reads=N_LOCATE, batch=BATCH, **cli,
               cli_reads_per_s=N_LOCATE / cli["cli_query_s"],
               cli_reads_per_s_with_load=N_LOCATE / cli["cli_wall_s"],
               markers=n_markers, cli_markers_per_s=n_markers / cli["cli_query_s"],
               reads_with_markers=sum(not ln.endswith(rbt_align.NO_MARKERS + "\n")
                                      for ln in want),
               reprobe_width=max(v.shape[1] for v, _ in probed),
               launches=launches, stages=stages, card=card["nvidia_smi"])
    emit("markers", **res)
    res["out_text"] = out_text
    return res


def phase_phi_chain(device, card: dict, loc: dict, k1: dict) -> dict:
    """P3 over the chr phi1 table from the first -s batch's toeholds, 100
    steps, against its plain twin, and the walk kernel over the same lanes
    (engine/locate.locate with each range the whole BWT, so the walk masks
    nothing: toeholds that are not kval[n - 1], so the chain over phi1)
    against the torch walk (cuda_phi.phi_walk_plain), its column 100 equal
    to P3's; then the walk of rbt_align -s on every -s batch's real lanes
    (walk_times, kval: the kval kernel, kval[hi - j] with no chain)."""
    import torch

    from rowbowt_tpu_torch.engine.locate import locate
    from rowbowt_tpu_torch.ops import cuda_gather as G
    from rowbowt_tpu_torch.ops import cuda_phi

    tx, k = loc["tx"], loc["ranges"][0][2].contiguous()
    phi1 = tx.arrays["phi1"]
    G.check_indices(k, phi1.numel())
    B, width = k.numel(), PHI_STEPS + 1
    lo, hi = torch.zeros_like(k), torch.full_like(k, tx.n - 1)
    size = torch.full((B,), width, dtype=torch.int64, device=device)
    off = torch.arange(B, dtype=torch.int64, device=device) * width

    def torch_walk():
        return cuda_phi.phi_walk_plain(tx, k, size, off, torch.empty(
            B * width, dtype=torch.int64, device=device)).view(B, width)

    got = G.gather_chain(phi1, k, PHI_STEPS)
    want = G.gather_chain_plain(phi1, k, PHI_STEPS)
    walk = locate(tx, lo, hi, k, max_hits=width)[0]
    plain_walk = torch_walk()
    torch.cuda.synchronize()
    err = max_abs_err([got, got, walk], [want, walk[:, PHI_STEPS], plain_walk])
    check(err == 0, f"gather_chain over phi1 != plain / the walk kernel != the torch walk: "
          f"max |err| {err}")
    kernel = [lambda: G.gather_chain(phi1, k, PHI_STEPS)]
    k_ms, p_ms = in_turns([lambda: G.gather_chain_plain(phi1, k, PHI_STEPS)], kernel, 3, 20)
    w_ms, walk_ms = in_turns([torch_walk], [lambda: locate(tx, lo, hi, k, max_hits=width)], 3, 20)
    res = dict(lanes=B, steps=PHI_STEPS, table_mb=phi1.numel() * 4 / 1e6, max_abs_err=err,
               kernel_ms=k_ms, plain_ms=p_ms, walk_kernel_ms=w_ms, phi_walk_ms=walk_ms,
               kernel_us_per_step=k_ms * 1e3 / PHI_STEPS, plain_us_per_step=p_ms * 1e3 / PHI_STEPS,
               walk_kernel_us_per_step=w_ms * 1e3 / PHI_STEPS,
               phi_walk_us_per_step=walk_ms * 1e3 / PHI_STEPS)
    res["walk"] = walk_times(device, tx, loc["ranges"], "kval",
                             k1["us_per_dependent_step"]["random_cycle"])
    emit("phi_chain", **res, card=card["nvidia_smi"])
    return res


# int32 operations of one phi step, on top of its loads: phi1 clamps and
# addresses the lane (4); the phi rows split the position (a division by
# 480 and a product, 4), mask and count 15 words (3 each), add the rank and
# the delta and take the remainder (4); the predecessor search takes 4 a
# level of its binary search and 10 for the step (phi_step_ops)
# the breakpoint table's step: its bucket (a shift and a clamp, 4), 5 a
# halving of its fixed search (a mean, a clamp, a compare, two selects), and
# the remainder (6); loads: the bucket's bounds, each halving's entry, then
# phi_at and pred_pos at the rank together (phi_step_ops, phi_loads)
# the kval walk's position: an index and an address (2), its one load
# dependent only on hi
PHI_STEP_OPS = {"phi1": 4, "phi_rows": 4 + 15 * 3 + 4, "kval": 2}
PHI_LOADS = {"phi1": 1, "phi_rows": 2, "kval": 0}  # dependent loads a step (phi_loads)


def phi_step_ops(tx, route: str, old: bool = False) -> int:
    """int32 operations of a walk step over `route`: the bucketed searches
    (phi_at; pred through pred_off) 10 and 5 a halving; with `old` the pred
    step's binary search over all R entries that the directory replaced."""
    if route == "phi_at":
        return 10 + 5 * tx.pp_bs[1]
    if route == "pred":
        return 4 * search_levels(tx.R) + 10 if old else 10 + 5 * tx.pred_bs[1]
    return PHI_STEP_OPS[route]


def phi_loads(tx, route: str, old: bool = False) -> int:
    """Dependent loads of a walk step over `route`: for phi_at and pred the
    directory's entry, `iters` probes and two loads (pred_pos and phi_at,
    or pred_to_run and samples_last); with `old` the pred step's search
    over all R entries."""
    if route == "phi_at":
        return tx.pp_bs[1] + 2
    if route == "pred":
        return search_levels(tx.R) + 2 if old else 1 + tx.pred_bs[1] + 2
    return PHI_LOADS[route]


def big_walk(device, path: str, fastq: str) -> dict:
    """walk_times over the phi rows of the BigIndex directory at `path`, on
    the batches of `fastq` as rbt_align -s loads and searches them.  A
    step's two dependent loads take the sum of the latencies over two random
    cycles the sizes of phi_rows and phi_delta."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold

    big, tx = load_big(device, path, "-s")
    ranges = []
    for names, qc, lens in iter_query_batches(big, fastq, BATCH):
        q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
        ranges.append(tuple(t[:len(names)] for t in find_ranges_w_toehold(tx, q, ln)))
    lat, table_mb = 0.0, {}
    for key in ("phi_rows", "phi_delta"):
        t = tx.arrays[key]
        table_mb[key] = t.numel() * t.element_size() / 1e6
        cycle = random_cycle(device, t.numel() * t.element_size() // 4)
        lat += dependent_latency_us(device, cycle)
        del cycle
    out = dict(walk_times(device, tx, ranges, "phi_rows", lat), table_mb=table_mb)
    del tx, ranges
    torch.cuda.empty_cache()
    return out


def walk_times(device, tx, ranges, route: str, step_us: float,
               step_us_old: float | None = None) -> dict:
    """The walk kernel (cuda_phi.launch_walk) over tx's `route` table on the
    -s batches' real lanes ranges [(lo, hi, k)], with the operands of
    engine/locate.locate_ragged (route "kval": each lane's hi handed, the
    kval kernel): equal to its plain twin on the card (cuda_phi.
    phi_walk_plain, the torch walk; for kval also kval_walk_plain) with max
    |err| 0, one launch a batch; call ms in turns with the twin; the kernel
    alone as its wrapper launches it (CUDA events just around the launch,
    a spin queued ahead of the first, so the host's launch is out of the
    time), beside `floor_us`, the empty kernel launched the same way in the
    same grid (what a launch and the events cost); the longest lane's
    steps; the bound of each batch,
    the larger of the bytes the inputs need once over the memory rate (k
    or hi, size and off; the distinct table entries the chains read, or
    for kval the distinct kval entries of the lanes' segments; the
    positions written) and, for the chain routes, the longest lane's steps
    x `step_us`, the latency of a step's dependent loads (PHI_LOADS: each
    load's latency measured over a table of its table's size, summed): a
    walk of kval needs no chain, so its bound is bytes alone, whatever
    kernel walks it; its share.  With `step_us_old` (the pred route) also
    the bound and share with the step of the search the directory replaced
    (the *_old keys: its operations and latency; its bytes without the
    directory's).  Times and bounds are means over the batches."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_phi
    from rowbowt_tpu_torch.ops import cuda_gather
    from rowbowt_tpu_torch.ops import rank as R

    by_hi = route == "kval"
    got_route = cuda_phi.walk_route(tx, by_hi)
    check(got_route == route, f"walk route {got_route} != {route}")
    args, outs = [], []
    for lo, hi, k in ranges:
        size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
        total = int(size.sum())
        args.append((k.to(torch.int64), size, torch.cumsum(size, 0) - size,
                     hi.to(torch.int64) if by_hi else None))
        outs.append(torch.empty(total, dtype=torch.int64, device=device))

    def launches():
        return cuda_phi.LAUNCHES_KVAL if by_hi else cuda_phi.LAUNCHES

    def plain_walk(a, o):
        if by_hi:
            return cuda_phi.kval_walk_plain(tx, a[3], *a[1:3], o)
        return cuda_phi.phi_walk_plain(tx, *a[:3], o)

    launches0, err = launches(), 0
    for a, out in zip(args, outs):
        cuda_phi.launch_walk(tx, *a[:3], out, a[3])
        want = [cuda_phi.phi_walk_plain(tx, *a[:3], torch.full_like(out, -1))]
        if by_hi:
            want.append(plain_walk(a, torch.full_like(out, -1)))
        torch.cuda.synchronize()
        err = max(err, *(max_abs_err([out], [w]) for w in want))
    n_launches = launches() - launches0
    check(err == 0, f"the walk kernel over {route} != its plain twin: max |err| {err}")
    check(n_launches == len(args), f"{n_launches} walk kernel launches for {len(args)} batches")
    kernel = [lambda a=a, o=o: cuda_phi.launch_walk(tx, *a[:3], o, a[3])
              for a, o in zip(args, outs)]
    plain = [lambda a=a, o=o: plain_walk(a, o) for a, o in zip(args, outs)]
    call_ms, plain_ms = in_turns(plain, kernel, 1, 5)
    device_us = kernel_event_us([around(fn) for fn in kernel], 5)
    lib, sms = cuda_phi.build(), cuda_gather._sm_count(device.index)

    def empty(a):
        B = a[0].numel()
        check(lib.rbt_phi_walk_empty(B, cuda_phi.launch_plan(B, sms),
                                     cuda_gather._raw_stream(device.index)) == 0,
              "the empty kernel's launch failed")

    floor_us = kernel_event_us([around(lambda a=a: empty(a)) for a in args], 5)
    name = "kval_walk_kernel" if by_hi else "phi_walk_kernel"
    profiled_us = profiled_kernel_us(kernel, 3, (name,))[name]
    batches = []
    for (k, size, off, hi), out in zip(args, outs):
        steps = max(int(size.max()) - 1, 0) if size.numel() else 0
        stepped = torch.ones(out.numel(), dtype=torch.bool, device=device)
        stepped[(off + size - 1)[size > 0]] = False  # a lane's last position is not stepped from
        pos = out[stepped]
        if route == "kval":
            # every lane's segment kval[hi - size + 1 .. hi], read once
            live = size > 0
            s = size[live]
            lane = torch.repeat_interleave(torch.arange(s.numel(), device=device), s)
            j = torch.arange(out.numel(), device=device) - (torch.cumsum(s, 0) - s)[lane]
            table_bytes = (torch.unique(hi[live][lane] - j).numel()
                           * tx.arrays["kval"].element_size())
        elif route == "phi1":
            table_bytes = torch.unique(pos).numel() * tx.arrays["phi1"].element_size()
        elif route == "phi_rows":
            table_bytes = (torch.unique(pos // 480).numel() * 64
                           + torch.unique(R.phi_rows_rank(tx, pos)).numel() * 8)
        elif route == "phi_at":
            # the bucket bounds of each position's bucket, and pred_pos and
            # phi_at at its rank (the search's other probes not counted)
            pp, at, poff = (tx.arrays[name] for name in cuda_phi.PHI_AT_TABLES)
            shift = tx.pp_bs[0]
            b = torch.clamp((pos + 1) >> shift, 0, poff.numel() - 2)
            rk = torch.searchsorted(pp, pos.to(pp.dtype), right=True) - 1
            table_bytes = (torch.unique(b).numel() * 2 * poff.element_size()
                           + torch.unique(rk).numel() * (pp.element_size() + at.element_size()))
        else:
            # the predecessor entry of each position (pred_pos and
            # pred_to_run), the sample it reads and the bucket bounds of
            # the position's bucket of pred_off
            pp, ptr, sl, poff = (tx.arrays[name] for name in cuda_phi.PRED_TABLES)
            rk = torch.searchsorted(pp, pos.to(pp.dtype)).long()
            jr = torch.where(rk == 0, tx.R - 1, rk - 1)
            b = torch.clamp(pos >> tx.pred_bs[0], 0, poff.numel() - 2)
            table_bytes = (torch.unique(jr).numel() * (pp.element_size() + ptr.element_size())
                           + torch.unique(ptr[jr].long() - 1).numel() * sl.element_size())
            dir_bytes = torch.unique(b).numel() * 2 * poff.element_size()
        one = dict(lanes=k.numel(), hits=out.numel(), longest_steps=steps)
        for tag, old in (("", False), ("_old", True)):
            if old and step_us_old is None:
                break
            tb = table_bytes + (dir_bytes if route == "pred" and not old else 0)
            nbytes = k.numel() * 24 + out.numel() * 8 + tb
            byte_us = nbytes / HBM_BYTES_PER_S * 1e6
            ops = out.numel() if by_hi else pos.numel()
            ops_us = ops * phi_step_ops(tx, route, old) / INT_OPS_PER_S * 1e6
            latency_us = 0.0 if by_hi else steps * (step_us_old if old else step_us)
            one.update({f"table_bytes{tag}": tb, f"bytes{tag}": nbytes, f"byte_us{tag}": byte_us,
                        f"ops_us{tag}": ops_us, f"latency_us{tag}": latency_us,
                        f"bound_us{tag}": max(byte_us, ops_us, latency_us)})
        batches.append(one)
    mean = {key: sum(b[key] for b in batches) / len(batches)
            for key in ("byte_us", "ops_us", "latency_us", "bound_us")}
    bound_by = max(("bytes", "byte_us"), ("operations", "ops_us"), ("latency", "latency_us"),
                   key=lambda kv: mean[kv[1]])[0]
    out = dict(route=route, batches=batches, launches=n_launches, max_abs_err=err,
               call_ms=call_ms, plain_ms=plain_ms, device_us=device_us, floor_us=floor_us,
               profiled_us=profiled_us, step_us=None if by_hi else step_us,
               loads_per_step=phi_loads(tx, route),
               longest_steps=max(b["longest_steps"] for b in batches),
               bound_ms=max(mean["byte_us"], mean["ops_us"]) / 1e3,
               bound_by="bytes" if mean["byte_us"] >= mean["ops_us"] else "operations",
               bound_us=mean["bound_us"], bound_us_by=bound_by,
               share=mean["bound_us"] / device_us)
    if route == "pred":
        out["pred_bs"] = list(tx.pred_bs)
    if step_us_old is not None:
        old = {key: sum(b[f"{key}_old"] for b in batches) / len(batches)
               for key in ("byte_us", "ops_us", "bound_us")}
        out.update(step_us_old=step_us_old, loads_per_step_old=phi_loads(tx, route, True),
                   bound_ms_old=max(old["byte_us"], old["ops_us"]) / 1e3,
                   bound_us_old=old["bound_us"], share_old=old["bound_us"] / device_us)
    return out


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 rate: half the data sheet's 67 T/s fp32 rate outside the
# tensor cores, as an SM has half as many INT32 lanes as FP32 ones
INT_OPS_PER_S = 33.5e12
RANK_OPS = 8 * 12 + 8  # int32 operations of one SWAR rank over a 64 B row: 8 words, checkpoint


def plane_rank_ops(syms: int) -> int:
    """int32 operations of one rank over a two-level bit-plane row of `syms`
    symbols: 8 a 32-symbol word (three xors with the code's masks, two ands,
    the offset's mask, a popcount, an add) and 8 for the checkpoint, the
    superblock's base and the sum, as RANK_OPS counts a SWAR rank."""
    return syms // 32 * 8 + 8


def k1_current(tx, q, ln, use_ftab: bool = True, start=None, end=None):
    """cuda_lf.find_ranges (one launch of K1), with CUDA events `start` and
    `end`, when given, recorded around the call."""
    from rowbowt_tpu_torch.ops import cuda_lf

    return around(lambda: cuda_lf.find_ranges(tx, q, ln, use_ftab))(start, end)


def k1_work(tx, q, ln, use_ftab: bool) -> dict:
    """What one batch asks of K1, by a counting replay of the plain loop
    (ops/rank.py, ops/cuda_lf.lf_start): the codes of the reads (min(length,
    L) a lane, the pad columns left out); active lane-steps; ranked steps (an
    absent code ends a lane without a load); steps whose lo and hi + 1 lie in
    two rows; row loads (one or two a ranked step, none for hi + 1 == n);
    distinct rows; lanes that read the ftab, ftab hits and distinct entries
    read; the longest lane's steps."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    B, L = q.shape
    n, dt = tx.n, tx.idx_dtype
    shift = cuda_lf._SYMS_PER_ROW[cuda_lf.row_layout(tx)].bit_length() - 1
    lo, hi, startj = cuda_lf.lf_start(tx, q, ln, use_ftab)
    lengths = ln.to(dt)
    k = tx.ftab_k if use_ftab and tx.has_ftab and L >= tx.ftab_k > 0 else 0
    ftab = dict(ftab_reads=0, ftab_hits=0, ftab_entries=0)
    if k:
        kc = R.kmer_codes(tx, q[:, L - k:])
        read = (kc >= 0) & (lengths >= k)
        ftab = dict(ftab_reads=int(read.sum()), ftab_hits=int((startj == k).sum()),
                    ftab_entries=int(torch.unique(kc[read]).numel()))
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
        has1 = rk & (hi + 1 < n)
        differ = has1 & (((hi + 1) >> shift) != (lo >> shift))
        ranked = ranked + rk.sum()
        two = two + differ.sum()
        rows += [(lo >> shift)[rk], ((hi + 1) >> shift)[differ]]
        nlo, nhi = step(tx, lo, hi, c)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    return dict(codes=int(lengths.clamp(max=L).sum()), lane_steps=int(steps.sum()),
                ranked_steps=int(ranked), two_row_steps=int(two),
                row_loads=int(ranked) + int(two),
                distinct_rows=int(torch.unique(torch.cat(rows)).numel()),
                longest_lane_steps=int(steps.max()), **ftab)


def k1_bound(work: list[dict], B: int, L: int, A: int, row_bytes: int, us_per_step: float,
             lane_bytes: int = 4, table_bytes: int = 0, out_bytes: int = 0,
             step_ops: int = 2 * RANK_OPS, sass_step_ops: int | None = None) -> dict:
    """K1's bound per batch from the batches' work: bytes (each input byte
    read once: the reads' int32 codes, the lengths, F, the distinct rows, the
    distinct ftab entries, `table_bytes` more (the two-level rows' base
    table); each output written once: lo, hi, of lane_bytes each, and
    `out_bytes` more (the record launch's [L, B] int64 step record)) over the
    card's memory rate; the operations of the ranked steps over its int32
    rate, `step_ops` a step (two SWAR ranks of RANK_OPS; the two-level
    search: two plane ranks, plane_rank_ops); the longest lane's dependent
    steps times the dependent load latency.  `sass_step_ops`, where given
    (the two-level search's two threads' step loop in machine code,
    step_loop), gives the issue time of the kernel's own instructions
    (`issue_bound_us`, one instruction of one thread an operation) beside
    the bound, not in it.  The kernel stages whole padded rows,
    padded_code_bytes, more than the reads' codes."""
    nb = len(work)
    mean = {key: sum(w[key] for w in work) / nb for key in work[0]}
    nbytes = (mean["codes"] * 4 + B * 4 + (A + 1) * lane_bytes
              + mean["distinct_rows"] * row_bytes + mean["ftab_entries"] * 8 + table_bytes
              + B * 2 * lane_bytes + out_bytes)
    ops = step_ops * mean["ranked_steps"]
    byte_us = nbytes / HBM_BYTES_PER_S * 1e6
    ops_us = ops / INT_OPS_PER_S * 1e6
    latency_us = mean["longest_lane_steps"] * us_per_step
    bound_us = max(byte_us, latency_us)
    return dict(mean, bytes=nbytes, padded_code_bytes=B * L * 4, byte_bound_us=byte_us,
                ops=ops, ops_bound_us=ops_us, step_ops=step_ops, sass_step_ops=sass_step_ops,
                issue_bound_us=(sass_step_ops * mean["ranked_steps"] / INT_OPS_PER_S * 1e6
                                if sass_step_ops else None),
                latency_bound_us=latency_us, bound_us=bound_us,
                bound_by="bytes" if byte_us >= latency_us else "latency",
                row_load_bytes=mean["row_loads"] * row_bytes,
                row_load_bound_us=mean["row_loads"] * row_bytes / HBM_BYTES_PER_S * 1e6)


def phase_k1(device, card: dict, chr_: dict) -> dict:
    """K1 at chr over the four 65,536-read batches of the main path, in two
    lines.  k1_step1: the work the batches need; P3's dependent-load latency
    on 32 lanes over the chr phi1 (640 MB), over a random cycle of the same
    size and over the probe tool's 4 MB table; the bound and what binds it.
    k1: K1 equal to the plain loop, its call time (CUDA events) and its
    kernel's time alone in two passes (CUDA events just around the launch;
    torch.profiler as a check), with and without the ftab; the share of the
    bound it reaches."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    tx = TorchIndex.from_index(idx, device)  # fblock64, ftab, phi1
    dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
           for _, qc, lens in iter_query_batches(idx, paths["reads.fq"], BATCH)]
    B, L = dev[0][0].shape
    modes = (("", False), ("ftab_", True))
    plain = {use_ftab: [cuda_lf.find_ranges_plain(tx, q, ln, use_ftab) for q, ln in dev]
             for _, use_ftab in modes}

    def held(use_ftab) -> int:
        """max |err| of K1 over the batches against the plain loop (0 or raise)."""
        e = max(max_abs_err(cuda_lf.find_ranges(tx, q, ln, use_ftab), want)
                for (q, ln), want in zip(dev, plain[use_ftab]))
        check(e == 0, f"K1 != plain at chr (ftab={use_ftab}): max |err| {e}")
        return e

    def calls(use_ftab):
        return [lambda q=q, ln=ln: k1_current(tx, q, ln, use_ftab) for q, ln in dev]

    def bracketed(use_ftab):  # calls that record CUDA events around the kernel
        return [lambda a, b, q=q, ln=ln: k1_current(tx, q, ln, use_ftab, a, b) for q, ln in dev]

    step1 = dict(batches=len(dev), lanes=B, L=L)
    # dependent-load latency: P3 on one warp, 10,000 steps a call (CUDA
    # events), over phi1, over one random cycle through a table of phi1's
    # size (every step a random 640 MB address) and over the probe tool's
    # 4 MB table
    cycle = random_cycle(device, tx.arrays["phi1"].numel())
    lat = {name: dependent_latency_us(device, tab) for name, tab in (
        ("phi1", tx.arrays["phi1"]), ("random_cycle", cycle),
        ("tool_table", torch.from_numpy(probe_cases(device)[2]).to(device)))}
    del cycle
    step1["us_per_dependent_step"] = lat
    for tag, use_ftab in modes:
        work = [k1_work(tx, q, ln, use_ftab) for q, ln in dev]
        step1[f"{tag}work"] = work
        step1[f"{tag}bound"] = k1_bound(work, B, L, tx.A, 64, lat["random_cycle"])
    emit("k1_step1", **step1, card=card["nvidia_smi"])

    res = dict(step1, max_abs_err=max(held(f) for _, f in modes),
               plan=dict(zip(("threads", "staged"), cuda_lf.launch_plan(
                   B, L, cuda_lf._sm_count(device.index)))))
    k1 = {}
    for tag, use_ftab in modes:
        k1[f"k1_{tag}call_ms"] = cuda_ms(calls(use_ftab), 5)
        each = [kernel_event_us(bracketed(use_ftab), 5) for _ in range(2)]
        k1[f"k1_{tag}device_us"], k1[f"k1_{tag}device_us_each"] = sum(each) / 2, each
        k1[f"{tag}profiled_us"] = profiled_kernel_us(calls(use_ftab), 3, ("lf_count_kernel",))
        k1[f"{tag}k1_share"] = res[f"{tag}bound"]["bound_us"] / k1[f"k1_{tag}device_us"]
    emit("k1", max_abs_err=res["max_abs_err"], plan=res["plan"], **k1, card=card["nvidia_smi"])
    res.update(k1)
    return res


def read_no(line: str) -> int:
    """The read number of an output line (names are r<i>)."""
    return int(line.split(" ", 1)[0].rstrip("\n")[1:])


def marker_count(lines: list[str]) -> int:
    """Markers printed on rbt_markers lines (fields after the fifth, "." none)."""
    return sum(len(ln.split()) - 5 for ln in lines if not ln.endswith(" .\n"))


def oracle_seed_lines(idx, reads: np.ndarray, lmem: bool, wsize=MA_WSIZE, max_range=1000,
                      max_seeds=8, max_k=32, use_ftab: bool = True) -> list[str]:
    """rbt_markers' lines (default filters, -f; use_ftab=False: as on an
    index without the ftab) for `reads` from the scalar oracle engine/naive:
    each strand's fn() calls, the seed table cut to max_seeds (greedy) and
    each seed's markers to their first max_k, then MarkerSeed.print_buf,
    forward strand first."""
    from rowbowt_tpu_torch.alphabet import revcomp
    from rowbowt_tpu_torch.engine import naive
    from rowbowt_tpu_torch.engine.filters import MarkerSeed, _u64

    out = []
    for i, r in enumerate(reads):
        for strand, seq in (("+", r), ("-", revcomp(r))):
            calls = []

            def fn(rn, q, mk):
                calls.append((rn, q, [int(x) for x in mk]))
            codes = idx.alpha.encode(seq).astype(np.int64)
            if lmem:
                naive.get_markers_lmems(idx, codes, wsize, max_range, fn)
            else:
                naive.get_markers_greedy_seeding(idx, codes, wsize, max_range, fn,
                                                 use_ftab=use_ftab)
                calls = calls[:max_seeds]
            for rn, (qs, qe), mk in calls:
                if rn[1] < rn[0]:
                    continue
                out.append(MarkerSeed(f"r{i}", strand, _u64(rn[1] - rn[0] + 1),
                                      len(seq) - qs - 1 if strand == "-" else qs,
                                      _u64(qe - qs + 1), sorted(set(mk[:max_k])))
                           .print_buf() + "\n")
    return out


def phase_greedy(device, card: dict, chr_: dict, lat: float | None = None) -> dict:
    """The port's rbt_markers -f on the first N_GREEDY reads: one launch of
    the greedy machine a batch and no torch seeding loop; against the CPU run
    of the first N_GREEDY_CPU and the oracle on N_ORACLE reads; the stage
    seconds are the CLI's own.  Then seeds_times: the greedy machine on the
    CLI's 65,536-lane batch, the lmem machine on one batch of the --lmem run
    (phase lmem's reads) and the sampled machine on rbt_locs' batch (phase
    locs'), each against its plain twin, with its work and bound (`lat`:
    phase k1's dependent-load latency over a random cycle)."""
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    argv = ["-f", "-b", str(GREEDY_BATCH)]
    reset_counts()
    cli, out_text, _ = run_seeding_cli(
        "rbt_markers", [paths["idx"], paths["greedy.fq"], *argv, "--device", str(device)],
        paths["out.txt"])
    k1, seeds = cuda_lf.LAUNCHES, seed_counts()
    batches = -(-N_GREEDY // GREEDY_BATCH)
    check(seeds == seed_launches(greedy=batches),
          f"rbt_markers -f: {seeds}, not one greedy launch a batch and no torch loop")
    lines = out_text.splitlines(keepends=True)
    nums = np.array([read_no(ln) for ln in lines])
    check(len(lines) > 2 * N_GREEDY and np.all(np.diff(nums) >= 0)
          and nums[-1] == N_GREEDY - 1, "rbt_markers lines are not in read order")

    cpu, cpu_text, _ = run_seeding_cli(
        "rbt_markers", [paths["idx"], paths["greedy_cpu.fq"], "-f", "-b", str(N_GREEDY_CPU),
                        "--device", "cpu"],
        paths["out.txt"])
    n_first = int((nums < N_GREEDY_CPU).sum())
    check(cpu_text.splitlines(keepends=True) == lines[:n_first],
          f"rbt_markers --device cuda != --device cpu on the first {N_GREEDY_CPU} reads")
    t = time.perf_counter()
    want = oracle_seed_lines(idx, chr_["reads"][:N_ORACLE], lmem=False)
    oracle_s = time.perf_counter() - t
    check(lines[:int((nums < N_ORACLE).sum())] == want,
          f"rbt_markers != the scalar oracle on the first {N_ORACLE} reads")

    n_markers = marker_count(lines)
    tx = TorchIndex.from_index(idx, device)
    res = dict(reads=N_GREEDY, lanes=2 * N_GREEDY, batch=GREEDY_BATCH, **cli,
               cli_reads_per_s=N_GREEDY / cli["cli_query_s"],
               cli_seeds_per_s=len(lines) / cli["cli_query_s"],
               cli_markers_per_s=n_markers / cli["cli_query_s"],
               seeds=len(lines), markers=n_markers,
               seeds_with_markers=sum(not ln.endswith(" .\n") for ln in lines),
               cpu_reads=N_GREEDY_CPU, cpu_lines=n_first, cpu_query_s=cpu["cli_query_s"],
               cpu_stages=cpu["cli_stages"], oracle_reads=N_ORACLE, oracle_lines=len(want),
               oracle_s=oracle_s, k1_launches=k1, seed_launches=seeds,
               seeds_times=seeds_times(tx, seed_batches(device, idx, tx, paths), lat),
               card=card["nvidia_smi"])
    emit("greedy", **res)
    res["out_text"] = out_text
    return res


def seed_batches(device, idx, tx, paths: dict,
                 modes=("greedy", "lmem", "sample")) -> dict:
    """{mode: (qcodes, lengths, cfg)} of one batch a machine of `modes` as
    the CLIs build it on the card: rbt_markers -f's first batch (both
    strands of GREEDY_BATCH reads, the ftab start), the --lmem run's (every
    prefix of both strands of its N_LMEM reads, lmem_expand) and rbt_locs'
    (GREEDY_BATCH reads, min_length 19)."""
    import torch

    from rowbowt_tpu_torch.alphabet import normalize_read, revcomp
    from rowbowt_tpu_torch.cli.common import iter_query_batches, pow2_at_least
    from rowbowt_tpu_torch.engine.batch import encode_batch
    from rowbowt_tpu_torch.engine.seeds import lmem_expand
    from rowbowt_tpu_torch.io.fastq import read_seqs

    def on_card(qc, lens):
        return torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)

    out = {}
    if "greedy" in modes:
        _, qc, lens = next(iter(iter_query_batches(idx, paths["greedy.fq"], GREEDY_BATCH,
                                                   normalize=True, with_rc=True)))
        out["greedy"] = on_card(qc, lens)
    if "lmem" in modes:
        seqs = [s for _, r, _ in read_seqs(paths["lmem.fq"])
                for s in (normalize_read(r), revcomp(normalize_read(r)))]
        lanes = lmem_expand([s.tobytes() for s in seqs])[0]
        out["lmem"] = on_card(*encode_batch(idx, lanes,
                                            pad_to=pow2_at_least(max(map(len, lanes)))))
    if "sample" in modes:
        _, qc, lens = next(iter(iter_query_batches(idx, paths["greedy.fq"], GREEDY_BATCH)))
        out["sample"] = on_card(qc, lens)
    return {mode: (q, ln, seed_cfg(tx, mode, q.shape[1])) for mode, (q, ln) in out.items()}


HEURISTIC = ["--heuristic", "--best-strand-only", "-y", "19", "--clear-conflicting",
             "--clear-identical"]


def heuristic_run(argv: list[str], out_path: str):
    """rbt_markers `argv` (with --heuristic) and the reads of each compacted
    second-strand batch it seeded: (run_seeding_cli's result, [reads])."""
    from rowbowt_tpu_torch.cli import rbt_markers

    second = []
    real_rc_lanes = rbt_markers.rc_lanes

    def counted(idx, qc, lens):
        second.append(qc.shape[0])
        return real_rc_lanes(idx, qc, lens)

    rbt_markers.rc_lanes = counted
    try:
        return run_seeding_cli("rbt_markers", argv, out_path), second
    finally:
        rbt_markers.rc_lanes = real_rc_lanes


def phase_heuristic(device, card: dict, chr_: dict) -> dict:
    """rbt_markers --heuristic --best-strand-only with the strand skip and
    with RBT_NO_STRAND_SKIP=1 on the greedy reads: the same lines."""
    from rowbowt_tpu_torch.ops import cuda_lf

    paths = chr_["paths"]
    argv = [paths["idx"], paths["greedy.fq"], *HEURISTIC, "-b", str(GREEDY_BATCH),
            "--device", str(device)]
    reset_counts()
    (cli, skip_text, _), second = heuristic_run(argv, paths["out.txt"])
    k1, seeds = cuda_lf.LAUNCHES, seed_counts()
    # one launch for each batch's forward strand, one for its compacted
    # second-strand batch
    check(seeds == seed_launches(greedy=-(-N_GREEDY // GREEDY_BATCH) + len(second)),
          f"--heuristic: {seeds} for {len(second)} second-strand batches")
    both, both_text, _ = run_seeding_cli("rbt_markers", argv, paths["out.txt"],
                                         env={"RBT_NO_STRAND_SKIP": "1"})
    check(skip_text == both_text, "--heuristic: the strand skip changed the lines")
    lines = skip_text.splitlines(keepends=True)
    check(bool(lines) and all(" + " in ln or " - " in ln for ln in lines),
          "--heuristic printed no seed lines")
    res = dict(reads=N_GREEDY, batch=GREEDY_BATCH, **cli,
               cli_reads_per_s=N_GREEDY / cli["cli_query_s"],
               seeds=len(lines), markers=marker_count(lines),
               second_strand_reads=sum(second), second_strand_batches=second,
               skipped_second_strand_share=1 - sum(second) / N_GREEDY,
               no_skip_query_s=both["cli_query_s"],
               no_skip_reads_per_s=N_GREEDY / both["cli_query_s"],
               no_skip_stages=both["cli_stages"], k1_launches=k1, seed_launches=seeds,
               card=card["nvidia_smi"])
    emit("heuristic", **res)
    res["out_text"] = skip_text
    return res


def phase_lmem(device, card: dict, chr_: dict) -> dict:
    """rbt_markers --lmem on the first N_LMEM reads; the first N_LMEM_ORACLE
    reads' lines against the oracle."""
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    reset_counts()
    cli, out_text, _ = run_seeding_cli(
        "rbt_markers", [paths["idx"], paths["lmem.fq"], "--lmem", "-b", str(N_LMEM),
                        "--device", str(device)], paths["out.txt"])
    k1, seeds = cuda_lf.LAUNCHES, seed_counts()
    check(seeds == seed_launches(lmem=1), f"--lmem: {seeds}, not one lmem launch a batch")
    lines = out_text.splitlines(keepends=True)
    nums = np.array([read_no(ln) for ln in lines])
    check(len(lines) > N_LMEM and np.all(np.diff(nums) >= 0), "--lmem lines out of read order")
    t = time.perf_counter()
    want = oracle_seed_lines(idx, chr_["reads"][:N_LMEM_ORACLE], lmem=True)
    oracle_s = time.perf_counter() - t
    check(lines[:int((nums < N_LMEM_ORACLE).sum())] == want,
          f"--lmem != the scalar oracle on the first {N_LMEM_ORACLE} reads")
    res = dict(reads=N_LMEM, lanes=2 * N_LMEM * READ_LEN, **cli,
               cli_reads_per_s=N_LMEM / cli["cli_query_s"], seeds=len(lines),
               markers=marker_count(lines), oracle_reads=N_LMEM_ORACLE,
               oracle_lines=len(want), oracle_s=oracle_s, k1_launches=k1, seed_launches=seeds,
               card=card["nvidia_smi"])
    emit("lmem", **res)
    res["out_text"] = out_text
    return res


def phase_locs(device, card: dict, chr_: dict) -> dict:
    """rbt_locs on the greedy reads; the first N_ORACLE lines against the
    oracle: greedy seeds with samples (min length 19), locate from the
    longest (4 hits), the markers at text positions [l, l+99]."""
    from rowbowt_tpu_torch.engine import naive
    from rowbowt_tpu_torch.index import marker_allele, marker_pos, marker_seq
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths, pm = chr_["idx"], chr_["paths"], chr_["pm"]
    reset_counts()
    cli, out_text, _ = run_seeding_cli(
        "rbt_locs", [paths["idx"], paths["greedy.fq"], "-b", str(GREEDY_BATCH),
                     "--device", str(device)], paths["out.txt"])
    k1, seeds = cuda_lf.LAUNCHES, seed_counts()
    check(seeds == seed_launches(sample=-(-N_GREEDY // GREEDY_BATCH)),
          f"rbt_locs: {seeds}, not one sampled-machine launch a batch")
    lines = out_text.splitlines(keepends=True)
    check(len(lines) == N_GREEDY and all(read_no(ln) == i for i, ln in enumerate(lines)),
          f"rbt_locs printed {len(lines)} lines, not one per read in order")
    t = time.perf_counter()
    want = []
    for i, r in enumerate(chr_["reads"][:N_ORACLE]):
        lfs = naive.get_seeds_greedy_w_sample(idx, idx.alpha.encode(r).astype(np.int64), 19)
        parts = [f"r{i}"]
        for loc in naive.locate_from_longest_seed(idx, 4, lfs):
            v = pm.at_range(loc, loc + READ_LEN - 1)
            parts += [f" {a}/{b}/{c}" for a, b, c in zip(
                marker_seq(v).tolist(), marker_pos(v).tolist(), marker_allele(v).tolist())]
        want.append("".join(parts) + "\n")
    oracle_s = time.perf_counter() - t
    check(lines[:N_ORACLE] == want, f"rbt_locs != the scalar oracle on the first {N_ORACLE} reads")
    res = dict(reads=N_GREEDY, batch=GREEDY_BATCH, **cli,
               cli_reads_per_s=N_GREEDY / cli["cli_query_s"],
               reads_with_markers=sum(len(ln.split()) > 1 for ln in lines),
               markers=sum(len(ln.split()) - 1 for ln in lines), oracle_reads=N_ORACLE,
               oracle_s=oracle_s, k1_launches=k1, seed_launches=seeds, card=card["nvidia_smi"])
    emit("locs", **res)
    res["out_text"] = out_text
    return res


# ---------------- the seeding machines (csrc/seeds.cu) ----------------

SEED_RANDOM_LANES = 4_096  # random-code lanes beside the parity batch: replays that meet an empty step
SEED_STEP_OPS = 16  # int32 operations of a machine step beside its ranks: tests, selects, slots


def seed_counts() -> dict:
    """The seeding machines' kernel launches since the last reset, by route
    (cuda_seeds.LAUNCHES_SEED: the machine over fused rows, with its step
    record or per-step toehold, or over the tables of a rank policy)."""
    from rowbowt_tpu_torch.ops import cuda_seeds

    return dict(cuda_seeds.LAUNCHES_SEED)


def seed_launches(**kw) -> dict:
    """seed_counts()'s dict with the given counts and every other 0."""
    return dict(dict.fromkeys(seed_counts(), 0), **kw)


def seed_cfg(tx, mode: str, L: int, small: bool = False, ftab: bool = True) -> dict:
    """The parameters of machine `mode` as its engine derives them for codes
    of width L (rbt_markers' window of MA_WSIZE, 8 seeds, the records its
    engine allots, max_range 2^62 clamped to the lane type; rbt_locs'
    min_length 19, with the step record on two-level rows; the ftab start
    where the index has one and L reaches its k), or with `small`
    capacities that overflow: 2 seeds, 3 (greedy) or 2 (lmem) records,
    max_range 20, sample's min_length 0.  The sampled machine carries the
    per-step toehold where cuda_seeds.carries_toehold says so."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    mr = min(20 if small else 1 << 62, torch.iinfo(tx.idx_dtype).max)
    k = tx.ftab_k if ftab and tx.has_ftab and L >= tx.ftab_k > 0 else 0
    if mode == "greedy":
        return dict(k=k, wsize=MA_WSIZE, max_range=mr, S=2 if small else 8,
                    W=3 if small else 2 * (L // MA_WSIZE) + 4)
    if mode == "lmem":
        return dict(k=k, wsize=MA_WSIZE, max_range=mr, S=1, W=2 if small else L // MA_WSIZE + 2)
    return dict(min_length=0 if small else 19, S=2 if small else 8,
                record=cuda_lf.row_layout(tx) in R.FB2_KEYS)


def seed_route(tx, mode: str, cfg: dict) -> str:
    """The cuda_seeds.LAUNCHES_SEED key of machine `mode` with cfg on tx."""
    from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds

    name = ("sample_rec" if cfg.get("record")
            else "sample_toe" if cuda_seeds.carries_toehold(tx, mode) else mode)
    policy = cuda_lf.table_policy(tx) if cuda_lf.row_layout(tx) is None else None
    return f"{name}_{policy}" if policy else name


def seed_records(tx, mode: str, q, ln, cfg: dict, plain: bool) -> dict:
    """Machine `mode`'s record tables over (q, ln) with cfg: the kernel's
    (cuda_seeds.launch_machine, one launch) or its plain twin's (the
    engine's *_records_plain torch loop)."""
    from rowbowt_tpu_torch.engine import seeds as S
    from rowbowt_tpu_torch.ops import cuda_seeds

    if not plain:
        return cuda_seeds.launch_machine(tx, mode, q, ln, **cfg)
    if mode == "greedy":
        return S.markers_greedy_records_plain(tx, q, ln, cfg["wsize"], cfg["max_range"],
                                              cfg["S"], cfg["k"], cfg["W"])
    if mode == "lmem":
        return S.markers_lmem_records_plain(tx, q, ln, cfg["wsize"], cfg["max_range"], cfg["k"],
                                            cfg["W"])
    return S.seeds_sample_records_plain(
        tx, q, ln, cfg["min_length"], cfg["S"],
        "trajectory" if cfg["record"]
        else "per_step" if cuda_seeds.carries_toehold(tx, mode) else "kval")


def records_err(got: dict, want: dict) -> int:
    """max |err| over every record table (the same tables, or a failed check)."""
    check(sorted(got) == sorted(want), f"record tables {sorted(got)} != {sorted(want)}")
    return max_abs_err([got[k] for k in want], [want[k] for k in want])


def seeds_parity(device, idx, codes, q, ln, edges, raw: dict) -> dict:
    """The seeding kernel (cuda_seeds.launch_machine) against its plain twins
    (the engines' *_records_plain torch loops, run on the card), every record
    table equal, one launch a call on its route:
      - over the small panel's fblock64 rows (int32 lanes) and its BigIndex
        view's fb2_64 bit planes (int64 lanes; the sampled machine with its
        step record there), the dense index's ftab attached to both: greedy and
        lmem with the ftab start and without, each at its engine's
        capacities and at capacities that overflow (seed_cfg small), on the
        parity batch and SEED_RANDOM_LANES random-code lanes; each machine
        at its engine's capacities at the edges of k1_edges over both (the
        unstaged L = 3,072 for the sampled machine only); greedy and the
        sampled machine over the fb2 and fb2_256 bit planes at the engines'
        capacities on the batch and the random lanes;
      - the sampled machine's per-step toehold over the raw tables' fused
        rows ({route: raw_tables}: tk1 and ltk), at both capacities on the
        batch and the random lanes, and at the k1_edges edges over tk1;
      - over each rank policy's tables (table_indexes: runs, dense, occ1, the
        dense index's ftab kept): greedy as over the rows, lmem so with the
        ftab start (and without it over the run-space tables), the sampled
        machine with its per-step toehold at both capacities and with kval
        (the index's own attached) at the engine's; the k1_edges edges
        (unstaged included) for every machine over the run-space tables,
        there with the run records and without, and over a directory of one
        bucket (run_variants).
    Returns {"errs": {kernel: max |err|}, "launches", "stats"}."""
    import dataclasses

    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    rng = np.random.default_rng(SMALL["seed"] + 7)
    rq, rl = random_lanes(rng, SEED_RANDOM_LANES, q.shape[1], idx.A)
    cases = [("batch", q, ln),
             ("random", torch.from_numpy(rq).to(device), torch.from_numpy(rl).to(device))]
    dense = TorchIndex.from_index(idx, device)
    big = TorchIndex.from_big(BigIndex.from_codes(codes, idx.alpha, n_sup=4), device)
    big = dataclasses.replace(big, arrays=dict(big.arrays, ftab=dense.arrays["ftab"]),
                              ftab_k=dense.ftab_k)
    errs, stats = {}, {}
    calls = dict.fromkeys(seed_counts(), 0)
    reset_counts()

    def held(tx, layout, mode, todo, views=None):
        # views: [(tag, view)] held to one plain twin (run_variants)
        for label, qe, le, small, ftab in todo:
            cfg = seed_cfg(tx, mode, qe.shape[1], small, ftab)
            route = seed_route(tx, mode, cfg)
            want = seed_records(tx, mode, qe, le, cfg, plain=True)
            tag = f"{layout},{route},{label},{'small' if small else 'engine'}," \
                  f"{'ftab' if cfg.get('k') else 'full'}"
            for vtag, view in views or [("", tx)]:
                got = seed_records(view, mode, qe, le, cfg, plain=False)
                torch.cuda.synchronize()
                e = records_err(got, want)
                check(e == 0, f"the seeding kernel != its plain twin at {tag} {vtag}: "
                      f"max |err| {e}")
                errs[f"seeds_{route}"] = max(errs.get(f"seeds_{route}", 0), e)
                calls[route] += qe.shape[0] > 0
            if label in ("batch", "random"):
                st = {}
                if "ns" in want:
                    st.update(seeds=int(want["ns"].sum()),
                              lanes_past_S=int((want["ns"] > cfg["S"]).sum()))
                if "nrec" in want:
                    st.update(records=int(want["nrec"].sum()),
                              lanes_past_W=int((want["nrec"] > cfg["W"]).sum()))
                if "ssamp" in want:
                    st.update(no_sample=int((want["ssamp"] < 0).sum()))
                stats[tag] = st

    def plan(mode, edge_labels, kval_only=False, ftab_only=False):
        todo = [(label, qe, le, small, ftab) for label, qe, le in cases
                for small in (False, True) for ftab in (True, False)
                if (mode not in ("sample", "lmem" if ftab_only else "") or ftab)
                and not (kval_only and small)]
        return todo + [(label, qe, le, False, True) for label, qe, le in edges
                       if label in edge_labels]

    every = {label for label, _, _ in edges}
    staged = every - {"L=3072 unstaged"}
    for layout, tx in (("fblock64", dense), ("fb2_64", big)):
        check(cuda_lf.row_layout(tx) == layout, f"seeds parity over {cuda_lf.row_layout(tx)}")
        for mode in ("greedy", "lmem", "sample"):
            held(tx, layout, mode, plan(mode, every if mode == "sample" else staged))
    # the two-level machines over the 96 B and 128 B plane rows, at the
    # engines' capacities on the batch and the random lanes
    for block, layout in ((128, "fb2"), (256, "fb2_256")):
        tx = TorchIndex.from_big(BigIndex.from_codes(codes, idx.alpha, n_sup=4, block=block),
                                 device, fb64=False)
        tx = dataclasses.replace(tx, arrays=dict(tx.arrays, ftab=dense.arrays["ftab"]),
                                 ftab_k=dense.ftab_k)
        check(cuda_lf.row_layout(tx) == layout, f"seeds parity over {cuda_lf.row_layout(tx)}")
        for mode in ("greedy", "sample"):
            held(tx, layout, mode, [(label, qe, le, False, True) for label, qe, le in cases])
        del tx
    # the per-step toehold over fused rows (no kval): tk1 and ltk
    for route in ("tk1", "ltk"):
        tx = TorchIndex.from_index(raw[route], device)
        check(cuda_lf.row_layout(tx) == "fblock64" and cuda_lf.toehold_route(tx) == route,
              f"the raw tables over {cuda_lf.row_layout(tx)}, {cuda_lf.toehold_route(tx)}")
        held(tx, f"fblock64,{route}", "sample", plan("sample", every if route == "tk1" else ()),
             resolve_variants(tx) if route == "ltk" else None)
        del tx
    # each rank policy's tables, with and without kval
    for policy, tab in table_indexes(idx, codes, raw["tk1"]).items():
        tx = TorchIndex.from_index(tab, device)
        check(cuda_lf.table_policy(tx) == policy and tx.has_ftab and "kval" not in tx.arrays,
              f"the {policy} tables: policy {cuda_lf.table_policy(tx)}")
        runs = policy == "runs"
        views = run_variants(tx) if runs else None
        for mode in ("greedy", "lmem", "sample"):
            # the per-step toehold over ltk through each of resolve_variants
            v = (resolve_variants(tx) if mode == "sample" and not runs
                 and cuda_lf.toehold_route(tx) == "ltk" else views)
            held(tx, policy, mode, plan(mode, every if runs else (), ftab_only=not runs), v)
        kv = TorchIndex.from_index(dataclasses.replace(tab, kval=idx.kval), device)
        held(kv, f"{policy},kval", "sample", plan("sample", (), kval_only=True))
        del tx, kv
    launches = seed_counts()
    check(launches == calls, f"seeds parity launches {launches} for {calls}")
    # the reads overflow the small record capacities, the random lanes the
    # small seed capacity; some per-step seeds precede any good step
    for layout in ("fblock64", "fb2_64", "runs", "dense", "occ1"):
        for mode in ("greedy", "lmem"):
            route = f"{mode}_{layout}" if layout in ("runs", "dense", "occ1") else mode
            reads = stats[f"{layout},{route},batch,small,ftab"]
            check(reads["lanes_past_W"] > 0, f"seeds parity: no record overflow at {layout},"
                  f"{mode}: {reads}")
        route = f"greedy_{layout}" if layout in ("runs", "dense", "occ1") else "greedy"
        rand = stats[f"{layout},{route},random,small,ftab"]
        check(rand["lanes_past_S"] > 0, f"seeds parity: no seed overflow at {layout}: {rand}")
    no_sample = sum(v.get("no_sample", 0) for v in stats.values())
    check(no_sample > 0, "seeds parity: no per-step seed without a toehold (-1)")
    return dict(errs=errs, launches=launches, stats=stats, s=time.perf_counter() - t0)


def seed_work(tx, mode: str, q, ln, cfg: dict) -> dict:
    """What one batch asks of machine `mode`, by a replay of its plain twin
    with its LF step counted (ops/rank.lf_step_auto, and the per-step
    toehold's lf_step_w_loc and lf_step_w_loc_occ1, wrapped for the call):
    the codes of the reads; the LF steps the kernel takes (a lane's active
    steps: to its length, for lmem to its failure, less greedy's replay
    steps that hold the full range, which load nothing); ranked steps (a
    code in [0, A)); the longest lane's ranked steps; distinct ftab entries
    read; the bytes of the record tables it writes; for greedy from the ftab
    its restarts: replayed (k codes or more left) and to the full range
    (fewer).  Over fused rows: row loads (one or two a ranked step, none for
    a position n) and distinct rows; over the tables (tables_entries): the
    distinct table entries the ranks need (and BWT[hi]'s for the per-step
    toehold) and their bytes.
    For the per-step toehold also the seeds that resolve a toehold and the
    distinct toeholds they resolve (as many table entries, at most)."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds
    from rowbowt_tpu_torch.ops import rank as R

    B, L = q.shape
    n, dt, A = tx.n, tx.idx_dtype, tx.A
    dev = q.device
    key = cuda_lf.row_layout(tx)
    policy = cuda_lf.table_policy(tx) if key is None else None
    steps = []
    names = ("lf_step_auto", "lf_step_w_loc", "lf_step_w_loc_occ1")
    real = {name: getattr(R, name) for name in names}
    step = real["lf_step_auto"](tx)

    def counted(tx_, lo, hi, c):
        nlo, nhi = step(tx_, lo, hi, c)
        steps.append((lo, hi, c, nlo <= nhi))
        return nlo, nhi

    def counted_loc(fn):
        def run(tx_, lo, hi, c, k):
            nlo, nhi, nk = fn(tx_, lo, hi, c, k)
            steps.append((lo, hi, c, nlo <= nhi))
            return nlo, nhi, nk
        return run

    R.lf_step_auto = lambda tx_: counted
    R.lf_step_w_loc = counted_loc(real["lf_step_w_loc"])
    R.lf_step_w_loc_occ1 = counted_loc(real["lf_step_w_loc_occ1"])
    try:
        rec = seed_records(tx, mode, q, ln, cfg, plain=True)
    finally:
        for name, fn in real.items():
            setattr(R, name, fn)
    m = ln.to(dt)
    k = cfg.get("k", 0)
    toe = cuda_seeds.carries_toehold(tx, mode)
    i0 = torch.zeros(B, dtype=dt, device=dev)
    ftab_entries = 0
    if k:
        kc = R.kmer_codes(tx, q[:, L - k:])
        hit = R.ftab_lookup(tx, kc)[2] & (m >= k)
        read = (kc >= 0) & (m >= k)
        ftab_entries = int(torch.unique(kc[read]).numel())
        i0 = torch.where(hit if mode == "greedy" else m >= k, k, 0).to(dt)
    rp = torch.zeros(B, dtype=dt, device=dev)
    rpmiss = torch.zeros(B, dtype=torch.bool, device=dev)
    restarts = dict.fromkeys(("replay", "to_full"), 0)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lane_ranked = torch.zeros(B, dtype=torch.int64, device=dev)
    lf_steps = ranked = two = 0
    rows, ranks = [], []
    shift = cuda_lf._SYMS_PER_ROW[key].bit_length() - 1 if key else 0
    for t, (lo, hi, c, ne) in enumerate(steps):
        if mode == "sample":
            load = t < m
        else:
            active = (t < m - i0) & ~done
            load = active
            if mode == "greedy" and k:
                normal = active & (rp == 0)
                hit = normal & ~ne & (m - i0 - t - 1 >= k)
                rstep = active & (rp > 0)
                load = active & (normal | ~rpmiss)
                held = rpmiss | (rstep & ~ne)
                rpmiss = torch.where(hit, False, held)
                rp = torch.where(hit, k, torch.where(rstep, rp - 1, rp))
                restarts["replay"] += int(hit.sum())
                restarts["to_full"] += int((normal & ~ne & ~hit).sum())
            if mode == "lmem":
                done = done | (active & ~ne)
        rk = load & (c >= 0) & (c < A)
        lf_steps += int(load.sum())
        ranked += int(rk.sum())
        lane_ranked += rk
        if key:
            has0 = rk & (lo < n)
            has1 = rk & (hi + 1 < n)
            differ = has1 & (~has0 | (((hi + 1) >> shift) != (lo >> shift)))
            two += int(differ.sum())
            rows += [(lo >> shift)[has0], ((hi + 1) >> shift)[differ]]
        else:
            ranks.append((c.long()[rk], lo.long()[rk], (hi + 1).long()[rk],
                          hi.long()[rk] if toe else None))
    out = dict(codes=int(m.clamp(max=L).sum()), lf_steps=lf_steps, ranked_steps=ranked,
               ftab_entries=ftab_entries, longest_lane_ranked_steps=int(lane_ranked.max()),
               out_bytes=sum(t.numel() * t.element_size() for t in rec.values()))
    if mode == "greedy" and k:
        out["restarts"] = restarts
    if key:
        out.update(row_loads=int(sum(r.numel() for r in rows)), two_row_steps=two,
                   distinct_rows=int(torch.unique(torch.cat(rows)).numel()) if rows else 0)
    else:
        out.update(policy=policy, **tables_entries(tx, policy, ranks))
    if toe:
        written = torch.arange(cfg["S"], device=dev)[:, None] < rec["ns"][None, :].clamp(
            max=cfg["S"])
        s = rec["ssamp"][written]
        out.update(resolves=int((s >= 0).sum()), resolve_entries=int(torch.unique(s[s >= 0])
                                                                      .numel()))
    return out


def tables_entries(tx, policy: str, ranks: list) -> dict:
    """The distinct table entries of the ranks [(c, lo, hi + 1, hi or None)]
    over the `policy` tables and their bytes: run_start and run_head at each
    position's run and occ_flat at (c, run) (runs); occ_blk_flat at (c,
    block) and the 64 B blocks of bwt4 (dense); occ1 at (c, position)
    (occ1).  Positions at n read nothing but F (runs, dense).  For the
    run-space policy also `search_ops`, the operations of the directory
    searches of lo and hi + 1 (4 a halving of the position's bucket, as many
    as its starts need, and 4 for the bucket and the rank)."""
    import torch

    from rowbowt_tpu_torch.ops import rank as R

    n, arr = tx.n, tx.arrays
    occ, rows = [], []
    search_ops = 0
    for c, *pos in ranks:
        for j, i in enumerate(pos):
            if i is None:
                continue
            use = i < n if policy != "occ1" else torch.ones_like(i, dtype=torch.bool)
            if policy == "runs":
                r = R.run_of(tx, i[use].to(tx.idx_dtype)).long()
                rows.append(r)
                occ.append(c[use] * tx.R + r)
                if j < 2:  # lo and hi + 1: BWT[hi] comes with hi + 1's run
                    off = arr["rs_off"].long()
                    b = ((i[use] + 1) >> tx.rs_bs[0]).clamp(max=off.numel() - 2)
                    seg = (off[b + 1] - off[b]).double()
                    search_ops += int((4 * torch.ceil(torch.log2(seg + 1)) + 4).sum())
            elif policy == "dense":
                rows.append(i[use] >> 7)
                occ.append(c[use] * (arr["bwt4"].numel() // 16) + (i[use] >> 7))
            else:
                occ.append(c * (n + 1) + i)
    occ_tab = arr[{"runs": "occ_flat", "dense": "occ_blk_flat", "occ1": "occ1_flat"}[policy]]
    distinct_occ = int(torch.unique(torch.cat(occ)).numel()) if occ else 0
    distinct_rows = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    row_bytes = (arr["run_start"].element_size() + arr["run_head"].element_size()
                 if policy == "runs" else 64)
    return dict(distinct_occ=distinct_occ, distinct_rows=distinct_rows,
                table_bytes=distinct_occ * occ_tab.element_size() + distinct_rows * row_bytes,
                search_ops=search_ops)


def seed_bound(work: dict, B: int, tx, lat) -> dict:
    """The bound of one seeding launch from its work: bytes (each input byte
    read once: the reads' int32 codes, the lengths, F, the distinct rows or
    table entries, the distinct ftab entries, the two-level rows' base
    table, the per-step toehold's resolved entries; each output written
    once: the record tables) over the card's memory rate; operations (two
    ranks a ranked step: a SWAR rank over a row, RANK_OPS, or the tables
    policy's as tables_bound counts them, three with BWT[hi]'s for the
    per-step toehold; SEED_STEP_OPS a step; a resolve, resolve_ops over
    ltk) over its int32 rate; with `lat` (phase k1's latencies, or the
    float µs of a dependent load over a random cycle of the chr table's
    size) the longest lane's ranked steps times a step's latency (a random
    cycle over rows, tables_step_us over the tables), plus one resolve for
    the toehold (resolve_us over ltk).  Over the run-space tables and for
    the resolve over ltk also the same with the searches over all R run
    starts that the directories replaced (the *_old keys).  bound_ms is the
    larger of the byte and operation times; bound_us the larger of the byte
    and latency times."""
    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    key = cuda_lf.row_layout(tx)
    lane = tx.arrays["F"].element_size()
    base = tx.arrays["fb2_base"].numel() * 8 if key in R.FB2_KEYS else 0
    toe = "resolves" in work
    ltk = toe and cuda_lf.toehold_route(tx) == "ltk"
    resolve_bytes = 0
    if toe:
        # a distinct toehold: its table entry and, over ltk, its run's start
        # and its bucket's bounds in rs_off
        tab = tx.arrays["ltk" if ltk else "tk1_flat"]
        resolve_bytes = work["resolve_entries"] * (tab.element_size() + (
            tx.arrays["run_start"].element_size() + 2 * tx.arrays["rs_off"].element_size()
            if ltk else 0))
    if key:
        table_bytes = work["distinct_rows"] * cuda_lf.rows_of(tx, key).shape[1] * 4
        per_rank = RANK_OPS
    else:
        table_bytes = work["table_bytes"]
        per_rank = {"runs": 0, "dense": RANK_OPS, "occ1": 1}[work["policy"]]
    nbytes = (work["codes"] * 4 + B * 4 + (tx.A + 1) * lane + table_bytes
              + work["ftab_entries"] * 8 + base + resolve_bytes + work["out_bytes"])
    ops = ((2 if key or not toe else 3) * per_rank * work["ranked_steps"]
           + work.get("search_ops", 0) + SEED_STEP_OPS * work["lf_steps"])
    if toe:
        ops += (TOE_STEP_OPS * work["ranked_steps"] if key else 0) + work["resolves"] * (
            resolve_ops(tx) if ltk else 1)
    byte_us = nbytes / HBM_BYTES_PER_S * 1e6
    ops_us = ops / INT_OPS_PER_S * 1e6
    b = dict(bytes=nbytes, byte_bound_us=byte_us, ops=ops, ops_bound_us=ops_us,
             bound_ms=max(byte_us, ops_us) / 1e3,
             bound_by="bytes" if byte_us >= ops_us else "operations")
    if not key:
        b.update(step_tables=step_tables(tx, work["policy"]), l2_bytes=l2_bytes())
    if ltk:
        b.update(resolve_loads=2 + tx.rs_bs[1], resolve_loads_old=search_levels(tx.R) + 1,
                 rs_bs=list(tx.rs_bs))
    if lat is not None:
        cycle = lat if isinstance(lat, float) else lat["random_cycle"]
        ltk_lat = ltk and not isinstance(lat, float)
        for tag, old in (("", False), ("_old", True)):
            if old and (key or work["policy"] != "runs") and not ltk_lat:
                break
            resolve = resolve_us(tx.R, lat, old) if ltk_lat else cycle if toe else 0.0
            step_us = cycle if key else tables_step_us(tx, work["policy"], lat, old)
            latency = work["longest_lane_ranked_steps"] * step_us + resolve
            b.update({f"step_us{tag}": step_us, f"latency_bound_us{tag}": latency,
                      f"bound_us{tag}": max(byte_us, latency),
                      f"bound_us_by{tag}": "bytes" if byte_us >= latency else "latency"})
    return b


SEED_KERNELS = ("seed_machine_kernel", "seed_tables_kernel")


def seeds_times(tx, runs: dict, lat) -> dict:
    """Each machine of `runs` ({name: (q, ln, cfg)}, one batch each; the
    name's first word is the mode) on tx: equal to its plain twin (max |err|
    0); the call ms in turns with the twin (plain, kernel, kernel, plain);
    the launch alone (CUDA events just around it) and in one profiler
    trace; the work (seed_work), the bound (seed_bound) and its share."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    kname = SEED_KERNELS[cuda_lf.row_layout(tx) is None]
    out = {}
    for name, (q, ln, cfg) in runs.items():
        mode = name.split("_")[0]

        def kern(mode=mode, q=q, ln=ln, cfg=cfg):
            return seed_records(tx, mode, q, ln, cfg, plain=False)

        def plain(mode=mode, q=q, ln=ln, cfg=cfg):
            return seed_records(tx, mode, q, ln, cfg, plain=True)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        e = records_err(got, want)
        check(e == 0, f"the {name} machine != its plain twin on the timed batch: max |err| {e}")
        B, L = q.shape
        r = dict(lanes=B, L=L, cfg=cfg, route=seed_route(tx, mode, cfg), max_abs_err=e)
        r["call_ms"], r["plain_ms"] = in_turns([plain], [kern], 1, 10)
        r["device_us"] = kernel_event_us([around(kern)], 10)
        r["profiled_us"] = profiled_kernel_us([kern], 3, (kname,))[kname]
        r["work"] = seed_work(tx, mode, q, ln, cfg)
        if "restarts" in r["work"]:
            r["restarts"] = r["work"]["restarts"]
        b = seed_bound(r["work"], B, tx, lat)
        r.update(bound=b, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                 share=b["bound_us"] / r["device_us"] if "bound_us" in b else None,
                 share_old=b["bound_us_old"] / r["device_us"] if "bound_us_old" in b else None)
        out[name] = r
    return out


def phase_greedy_trace(device, card: dict, chr_: dict, greedy: dict) -> dict:
    """rbt_markers -f --profile on the greedy reads, after every timed phase:
    the same lines, the card's busy seconds against the CLI's query seconds,
    kernel launches per batch, and the largest device items."""
    paths = chr_["paths"]
    trace_dir = os.path.join(WORK, "greedy_trace")
    cli, out_text, err = run_seeding_cli(
        "rbt_markers", [paths["idx"], paths["greedy.fq"], "-f", "-b", str(GREEDY_BATCH),
                        "--device", str(device), "--profile", trace_dir], paths["out.txt"])
    check(out_text == greedy["out_text"], "rbt_markers --profile output != the greedy run's")
    check(f"profiler trace written to {trace_dir}" in err.splitlines(),
          "rbt_markers --profile did not report its trace")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    check(len(traces) == 1, f"expected one trace in {trace_dir}, found {traces}")
    path = os.path.join(trace_dir, traces[0])
    events = device_events(path)
    kernels = device_events(path, ("kernel",))
    check(bool(kernels), "the greedy trace holds no kernel")
    by_name: dict = {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur
    busy_s = busy_us(events) / 1e6
    n_batches = -(-N_GREEDY // GREEDY_BATCH)
    # 37,404 a batch while the greedy machine was a torch loop
    check(len(kernels) / n_batches < 3_740,
          f"rbt_markers -f launched {len(kernels) / n_batches} kernels a batch")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    res = dict(reads=N_GREEDY, batches=n_batches, **cli, trace_mb=os.path.getsize(path) / 1e6,
               device_events=len(events), kernel_launches=len(kernels),
               kernel_launches_per_batch=len(kernels) / n_batches,
               kernel_s=sum(d for _, _, d in kernels) / 1e6,
               device_busy_s=busy_s, busy_share_of_query=busy_s / cli["cli_query_s"],
               busy_share_of_greedy_stage=busy_s / cli["cli_stages"]["greedy"],
               top_device_s={name[:80]: us / 1e6 for name, us in top},
               card=card["nvidia_smi"])
    emit("greedy_trace", **res)
    return res

def host_rank_fb2(big, i: np.ndarray, c: np.ndarray) -> np.ndarray:
    """rank(i, c), i in [0, n], over a BigIndex's 128-symbol rows and base on
    the host (numpy int64): base of i's superblock + the row's checkpoint +
    the count of c among the row's symbols below i's offset."""
    isafe = np.minimum(i, big.n - 1)
    blk = isafe >> 7
    rows = np.asarray(big.fb2[blk])  # [m, 24] int32
    m = np.arange(len(c))
    words = np.ascontiguousarray(rows[:, 8:]).view(np.uint32)
    sym = ((words[:, :, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15).reshape(len(c), 128)
    below = np.arange(128)[None, :] < (isafe & 127)[:, None]
    v = (big.base[blk // big.per_blk, c] + rows[m, c].astype(np.int64)
         + ((sym == c[:, None]) & below).sum(axis=1))
    return np.where(i >= big.n, big.F[c + 1] - big.F[c], v)


def host_ranges_fb2(big, qc: np.ndarray, lens: np.ndarray):
    """Batched backward search on the host over the 128-symbol rows and base
    (never the 64-symbol repack): (lo, hi) int64 with the (1, 0) empty range."""
    B, L = qc.shape
    lo = np.zeros(B, np.int64)
    hi = np.full(B, big.n - 1, np.int64)
    done = np.zeros(B, bool)
    for j in range(L):
        c = qc[:, L - 1 - j].astype(np.int64)
        active = ~done & (j < lens)
        valid = (c >= 0) & (c < big.A)
        cs = np.where(valid, c, 0)
        cb = host_rank_fb2(big, lo, cs)
        ci = host_rank_fb2(big, hi + 1, cs) - cb
        empty = (ci <= 0) | ~valid
        nlo = np.where(empty, 1, big.F[cs] + cb)
        nhi = np.where(empty, 0, big.F[cs] + cb + ci - 1)
        lo = np.where(active, nlo, lo)
        hi = np.where(active, nhi, hi)
        done |= active & (nlo > nhi)
    return lo, hi


def random_lanes(rng, B: int, L: int, A: int):
    """(codes int32 [B, L] right-aligned with -1 pad, lengths) of B lanes of
    0-L random codes of A, a quarter of them 1-16 codes long and starting
    with the last code, so that their ranges lie near the top of the BWT."""
    lens = rng.integers(0, L + 1, size=B)
    short = rng.random(B) < 0.25
    lens[short] = rng.integers(1, 17, size=int(short.sum()))
    qc = np.where(np.arange(L)[None, :] >= L - lens[:, None],
                  rng.integers(0, A, size=(B, L)), -1).astype(np.int32)
    qc[np.flatnonzero(short), (L - lens)[short]] = A - 1
    return qc, lens.astype(np.int32)


def pfp_big_build(path: str) -> None:
    """Phase pfp_big's host build, in a child process of its own (started
    with the run, so that it overlaps the card's phases and its peak RSS is
    its own): the PFP_BIG panel through tools/build_giant_index.build into
    `path` (256-symbol rows), then the same PfpResult assembled with
    128-symbol rows into path + "_128" with its 64-symbol repack (fb2_64.npy)
    cached beside it; their seconds and the child's peak RSS in
    path + "_128/layout.json"."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.construct import pfp
    from rowbowt_tpu_torch.tools import build_giant_index

    _, res = build_giant_index.build(path, **PFP_BIG)
    alpha = BigIndex.load(path).alpha
    t = time.perf_counter()
    big = pfp.assemble_bigindex(res, alpha, block=128)
    del res
    assemble_s = time.perf_counter() - t
    big.save(path + "_128")
    big.prefix = path + "_128"
    t = time.perf_counter()
    big._fb2_64()
    repack_s = time.perf_counter() - t
    with open(os.path.join(path + "_128", "layout.json"), "w") as f:
        json.dump(dict(assemble_128_s=assemble_s, repack_64_s=repack_s,
                       child_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6),
                  f)


def start_pfp_big_build() -> dict:
    """pfp_big_build in a spawned child process (no CUDA, no torch state of
    this process); phase_pfp_big joins it."""
    path = os.path.join(WORK, "pfp_big")
    return dict(proc=spawn_child(pfp_big_build, path), path=path, started=time.perf_counter())


def spawn_child(target, *args):
    """target(*args) started in a spawned child process (a fresh
    interpreter: no CUDA or torch state of this process), named after it."""
    import multiprocessing

    proc = multiprocessing.get_context("spawn").Process(target=target, args=args,
                                                        name=target.__name__)
    proc.start()
    return proc


def stop_child(child: dict | None) -> None:
    """Ends a host build's child (start_pfp_big_build, start_raw_chr_build,
    start_small_builds) if it still runs (a phase failed)."""
    if child is None:
        return
    if child["proc"].is_alive():
        child["proc"].terminate()
    child["proc"].join()


def phase_pfp_big(device, card: dict, child: dict, k1: dict | None) -> dict:
    """A PFP-built panel above 2^31 (PFP_BIG: the giant panel's widths, 113
    documents, n = 2,203,501,131) through K1 and the port's CLIs.

    Waits for pfp_big_build's child, then K1 on the build tool's 65,536 reads of
    100 bp over fb2_256 (the saved directory), fb2_64 and fb2 (the second
    assembly) with int64 lanes, each against the plain loop, the three
    layouts' ranges equal, one launch a batch; the first N_PFP_CPU reads
    against cpu_backend.count_ranges_fb2g and the first 512 against the
    build tool's analytic counts; the first N_BIG_HOST against the host rank
    over the 96 B rows; at least one final lo at or above 2^31.  The same
    over 65,536 lanes of random codes (random_lanes: absent patterns, short
    lanes near the top, length-0 lanes).  K1's call and device times per layout, and its bound over
    fb2_256 when phase k1's dependent-step latency is given.

    Then rbt_align count (65,536 reads), -s (N_PFP_LOCATE) and -m (65,536),
    and rbt_markers -f (N_GREEDY), on the saved directory: count lines equal
    to K1's ranges and the analytic counts; -s every occurrence, as a set
    equal to doc x doc_len + offset on the analytic reads, the first four
    (toehold, then the phi chain) equal to cpu_backend.locate_fb2's on
    N_PFP_CPU reads; -m multisets equal to the analytic ones and to the host
    CSR over the range, the ranges to cpu_backend.markers_fb2's; rbt_markers
    -f seeds per read and strand equal to cpu_backend.greedy_fb2's (at most
    --max-seeds 8).  Each CLI's load and query seconds, reads/s and, for
    rbt_align, its stages one by one."""
    import torch

    from rowbowt_tpu_torch import cpu_backend
    from rowbowt_tpu_torch.alphabet import revcomp
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t = time.perf_counter()
    child["proc"].join()
    wait_s = time.perf_counter() - t
    check(child["proc"].exitcode == 0, f"pfp_big's build exited {child['proc'].exitcode}")
    path = child["path"]
    with open(os.path.join(path, "build_stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(path + "_128", "layout.json")) as f:
        layout = json.load(f)
    big, b128 = BigIndex.load(path), BigIndex.load(path + "_128")
    n, top = big.n, 1 << 31
    check(n == (PFP_BIG["n_haps"] + 1) * (PFP_BIG["ref_len"] + PFP_BIG["w"]) + 1 and n > top,
          f"pfp_big: n = {n}")
    check(b128.n == n and b128.fb2.shape[1] == 24 and big.fb2.shape[1] == 40
          and all(np.array_equal(getattr(big, x), getattr(b128, x))
                  for x in ("F", "run_start", "run_head", "samples_last", "pred_pos", "phi_at",
                            "cruns_keys")),
          "the two assemblies of one PfpResult differ outside their rank rows")
    qc16 = np.load(os.path.join(path, "qcodes.npy"))
    qlens = np.load(os.path.join(path, "qlens.npy"))
    e = {x: np.load(os.path.join(path, f"expect_{x}.npy"))
         for x in ("lo", "hi", "cnt", "pos_flat", "pos_off", "mval_flat", "mval_off")}
    n_par = e["cnt"].shape[0]
    lanes = {"reads": (qc16.astype(np.int32), qlens),
             "random": random_lanes(np.random.default_rng(PFP_BIG_LANE_SEED), BATCH, READ_LEN,
                                    big.A)}
    t = time.perf_counter()
    txs = {"fb2_256": TorchIndex.from_big(big, device, with_locate=False, with_markers=False),
           "fb2_64": TorchIndex.from_big(b128, device, with_locate=False, with_markers=False),
           "fb2": TorchIndex.from_big(b128, device, fb64=False, with_locate=False,
                                      with_markers=False)}
    torch.cuda.synchronize()
    res = dict(load_s=time.perf_counter() - t, wait_s=wait_s, build=stats, layout=layout,
               table_gb={k: cuda_lf.rows_of(tx, k).numel() * 4 / 1e9 for k, tx in txs.items()},
               planes={k: dict(bytes=tx.planes_bytes, s=tx.planes_s) for k, tx in txs.items()},
               n=n, R=big.R, M=int(big.ma_row.shape[0]), n_sup=big.n_sup)
    check(all(cuda_lf.row_layout(tx) == k for k, tx in txs.items()), "pfp_big's row layouts")
    err, rec_err, ranges, launches = 0, 0, {}, {}
    for kind, (qc, lens) in lanes.items():
        q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
        for key, tx in txs.items():
            cuda_lf.LAUNCHES_FB2 = 0
            got = find_ranges(tx, q, ln)
            launches[f"{kind}_{key}"] = cuda_lf.LAUNCHES_FB2
            want = cuda_lf.find_ranges_plain(tx, q, ln)
            torch.cuda.synchronize()
            ek = max_abs_err(got, want)
            check(ek == 0 and got[0].dtype == torch.int64,
                  f"K1 over {key} != plain above 2^31 on the {kind} lanes: max |err| {ek}")
            err = max(err, ek)
            er = held_record(tx, q, ln, got)
            check(er == 0, f"the record launch over {key} != its plain twin above 2^31 on the "
                  f"{kind} lanes: max |err| {er}")
            rec_err = max(rec_err, er)
            ranges[kind, key] = tuple(x.cpu().numpy() for x in got)
            if kind == "reads":
                res[f"{key}_call_ms"], res[f"{key}_plain_ms"] = in_turns(
                    [lambda tx=tx: cuda_lf.find_ranges_plain(tx, q, ln)],
                    [lambda tx=tx: find_ranges(tx, q, ln)], 1, 5)
                res[f"{key}_device_us"] = kernel_event_us(
                    [lambda a, b, tx=tx: k1_current(tx, q, ln, False, a, b)], 5)
        lo, hi = ranges[kind, "fb2_256"]
        check(all(np.array_equal(ranges[kind, key][i], (lo, hi)[i]) for key in txs for i in (0, 1)),
              f"K1's ranges over fb2_256, fb2_64 and fb2 differ on the {kind} lanes")
        t = time.perf_counter()
        hlo, hhi = host_ranges_fb2(b128, qc[:N_BIG_HOST], lens[:N_BIG_HOST])
        res[f"{kind}_host_s"] = time.perf_counter() - t
        check(np.array_equal(hlo, lo[:N_BIG_HOST]) and np.array_equal(hhi, hi[:N_BIG_HOST]),
              f"K1 over the two-level rows != the host rank over the 96 B rows ({kind} lanes)")
        found = hi >= lo
        res[kind] = dict(lanes=int(lo.shape[0]), nonempty=int(found.sum()),
                         lo_at_or_above_2_31=int((found & (lo >= top)).sum()),
                         hi_at_or_above_2_31=int((found & (hi >= top)).sum()),
                         max_hi=int(hi[found].max()))
        check(res[kind]["lo_at_or_above_2_31"] > 0, f"no final range lies above 2^31 ({kind})")
    check(all(v == 1 for v in launches.values()), f"K1 launches a batch: {launches}")
    q, ln = torch.from_numpy(lanes["reads"][0]).to(device), torch.from_numpy(qlens).to(device)
    res["rec_lanes_checked"] = {k: int(v[0].shape[0]) for k, v in lanes.items()}
    lo, hi = ranges["reads", "fb2_256"]
    t = time.perf_counter()
    clo, chi = cpu_backend.count_ranges_fb2g(big, qc16[:N_PFP_CPU], qlens[:N_PFP_CPU])
    res["cpu_count_reads_per_s"] = N_PFP_CPU / (time.perf_counter() - t)
    check(np.array_equal(clo, lo[:N_PFP_CPU]) and np.array_equal(chi, hi[:N_PFP_CPU])
          and np.array_equal(lo[:n_par], e["lo"]) and np.array_equal(hi[:n_par], e["hi"])
          and np.array_equal(hi[:n_par] - lo[:n_par] + 1, e["cnt"]),
          "K1 over fb2_256 != the CPU engine or the analytic counts")
    if k1 is not None:
        # each layout's bound: the same steps over rows of its own width
        for key, tx in txs.items():
            row_bytes, step_ops, sass_ops = two_level_costs(tx, False)
            res[f"{key}_work"] = [k1_work(tx, q, ln, False)]
            bk = k1_bound(res[f"{key}_work"], BATCH, READ_LEN, tx.A, row_bytes,
                          k1["us_per_dependent_step"]["random_cycle"], lane_bytes=8,
                          table_bytes=tx.arrays["fb2_base"].numel() * 8, step_ops=step_ops,
                          sass_step_ops=sass_ops)
            res[f"{key}_bound"] = bk
            res[f"{key}_share"] = bk["bound_us"] / res[f"{key}_device_us"]
        tx, work = txs["fb2_256"], res["fb2_256_work"]
        res["work"], res["bound"] = work, res["fb2_256_bound"]
        # the record launch over the saved directory's rows: rbt_align -s's route
        res["rec"] = record_times(device, big, tx, [(q, ln)], work, k1, "fb2_256",
                                  res["fb2_256_call_ms"])
    res.update(launches=launches, max_abs_err=err, rec_max_abs_err=rec_err)
    del txs, q, ln
    torch.cuda.empty_cache()

    # the CLIs on the saved directory
    reads = big.alpha.bytes_[qc16]
    fq = {x: os.path.join(WORK, f"pfp_{x}.fq") for x in ("reads", "locate", "greedy")}
    write_fastq(fq["reads"], reads)
    write_fastq(fq["locate"], reads[:N_PFP_LOCATE])
    write_fastq(fq["greedy"], reads[:N_GREEDY])
    out_txt = os.path.join(WORK, "pfp_out.txt")
    names = [f"r{i}" for i in range(BATCH)]
    doc_len = PFP_BIG["ref_len"] + PFP_BIG["w"]
    runs = {}
    for tag, fastq, flags, nr in (("count", fq["reads"], [], BATCH),
                                  ("-s", fq["locate"], ["-s"], N_PFP_LOCATE),
                                  ("-m", fq["reads"], ["-m"], BATCH)):
        reset_counts()
        cli, text, err_text = run_cli([path, fastq, *flags, "-b", str(BATCH), "--device",
                                       str(device)], out_txt)
        runs[tag] = dict(cli, reads=nr, cli_reads_per_s=nr / cli["cli_query_s"],
                         launches=cuda_lf.LAUNCHES_FB2, rec_launches=cuda_lf.LAUNCHES_REC,
                         records_plain=cuda_lf.RECORDS_PLAIN, walks=walk_counts())
        check(err_text.startswith(f"loading (big two-level artifact): {path}"),
              "rbt_align did not load the PFP directory as a big one")
        lines = text.splitlines(keepends=True)
        per = 1 if tag == "count" else 2
        check("".join(lines[::per]) == "".join(count_lines(names[:nr], lo[:nr], hi[:nr])),
              f"rbt_align {tag}'s count lines != K1's ranges on the PFP panel")
        runs[tag]["stages"] = align_stages(device, lambda m: load_big(device, path, m), fastq,
                                           flags[0] if flags else "", text)
        if tag == "-s":
            counts, pos, docs, doff = parse_locs(lines[1::2])
            sizes = np.where(hi[:nr] >= lo[:nr], hi[:nr] - lo[:nr] + 1, 0)
            check(np.array_equal(counts, sizes), "-s: a read's located hits != its count")
            check(docs == [f"hap{d - 1}" if d else "ref" for d in (pos // doc_len).tolist()]
                  and np.array_equal(doff, pos % doc_len), "-s: a document or offset is wrong")
            offs = np.concatenate([[0], np.cumsum(counts)])
            check(all(sorted(pos[offs[i]:offs[i + 1]].tolist()) == sorted(
                e["pos_flat"][e["pos_off"][i]:e["pos_off"][i + 1]].tolist())
                for i in range(n_par)), "-s: an occurrence set != doc x doc_len + offset")
            t = time.perf_counter()
            c = cpu_backend.locate_fb2(big, qc16[:N_PFP_CPU], qlens[:N_PFP_CPU], max_hits=4)
            runs[tag]["cpu_reads_per_s"] = N_PFP_CPU / (time.perf_counter() - t)
            check(np.array_equal(c[0], lo[:N_PFP_CPU]) and np.array_equal(c[1], hi[:N_PFP_CPU])
                  and all(pos[offs[i]:offs[i] + c[4][i]].tolist() == c[3][i, :c[4][i]].tolist()
                          for i in range(N_PFP_CPU)),
                  "-s: the toehold and phi chain != cpu_backend.locate_fb2's")
            runs[tag]["hits"] = int(pos.shape[0])
        elif tag == "-m":
            mlines = lines[1::2]
            got = [sorted((int(p) << 8) | int(a) for p, a in (x.split("/") for x in ln.split()[1:]))
                   if not ln.startswith("\tmarkers: no markers") else [] for ln in mlines]
            check(all(got[i] == sorted(e["mval_flat"][e["mval_off"][i]:e["mval_off"][i + 1]]
                                       .tolist()) for i in range(n_par)),
                  "-m: a marker multiset != the analytic one")
            s0 = np.searchsorted(big.ma_row, lo[:N_PFP_CPU].astype(big.ma_row.dtype))
            s1 = np.searchsorted(big.ma_row, (hi[:N_PFP_CPU] + 1).astype(big.ma_row.dtype))
            check(all(got[i] == (sorted((np.asarray(big.ma_val[s0[i]:s1[i]]) & ((1 << 48) - 1))
                                        .tolist()) if hi[i] >= lo[i] else [])
                      for i in range(N_PFP_CPU)), "-m: a marker multiset != the host CSR's")
            t = time.perf_counter()
            c = cpu_backend.markers_fb2(big, qc16[:N_PFP_CPU], qlens[:N_PFP_CPU],
                                        MA_WSIZE, 1000)
            runs[tag]["cpu_reads_per_s"] = N_PFP_CPU / (time.perf_counter() - t)
            check(np.array_equal(c[0], lo[:N_PFP_CPU]) and np.array_equal(c[1], hi[:N_PFP_CPU]),
                  "-m: the ranges != cpu_backend.markers_fb2's")
            runs[tag]["reads_with_markers"] = int(sum(1 for x in got if x))
            runs["-m_routes"] = marker_routes(device, path, fastq, text)
    check(runs["count"]["launches"] == 1 and runs["-m"]["launches"] == 1
          and runs["-s"]["launches"] == 0, f"K1 launches of the PFP panel's CLIs: {runs}")
    check([runs[t]["rec_launches"] for t in ("count", "-s", "-m")] == [0, 1, 0]
          and runs["-s"]["records_plain"] == 0,
          f"rbt_align -s on the PFP panel: one record launch and no torch record loop: {runs}")
    check([runs[t]["walks"] for t in ("count", "-s", "-m")]
          == [dict(walk=0, kval=0), dict(walk=1, kval=0), dict(walk=0, kval=0)],
          f"rbt_align -s on the PFP panel: one walk kernel launch and no torch walk: {runs}")
    res["walk"] = big_walk(device, path, fq["locate"])
    reset_counts()
    cli, g_text, _ = run_seeding_cli("rbt_markers", [path, fq["greedy"], "-f", "-b",
                                                     str(GREEDY_BATCH), "--device", str(device)],
                                     out_txt)
    g_seeds = seed_counts()
    check(g_seeds == seed_launches(greedy=-(-N_GREEDY // GREEDY_BATCH)),
          f"rbt_markers -f on the PFP panel: {g_seeds}, not one greedy launch a batch")
    seeds = {}
    for ln in g_text.splitlines():
        key = (read_no(ln), ln.split()[2])
        seeds[key] = seeds.get(key, 0) + 1
    enc = big.alpha.encode_table()
    rc = np.stack([enc[revcomp(r).astype(np.int64)] for r in reads[:N_PFP_CPU]]).astype(np.int16)
    both = np.stack([qc16[:N_PFP_CPU], rc], axis=1).reshape(2 * N_PFP_CPU, READ_LEN)
    t = time.perf_counter()
    ns, _ = cpu_backend.greedy_fb2(big, both, np.repeat(qlens[:N_PFP_CPU], 2), MA_WSIZE, 1000)
    cpu_s = time.perf_counter() - t
    got = np.array([seeds.get((i, s), 0) for i in range(N_PFP_CPU) for s in "+-"])
    check(np.array_equal(got, np.minimum(ns, 8)),
          "rbt_markers -f seeds per read and strand != cpu_backend.greedy_fb2's")
    runs["markers_f"] = dict(cli, reads=N_GREEDY, cli_reads_per_s=N_GREEDY / cli["cli_query_s"],
                             seeds=len(g_text.splitlines()), launches=cuda_lf.LAUNCHES_FB2,
                             seed_launches=g_seeds, cpu_reads_per_s=N_PFP_CPU / cpu_s)
    res.update(runs=runs, dir_gb=dir_gb(path), dir_128_gb=dir_gb(path + "_128"),
               cpu_checked=N_PFP_CPU, analytic_checked=n_par, card=card["nvidia_smi"])
    emit("pfp_big", **res)
    return res


def build_big_chr(chr_) -> dict:
    """The chr panel's BigIndex view (n_sup = N_SUP_CHR), with the locate
    tables derived from the chr index as bench.py:143-168 derives them (the
    phi breakpoints from the dense phi1), the marker CSR, window and document
    list, saved as a big directory with the chr `idx.midx.npz` beside it."""
    from rowbowt_tpu_torch.bigindex import BigIndex

    idx, paths = chr_["idx"], chr_["paths"]
    t0 = time.perf_counter()
    big = BigIndex.from_codes(codes_of(idx), idx.alpha, n_sup=N_SUP_CHR)
    head = np.asarray(idx.run_head).astype(np.uint8)
    big.run_start = np.asarray(idx.run_start).astype(np.uint32)
    big.run_head = head
    big.samples_last = np.asarray(idx.samples_last).astype(np.uint32)
    phi1 = np.asarray(idx.phi1).astype(np.int64)
    bp = np.flatnonzero(np.diff(phi1) != 1) + 1
    if bp.size == 0 or bp[0] != 0:
        bp = np.concatenate(([0], bp))
    big.pred_pos, big.phi_at = bp.astype(np.uint32), phi1[bp].astype(np.uint32)
    del phi1
    R = idx.R
    keys = head.astype(np.int64) * R + np.arange(R, dtype=np.int64)
    big.cruns_keys = keys[np.argsort(head, kind="stable")].astype(np.int32)
    big.ma_row, big.ma_val = np.asarray(idx.ma_row).astype(np.uint32), np.asarray(idx.ma_val)
    big.ma_wsize, big.doc_starts, big.doc_names = idx.ma_wsize, idx.doc_starts, idx.doc_names
    build_s = time.perf_counter() - t0
    path = os.path.join(WORK, "big")
    big.save(path)
    shutil.copy(paths["idx"] + ".midx.npz", path + ".midx.npz")
    return dict(path=path, n_sup=big.n_sup, per_blk=big.per_blk, R=big.R,
                breakpoints=int(bp.size), M=int(big.ma_row.shape[0]), build_s=build_s,
                dir_gb=sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9)


def load_big(device, path: str, mode: str):
    """(BigIndex, its TorchIndex) for rbt_align `mode`, as the CLI loads it."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.device import TorchIndex

    big = BigIndex.load(path)
    return big, TorchIndex.from_big(big, device, with_locate=mode == "-s",
                                    with_markers=mode == "-m")


def load_dense(device, path: str, mode: str):
    """(RbtIndex, its TorchIndex) for rbt_align `mode`, as the CLI loads it."""
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex

    idx = RbtIndex.load(path, with_sa=mode == "-s", with_ma=mode == "-m", with_dl=mode == "-s",
                        with_ft=False)
    return idx, TorchIndex.from_index(idx, device)


def align_stages(device, load, fastq: str, mode: str, out_text: str,
                 resident: dict | None = None) -> dict:
    """rbt_align's stages one by one (host clock; each device stage ends in a
    synchronize): count (mode ""), -s or -m, on the index that load(mode)
    returns as (host index, TorchIndex).  The staged run's lines must equal
    the CLI's.  `resident` receives the MB of each table on the card."""
    import torch

    from rowbowt_tpu_torch.cli import rbt_align
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold, locate_ragged

    stages = {}
    with timed(stages, "load_s"):
        host, tx = load(mode)
    if resident is not None:
        resident.update({k: v.numel() * v.element_size() / 1e6 for k, v in tx.arrays.items()})
    with timed(stages, "parse_s"):
        batches = list(iter_query_batches(host, fastq, BATCH))
    with timed(stages, "h2d_s"):
        dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device), len(names))
               for names, qc, lens in batches]
    with timed(stages, "lf_toehold_s" if mode == "-s" else "lf_s"):
        search = find_ranges_w_toehold if mode == "-s" else find_ranges
        ranges = [tuple(t[:nr] for t in search(tx, q, ln)) for q, ln, nr in dev]
    cols = []
    if mode == "-s":  # rbt_align.locate_hits, then format_locs, split in three
        with timed(stages, "walk_s"):
            located = [locate_ragged(tx, lo, hi, k) for lo, hi, k in ranges]
        with timed(stages, "docs_s"):
            docs = [rbt_align.hit_docs(tx, flat) for flat, _ in located]
        with timed(stages, "text_s"):
            cols = [rbt_align.format_locs(host.doc_names, *loc, *d)
                    for loc, d in zip(located, docs)]
    elif mode == "-m":
        with timed(stages, "probe_s"):
            cols = [rbt_align.format_markers(*rbt_align.probe_markers(tx, lo, hi))
                    for lo, hi in ranges]
    with timed(stages, "format_s"):
        text = "".join(
            "".join("".join(parts) for parts in zip(
                count_lines(names, r[0].cpu().numpy(), r[1].cpu().numpy()),
                *([cols[b]] if cols else [])))
            for b, ((names, _, _), r) in enumerate(zip(batches, ranges)))
    check(text == out_text, f"rbt_align {mode} != its staged run")
    return stages


def phase_big_chr(device, card: dict, chr_: dict, count: dict, k1: dict, loc: dict,
                  markers: dict, locs: dict) -> dict:
    """The chr panel's BigIndex view (build_big_chr) through the port's CLIs:
    rbt_align count (N_READS reads), -s and -m (N_LOCATE) print the lines of
    the dense chr index; rbt_markers -f (N_GREEDY; big artifacts carry no
    ftab, so it runs without) prints the dense index's lines without -f on
    the first N_GREEDY_CPU reads and the scalar oracle's (no ftab) on N_ORACLE
    reads;
    rbt_locs prints the dense run's lines (held to the oracle in phase
    locs).  Load and query seconds, reads/s, stages and K1 launches of each.
    Then K1 over fb2_64's bit planes on the first two of the main path's
    batches against the plain loop and K1 over fblock64 (no ftab: the same
    work), call times in turns
    and device times alone (CUDA events; one profiler trace as a check),
    the bound as phase k1 computes it (int64 F, lo and hi, and the base
    table), and K1 over the 96 B fb2 rows against the plain loop."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    view = build_big_chr(chr_)
    path, dev_s = view["path"], str(device)
    runs = {}

    def align(tag, fastq, flags, want):
        reset_counts()
        cli, out_text, err = run_cli([path, fastq, *flags, "-b", str(BATCH), "--device", dev_s],
                                     paths["out.txt"])
        check(out_text == want, f"rbt_align {tag} on the big directory != the dense index's lines")
        check(err.startswith(f"loading (big two-level artifact): {path}"),
              "rbt_align did not load the big directory as one")
        n = N_READS if tag == "count" else N_LOCATE
        runs[tag] = dict(cli, cli_reads_per_s=n / cli["cli_query_s"], reads=n,
                         launches=cuda_lf.LAUNCHES_FB2, rec_launches=cuda_lf.LAUNCHES_REC,
                         records_plain=cuda_lf.RECORDS_PLAIN, walks=walk_counts(),
                         stages=align_stages(device, lambda m: load_big(device, path, m),
                                             fastq, flags[0] if flags else "", out_text))

    align("count", paths["reads.fq"], [], "".join(count["lines"]))
    align("-s", paths["locate.fq"], ["-s"], loc["out_text"])
    align("-m", paths["locate.fq"], ["-m"], markers["out_text"])
    check(runs["count"]["launches"] == N_READS // BATCH and runs["-m"]["launches"] == -(
        -N_LOCATE // BATCH), f"K1 launches over the big rows: {runs}")
    # -s: one record launch a batch, no count launch and no torch record loop
    check((runs["-s"]["rec_launches"], runs["-s"]["launches"], runs["-s"]["records_plain"])
          == (-(-N_LOCATE // BATCH), 0, 0), f"rbt_align -s routes on the big rows: {runs['-s']}")
    check(all(runs[t]["rec_launches"] == 0 for t in ("count", "-m")),
          "a record launch outside -s")
    # -s: one walk kernel launch a batch over the phi rows, no torch walk
    check(runs["-s"]["walks"] == dict(walk=-(-N_LOCATE // BATCH), kval=0),
          f"rbt_align -s walks on the big rows: {runs['-s']['walks']}")
    runs["-m_routes"] = marker_routes(device, path, paths["locate.fq"], markers["out_text"])

    # rbt_markers -f and rbt_locs on the big directory
    argv = ["-f", "-b", str(GREEDY_BATCH), "--device", dev_s]
    reset_counts()
    cli, g_text, g_err = run_seeding_cli("rbt_markers", [path, paths["greedy.fq"], *argv],
                                         paths["out.txt"])
    g_seeds = seed_counts()
    check(g_seeds == seed_launches(greedy=-(-N_GREEDY // GREEDY_BATCH)),
          f"rbt_markers -f on the big directory: {g_seeds}, not one greedy launch a batch")
    check("note: big artifacts carry no ftab; running without it" in g_err.splitlines(),
          "rbt_markers -f did not note the missing ftab")
    lines = g_text.splitlines(keepends=True)
    nums = np.array([read_no(ln) for ln in lines])
    dense, d_text, _ = run_seeding_cli(
        "rbt_markers", [paths["idx"], paths["greedy_cpu.fq"], *argv[1:]], paths["out.txt"])
    n_first = int((nums < N_GREEDY_CPU).sum())
    check(d_text.splitlines(keepends=True) == lines[:n_first],
          "rbt_markers -f on the big directory != the dense index without -f")
    t = time.perf_counter()
    want = oracle_seed_lines(idx, chr_["reads"][:N_ORACLE], lmem=False, use_ftab=False)
    oracle_s = time.perf_counter() - t
    check(lines[:int((nums < N_ORACLE).sum())] == want,
          f"rbt_markers on the big directory != the scalar oracle on the first {N_ORACLE} reads")
    runs["markers_f"] = dict(cli, cli_reads_per_s=N_GREEDY / cli["cli_query_s"],
                             reads=N_GREEDY, seeds=len(lines), launches=cuda_lf.LAUNCHES_FB2,
                             seed_launches=g_seeds,
                             dense_no_ftab_query_s=dense["cli_query_s"], dense_no_ftab_reads=N_GREEDY_CPU,
                             oracle_reads=N_ORACLE, oracle_s=oracle_s)
    reset_counts()
    cli, l_text, _ = run_seeding_cli(
        "rbt_locs", [path, paths["greedy.fq"], "-b", str(GREEDY_BATCH), "--device", dev_s],
        paths["out.txt"])
    l_seeds = seed_counts()
    check(l_text == locs["out_text"], "rbt_locs on the big directory != the dense index's lines")
    check(l_seeds == seed_launches(sample_rec=-(-N_GREEDY // GREEDY_BATCH)),
          f"rbt_locs on the big directory: {l_seeds}, not one record launch of the sampled "
          "machine a batch")
    runs["locs"] = dict(cli, cli_reads_per_s=N_GREEDY / cli["cli_query_s"], reads=N_GREEDY,
                        launches=cuda_lf.LAUNCHES_FB2, seed_launches=l_seeds)

    # K1 over the two-level rows on the main path's batches
    big = BigIndex.load(path)
    tx = TorchIndex.from_big(big, device, with_locate=False, with_markers=False)  # fb2_64
    txd = TorchIndex.from_index(idx, device)  # fblock64
    host = [(qc, lens) for _, qc, lens in iter_query_batches(big, paths["reads.fq"], BATCH)][:2]
    dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
           for qc, lens in host]
    B, L = dev[0][0].shape
    plain = [cuda_lf.find_ranges_plain(tx, q, ln) for q, ln in dev]
    err = max(max(max_abs_err(k1_current(tx, q, ln), want),
                  max_abs_err(k1_current(txd, q, ln, False), want))
              for (q, ln), want in zip(dev, plain))
    tx96 = TorchIndex.from_big(big, device, fb64=False, with_locate=False, with_markers=False)
    err = max(err, *(max_abs_err(k1_current(tx96, q, ln), want)
                     for (q, ln), want in zip(dev, plain)))
    torch.cuda.synchronize()
    check(err == 0, f"K1 over the two-level rows != plain at chr: max |err| {err}")
    # the record launch on the same batches and at the edges (fb2_64)
    t = time.perf_counter()
    edges = k1_edges(*host[0], device)
    rec_err = max(held_record(tx, q, ln, want) for (q, ln), want in zip(dev, plain))
    rec_err = max(rec_err, *(held_record(tx, qe, le) for _, qe, le in edges))
    check(rec_err == 0, f"the record launch != its plain twin at chr: max |err| {rec_err}")
    rec_check_s = time.perf_counter() - t

    def calls(t, use_ftab=False):
        return [lambda q=q, ln=ln: k1_current(t, q, ln, use_ftab) for q, ln in dev]

    def bracketed(t):
        return [lambda a, b, q=q, ln=ln: k1_current(t, q, ln, False, a, b) for q, ln in dev]

    res = dict(view, launches=runs["count"]["launches"], max_abs_err=err, batches=len(dev),
               lanes=B, L=L, runs=runs, planes=dict(bytes=tx.planes_bytes, s=tx.planes_s))
    res["fb2_call_ms"], res["plain_ms"] = in_turns(
        [lambda q=q, ln=ln: cuda_lf.find_ranges_plain(tx, q, ln) for q, ln in dev],
        calls(tx), 1, 5)
    res["fblock64_call_ms"], res["fb2_call_ms_again"] = in_turns(calls(tx), calls(txd), 5, 5)
    res["fb2_96_call_ms"] = cuda_ms(calls(tx96), 5)
    # the kernels alone, in turns: fblock64, fb2_64, fb2_64, fblock64
    old = [kernel_event_us(bracketed(txd), 5)]
    new = [kernel_event_us(bracketed(tx), 5) for _ in range(2)]
    old.append(kernel_event_us(bracketed(txd), 5))
    res["fb2_device_us"], res["fblock64_device_us"] = sum(new) / 2, sum(old) / 2
    res["fb2_device_us_each"], res["fblock64_device_us_each"] = new, old
    res["profiled_us"] = profiled_kernel_us(calls(tx), 3,
                                            ("lf_count2_kernel",))["lf_count2_kernel"]
    work = [k1_work(tx, q, ln, False) for q, ln in dev]
    res["work"] = work
    row_bytes, step_ops, sass_ops = two_level_costs(tx, False)
    res["bound"] = k1_bound(work, B, L, tx.A, row_bytes,
                            k1["us_per_dependent_step"]["random_cycle"], lane_bytes=8,
                            table_bytes=tx.arrays["fb2_base"].numel() * 8, step_ops=step_ops,
                            sass_step_ops=sass_ops)
    res["fb2_share"] = res["bound"]["bound_us"] / res["fb2_device_us"]
    res["rec"] = record_times(device, big, tx, dev, work, k1, "fb2_64", res["fb2_call_ms"])
    res["rec"].update(max_abs_err=rec_err, edges=[label for label, _, _ in edges],
                      check_s=rec_check_s)
    res["resident_mb"] = {k: v.numel() * v.element_size() / 1e6 for k, v in TorchIndex.from_big(
        big, device).arrays.items()}
    res["walk"] = big_walk(device, path, paths["locate.fq"])
    # the sampled machine with its step record (rbt_locs' route here) on
    # rbt_locs' first batch over fb2_64
    _, qc, lens = next(iter(iter_query_batches(big, paths["greedy.fq"], GREEDY_BATCH)))
    q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
    res["seeds_rec"] = seeds_times(tx, {"sample": (q, ln, seed_cfg(tx, "sample", q.shape[1]))},
                                   k1["us_per_dependent_step"]["random_cycle"])["sample"]
    emit("big_chr", **res, card=card["nvidia_smi"])
    del tx, txd, tx96, dev, plain
    torch.cuda.empty_cache()
    return res


def two_level_costs(tx, rec: bool) -> tuple:
    """(row bytes, operations a ranked step, machine instructions a ranked
    step) of the two-level search over tx's bit planes, the record launch's
    where `rec`: the plane row's bytes, two plane ranks (plane_rank_ops),
    and the two threads' step loop (step_loop) where the build phase counted
    it, else None."""
    from rowbowt_tpu_torch.ops import cuda_lf

    key = cuda_lf.row_layout(tx)
    syms = cuda_lf._SYMS_PER_ROW[key]
    loop = step_loop(syms, rec)
    return (cuda_lf.rows_of(tx, key).shape[1] * 4, 2 * plane_rank_ops(syms),
            2 * loop if loop else None)


def record_times(device, big, tx, dev, work: list, k1: dict, key: str, k1_ms: float) -> dict:
    """The record launch on the batches `dev` over `tx`'s rows: its call ms
    in turns with its plain twin (the torch loop), K1 without the record and
    the record launch alone in turns (CUDA events just around the launch:
    fb2, record, record, fb2), one profiler trace, the toehold's resolve
    (engine/locate.span_toeholds over the record) and the whole trajectory
    toehold (find_ranges_w_toehold) on the index with its locate tables, the
    bound (K1's over `work` and the record's L * B * 8 bytes) and its share.
    `k1_ms` is K1's call ms without the record."""
    import torch

    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold, span_toeholds
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    B, L = dev[0][0].shape
    calls = [lambda q=q, ln=ln: cuda_lf.find_ranges_record(tx, q, ln) for q, ln in dev]
    out = dict(layout=key, batches=len(dev), lanes=B, L=L, record_mb=L * B * 8 / 1e6)
    out["call_ms"], out["plain_ms"] = in_turns(
        [lambda q=q, ln=ln: cuda_lf.find_ranges_record_plain(tx, q, ln) for q, ln in dev],
        calls, 1, 5)
    out["k1_call_ms"] = k1_ms
    rec = [around(c) for c in calls]
    bare = [lambda a, b, q=q, ln=ln: k1_current(tx, q, ln, False, a, b) for q, ln in dev]
    old = [kernel_event_us(bare, 5)]
    new = [kernel_event_us(rec, 5) for _ in range(2)]
    old.append(kernel_event_us(bare, 5))
    out["device_us"], out["k1_device_us"] = sum(new) / 2, sum(old) / 2
    out["device_us_each"], out["k1_device_us_each"] = new, old
    out["profiled_us"] = profiled_kernel_us(calls, 3, ("lf_count2_kernel",))["lf_count2_kernel"]
    txl = TorchIndex.from_big(big, device, fb64=key == "fb2_64", with_locate=True,
                              with_markers=False)
    recs = [cuda_lf.find_ranges_record(txl, q, ln) for q, ln in dev]
    zeros = torch.zeros((1, B), dtype=torch.int64, device=device)
    out["resolve_ms"] = cuda_ms([lambda q=q, ln=ln, r=r: span_toeholds(
        txl, q, r[2], ln.long(), zeros, (ln.long() - 1)[None, :]) for (q, ln), r in zip(dev, recs)],
        3)
    out["toehold_ms"] = cuda_ms([lambda q=q, ln=ln: find_ranges_w_toehold(txl, q, ln)
                                 for q, ln in dev], 3)
    del txl, recs
    row_bytes, step_ops, sass_ops = two_level_costs(tx, True)
    b = k1_bound(work, B, L, tx.A, row_bytes, k1["us_per_dependent_step"]["random_cycle"],
                 lane_bytes=8, table_bytes=tx.arrays["fb2_base"].numel() * 8,
                 out_bytes=L * B * 8, step_ops=step_ops, sass_step_ops=sass_ops)
    out["bound"] = b
    out["bound_ms"] = max(b["byte_bound_us"], b["ops_bound_us"]) / 1e3
    out["bound_by"] = "bytes" if b["byte_bound_us"] >= b["ops_bound_us"] else "operations"
    out["share"] = b["bound_us"] / out["device_us"]
    out["wall_s"] = time.perf_counter() - t0
    return out


def marker_routes(device, path: str, fastq: str, out_text: str) -> dict:
    """rbt_align -m's lines on the big directory at `path` from each marker
    bound route of TorchIndex.from_big, in this process: the run pack (the
    default) and the bucketed CSR (the instance's run pack taken away, as
    the tests do it).  The lines of each equal `out_text` and
    markers_bounds is the same on both.  Beside them the nibble-count rows
    (BigIndex._ma_cnt64, which no route of the port selects), put on the
    card by hand with the bucketed instance: their bounds (ops/rank.
    _ms_nibble at lo and hi + 1) equal the run pack's.  Per route its load
    seconds (BigIndex.load and from_big; for the nibble rows their build or
    cache read and copy), bounds seconds (every batch's two probes, host
    clock, synchronized), table GB and, for the two from_big routes, probe
    seconds (cli/rbt_align.probe_markers and the formatting)."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.cli import rbt_align
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import rank as R

    def nibble_bounds(tx, lo, hi):
        s = R._ms_nibble(tx, torch.clamp(lo, 0, tx.n))
        e = R._ms_nibble(tx, torch.clamp(hi + 1, 0, tx.n))
        return s, torch.clamp(e - s, min=0)

    tables = {"run_pack": ("ma_roff", "ma_sd16", "ma_rec"), "bucketed": ("ma_row", "ma_off"),
              "nibble": ("ma_cnt64",)}
    res, bounds, t0 = {}, {}, time.perf_counter()
    for route in ("run_pack", "bucketed"):
        t = time.perf_counter()
        big = BigIndex.load(path)
        if route == "bucketed":
            big._ma_runpack = lambda: None
        tx = TorchIndex.from_big(big, device, with_locate=False, with_markers=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        check(all(k in tx.arrays for k in tables[route])
              and not any(k in tx.arrays for r, ks in tables.items() if r != route
                          for k in ks if k != "ma_row"),
              f"the {route} route's marker tables: {sorted(tx.arrays)}")
        batches = [(names, torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
                   for names, qc, lens in iter_query_batches(big, fastq, BATCH)]
        ranges = [tuple(x[:len(names)] for x in find_ranges(tx, q, ln))
                  for names, q, ln in batches]
        stages = {}
        with timed(stages, "probe_s"):
            cols = [rbt_align.format_markers(*rbt_align.probe_markers(tx, lo, hi))
                    for lo, hi in ranges]
        text = "".join("".join(a + b for a, b in zip(
            count_lines(names, lo.cpu().numpy(), hi.cpu().numpy()), col))
            for (names, _, _), (lo, hi), col in zip(batches, ranges, cols))
        check(text == out_text, f"rbt_align -m over the {route} route != its lines")
        routes = [(route, tx, R.markers_bounds)]
        if route == "bucketed":
            t = time.perf_counter()
            nib = big._ma_cnt64()
            check(nib is not None, "no nibble-count rows for the panel")
            ntx = dataclasses.replace(tx, arrays=dict(
                tx.arrays, ma_cnt64=torch.from_numpy(np.ascontiguousarray(nib)).to(device)))
            torch.cuda.synchronize()
            res["nibble"] = dict(load_s=time.perf_counter() - t)
            routes.append(("nibble", ntx, nibble_bounds))
        for r, rtx, fn in routes:
            fn(rtx, *ranges[0])  # warm
            with timed(stages, r):
                out = [fn(rtx, lo, hi) for lo, hi in ranges]
            bounds[r] = [torch.cat(x).cpu() for x in zip(*out)]
            res.setdefault(r, {}).update(
                bounds_s=stages[r], table_gb=sum(rtx.arrays[k].numel() * rtx.arrays[k].element_size()
                                                 for k in tables[r]) / 1e9)
        res[route].update(load_s=load_s, probe_s=stages["probe_s"])
        del tx, batches, ranges, routes
        torch.cuda.empty_cache()
    check(all(all(torch.equal(a, b) for a, b in zip(bounds["run_pack"], bounds[r]))
              for r in tables), "markers_bounds differ between the marker routes")
    res["wall_s"] = time.perf_counter() - t0
    return res


def route_counts() -> dict:
    """The launch counts of the count search's routes since the last reset:
    K1 over the single-level rows, over the two-level rows, its record
    launch (a big index's toehold search), its toehold launch (the per-step
    toehold of an index without kval), and the tables kernel of an index
    without fused-block rows by rank policy, its count search (tab_<policy>:
    count and -m) and its toehold search (tab_toe_<policy>: -s)."""
    from rowbowt_tpu_torch.ops import cuda_lf

    return dict(k1=cuda_lf.LAUNCHES, k1_fb2=cuda_lf.LAUNCHES_FB2, k1_rec=cuda_lf.LAUNCHES_REC,
                toe=cuda_lf.LAUNCHES_TOE,
                **{f"tab_{p}": v for p, v in cuda_lf.LAUNCHES_TAB.items()},
                **{f"tab_toe_{p}": v for p, v in cuda_lf.LAUNCHES_TAB_TOE.items()})


def walk_counts() -> dict:
    """The phi walk's launches since the last reset: the chain's (walk:
    every phi route, phi1, the phi rows, phi_at, the predecessor search) and
    the kval kernel's (kval)."""
    from rowbowt_tpu_torch.ops import cuda_phi

    return dict(walk=cuda_phi.LAUNCHES, kval=cuda_phi.LAUNCHES_KVAL)


def reset_counts() -> None:
    """Every route count to 0 (the count search's, the phi walk's and the
    seeding machines'), and the runs of the torch record loop."""
    from rowbowt_tpu_torch.ops import cuda_lf, cuda_phi, cuda_seeds

    cuda_lf.LAUNCHES = cuda_lf.LAUNCHES_FB2 = 0
    cuda_lf.LAUNCHES_REC = cuda_lf.RECORDS_PLAIN = cuda_lf.LAUNCHES_TOE = 0
    for counts in (cuda_lf.LAUNCHES_TAB, cuda_lf.LAUNCHES_TAB_TOE, cuda_seeds.LAUNCHES_SEED):
        counts.update(dict.fromkeys(counts, 0))
    cuda_phi.LAUNCHES = cuda_phi.LAUNCHES_KVAL = 0


def align_runs(device, path: str, runs: list, out_path: str) -> dict:
    """rbt_align on the index at `path` for each (tag, fastq, flags, wanted
    lines, reads): the lines must be the wanted ones.  Per run the CLI's own
    seconds, its reads/s and the route counts of that run alone."""
    res = {}
    for tag, fastq, flags, want, n in runs:
        reset_counts()
        cli, out_text, _ = run_cli([path, fastq, *flags, "-b", str(BATCH), "--device",
                                    str(device)], out_path)
        check(out_text == want, f"rbt_align {tag} on {path} != the dense index's lines")
        res[tag] = dict(cli, reads=n, cli_reads_per_s=n / cli["cli_query_s"],
                        launches=route_counts(), walks=walk_counts())
    return res


def launch_counts(**kw) -> dict:
    """route_counts()'s dict with the given counts and every other 0."""
    return dict(dict.fromkeys(route_counts(), 0), **kw)


L1_LEVELS = 16  # binary-search levels counted free in a bound: 2^16 int32 entries, in L1
TOE_STEP_OPS = 4  # int32 operations of the trivial test a step: a shift, a mask, a compare


def search_levels(R: int) -> int:
    """Dependent loads of a binary search over R sorted entries."""
    return math.ceil(math.log2(R + 1))


def pred_step_us(R: int, lat: dict, old: bool = False) -> float:
    """A lower bound on the latency of one step of the predecessor walk: the
    entry of the bucket directory pred_off and one pred_pos probe at the
    L2's dependent-load latency (P3 over the probe tool's 4 MB table; the
    bucket's other probes hit the line the first brought into L1), then the
    pred_to_run and samples_last loads at a random cycle's latency over a
    table of phi1's size; or where shorter (R below 2^(L1_LEVELS + 1)) the
    old bound.  With `old`, the bound of the binary search over all R
    entries that the directory replaced: its levels below the first
    L1_LEVELS at the L2's latency, then the same two loads."""
    search = max(search_levels(R) - L1_LEVELS, 0) * lat["tool_table"]
    return 2 * lat["random_cycle"] + (search if old else min(search, 2 * lat["tool_table"]))


def resolve_us(R: int, lat: dict, old: bool = False) -> float:
    """A lower bound on the latency of one toehold resolve over ltk: the
    directory's entry and one run_start probe at the L2's dependent-load
    latency, then the ltk load at a random cycle's latency; or where shorter
    the old bound.  With `old`, the bound of the binary search over all R
    run starts that the directory replaced: its levels below the first
    L1_LEVELS at the L2's latency, then the ltk load."""
    search = max(search_levels(R) - L1_LEVELS, 0) * lat["tool_table"]
    return lat["random_cycle"] + (search if old else min(search, 2 * lat["tool_table"]))


def resolve_ops(tx, old: bool = False) -> int:
    """int32 operations of one toehold resolve over ltk: the bucket and its
    bounds (4), 4 a halving of rs_off's `iters` and 4 for the run and the
    load; with `old` 4 a level of the search over all R run starts and 4."""
    return 4 * search_levels(tx.R) + 4 if old else 4 * tx.rs_bs[1] + 8


def toehold_work(tx, q, ln) -> dict:
    """What one batch asks of the toehold launch beyond K1's search
    (k1_work without the ftab), by a replay of the plain loop: the lanes
    whose search ends with a non-trivial step (BWT[hi] != c), the distinct
    entries their resolve reads (tk1, or ltk, the start of the run of each
    pre-step hi and the bounds of its bucket of rs_off), and their bytes."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    B, L = q.shape
    dt = tx.idx_dtype
    lo = torch.zeros(B, dtype=dt, device=q.device)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=q.device)
    tc = torch.full((B,), -1, dtype=torch.int64, device=q.device)
    thi = torch.zeros(B, dtype=torch.int64, device=q.device)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    lengths = ln.to(dt)
    step = R.lf_step_auto(tx)
    for j in range(L):
        c = q[:, L - 1 - j].to(dt)
        active = ~done & (j < lengths)
        nlo, nhi = step(tx, lo, hi, c)
        nontrivial = active & (nlo <= nhi) & (R.bwt_sym(tx, hi) != c)
        tc = torch.where(nontrivial, c.long(), tc)
        thi = torch.where(nontrivial, hi.long(), thi)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    res = (hi >= lo) & (tc >= 0)
    tc, thi = tc[res], thi[res]
    if cuda_lf.toehold_route(tx) == "tk1":
        tab = tx.arrays["tk1_flat"]
        entries = torch.unique(tc * tx.n + thi).numel()
        nbytes = entries * tab.element_size()
    else:
        entries, nbytes = ltk_resolve_bytes(tx, tc, thi)
    return dict(resolved_lanes=int(res.sum()), resolve_entries=entries, resolve_bytes=nbytes)


def ltk_resolve_bytes(tx, tc, thi) -> tuple[int, int]:
    """(entries, bytes) the resolves over ltk of the last non-trivial steps
    (codes tc, pre-step his thi) read: the distinct ltk entries, the start
    of each distinct run and the two bounds of each distinct bucket of
    rs_off that x + 1 = min(thi + 1, n - 1) + 1 falls in."""
    import torch

    rs, tab, off = tx.arrays["run_start"], tx.arrays["ltk"], tx.arrays["rs_off"]
    r = torch.searchsorted(rs, thi.to(rs.dtype), right=True).long() - 1
    b = torch.clamp((torch.clamp(thi + 1, max=tx.n - 1) + 1) >> tx.rs_bs[0], max=off.numel() - 2)
    entries = torch.unique(tc * tx.R + r).numel()
    return entries, (entries * tab.element_size() + torch.unique(r).numel() * rs.element_size()
                     + torch.unique(b).numel() * 2 * off.element_size())


def toehold_bound(work: dict, tw: dict, B: int, L: int, tx, lat: dict) -> dict:
    """The toehold launch's bound on one batch: K1's (k1_bound, 64 B rows,
    no ftab) with the resolve's entries as table bytes and k as one more
    int32 output; its operations add the trivial test a ranked step and a
    resolve a resolved lane (resolve_ops); its latency one resolve
    (resolve_us).  Over ltk also the bound with the search over all R run
    starts that the directory replaced (the *_old keys), and the resolve's
    dependent loads both ways (resolve_loads: the directory's entry, its
    `iters` probes and the ltk load)."""
    from rowbowt_tpu_torch.ops import cuda_lf

    b = k1_bound([work], B, L, tx.A, 64, lat["random_cycle"],
                 table_bytes=tw["resolve_bytes"], out_bytes=B * 4)
    base_ops, base_latency = b["ops"], b["latency_bound_us"]
    ltk = cuda_lf.toehold_route(tx) == "ltk"
    for tag, old in (("", False), ("_old", True)):
        if old and not ltk:
            break
        ops = base_ops + TOE_STEP_OPS * work["ranked_steps"] + tw["resolved_lanes"] * (
            resolve_ops(tx, old) if ltk else 1)
        latency = base_latency + (resolve_us(tx.R, lat, old) if ltk else lat["random_cycle"])
        b.update({f"ops{tag}": ops, f"ops_bound_us{tag}": ops / INT_OPS_PER_S * 1e6,
                  f"latency_bound_us{tag}": latency,
                  f"bound_us{tag}": max(b["byte_bound_us"], latency),
                  f"bound_by{tag}": "bytes" if b["byte_bound_us"] >= latency else "latency"})
    if ltk:
        b.update(resolve_loads=2 + tx.rs_bs[1], resolve_loads_old=search_levels(tx.R) + 1,
                 rs_bs=list(tx.rs_bs))
    b.update(tw)
    return b


def stage_turns(before, after) -> tuple[float, float]:
    """(before s, after s): host-clock seconds of each call, closed by a
    synchronize, in turns (before, after, after, before), means of two."""
    import torch

    def run(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    b, a = [run(before)], [run(after), run(after)]
    b.append(run(before))
    return sum(b) / 2, sum(a) / 2


def toehold_times(device, path: str, fastq: str, loc: dict, k1: dict) -> dict:
    """K1's toehold launch on the raw index at `path` (ltk) over rbt_align
    -s's batches of `fastq`: equal to its plain twin (the torch loop of
    lf_step_w_loc) and, on each batch's real lanes, to dense chr's toeholds
    (phase locate), one launch a batch; the search + toehold stage over all
    batches with the torch loop (the parent's stage) and with the kernel, in
    turns; then on the first batch the call ms in turns with the twin, the
    launch alone (CUDA events just around it) beside K1's count instance
    alone on the same batch from the full range (`count_device_us`, the same
    build), one profiler trace, the work, the bound and its share.  Then
    the walk of rbt_align -s on this index (no kval: the chain over its
    phi1) on every batch's real lanes (walk_times, `walk`)."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    host, tx = load_dense(device, path, "-s")
    check(cuda_lf.toehold_route(tx) == "ltk", f"raw chr's route {cuda_lf.toehold_route(tx)}")
    dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device), len(names))
           for names, qc, lens in iter_query_batches(host, fastq, BATCH)]
    reset_counts()
    err, ranges = 0, []
    for (q, ln, nr), want in zip(dev, loc["ranges"]):
        got = cuda_lf.find_ranges_toehold(tx, q, ln)
        plain = cuda_lf.find_ranges_toehold_plain(tx, q, ln)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, plain), max_abs_err([t[:nr] for t in got], want))
        ranges.append(tuple(t[:nr] for t in got))
    check(err == 0, f"the toehold launch at raw chr != its twin or dense chr: max |err| {err}")
    check(route_counts() == launch_counts(toe=len(dev)), f"routes {route_counts()}")
    before_s, after_s = stage_turns(
        lambda: [cuda_lf.find_ranges_toehold_plain(tx, q, ln) for q, ln, _ in dev],
        lambda: [cuda_lf.find_ranges_toehold(tx, q, ln) for q, ln, _ in dev])
    q, ln, _ = dev[0]
    ln = ln.to(torch.int32)
    B, L = q.shape
    call_ms, plain_ms = in_turns([lambda: cuda_lf.find_ranges_toehold_plain(tx, q, ln)],
                                 [lambda: cuda_lf.find_ranges_toehold(tx, q, ln)], 2, 20)
    device_us = kernel_event_us([around(lambda: cuda_lf.launch_toehold(tx, q, ln))], 20)
    count_us = kernel_event_us([around(lambda: cuda_lf.launch_k1(tx, q, ln, use_ftab=False))],
                               20)
    profiled_us = profiled_kernel_us([lambda: cuda_lf.launch_toehold(tx, q, ln)], 5,
                                     ("lf_count_kernel",))["lf_count_kernel"]
    work = k1_work(tx, q, ln, use_ftab=False)
    b = toehold_bound(work, toehold_work(tx, q, ln), B, L, tx, k1["us_per_dependent_step"])
    out = dict(batches=len(dev), lanes=B, L=L, route="ltk", max_abs_err=err,
               launches=len(dev), stage_before_s=before_s, stage_after_s=after_s,
               call_ms=call_ms, plain_ms=plain_ms, device_us=device_us,
               count_device_us=count_us, over_count=device_us / count_us,
               step_loops={name: k1_loop(cuda_lf._SYMS_PER_ROW[cuda_lf.row_layout(tx)], toe)
                           for name, toe in (("count", False), ("toehold", True))},
               profiled_us=profiled_us, bound=b,
               bound_ms=max(b["byte_bound_us"], b["ops_bound_us"]) / 1e3,
               bound_by="bytes" if b["byte_bound_us"] >= b["ops_bound_us"] else "operations",
               share=b["bound_us"] / device_us, share_old=b["bound_us_old"] / device_us,
               walk=walk_times(device, tx, ranges, "phi1",
                               k1["us_per_dependent_step"]["random_cycle"]),
               wall_s=time.perf_counter() - t0)
    del tx, dev
    torch.cuda.empty_cache()
    return out


def seeding_runs(device, path: str, chr_: dict, dense: dict, routes: dict) -> dict:
    """The seeding CLIs of phases greedy to locs on the index at `path`, with
    their reads and flags: rbt_markers -f, --heuristic (the strand skip on)
    and --lmem, and rbt_locs (`path`.midx.npz beside it), those of `routes`
    ({tag: LAUNCHES_SEED key}).  Each prints the dense index's lines (`dense`:
    {tag: text}) and launches the seeding kernel on its route once a batch
    (--heuristic also once a compacted second-strand batch), nothing else:
    required.  Per run the CLI's own seconds and stages, reads/s and the
    launches."""
    paths = chr_["paths"]
    n_batches = -(-N_GREEDY // GREEDY_BATCH)
    flags = {"-f": ("rbt_markers", paths["greedy.fq"], ["-f", "-b", str(GREEDY_BATCH)], N_GREEDY),
             "--heuristic": ("rbt_markers", paths["greedy.fq"],
                             [*HEURISTIC, "-b", str(GREEDY_BATCH)], N_GREEDY),
             "--lmem": ("rbt_markers", paths["lmem.fq"], ["--lmem", "-b", str(N_LMEM)], N_LMEM),
             "locs": ("rbt_locs", paths["greedy.fq"], ["-b", str(GREEDY_BATCH)], N_GREEDY)}
    res = {}
    for tag, route in routes.items():
        tool, fastq, argv, n = flags[tag]
        argv = [path, fastq, *argv, "--device", str(device)]
        reset_counts()
        if tag == "--heuristic":
            (cli, out_text, _), second = heuristic_run(argv, paths["out.txt"])
        else:
            (cli, out_text, _), second = run_seeding_cli(tool, argv, paths["out.txt"]), []
        launches = seed_counts()
        want = seed_launches(**{route: 1 if tag == "--lmem" else n_batches + len(second)})
        check(launches == want, f"{tool} {tag} on {path}: {launches}, not {want}")
        check(out_text == dense[tag], f"{tool} {tag} on {path} != the dense index's lines")
        res[tag] = dict(cli, reads=n, cli_reads_per_s=n / cli["cli_query_s"],
                        seed_launches=launches, second_strand_batches=second)
    return res


def seeding_tx(device, path: str):
    """(RbtIndex, TorchIndex) of the index at `path` as rbt_markers and
    rbt_locs load it (SA samples and the ftab; the markers stay on the
    host, which the machines do not read)."""
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex

    idx = RbtIndex.load(path, with_sa=True, with_ma=False, with_dl=False, with_ft=True)
    return idx, TorchIndex.from_index(idx, device)


def raw_chr_build(prefix: str, out_dir: str, log: str) -> None:
    """Phase raw_chr's host build, in a child process of its own (started
    after build_cli, so that it overlaps the card's phases and its peak RSS
    is its own): `rbt_build_torch <prefix> -s -m -l -o out_dir`; its seconds,
    stderr and the child's peak RSS in out_dir + ".json"."""
    build_s, _, err = run_main("rbt_build", [prefix, "-s", "-m", "-l", "-o", out_dir], log)
    with open(out_dir + ".json", "w") as f:
        json.dump(dict(build_s=build_s, stderr=err,
                       peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6), f)


def start_raw_chr_build(chr_: dict) -> dict:
    """The chr index written as the reference's raw files (.bwt/.ssa/.esa/
    .docs, and .mab through write_mab) in this process, then raw_chr_build
    in a spawned child process; phase_raw_chr joins it."""
    from rowbowt_tpu_torch.construct.rawio import write_raw
    from rowbowt_tpu_torch.construct.sdslwrite import write_mab

    idx = chr_["idx"]
    d = os.path.join(WORK, "raw")
    os.makedirs(d, exist_ok=True)
    prefix, out_dir = os.path.join(d, "chr"), os.path.join(WORK, "raw_idx")
    t = time.perf_counter()
    write_raw(idx, prefix)
    write_mab(prefix + ".mab", idx.ma_row, idx.ma_val, idx.ma_wsize, idx.n)
    write_s = time.perf_counter() - t
    proc = spawn_child(raw_chr_build, prefix, out_dir, os.path.join(WORK, "raw_build.txt"))
    return dict(proc=proc, dir=d, prefix=prefix, out_dir=out_dir, write_s=write_s,
                raw_files_gb=sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e9)


def phase_raw_chr(device, card: dict, chr_: dict, count: dict, loc: dict,
                  markers: dict, k1: dict, seeding: dict, child: dict) -> dict:
    """Phase raw_chr: the chr index written as the reference's raw files
    (.bwt/.ssa/.esa/.docs, and .mab through write_mab) and built from the
    prefix by `rbt_build_torch <prefix> -s -m -l` (start_raw_chr_build's
    child, joined here): fused-block rows and the
    predecessor-built phi1, no kval, and (n > OCC1_MAX_N) no occ1/tk1, so
    -s carries the toehold step by step over ltk.  rbt_align count, -s and
    -m print the dense index's lines (phases main, locate, markers); K1
    launches once a batch of count and -m, its toehold launch once a batch
    of -s, and nothing runs the torch loop.  Build seconds and peak RSS;
    each run's load and query seconds and reads/s, and the toehold launch
    against the torch loop (toehold_times).  Then
    rbt_locs (`seeding`: phase locs' lines) prints the dense index's lines
    with the sampled machine's per-step toehold over the fused rows and ltk
    launched once a batch (seeding_runs), and that machine is timed on one
    batch against its plain twin (seeds_times)."""
    from rowbowt_tpu_torch.index import _ARRS_NAME

    idx, paths = chr_["idx"], chr_["paths"]
    d, prefix, out_dir = child["dir"], child["prefix"], child["out_dir"]
    t = time.perf_counter()
    child["proc"].join()
    wait_s = time.perf_counter() - t
    check(child["proc"].exitcode == 0, f"raw_chr's build exited {child['proc'].exitcode}")
    with open(out_dir + ".json") as f:
        built = json.load(f)
    build_s, err = built["build_s"], built["stderr"]
    check(f"constructing from raw {prefix}.bwt" in err.splitlines(), "not a raw-prefix build")
    z = np.load(os.path.join(out_dir, _ARRS_NAME))
    check({"fblock", "phi1", "ltk", "ma_start1", "samples_last"} <= set(z.files)
          and not {"kval", "occ1", "tk1"} & set(z.files), f"raw build's tables: {z.files}")
    check(np.array_equal(z["phi1"], idx.phi1), "raw build's phi1 != the full-SA build's")
    check(np.array_equal(z["ma_start1"], idx.ma_start1), "raw build's ma_start1 differs")
    del z
    n_loc = -(-N_LOCATE // BATCH)
    runs = align_runs(device, out_dir, [
        ("count", paths["reads.fq"], [], "".join(count["lines"]), N_READS),
        ("-s", paths["locate.fq"], ["-s"], loc["out_text"], N_LOCATE),
        ("-m", paths["locate.fq"], ["-m"], markers["out_text"], N_LOCATE)], paths["out.txt"])
    check(runs["count"]["launches"] == launch_counts(k1=N_READS // BATCH)
          and runs["-m"]["launches"] == launch_counts(k1=n_loc)
          and runs["-s"]["launches"] == launch_counts(toe=n_loc),
          f"raw chr routes: {({k: v['launches'] for k, v in runs.items()})}")
    # raw chr keeps phi1 (built from the run samples): the walk kernel
    check(runs["-s"]["walks"] == dict(walk=n_loc, kval=0),
          f"raw chr -s walks: {runs['-s']['walks']}")
    toehold = toehold_times(device, out_dir, paths["locate.fq"], loc, k1)
    shutil.copy(paths["idx"] + ".midx.npz", out_dir + ".midx.npz")
    runs.update(seeding_runs(device, out_dir, chr_, seeding, {"locs": "sample_toe"}))
    host, tx = seeding_tx(device, out_dir)
    seeds = seeds_times(tx, seed_batches(device, host, tx, paths, ("sample",)),
                        k1["us_per_dependent_step"])
    del host, tx
    res = dict(n=idx.n, raw_files_gb=child["raw_files_gb"], raw_write_s=child["write_s"],
               build_s=build_s, build_wait_s=wait_s, peak_rss_gb=built["peak_rss_gb"],
               index_gb=dir_gb(out_dir), runs=runs, toehold=toehold, seeds_times=seeds,
               dense_reads_per_s={"count": count["cli_reads_per_s"],
                                  "-s": loc["cli_reads_per_s"],
                                  "-m": markers["cli_reads_per_s"]},
               card=card["nvidia_smi"])
    emit("raw_chr", **res)
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.remove(out_dir + ".midx.npz")
    return res


L2_BYTES = 50 * 2 ** 20  # H100 SXM L2 (NVIDIA data sheet), where torch does not report it


def l2_bytes() -> int:
    """The card's L2 in bytes as torch reports it, else L2_BYTES."""
    import torch

    return int(getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) or L2_BYTES)


def step_tables(tx, policy: str) -> dict:
    """{table: bytes} that the `policy` step of the tables kernels reads
    from: bwt4 and occ_blk_flat (dense), occ1_flat (occ1), and the bucket
    directory with the run records or run_start, run_head and occ_flat
    (runs)."""
    arr = tx.arrays
    names = {"dense": ("bwt4", "occ_blk_flat"), "occ1": ("occ1_flat",),
             "runs": ("rs_off", "run_rec") if "run_rec" in arr else
             ("rs_off", "run_start", "run_head", "occ_flat")}[policy]
    return {k: arr[k].numel() * arr[k].element_size() for k in names if k in arr}


def tables_step_us(tx, policy: str, lat: dict, old: bool = False) -> float:
    """A lower bound on the latency of one step of the tables kernel: for
    the run-space policy the shortest chain a step needs: the bucket
    directory's entry and one run_start probe at the L2's dependent-load
    latency (P3 over the probe tool's 4 MB table; the directory is a few MB)
    and then the occ_flat (or run record) load at a random cycle's latency
    (R-sized tables, beyond the L2 at chr), or where shorter (R below
    2^(L1_LEVELS + 1)) the old bound; with `old`, the bound of the binary
    search over every run_start that the directory replaced: its levels
    below the first L1_LEVELS at the L2's latency, then the occ_flat load.
    For the dense and occ1 policies one load: at the L2's latency where
    the policy's tables (step_tables) fit the card's L2, at a random
    cycle's latency where they exceed it (occ1 is A * (n + 1) entries)."""
    if policy == "runs":
        search = (max(search_levels(tx.R) - L1_LEVELS, 0) * lat["tool_table"]
                  + lat["random_cycle"])
        return search if old else min(search, 2 * lat["tool_table"] + lat["random_cycle"])
    if sum(step_tables(tx, policy).values()) > l2_bytes():
        return lat["random_cycle"]
    return lat["tool_table"]


def tables_work(tx, q, ln, use_ftab: bool, toehold: bool) -> dict:
    """What one batch asks of the tables kernel, by a replay of the plain
    loop (ops/cuda_lf.lf_start, then the steps of ops/rank.py): the codes
    (min(length, L) a lane), active and ranked lane-steps, the longest
    lane's steps, the ftab entries read, and the distinct table entries the
    ranks need and their bytes: run_start and run_head at the run of lo and
    of hi + 1 (and, for the toehold, of hi) and occ_flat at (c, run) for the
    run-space policy; occ_blk_flat at (c, block) and the 64 B blocks of
    bwt4 for the dense one; occ1 at (c, lo), (c, hi + 1) (and (c, hi)) for
    occ1.  For the toehold also the lanes that resolve from a table and
    the entries they read (toehold_work's count, over run_head;
    ltk_resolve_bytes)."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.ops import rank as R

    B, L = q.shape
    n, dt = tx.n, tx.idx_dtype
    policy = cuda_lf.table_policy(tx)
    arr = tx.arrays
    if toehold:
        lo = torch.zeros(B, dtype=dt, device=q.device)
        hi = torch.full((B,), n - 1, dtype=dt, device=q.device)
        startj = torch.zeros_like(lo)
    else:
        lo, hi, startj = cuda_lf.lf_start(tx, q, ln, use_ftab)
    k = tx.ftab_k if use_ftab and not toehold and tx.has_ftab and L >= tx.ftab_k > 0 else 0
    ftab_entries = 0
    if k:
        kc = R.kmer_codes(tx, q[:, L - k:])
        ftab_entries = int(torch.unique(kc[(kc >= 0) & (ln >= k)]).numel())
    lengths = ln.to(dt)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    steps = torch.zeros(B, dtype=torch.int64, device=q.device)
    tc = torch.full((B,), -1, dtype=torch.int64, device=q.device)
    thi = torch.zeros(B, dtype=torch.int64, device=q.device)
    ranked = 0
    ranks = []
    step = R.lf_step_auto(tx)
    for j in range(L):
        c = q[:, L - 1 - j].to(dt)
        active = (~done) & (j >= startj) & (j < lengths)
        steps += active
        rk = active & (c >= 0) & (c < tx.A)
        ranked += int(rk.sum())
        c64 = c.long()
        ranks.append((c64[rk], lo.long()[rk], (hi + 1).long()[rk],
                      hi.long()[rk] if toehold else None))
        nlo, nhi = step(tx, lo, hi, c)
        if toehold:
            # BWT[hi] == c, from the policy's own tables
            if policy == "runs":
                trivial = arr["run_head"][R.run_of(tx, hi).long()] == c
            elif policy == "dense":
                w = arr["bwt4"][(hi >> 3).long()].long() & 0xFFFFFFFF
                trivial = ((w >> (4 * (hi & 7).long())) & 15) == c64
            else:
                row = c64.clamp(min=0) * (n + 1) + hi.long()
                trivial = arr["occ1_flat"][row + 1] - arr["occ1_flat"][row] == 1
            nontrivial = active & (nlo <= nhi) & ~trivial
            tc = torch.where(nontrivial, c64, tc)
            thi = torch.where(nontrivial, hi.long(), thi)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    out = dict(policy=policy, codes=int(lengths.clamp(max=L).sum()),
               lane_steps=int(steps.sum()), ranked_steps=ranked,
               longest_lane_steps=int(steps.max()) if B else 0, ftab_entries=ftab_entries,
               **tables_entries(tx, policy, ranks))
    if toehold:
        res = (hi >= lo) & (tc >= 0)
        tcr, thr = tc[res], thi[res]
        if cuda_lf.toehold_route(tx) == "tk1":
            entries = torch.unique(tcr * n + thr).numel()
            nbytes = entries * arr["tk1_flat"].element_size()
        else:
            entries, nbytes = ltk_resolve_bytes(tx, tcr, thr)
        out.update(resolved_lanes=int(res.sum()), resolve_entries=int(entries),
                   resolve_bytes=int(nbytes))
    return out


def tables_bound(work: dict, B: int, tx, toehold: bool, lat: dict | None) -> dict:
    """The tables kernel's bound on one batch from its work: bytes (each
    input byte read once: the reads' int32 codes, the lengths, F, the
    distinct ftab entries and table entries, the resolve's entries; each
    output written once: lo, hi and for the toehold k) over the card's
    memory rate; operations (the run-space ranks' directory searches,
    tables_entries' search_ops, and a resolve over ltk, resolve_ops, or one
    load of tk1 for each resolving lane; the dense policy's 16-word nibble
    count, RANK_OPS; 8 for a step's own arithmetic) over its int32 rate;
    the bytes of the tables the step reads (step_tables) beside the card's
    L2; with `lat` (phase k1's latencies) the longest lane's steps times
    tables_step_us, plus one resolve (resolve_us over ltk, a random
    cycle's latency over tk1) for the toehold; for the run-space policy and
    the resolve over ltk also the same with the searches over all R run
    starts that the directories replaced (the *_old keys).  bound_ms is
    the larger of the byte and operation times; bound_us the larger of the
    byte and latency times."""
    from rowbowt_tpu_torch.ops import cuda_lf

    lane = tx.arrays["F"].element_size()
    outs = 3 if toehold else 2
    nbytes = (work["codes"] * 4 + B * 4 + (tx.A + 1) * lane + work["ftab_entries"] * 2 * lane
              + work["table_bytes"] + work.get("resolve_bytes", 0) + outs * B * lane)
    ltk = toehold and cuda_lf.toehold_route(tx) == "ltk"
    per_rank = {"runs": 0, "dense": RANK_OPS, "occ1": 1}[work["policy"]]
    ops = ((2 + toehold) * per_rank * work["ranked_steps"] + work["search_ops"]
           + 8 * work["lane_steps"])
    if toehold:
        ops += work["resolved_lanes"] * (resolve_ops(tx) if ltk else 1)
    byte_us = nbytes / HBM_BYTES_PER_S * 1e6
    ops_us = ops / INT_OPS_PER_S * 1e6
    b = dict(bytes=nbytes, byte_bound_us=byte_us, ops=ops, ops_bound_us=ops_us,
             bound_ms=max(byte_us, ops_us) / 1e3,
             bound_by="bytes" if byte_us >= ops_us else "operations",
             step_tables=step_tables(tx, work["policy"]), l2_bytes=l2_bytes())
    if ltk:
        b.update(resolve_loads=2 + tx.rs_bs[1], resolve_loads_old=search_levels(tx.R) + 1,
                 rs_bs=list(tx.rs_bs))
    if lat is not None:
        for tag, old in (("", False), ("_old", True)):
            if old and work["policy"] != "runs" and not ltk:
                break
            resolve = (resolve_us(tx.R, lat, old) if ltk else
                       lat["random_cycle"] if toehold else 0.0)
            step_us = tables_step_us(tx, work["policy"], lat, old)
            latency = work["longest_lane_steps"] * step_us + resolve
            b.update({f"step_us{tag}": step_us, f"latency_bound_us{tag}": latency,
                      f"bound_us{tag}": max(byte_us, latency),
                      f"bound_us_by{tag}": "bytes" if byte_us >= latency else "latency"})
    return b


def tables_times(device, tx, batches: list, toehold: bool, lat: dict | None,
                 stage: bool = True) -> dict:
    """The tables kernel over tx's policy on the batches [(q, ln)] (count
    without the ftab start, as rbt_align loads an index, or the toehold):
    equal to its plain twin on every batch (max |err| 0), one launch a
    batch; with `stage`, the search over all batches with the plain twin
    (the torch loop the parent ran on the card) and with the kernel, in
    turns; on the first batch the call ms in turns with the twin, the
    launch alone (CUDA events just around it), one profiler trace, the
    work (tables_work), the bound (tables_bound) and its share."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    policy = cuda_lf.table_policy(tx)
    if toehold:
        kern = lambda q, ln: cuda_lf.find_ranges_toehold(tx, q, ln)  # noqa: E731
        plain = lambda q, ln: cuda_lf.find_ranges_toehold_plain(tx, q, ln)  # noqa: E731
    else:
        kern = lambda q, ln: cuda_lf.find_ranges(tx, q, ln, use_ftab=False)  # noqa: E731
        plain = lambda q, ln: cuda_lf.find_ranges_plain(tx, q, ln, use_ftab=False)  # noqa: E731
    counts = cuda_lf.LAUNCHES_TAB_TOE if toehold else cuda_lf.LAUNCHES_TAB
    launches0, err = counts[policy], 0
    for q, ln in batches:
        got, want = kern(q, ln), plain(q, ln)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
    launches = counts[policy] - launches0
    check(err == 0, f"the {policy} tables kernel (toehold={toehold}) != its plain twin: "
          f"max |err| {err}")
    check(launches == len(batches), f"{launches} {policy} launches for {len(batches)} batches")
    out = dict(policy=policy, toehold=toehold, batches=len(batches), max_abs_err=err,
               launches=launches)
    if stage:
        out["stage_before_s"], out["stage_after_s"] = stage_turns(
            lambda: [plain(q, ln) for q, ln in batches],
            lambda: [kern(q, ln) for q, ln in batches])
    q, ln = batches[0]
    ln = ln.to(torch.int32)
    B, L = q.shape
    out["call_ms"], out["plain_ms"] = in_turns([lambda: plain(q, ln)], [lambda: kern(q, ln)],
                                               2, 20)
    launch = lambda: cuda_lf.launch_tables(tx, q, ln, use_ftab=False, toehold=toehold)  # noqa
    out["device_us"] = kernel_event_us([around(launch)], 20)
    out["profiled_us"] = profiled_kernel_us([launch], 5, ("lf_tables_kernel",))[
        "lf_tables_kernel"]
    out["work"] = tables_work(tx, q, ln, use_ftab=False, toehold=toehold)
    b = tables_bound(out["work"], B, tx, toehold, lat)
    out.update(lanes=B, L=L, bound=b, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               share=b["bound_us"] / out["device_us"] if "bound_us" in b else None,
               share_old=b["bound_us_old"] / out["device_us"] if "bound_us_old" in b else None)
    return out


RUN_SPANS = (6, 7, 8)  # directory spans (log2 positions a bucket) timed at chr


def run_variants(tx) -> list:
    """[(tag, view)] that parity holds to one plain twin over the run-space
    tables: tx as loaded (with the run records where it has them), tx
    without the records (the step of an index of more than 6 codes or int64
    lanes), and tx over a directory of one bucket (shift 62: every run in
    it, the largest iters)."""
    import dataclasses

    rec = "run_rec" in tx.arrays
    out = [("records" if rec else "no records", tx)]
    if rec:
        out.append(("no records", dataclasses.replace(
            tx, arrays={k: v for k, v in tx.arrays.items() if k != "run_rec"})))
    one = tx.with_run_tables(62)
    out.append((f"shift=62,iters={one.rs_bs[1]}", one))
    return out


def resolve_variants(tx) -> list:
    """[(tag, view)] that parity holds to one plain twin where the toehold
    resolves over ltk outside the run-space step: tx as loaded, and tx over
    directories of 2-position buckets (most of them empty) and of one
    bucket (shift 62: a binary search over every run start)."""
    out = [(f"loaded,shift={tx.rs_bs[0]},iters={tx.rs_bs[1]}", tx)]
    for shift in (1, 62):
        view = tx.with_run_tables(shift)
        out.append((f"shift={shift},iters={view.rs_bs[1]}", view))
    return out


def step_paths(tx, batches: dict) -> dict:
    """{path: fn()} of the run-space tables kernels on one batch of each
    path of batches ({"count" and "toehold": (q, ln); "greedy", "lmem",
    "sample": (q, ln, cfg)}): the count search without the ftab start (as
    rbt_align loads an index), the toehold search, and the machines; fn()
    launches the path once and returns its outputs."""
    from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds

    out = {}
    for path, b in batches.items():
        if path in ("count", "toehold"):
            q, ln = b
            out[path] = (lambda q=q, ln=ln, t=path == "toehold":
                         cuda_lf.launch_tables(tx, q, ln, use_ftab=False, toehold=t))
        else:
            q, ln, cfg = b
            out[path] = (lambda q=q, ln=ln, cfg=cfg, m=path:
                         cuda_seeds.launch_machine(tx, m, q, ln, **cfg))
    return out


def outputs_digest(out) -> str:
    """sha256 of a launch's outputs (a tuple of tensors or a dict of them,
    in key order): what two launches of a kernel compare."""
    import hashlib

    ts = [out[k] for k in sorted(out)] if isinstance(out, dict) else list(out)
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def step_batches(device, host, paths: dict, seeds: dict) -> dict:
    """One batch of each run-space path at chr (step_paths): the first
    count batch of rbt_align, the first -s batch, and the machines' of
    `seeds` (seed_batches)."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches

    out = {}
    for path, fastq in (("count", paths["reads.fq"]), ("toehold", paths["locate.fq"])):
        _, qc, lens = next(iter(iter_query_batches(host, fastq, BATCH)))
        out[path] = (torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
    for mode, (q, ln, cfg) in seeds.items():
        out[mode] = (q, ln, {k: v for k, v in cfg.items() if k != "record"})
    return out


def run_span_times(device, host, tx, paths: dict, seeds: dict) -> dict:
    """The run-space tables as rbt_markers and rbt_locs load them at
    nodense_chr (tx, from seeding_tx): what the load built (TorchIndex.
    with_run_tables: seconds, bytes, the directory's entries, shift and
    iters, whether the run records were built); then the tables kernel and
    the seeding machines over directories of each span of RUN_SPANS, on one
    batch of each path (step_batches: count, toehold, and the machines'
    batches `seeds`), each equal to the loaded span's outputs, each path's
    device µs alone (CUDA events just around the launch, 10 passes)."""
    res = dict(tables=dict(build_s=tx.run_tables_s, bytes=tx.run_tables_bytes,
                           entries=int(tx.arrays["rs_off"].numel()), shift=tx.rs_bs[0],
                           iters=tx.rs_bs[1], records="run_rec" in tx.arrays))
    batches = step_batches(device, host, paths, seeds)
    want = {path: outputs_digest(fn()) for path, fn in step_paths(tx, batches).items()}
    res["spans_us"] = {}
    for shift in RUN_SPANS:
        view = tx.with_run_tables(shift)
        tag = f"shift={shift},iters={view.rs_bs[1]}"
        res["spans_us"][tag] = {}
        for path, fn in step_paths(view, batches).items():
            check(outputs_digest(fn()) == want[path], f"the {path} outputs at {tag} != the "
                  f"loaded directory's")
            res["spans_us"][tag][path] = kernel_event_us([around(fn)], 10)
        del view
    return res


def phase_nodense_chr(device, card: dict, chr_: dict, count: dict, loc: dict,
                      markers: dict, k1: dict, seeding: dict) -> dict:
    """Phase nodense_chr: the chr index without fblock, kval, phi1 and
    ma_start1 (what `rbt_build_torch --no-dense` writes; phase build_small
    holds the two equal on the small panel).  rbt_align count and -m launch
    the tables kernel's run-space count search once a batch, -s its toehold
    search once a batch and the walk kernel over the predecessor search
    once a batch (no other route: required); each prints the dense index's
    lines.  Reads/s beside the dense index's; the tables
    kernel's count search on the count batches and its toehold search on
    the -s batches against their plain twins (the torch loops of lf_step
    and lf_step_w_loc that the parent ran on the card), each stage before
    and after in turns and its first batch timed and bounded
    (tables_times); the walk kernel over the predecessor search on the -s
    batches' lanes against the torch walk (walk_times).  Then the seeding
    CLIs of phases greedy to locs (`seeding`: their lines): rbt_markers -f,
    --heuristic and --lmem launch the seeding kernel's greedy and L-MEM
    machines over the run-space tables, and rbt_locs its sampled machine
    with the per-step toehold over them and ltk, once a batch (required),
    each printing the dense index's lines (seeding_runs); each machine timed
    on one batch of its CLI's path against its plain twin (seeds_times).
    Each CLI's load reports the run-space tables it built (required).
    Last, the directory's spans side by side on one batch of each of those
    paths (run_span_times)."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches

    idx, paths = chr_["idx"], chr_["paths"]
    out_dir = os.path.join(WORK, "nodense_idx")
    t = time.perf_counter()
    dataclasses.replace(idx, fblock=None, kval=None, phi1=None, ma_start1=None).save(out_dir)
    save_s = time.perf_counter() - t
    n_count, n_loc = N_READS // BATCH, -(-N_LOCATE // BATCH)
    runs = align_runs(device, out_dir, [
        ("count", paths["reads.fq"], [], "".join(count["lines"]), N_READS),
        ("-s", paths["locate.fq"], ["-s"], loc["out_text"], N_LOCATE),
        ("-m", paths["locate.fq"], ["-m"], markers["out_text"], N_LOCATE)], paths["out.txt"])
    check(runs["count"]["launches"] == launch_counts(tab_runs=n_count)
          and runs["-m"]["launches"] == launch_counts(tab_runs=n_loc)
          and runs["-s"]["launches"] == launch_counts(tab_toe_runs=n_loc),
          f"no-dense chr routes: {({k: v['launches'] for k, v in runs.items()})}")
    # no phi1: the walk kernel over the predecessor search
    check(runs["-s"]["walks"] == dict(walk=n_loc, kval=0),
          f"no-dense chr -s walks: {runs['-s']['walks']}")
    lat = k1["us_per_dependent_step"]
    tables = {}
    host, tx = load_dense(device, out_dir, "-s")  # the run-space tables and the toehold's
    for name, fastq in (("count", paths["reads.fq"]), ("toehold", paths["locate.fq"])):
        batches = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
                   for _, qc, lens in iter_query_batches(host, fastq, BATCH)]
        tables[name] = tables_times(device, tx, batches, name == "toehold", lat)
    resident = {k: v.numel() * v.element_size() / 1e6 for k, v in tx.arrays.items()}
    walk = walk_times(device, tx, loc["ranges"], "pred", pred_step_us(tx.R, lat),
                      pred_step_us(tx.R, lat, old=True))
    del host, tx, batches
    torch.cuda.empty_cache()
    shutil.copy(paths["idx"] + ".midx.npz", out_dir + ".midx.npz")
    runs.update(seeding_runs(device, out_dir, chr_, seeding, {
        "-f": "greedy_runs", "--heuristic": "greedy_runs", "--lmem": "lmem_runs",
        "locs": "sample_toe_runs"}))
    check(all(r["cli_run_tables"] for r in runs.values()),
          f"a no-dense chr load reported no run tables: "
          f"{({k: r['cli_run_tables'] for k, r in runs.items()})}")
    host, tx = seeding_tx(device, out_dir)
    batches = seed_batches(device, host, tx, paths)
    seeds = seeds_times(tx, batches, lat)
    spans = run_span_times(device, host, tx, paths, batches)
    del host, tx, batches
    torch.cuda.empty_cache()
    res = dict(n=idx.n, R=idx.R, save_s=save_s, index_gb=dir_gb(out_dir), runs=runs,
               resident_mb_locate=resident, tables=tables, walk=walk, seeds_times=seeds,
               run_spans=spans,
               dense_reads_per_s={"count": count["cli_reads_per_s"],
                                  "-s": loc["cli_reads_per_s"],
                                  "-m": markers["cli_reads_per_s"]},
               card=card["nvidia_smi"])
    emit("nodense_chr", **res)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.remove(out_dir + ".midx.npz")
    return res


N_SMALL_READS = 16_384  # reads of phase build_small's queries: one batch
N_SMALL_SEEDING = 8_192  # of them through rbt_markers -f and rbt_locs
N_SMALL_CPU = 2_048  # of them also run with --device cpu on the index of 13 codes
N_IUPAC = 20_000  # IUPAC codes put into the small reference for that index
N_IUPAC_READS = 2_000  # reads of that index's batch that hold an IUPAC code


def iupac_reads(text: np.ndarray, rng, n: int) -> np.ndarray:
    """n windows of READ_LEN bytes of `text` that hold an IUPAC code and no
    separator: exact substrings, each with at least one code beyond ACGT."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    at = np.flatnonzero((text >= 65) & ~np.isin(text, acgt))
    out = []
    while len(out) < n:
        s = int(rng.choice(at)) - int(rng.integers(0, READ_LEN))
        w = text[max(s, 0):max(s, 0) + READ_LEN]
        if w.shape[0] == READ_LEN and (w >= 65).all():
            out.append(w)
    return np.stack(out)


def oracle_align_lines(idx, reads: np.ndarray) -> dict:
    """rbt_align's count, -s and -m lines for `reads` from the scalar oracle
    (engine/naive): the toehold search, every occurrence by the phi chain
    with its document, and the markers of the final range."""
    from rowbowt_tpu_torch.cli.rbt_align import NO_MARKERS
    from rowbowt_tpu_torch.engine import naive
    from rowbowt_tpu_torch.index import marker_allele, marker_pos

    out = {"count": [], "-s": [], "-m": []}
    for i, r in enumerate(reads):
        (s, e), k = naive.find_range_w_toehold(idx, idx.alpha.encode(r).astype(np.int64))
        line = f"r{i} ({s},{e}), count={e - s + 1 if e >= s else 0}\n"
        locs = naive.locate_range(idx, s, e, k, max_hits=idx.n)
        docs = [naive.resolve_offset(idx, x) for x in locs]
        v = naive.markers_at_range(idx, s, e) if e >= s else np.empty(0, np.int64)
        out["count"].append(line)
        out["-s"].append(line + "\tlocs: " + "".join(f"{x}/{dn}:{o} " for x, (dn, o)
                                                      in zip(locs, docs)) + "\n")
        out["-m"].append(line + "\tmarkers: " + ("".join(
            f"{p}/{a} " for p, a in zip(marker_pos(v).tolist(), marker_allele(v).tolist()))
            if v.size else NO_MARKERS) + "\n")
    return {k: "".join(v) for k, v in out.items()}


def same_lines(got: str, want: str, per_read: int) -> bool:
    """rbt_align's lines of two indexes of one text agree: each read's count
    line equal, its locs or markers line equal as a multiset (a BigIndex of
    the merge's generalized order lists a range's rows in another order)."""
    g, w = got.splitlines(), want.splitlines()
    return len(g) == len(w) and all(
        a == b if i % per_read == 0 else sorted(a.split()) == sorted(b.split())
        for i, (a, b) in enumerate(zip(g, w)))


def small_big_dirs(cfg, alpha, doc_names, d: str) -> dict:
    """The panel of `cfg` as two BigIndex directories under d, built as the
    pangenome builders build: "merge" (construct/merge.merge_construct with a
    uint32 SA, then BigIndex.from_codes, attach_locate and attach_markers, as
    tools/build_big_index.py) and "pfp" (construct/pfp.pfp_construct with the
    marker windows as probes, then assemble_bigindex and
    attach_markers_from_probes, as tools/build_giant_index.py), each with the
    document list.  Returns {route: {path, build_s, n, R, M}}."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.construct import pfp
    from rowbowt_tpu_torch.construct.merge import merge_construct, split_text_docs

    text, doc_starts, markers = panel(cfg)
    tpos = np.array([m.text_pos for m in markers], dtype=np.int64)
    packed = np.array([(m.seq << 48) | (m.pos << 8) | m.allele for m in markers], dtype=np.int64)
    parts = split_text_docs(text, doc_starts)
    del text
    out = {}
    for route in ("merge", "pfp"):
        t = time.perf_counter()
        if route == "merge":
            codes, sa, _ = merge_construct(parts, alpha=alpha, sa_dtype=np.uint32, prefetch=False)
            big = BigIndex.from_codes(codes, alpha)
            big.attach_locate(codes, sa)
            big.attach_markers(sa, tpos, packed, MA_WSIZE)
            del codes, sa
        else:
            res = pfp.pfp_construct(parts, w=MA_WSIZE, p=100,
                                    probe_pos=pfp.marker_window_positions(tpos, MA_WSIZE))
            big = pfp.assemble_bigindex(res, alpha, block=128)
            pfp.attach_markers_from_probes(big, res, tpos, packed, MA_WSIZE)
            del res
        big.doc_starts, big.doc_names = doc_starts, doc_names
        path = os.path.join(d, f"big_{route}")
        big.save(path)
        out[route] = dict(path=path, build_s=time.perf_counter() - t, n=big.n, R=big.R,
                          M=int(big.ma_row.shape[0]))
    return out


def phi_at_route(device, path: str, fastq: str, want: str, out_path: str,
                 lat: dict | None) -> dict:
    """rbt_align -s on the BigIndex directory at `path` with its phi rows
    withheld (BigIndex._phi_pack yields none, as above 2^31 breakpoints): the
    walk runs over the breakpoint table, one launch of the walk kernel's
    phi_at route a batch (required), and prints `want`, the dense index's
    lines.  Then the route timed on those batches against its plain twin
    (walk_times; a step's latency, with `lat`, the search's 2 + iters loads
    at the L2's latency: the small panel's tables fit the L2)."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold
    from rowbowt_tpu_torch.ops import cuda_phi

    real_pack, real_launch = BigIndex._phi_pack, cuda_phi.launch_walk
    routes = []

    def spy(tx, *a, **kw):
        routes.append(cuda_phi.walk_route(tx))
        return real_launch(tx, *a, **kw)

    BigIndex._phi_pack = lambda self: (None, None)
    cuda_phi.launch_walk = spy
    try:
        reset_counts()
        cli, got, _ = run_cli([path, fastq, "-s", "-b", str(BATCH), "--device", str(device)],
                              out_path)
        walks = walk_counts()
        big, tx = load_big(device, path, "-s")
    finally:
        BigIndex._phi_pack, cuda_phi.launch_walk = real_pack, real_launch
    check(got == want, "rbt_align -s over the breakpoint table != the dense index's lines")
    check(walks == dict(walk=1, kval=0) and routes == ["phi_at"],
          f"rbt_align -s over the breakpoint table: {walks}, routes {routes}")
    ranges = []
    for names, qc, lens in iter_query_batches(big, fastq, BATCH):
        q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
        ranges.append(tuple(t[:len(names)] for t in find_ranges_w_toehold(tx, q, ln)))
    step_us = phi_loads(tx, "phi_at") * lat["tool_table"] if lat else 0.0
    out = dict(walk_times(device, tx, ranges, "phi_at", step_us), cli=cli, launches=walks["walk"],
               pp_bs=list(tx.pp_bs), breakpoints=int(tx.arrays["pred_pos"].numel()))
    del big, tx, ranges
    torch.cuda.empty_cache()
    return out


def iupac_seeding(device, path: str, fq: dict, out_path: str) -> dict:
    """rbt_markers -f and rbt_locs on the index of 13 codes (its dense tables
    and kval): one launch a batch of the greedy and the sampled machine over
    the dense tables (required), the lines of the first N_SMALL_CPU reads
    equal to the --device cpu run's."""
    res = {}
    for tool, argv, route in (("rbt_markers", ["-f"], "greedy_dense"),
                              ("rbt_locs", [], "sample_dense")):
        reset_counts()
        cli, got, _ = run_seeding_cli(tool, [path, fq["iupac"], *argv, "-b", str(GREEDY_BATCH),
                                             "--device", str(device)], out_path)
        launches = seed_counts()
        check(launches == seed_launches(**{route: 1}),
              f"{tool} on the 13-code index: {launches}, not one {route} launch")
        _, cpu, _ = run_seeding_cli(tool, [path, fq["iupac_cpu"], *argv, "-b",
                                           str(N_SMALL_CPU), "--device", "cpu"], out_path)
        first = [ln for ln in got.splitlines(keepends=True) if read_no(ln) < N_SMALL_CPU]
        check(bool(first) and first == cpu.splitlines(keepends=True),
              f"{tool} on the 13-code index: the card's lines != --device cpu's")
        res[f"{tool}_iupac"] = dict(cli, reads=N_SMALL_READS,
                                    cli_reads_per_s=N_SMALL_READS / cli["cli_query_s"],
                                    seed_launches=launches)
    return res


def occ1_seeding_route(device, raw, reads: np.ndarray) -> dict:
    """The seeding engines on the raw index without its fused rows (occ1 +
    tk1, no kval): markers_greedy_seeding and seeds_greedy_w_sample launch
    the greedy machine and the sampled machine with its per-step toehold
    over the occ1 tables once each (required), and give what they give on
    the same index with its rows (the rows' greedy and TOE launches)."""
    import torch

    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.seeds import markers_greedy_seeding, seeds_greedy_w_sample

    qc = torch.from_numpy(np.stack([raw.alpha.encode(r).astype(np.int32)
                                    for r in reads[:GREEDY_BATCH]])).to(device)
    ln = torch.full((qc.shape[0],), READ_LEN, dtype=torch.int32, device=device)
    out, counts = {}, {}
    for name, drop in (("occ1", True), ("rows", False)):
        tx = TorchIndex.from_index(raw, device)
        if drop:
            del tx.arrays["fblock64"]
        reset_counts()
        out[name] = (markers_greedy_seeding(tx, qc, ln, wsize=MA_WSIZE, max_range=1000),
                     seeds_greedy_w_sample(tx, qc, ln, min_length=19))
        torch.cuda.synchronize()
        counts[name] = seed_counts()
        del tx
    check(counts["occ1"] == seed_launches(greedy_occ1=1, sample_toe_occ1=1)
          and counts["rows"] == seed_launches(greedy=1, sample_toe=1),
          f"the occ1 seeding route: {counts}")
    e = max(max_abs_err(a, b) for a, b in zip(out["occ1"], out["rows"]))
    check(e == 0, f"the seeding engines over occ1 != over the rows: max |err| {e}")
    return dict(launches=counts, max_abs_err=e)


def seeding_small_times(device, iupac_path: str, raw, fq: dict, reads: np.ndarray,
                        lat: dict | None) -> dict:
    """The dense and occ1 seeding instances timed (seeds_times) on one batch
    of their paths: the greedy and sampled machines over the 13-code index's
    dense tables (rbt_markers -f's and rbt_locs' batches of its reads), and
    over the raw index's occ1 without its rows (the greedy machine from the
    ftab, the sampled machine with its per-step toehold over tk1)."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex

    host, tx = seeding_tx(device, iupac_path)
    runs = {}
    for mode, rc in (("greedy", True), ("sample", False)):
        _, qc, lens = next(iter(iter_query_batches(host, fq["iupac"], GREEDY_BATCH,
                                                   normalize=rc, with_rc=rc)))
        q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
        runs[mode] = (q, ln, seed_cfg(tx, mode, q.shape[1]))
    out = {f"dense_{k}": v for k, v in seeds_times(tx, runs, lat).items()}
    del host, tx, runs
    tx = TorchIndex.from_index(raw, device)
    del tx.arrays["fblock64"]
    qc = torch.from_numpy(np.stack([raw.alpha.encode(r).astype(np.int32)
                                    for r in reads[:GREEDY_BATCH]])).to(device)
    ln = torch.full((qc.shape[0],), READ_LEN, dtype=torch.int32, device=device)
    runs = {mode: (qc, ln, seed_cfg(tx, mode, READ_LEN)) for mode in ("greedy", "sample")}
    out.update({f"occ1_{k}": v for k, v in seeds_times(tx, runs, lat).items()})
    del tx, runs
    torch.cuda.empty_cache()
    return out


def small_builds(d: str) -> None:
    """Phase build_small's host builds, in a child process of its own
    (started with the run, so that they overlap the card's phases before
    build_small): the small panel's FASTA and VCF (and its IUPAC FASTA)
    through rbt_build_torch in every mode (build_small's docstring), then
    save_reference_format of the dense index; each build's seconds and
    index GB, -x's stderr, the paths and the writer's seconds in
    d/builds.json."""
    from rowbowt_tpu_torch.construct.rawio import write_raw
    from rowbowt_tpu_torch.construct.sdslwrite import save_reference_format, write_mab
    from rowbowt_tpu_torch.index import RbtIndex

    fa, vcf = write_panel_files(SMALL, os.path.join(d, "panel"))
    fa_iu, _ = write_panel_files(SMALL, os.path.join(d, "iupac"), iupac=N_IUPAC)
    out_txt = os.path.join(d, "build.txt")
    p = {x: os.path.join(d, x) for x in ("dense", "x", "nodense", "raw_idx", "ser",
                                         "ftab_only", "iupac")}
    native = ["--fasta", fa, "--vcf", vcf]
    builds = {}

    def build(name, argv):
        wall, _, err = run_main("rbt_build", argv, out_txt)
        builds[name] = dict(build_s=wall, index_gb=dir_gb(p[name]))
        return err

    build("dense", [*native, "-s", "-m", "-l", "-f", "-k", str(FTAB_K), "-o", p["dense"],
                    "--emit-ref", os.path.join(d, "ref_fmt")])
    x_err = build("x", [*native, "-x", "-s", "-m", "-l", "-o", p["x"]])
    build("nodense", [*native, "--no-dense", "-s", "-m", "-l", "-o", p["nodense"]])
    dense = RbtIndex.load(p["dense"])
    prefix = os.path.join(d, "raw")
    write_raw(dense, prefix)
    write_mab(prefix + ".mab", dense.ma_row, dense.ma_val, dense.ma_wsize, dense.n)
    build("raw_idx", [prefix, "-s", "-m", "-l", "-f", "-k", str(FTAB_K), "-o", p["raw_idx"]])
    build("ser", [os.path.join(d, "ref_fmt"), "-s", "-m", "-l", "-o", p["ser"]])
    shutil.copytree(p["dense"], p["ftab_only"])
    build("ftab_only", ["--ftab-only", "-k", "8", "-o", p["ftab_only"]])
    build("iupac", ["--fasta", fa_iu, "--vcf", vcf, "-s", "-m", "-l", "-o", p["iupac"]])
    t = time.perf_counter()
    save_reference_format(dense, os.path.join(d, "ref_again"))
    with open(os.path.join(d, "builds.json"), "w") as f:
        json.dump(dict(builds=builds, x_stderr=x_err, paths=p, fa_iu=fa_iu, vcf=vcf,
                       sdsl_write_s=time.perf_counter() - t), f)


def start_small_builds() -> dict:
    """small_builds in a spawned child process (no CUDA, no torch state of
    this process); phase_build_small joins it."""
    d = os.path.join(WORK, "small")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return dict(proc=spawn_child(small_builds, d), dir=d)


def phase_build_small(device, card: dict, child: dict, lat: dict | None = None) -> dict:
    """Phase build_small: the small panel (n ~ 8.0 M) through rbt_build_torch
    in every mode: native with -s -m -l -f and --emit-ref (the dense index),
    native -x, --no-dense (equal, array for array, to the dense index without
    fblock, kval, phi1, ma_start1 and the ftab), the raw prefix of the dense
    index (n <= OCC1_MAX_N: fused rows, occ1 and tk1), the serialized
    .rbwt/.tsa/.mab/.docs that --emit-ref wrote (the raw build's arrays),
    --ftab-only, and a FASTA with IUPAC codes (13 codes: bwt4/occ_blk).
    rbt_align count, -s and -m on each print the dense index's lines (-x:
    count and -m), the index of 13 codes its --device cpu run's and the
    scalar oracle's; rbt_markers -f and rbt_locs on the raw index print the
    dense index's.  Without fused rows the search is the tables kernel:
    --no-dense launches its run-space count search once for count and -m
    and its toehold search once for -s, the index of 13 codes its dense
    count search once for each, and the raw index without its fused rows
    its occ1 count and toehold searches, held against K1's count and
    toehold launches on the same index with them.  The dense and occ1
    searches are timed against their plain twins on their batch
    (tables_times; their latency bound with `lat`, phase k1's latencies,
    where given).  The builds ran in start_small_builds' child (small_builds),
    joined here.  Builds' seconds, reads/s and routes."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.construct import build_panel
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    d = child["dir"]
    child["proc"].join()
    wait_s = time.perf_counter() - t0
    check(child["proc"].exitcode == 0, f"build_small's builds exited {child['proc'].exitcode}")
    with open(os.path.join(d, "builds.json")) as f:
        built = json.load(f)
    builds, p, fa_iu, vcf = (built[k] for k in ("builds", "paths", "fa_iu", "vcf"))
    check("Warning: fbb backend does not support the toehold suffix array"
          in built["x_stderr"].splitlines(), "rbt_build -x -s gave no warning")
    out_txt = os.path.join(d, "out.txt")
    dense = RbtIndex.load(p["dense"])

    # the tables of each mode against the dense index
    names = ("run_start", "run_head", "occ", "F", "cruns_flat", "cruns_off", "samples_last",
             "pred_pos", "pred_to_run", "ltk", "ma_row", "ma_val", "ma_start1", "doc_starts",
             "ftab", "bwt4", "occ_blk", "occ1", "tk1", "kval", "phi1", "fblock")

    def same(a, b, skip=()):
        for x in names:
            if x not in skip:
                u, v = getattr(a, x), getattr(b, x)
                check((u is None) == (v is None) and (u is None or np.array_equal(u, v)),
                      f"table {x} differs")
        check(a.doc_names == b.doc_names and a.n == b.n, "doc names or n differ")

    got = {x: RbtIndex.load(p[x]) for x in ("x", "nodense", "raw_idx", "ser", "ftab_only",
                                            "iupac")}
    check(all(getattr(got["nodense"], x) is None for x in ("fblock", "kval", "phi1",
                                                            "ma_start1", "ftab")),
          "--no-dense wrote a dense table")
    same(got["nodense"], dense, skip=("fblock", "kval", "phi1", "ma_start1", "ftab"))
    check(got["x"].samples_last is None and got["x"].kval is None, "-x kept the toehold SA")
    same(got["x"], dense, skip=("samples_last", "pred_pos", "pred_to_run", "ltk", "kval",
                                "phi1", "ftab"))
    raw = got["raw_idx"]
    check(raw.kval is None and raw.occ1 is not None and raw.tk1 is not None
          and np.array_equal(raw.phi1, dense.phi1), "raw build's tables")
    same(raw, dense, skip=("kval", "occ1", "tk1"))
    same(got["ser"], raw, skip=("ftab",))
    check(got["ftab_only"].ftab_k == 8, "--ftab-only kept the old k")
    same(got["ftab_only"], dense, skip=("ftab",))
    iu = got["iupac"]
    check(iu.A == 13 and iu.bwt4 is not None and iu.fblock is None and iu.kval is not None,
          f"the IUPAC index: A = {iu.A}")

    # reads
    text = panel(SMALL)[0]
    reads = sample_reads(text, np.random.default_rng(SMALL["seed"] + 1), N_SMALL_READS)
    fq = {x: os.path.join(d, x + ".fq") for x in ("reads", "seeding", "iupac", "iupac_cpu")}
    write_fastq(fq["reads"], reads)
    write_fastq(fq["seeding"], reads[:N_SMALL_SEEDING])
    text_iu = build_panel(fa_iu, vcf, wsize=MA_WSIZE).text
    rng = np.random.default_rng(SMALL["seed"] + 2)
    reads_iu = sample_reads(text_iu, rng, N_SMALL_READS)
    reads_iu[:N_IUPAC_READS] = iupac_reads(text_iu, rng, N_IUPAC_READS)
    write_fastq(fq["iupac"], reads_iu)
    write_fastq(fq["iupac_cpu"], reads_iu[:N_SMALL_CPU])

    # the dense index's lines, then every other index's
    modes = (("count", []), ("-s", ["-s"]), ("-m", ["-m"]))
    dense_runs, want = {}, {}
    for tag, flags in modes:
        reset_counts()
        cli, want[tag], _ = run_cli([p["dense"], fq["reads"], *flags, "-b", str(BATCH),
                                     "--device", str(device)], out_txt)
        dense_runs[tag] = dict(cli, reads=N_SMALL_READS,
                               cli_reads_per_s=N_SMALL_READS / cli["cli_query_s"],
                               launches=route_counts(), walks=walk_counts())
    runs = {"dense": dense_runs}
    for x in ("x", "nodense", "raw_idx", "ser", "ftab_only"):
        runs[x] = align_runs(device, p[x], [(tag, fq["reads"], f, want[tag], N_SMALL_READS)
                                            for tag, f in modes if not (x == "x" and f == ["-s"])],
                             out_txt)
    k1 = launch_counts(k1=1)
    toe = launch_counts(toe=1)
    tab_runs, tab_toe_runs = launch_counts(tab_runs=1), launch_counts(tab_toe_runs=1)
    # the pangenome builders' routes: the merge's and PFP's BigIndex directories
    t = time.perf_counter()
    big_dirs = small_big_dirs(SMALL, dense.alpha, dense.doc_names, d)
    builders_s = time.perf_counter() - t
    for route, v in big_dirs.items():
        check(v["n"] == dense.n and v["M"] == dense.ma_row.shape[0],
              f"the {route} directory: n {v['n']}, M {v['M']}")
        builds[f"big_{route}"] = dict(build_s=v["build_s"], index_gb=dir_gb(v["path"]), R=v["R"])
        runs[f"big_{route}"] = {}
        for tag, flags in modes:
            reset_counts()
            cli, got, _ = run_cli([v["path"], fq["reads"], *flags, "-b", str(BATCH),
                                   "--device", str(device)], out_txt)
            check(same_lines(got, want[tag], per_read=1 if tag == "count" else 2),
                  f"rbt_align {tag} on the {route} directory != the dense index's lines")
            runs[f"big_{route}"][tag] = dict(
                cli, reads=N_SMALL_READS, cli_reads_per_s=N_SMALL_READS / cli["cli_query_s"],
                launches=route_counts(), identical=got == want[tag])
    k1_fb2 = launch_counts(k1_fb2=1)
    k1_rec = launch_counts(k1_rec=1)
    routes = {x: {t: v["launches"] for t, v in runs[x].items()} for x in ("big_merge", "big_pfp")}
    check(all(r[tag] == (k1_rec if tag == "-s" else k1_fb2) for r in routes.values() for tag in r),
          f"the builders' routes: {routes}")
    check(all(runs["big_pfp"][tag]["identical"] for tag, _ in modes)
          and runs["big_merge"]["count"]["identical"],
          "the PFP directory's lines or the merge directory's count lines are not the "
          "dense index's byte for byte")
    phi_at = phi_at_route(device, big_dirs["pfp"]["path"], fq["reads"], want["-s"], out_txt,
                          lat)
    check(all(runs[x]["count"]["launches"] == k1 and runs[x]["-m"]["launches"] == k1
              for x in ("dense", "x", "raw_idx", "ser", "ftab_only"))
          and runs["nodense"]["count"]["launches"] == tab_runs
          and runs["nodense"]["-m"]["launches"] == tab_runs
          and runs["nodense"]["-s"]["launches"] == tab_toe_runs
          and all(runs[x]["-s"]["launches"] == toe for x in ("raw_idx", "ser"))
          and runs["dense"]["-s"]["launches"] == k1,
          f"small routes: {({x: {t: v['launches'] for t, v in r.items()} for x, r in runs.items()})}")
    # every -s walks in a kernel: the dense index's kval (no chain), the
    # raw and serialized indexes' phi1, the predecessor search without it
    check(all(runs[x]["-s"]["walks"] == dict(walk=1, kval=0)
              for x in ("nodense", "raw_idx", "ser"))
          and runs["dense"]["-s"]["walks"] == dict(walk=0, kval=1),
          f"small -s walks: {({x: runs[x]['-s']['walks'] for x in ('dense', 'nodense', 'raw_idx', 'ser')})}")

    # the index of 13 codes: its lines on the card, on the CPU, and the oracle's
    iu_runs, iu_lines = {}, {}
    for tag, flags in modes:
        reset_counts()
        cli, iu_lines[tag], _ = run_cli([p["iupac"], fq["iupac"], *flags, "-b", str(BATCH),
                                         "--device", str(device)], out_txt)
        iu_runs[tag] = dict(cli, reads=N_SMALL_READS,
                            cli_reads_per_s=N_SMALL_READS / cli["cli_query_s"],
                            launches=route_counts())
        cpu, cpu_lines, _ = run_cli([p["iupac"], fq["iupac_cpu"], *flags, "-b", str(N_SMALL_CPU),
                                     "--device", "cpu"], out_txt)
        per_read = 1 if tag == "count" else 2
        got_lines = iu_lines[tag].splitlines(keepends=True)
        check(got_lines[:per_read * N_SMALL_CPU] == cpu_lines.splitlines(keepends=True),
              f"the 13-code index: rbt_align {tag} on the card != --device cpu")
        iu_runs[tag]["cpu_query_s"] = cpu["cli_query_s"]
    check(all(iu_runs[tag]["launches"] == launch_counts(tab_dense=1) for tag, _ in modes),
          f"the 13-code index's routes: {({t: v['launches'] for t, v in iu_runs.items()})}")
    t = time.perf_counter()
    oracle = oracle_align_lines(iu, reads_iu[:N_ORACLE])
    oracle_s = time.perf_counter() - t
    for tag, per_read in (("count", 1), ("-s", 2), ("-m", 2)):
        check("".join(iu_lines[tag].splitlines(keepends=True)[:per_read * N_ORACLE])
              == oracle[tag], f"the 13-code index: rbt_align {tag} != the scalar oracle")

    # the occ1 route on the card: the raw index without its fused rows,
    # count (from its ftab) and toehold against K1's on the same index
    tx = TorchIndex.from_index(raw, device)
    del tx.arrays["fblock64"]
    qc = torch.from_numpy(np.stack([raw.alpha.encode(r).astype(np.int32)
                                    for r in reads[:BATCH]])).to(device)
    ln = torch.full((qc.shape[0],), READ_LEN, dtype=torch.int32, device=device)
    reset_counts()
    occ1_ranges = find_ranges(tx, qc, ln)
    occ1_toe = cuda_lf.find_ranges_toehold(tx, qc, ln)
    occ1_counts = route_counts()
    with_rows = TorchIndex.from_index(raw, device)
    k1_ranges, k1_toe = find_ranges(with_rows, qc, ln), cuda_lf.find_ranges_toehold(with_rows,
                                                                                    qc, ln)
    torch.cuda.synchronize()
    check(occ1_counts == launch_counts(tab_occ1=1, tab_toe_occ1=1)
          and max_abs_err(occ1_ranges, k1_ranges) == 0 and max_abs_err(occ1_toe, k1_toe) == 0,
          f"the occ1 route != K1 ({occ1_counts})")
    del with_rows
    # the dense and occ1 searches timed against their twins on one batch
    host_iu, tx_iu = load_dense(device, p["iupac"], "")
    iu_batch = [(torch.from_numpy(qc_).to(device), torch.from_numpy(lens).to(device))
                for _, qc_, lens in iter_query_batches(host_iu, fq["iupac"], BATCH)]
    tables = {"dense": tables_times(device, tx_iu, iu_batch, False, lat, stage=False),
              "occ1": tables_times(device, tx, [(qc, ln)], False, lat, stage=False),
              "occ1_toehold": tables_times(device, tx, [(qc, ln)], True, lat, stage=False)}
    del tx, tx_iu, iu_batch

    # rbt_markers -f and rbt_locs on the raw index against the dense index
    shutil.copy(p["dense"] + ".midx.npz", p["raw_idx"] + ".midx.npz")
    seeding = {}
    for tool, argv in (("rbt_markers", ["-f"]), ("rbt_locs", [])):
        outs = {}
        for x in ("dense", "raw_idx"):
            reset_counts()
            cli, outs[x], _ = run_seeding_cli(tool, [p[x], fq["seeding"], *argv, "-b",
                                                     str(GREEDY_BATCH), "--device", str(device)],
                                              out_txt)
            # the raw index has fused rows but no kval: rbt_locs' sampled
            # machine carries its toehold step by step (its TOE instance)
            want_seeds = (seed_launches(greedy=1) if tool == "rbt_markers" else
                          seed_launches(sample=1) if x == "dense" else
                          seed_launches(sample_toe=1))
            check(seed_counts() == want_seeds,
                  f"{tool} on the small {x}: {seed_counts()}, not {want_seeds}")
            seeding[f"{tool}_{x}"] = dict(cli, reads=N_SMALL_SEEDING,
                                          cli_reads_per_s=N_SMALL_SEEDING / cli["cli_query_s"],
                                          seed_launches=seed_counts())
        check(outs["dense"] == outs["raw_idx"] and outs["dense"],
              f"{tool} on the raw index != the dense index")
    seeding.update(iupac_seeding(device, p["iupac"], fq, out_txt))
    occ1_seeding = occ1_seeding_route(device, raw, reads)
    seed_tables = seeding_small_times(device, p["iupac"], raw, fq, reads, lat)
    res = dict(n=dense.n, R=dense.R, A_iupac=iu.A, builds=builds, builders_s=builders_s,
               sdsl_write_s=built["sdsl_write_s"], build_wait_s=wait_s,
               reads=N_SMALL_READS, runs=runs, iupac_runs=iu_runs, oracle_reads=N_ORACLE,
               oracle_s=oracle_s, occ1_route=occ1_counts, tables=tables, seeding=seeding,
               occ1_seeding=occ1_seeding, seeds_times=seed_tables, phi_at=phi_at,
               setup_s=time.perf_counter() - t0, card=card["nvidia_smi"])
    emit("build_small", **res)
    shutil.rmtree(d, ignore_errors=True)
    return res


# ---------------- the multi-rank phases: the mesh engines on the card ----------------

PAR_RANKS = 4  # ranks of the multi-rank phases: processes on cuda:0 over gloo
N_PAR_COUNT = 2_048  # reads of the sharded count runs: the first of main's first batch
N_PAR_LOCATE = 1_024  # reads of the sharded toehold + locate and window-marker runs
N_PAR_GREEDY = 512  # reads of the sharded greedy runs: 1,024 lanes with both strands
PAR_MAX_HITS = 8
PAR_MAX_K = 32  # window-marker buffer: sharded_stream's
PAR_MAX_RANGE = 1000
PAR_TIMEOUT_S = 600


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device) -> float | None:
    """Peak device memory since reset_peak; None off the card."""
    import torch

    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def par_run(stats: dict, bufs: dict, tag: str, mesh, steps: int, names, fn) -> None:
    """fn() on this rank: its seconds (the card synchronized around it), its
    all-reduces (count, seconds, per step) and its outputs gathered over dp
    in read order (kept on rank 0)."""
    from rowbowt_tpu_torch.parallel import multihost as mh

    mesh.reset_counts()
    sync(mesh.device)
    t = time.perf_counter()
    outs = fn()
    sync(mesh.device)
    s = time.perf_counter() - t
    stats[tag] = dict(mesh=[mesh.n_dp, mesh.n_idx], s=s, steps=steps,
                      us_per_step=s / steps * 1e6, allreduces=mesh.allreduces,
                      allreduces_per_step=mesh.allreduces / steps, allreduce_s=mesh.allreduce_s,
                      allreduce_us=mesh.allreduce_s / max(mesh.allreduces, 1) * 1e6)
    got = {n: mh.gather_to_host0(mesh, o) for n, o in zip(names, outs)}
    if mesh.rank == 0:
        bufs[tag] = got


def par_rank_stats(mesh, load_s: float, stats: dict, bufs: dict) -> dict:
    return dict(rank=mesh.rank, load_s=load_s, runs=stats,
                peak_gb=peak_gb(mesh.device),
                bufs=bufs if mesh.rank == 0 else None)


def parallel_dp_rank(device, idx_path: str, lanes_path: str) -> dict:
    """A rank of phase parallel_dp: the chr count tables replicated on its
    device, K1 over its dp rows of each of main's batches."""
    import torch.distributed as dist

    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.parallel import multihost as mh
    from rowbowt_tpu_torch.parallel.mesh import make_mesh, replicate_index, shard_queries

    t = time.perf_counter()
    idx = RbtIndex.load(idx_path, with_sa=False, with_ma=False, with_dl=False, with_ft=False)
    mesh = make_mesh(device)
    tx = replicate_index(mesh, idx)
    sync(device)
    load_s = time.perf_counter() - t
    with np.load(lanes_path) as z:
        qc, lens = z["qc"], z["lens"]
    reset_peak(device)
    cuda_lf.LAUNCHES = 0
    sync(device)
    t = time.perf_counter()
    ranges = [find_ranges(tx, *shard_queries(mesh, qc[b], lens[b])) for b in range(qc.shape[0])]
    sync(device)
    query_s = time.perf_counter() - t
    launches = cuda_lf.LAUNCHES
    t = time.perf_counter()
    lo = np.concatenate([mh.gather_to_host0(mesh, r[0]) for r in ranges])
    hi = np.concatenate([mh.gather_to_host0(mesh, r[1]) for r in ranges])
    return dict(rank=mesh.rank, backend=dist.get_backend(), load_s=load_s, query_s=query_s,
                gather_s=time.perf_counter() - t, launches=launches,
                reads=int(qc.shape[0] * qc.shape[1] // mesh.n_dp),
                peak_gb=peak_gb(device),
                lo=lo if mesh.rank == 0 else None, hi=hi if mesh.rank == 0 else None)


def phase_parallel_dp(device, card: dict, chr_: dict, count: dict) -> dict:
    """The dp path on the card: main's 262,144 reads split over PAR_RANKS
    ranks on cuda:0 over gloo, the chr count tables replicated on each, K1
    on every rank (its launches counted in each rank, one a batch
    required); the ranges gathered in read order equal phase main's.  Then
    one rank over NCCL (a world of one) gives the same ranges.  Each rank's
    load and query seconds and peak device memory; reads/s over the slowest
    rank's query seconds."""
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.parallel import multihost as mh

    idx, paths = chr_["idx"], chr_["paths"]
    batches = list(iter_query_batches(idx, paths["reads.fq"], BATCH))
    lanes = os.path.join(WORK, "parallel_dp.npz")
    np.savez(lanes, qc=np.stack([q for _, q, _ in batches]),
             lens=np.stack([ln for _, _, ln in batches]))
    res = {}
    # on the CPU the world of one runs gloo too: NCCL needs a card
    for tag, world, backend in (("gloo", PAR_RANKS, "gloo"),
                                ("nccl", 1, "nccl" if device.type == "cuda" else "gloo")):
        t = time.perf_counter()
        ranks = mh.run_local(parallel_dp_rank, world, backend=backend, device=device.type,
                             args=(paths["idx"], lanes), timeout_s=PAR_TIMEOUT_S)
        wall_s = time.perf_counter() - t
        check(np.array_equal(ranks[0]["lo"], count["lo"])
              and np.array_equal(ranks[0]["hi"], count["hi"]),
              f"parallel_dp over {backend} ({world} ranks): the ranges != phase main's")
        check(device.type != "cuda" or all(r["launches"] == len(batches) for r in ranks),
              f"parallel_dp over {backend}: K1 launches by rank {[r['launches'] for r in ranks]}")
        query_s = max(r["query_s"] for r in ranks)
        res[tag] = dict(ranks=world, backend=backend, wall_s=wall_s, reads=N_READS, query_s=query_s,
                            reads_per_s=N_READS / query_s,
                            launches=sum(r["launches"] for r in ranks),
                            per_rank=[{k: v for k, v in r.items() if k not in ("lo", "hi")}
                                      for r in ranks])
    res.update(launches=res["gloo"]["launches"], card=card["nvidia_smi"])
    emit("parallel_dp", **res)
    return res


def with_rc_lanes(alpha, qc: np.ndarray, lens: np.ndarray):
    """Forward and reverse-complement lanes of right-aligned code reads,
    interleaved (sharded_stream's --greedy lanes)."""
    tab = alpha.encode_table()
    comp = np.full(16, -1, dtype=np.int64)
    for x, y in zip(b"ACGT", b"TGCA"):
        comp[int(tab[x])] = int(tab[y])
    B, L = qc.shape
    out = np.full((2 * B, L), -1, np.int32)
    out[0::2] = qc
    for b in range(B):
        m = int(lens[b])
        r = qc[b, L - m:].astype(np.int64)[::-1]
        out[2 * b + 1, L - m:] = np.where(r < 0, -1, comp[np.maximum(r, 0)])
    return out, np.repeat(lens, 2).astype(np.int32)


PAR_NAMES = {
    "count": ("lo", "hi"), "toehold": ("tlo", "thi", "k"), "locate": ("locs", "nocc"),
    "markers": ("mlo", "mhi", "buf", "used", "ovf"),
    "greedy": ("slo", "shi", "sqs", "sqe", "mvals", "mcnt", "ns"),
}


def par_engines(mesh, lanes: dict, eng) -> tuple[dict, dict]:
    """The engines of one layout on this rank's dp rows of each lane set:
    eng maps an engine name to fn(q, ln) (locate to fn(tlo, thi, k))."""
    from rowbowt_tpu_torch.parallel.mesh import shard_queries

    stats, bufs = {}, {}
    q = {k: shard_queries(mesh, *v) for k, v in lanes.items()}
    L = {k: int(v[0].shape[1]) for k, v in lanes.items()}
    par_run(stats, bufs, "count", mesh, L["count"], PAR_NAMES["count"],
            lambda: eng["count"](*q["count"]))
    tl = {}
    par_run(stats, bufs, "toehold", mesh, L["locate"], PAR_NAMES["toehold"],
            lambda: tl.setdefault("r", eng["toehold"](*q["locate"])))
    par_run(stats, bufs, "locate", mesh, PAR_MAX_HITS - 1, PAR_NAMES["locate"],
            lambda: eng["locate"](*tl["r"]))
    for name in ("markers", "greedy"):
        if name in eng:
            lane = "locate" if name == "markers" else "greedy"
            par_run(stats, bufs, name, mesh, L[lane], PAR_NAMES[name],
                    lambda name=name, lane=lane: eng[name](*q[lane]))
    return stats, bufs


def par_lanes(path: str) -> dict:
    with np.load(path) as z:
        return {k: (z[f"{k}_qc"], z[f"{k}_lens"]) for k in ("count", "locate", "greedy")}


def parallel_chr_rank(device, idx_path: str, lanes_path: str) -> dict:
    """A rank of phase parallel_sharded over the chr index: the R-sharded
    run tables at (1, world), then the position-sharded layout at (1, world)
    and (2, world / 2), each engine on its lane set."""
    import torch.distributed as dist

    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.parallel import sharded as S
    from rowbowt_tpu_torch.parallel import sharded_dense as SD
    from rowbowt_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    t = time.perf_counter()
    idx = RbtIndex.load(idx_path, with_dl=False, with_ft=False)
    load_s = time.perf_counter() - t
    lanes = par_lanes(lanes_path)
    reset_peak(device)
    stats, bufs, setup = {}, {}, {}
    mesh = make_mesh(device, n_dp=1, n_idx=world)
    mesh.sync = True
    t = time.perf_counter()
    sidx = S.ShardedIndex.build(idx, world)
    tb = sidx.device_put(mesh)
    setup["r_sharded"] = time.perf_counter() - t
    st, bf = par_engines(mesh, lanes, {
        "count": lambda q, ln: S.find_ranges_sharded(mesh, sidx, tb, q, ln),
        "toehold": lambda q, ln: S.find_ranges_w_toehold_sharded(mesh, sidx, tb, q, ln),
        "locate": lambda lo, hi, k: S.locate_sharded(mesh, sidx, tb, lo, hi, k, PAR_MAX_HITS)})
    stats["r_sharded"], bufs["r_sharded"] = st, bf
    del tb
    for n_dp in (1, 2):
        n_idx = world // n_dp
        tag = f"pos_sharded_{n_dp}x{n_idx}"
        mesh = make_mesh(device, n_dp=n_dp, n_idx=n_idx)
        mesh.sync = True
        t = time.perf_counter()
        sdx = SD.ShardedDenseIndex.build(idx, n_idx)
        tb = sdx.device_put(mesh)
        setup[tag] = time.perf_counter() - t
        stats[tag], bufs[tag] = par_engines(mesh, lanes, sd_engines(mesh, sdx, tb, True))
        del tb, sdx
    out = par_rank_stats(mesh, load_s, stats, bufs)
    out["setup_s"] = setup
    return out


def sd_engines(mesh, sdx, tb, markers: bool) -> dict:
    from rowbowt_tpu_torch.parallel import sharded_dense as SD

    eng = {
        "count": lambda q, ln: SD.find_ranges_sharded_dense(mesh, sdx, tb, q, ln),
        "toehold": lambda q, ln: SD.find_ranges_w_toehold_sharded_dense(mesh, sdx, tb, q, ln),
        "locate": lambda lo, hi, k: SD.locate_sharded_dense(mesh, sdx, tb, lo, hi, k,
                                                            PAR_MAX_HITS),
        "greedy": lambda q, ln: SD.markers_greedy_seeding_sharded_dense(
            mesh, sdx, tb, q, ln, wsize=MA_WSIZE, max_range=PAR_MAX_RANGE)}
    if markers:
        eng["markers"] = lambda q, ln: SD.find_ranges_w_markers_sharded_dense(
            mesh, sdx, tb, q, ln, wsize=MA_WSIZE, max_k=PAR_MAX_K)
    return eng


def parallel_big_rank(device, path: str, lanes_path: str) -> dict:
    """A rank of phase parallel_sharded over a BigIndex directory: its
    superblocks are the shards (n_idx = n_sup = world), the O(R)/O(M)
    tables replicated; count, toehold, locate and greedy seeding."""
    import torch.distributed as dist

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.parallel.mesh import make_mesh

    t = time.perf_counter()
    big = BigIndex.load(path)
    check(big.n_sup == dist.get_world_size(), f"{path}: n_sup {big.n_sup} != world")
    sdx = big.sharded_index()
    mesh = make_mesh(device, n_dp=1, n_idx=big.n_sup)
    mesh.sync = True
    tb = sdx.device_put(mesh)
    sync(device)
    load_s = time.perf_counter() - t
    reset_peak(device)
    stats, bufs = par_engines(mesh, par_lanes(lanes_path), sd_engines(mesh, sdx, tb, False))
    out = par_rank_stats(mesh, load_s, {"big": stats}, {"big": bufs})
    out["resident_gb"] = sum(v.numel() * v.element_size() for v in tb.values()) / 1e9
    return out


def single_device_refs(tx, lanes: dict, markers: bool) -> dict:
    """The single-device port engines on the same lanes (numpy)."""
    import torch

    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold, locate
    from rowbowt_tpu_torch.engine.markers import find_ranges_w_markers
    from rowbowt_tpu_torch.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu_torch.engine.seeds import markers_greedy_seeding

    dev = {k: (torch.from_numpy(q).to(tx.device), torch.from_numpy(ln).to(tx.device))
           for k, (q, ln) in lanes.items()}
    out = {"count": find_ranges(tx, *dev["count"]),
           "toehold": find_ranges_w_toehold(tx, *dev["locate"])}
    out["locate"] = locate(tx, *out["toehold"], max_hits=PAR_MAX_HITS)
    if markers:
        out["markers"] = find_ranges_w_markers(tx, *dev["locate"], wsize=MA_WSIZE,
                                               max_k=PAR_MAX_K)
    out["greedy"] = markers_greedy_seeding(tx, *dev["greedy"], wsize=MA_WSIZE,
                                           max_range=PAR_MAX_RANGE, use_ftab=False)
    return {k: [t.cpu().numpy() for t in v] for k, v in out.items()}


def check_against(tag: str, bufs: dict, refs: dict) -> int:
    """Every gathered buffer of each engine == the single-device engine's;
    the number of buffers compared."""
    n = 0
    for engine, got in bufs.items():
        for name, want in zip(PAR_NAMES[engine], refs[engine]):
            check(got[name].shape == want.shape and np.array_equal(got[name], want),
                  f"parallel_sharded {tag} {engine}: {name} != the single-device engine's")
            n += 1
    return n


def write_par_lanes(path: str, alpha, qc: np.ndarray, lens: np.ndarray) -> dict:
    """The lane sets of the sharded runs from right-aligned reads: count
    (N_PAR_COUNT), locate (N_PAR_LOCATE) and greedy (N_PAR_GREEDY reads,
    both strands), saved for the ranks; returns them."""
    g = with_rc_lanes(alpha, qc[:N_PAR_GREEDY], lens[:N_PAR_GREEDY])
    lanes = {"count": (qc[:N_PAR_COUNT], lens[:N_PAR_COUNT]),
             "locate": (qc[:N_PAR_LOCATE], lens[:N_PAR_LOCATE]), "greedy": g}
    lanes = {k: (np.ascontiguousarray(q, np.int32), np.ascontiguousarray(ln, np.int32))
             for k, (q, ln) in lanes.items()}
    np.savez(path, **{f"{k}_{x}": v for k, (q, ln) in lanes.items()
                      for x, v in (("qc", q), ("lens", ln))})
    return lanes


def summarize_ranks(ranks: list, lanes: dict) -> dict:
    """Per layout and engine: the slowest rank's seconds, reads/s over them,
    all-reduces per step and their mean microseconds; per rank its load
    seconds and peak device memory."""
    reads = {"count": lanes["count"][0].shape[0], "toehold": lanes["locate"][0].shape[0],
             "locate": lanes["locate"][0].shape[0], "markers": lanes["locate"][0].shape[0],
             "greedy": lanes["greedy"][0].shape[0] // 2}
    out = {}
    for layout, runs in ranks[0]["runs"].items():
        out[layout] = {}
        for engine, r0 in runs.items():
            s = max(r["runs"][layout][engine]["s"] for r in ranks)
            out[layout][engine] = dict(
                mesh=r0["mesh"], s=s, reads=reads[engine], reads_per_s=reads[engine] / s,
                steps=r0["steps"], us_per_step=s / r0["steps"] * 1e6,
                allreduces=r0["allreduces"], allreduces_per_step=r0["allreduces_per_step"],
                allreduce_us=max(r["runs"][layout][engine]["allreduce_us"] for r in ranks))
    out["per_rank"] = [dict(rank=r["rank"], load_s=r["load_s"], peak_gb=r["peak_gb"],
                            **{k: r[k] for k in ("setup_s", "resident_gb") if k in r})
                       for r in ranks]
    return out


def phase_parallel_sharded(device, card: dict, chr_: dict, big_path: str,
                           pfp_path: str) -> dict:
    """The sharded engines on the card, PAR_RANKS processes on cuda:0 over
    gloo (the program, not a scaling: every rank shares one card).

    chr as ShardedIndex (n_idx = PAR_RANKS: count, toehold, locate) and as
    ShardedDenseIndex at (1, PAR_RANKS) and (2, PAR_RANKS / 2) (count,
    toehold, locate, window markers, greedy seeding): N_PAR_COUNT reads of
    count, N_PAR_LOCATE of toehold + locate (PAR_MAX_HITS) and window
    markers, N_PAR_GREEDY of greedy seeding with both strands; every
    gathered buffer equal to the single-device port engine's on the same
    lanes.  Then the big layout through BigIndex.sharded_index: the big_chr
    directory (n_sup = 4, 4 ranks) and the pfp_big directory (n above 2^31,
    int64 lanes, 256-symbol rows, n_sup = 3, 3 ranks): count, toehold,
    locate and greedy against the single-device big engines
    (TorchIndex.from_big).  Then tools/dryrun_multichip on PAR_RANKS ranks.
    Per layout and engine: the slowest rank's seconds, reads/s, all-reduces
    per step and their microseconds; per rank its load seconds and peak
    device memory."""
    import torch

    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.parallel import multihost as mh
    from rowbowt_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    idx, paths = chr_["idx"], chr_["paths"]
    _, qc, lens = next(iter_query_batches(idx, paths["reads.fq"], N_PAR_COUNT))
    lp = os.path.join(WORK, "parallel_chr.npz")
    lanes = write_par_lanes(lp, idx.alpha, qc, lens)
    refs = single_device_refs(TorchIndex.from_index(idx, device), lanes, True)
    res = {}
    t = time.perf_counter()
    ranks = mh.run_local(parallel_chr_rank, PAR_RANKS, backend="gloo", device=device.type,
                         args=(paths["idx"], lp), timeout_s=PAR_TIMEOUT_S)
    compared = sum(check_against(layout, b, refs) for layout, b in ranks[0]["bufs"].items())
    res["chr"] = dict(summarize_ranks(ranks, lanes), wall_s=time.perf_counter() - t,
                      ranks=PAR_RANKS, buffers_equal=compared)
    del refs
    torch.cuda.empty_cache()

    pfp_qc = np.load(os.path.join(pfp_path, "qcodes.npy")).astype(np.int32)
    pfp_lens = np.load(os.path.join(pfp_path, "qlens.npy")).astype(np.int32)
    for name, path, (bqc, blens) in (("big_chr", big_path, (qc, lens)),
                                     ("pfp_big", pfp_path, (pfp_qc, pfp_lens))):
        big = BigIndex.load(path)
        lp = os.path.join(WORK, f"parallel_{name}.npz")
        blanes = write_par_lanes(lp, big.alpha, bqc, blens)
        refs = single_device_refs(TorchIndex.from_big(big, device), blanes, False)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ranks = mh.run_local(parallel_big_rank, big.n_sup, backend="gloo", device=device.type,
                             args=(path, lp), timeout_s=PAR_TIMEOUT_S)
        compared = check_against(name, ranks[0]["bufs"]["big"], refs)
        lo = refs["count"][0]
        res[name] = dict(summarize_ranks(ranks, blanes), wall_s=time.perf_counter() - t,
                         ranks=big.n_sup, n=big.n, rows=int(big.fb2.shape[1]),
                         buffers_equal=compared,
                         lo_at_or_above_2_31=int(((lo >= 1 << 31) & (refs["count"][1] >= lo)).sum()))
        del refs, big
        torch.cuda.empty_cache()
    check(res["pfp_big"]["n"] > 1 << 31 and res["pfp_big"]["lo_at_or_above_2_31"] > 0,
          "parallel_sharded pfp_big: no lane's range lies above 2^31")
    t = time.perf_counter()
    dry = dryrun_multichip(PAR_RANKS, device.type, backend="gloo", timeout_s=PAR_TIMEOUT_S)
    res["dryrun_multichip"] = dict(wall_s=time.perf_counter() - t, world=dry[0]["world"],
                                   n_idx=dry[0]["n_idx"], paths=dry[0]["paths"],
                                   k1_launches=[r["paths"]["dp"]["k1_launches"] for r in dry])
    res["card"] = card["nvidia_smi"]
    emit("parallel_sharded", **res)
    return res


def start_stream(device, path: str, fastqs: list, flags: list, n_idx: int, batch: int) -> dict:
    """Start tools/sharded_stream as one process per FASTQ on cuda:0 (a
    gloo group over localhost when there are several, none for one), each
    writing to files of its own (a pipe left unread would stall a process,
    and its peers with it, at their next collective)."""
    from rowbowt_tpu_torch.parallel import multihost as mh

    n = len(fastqs)
    group = (["--coordinator", f"localhost:{mh.free_port()}", "--num-processes", str(n)]
             if n > 1 else [])
    env = dict(os.environ, PYTHONPATH=HERE)
    run = dict(flags=flags, procs=[], files=[], t0=time.perf_counter())
    for p, fq in enumerate(fastqs):
        out, err = (tempfile.TemporaryFile("w+", dir=WORK), tempfile.TemporaryFile("w+", dir=WORK))
        run["files"].append((out, err))
        run["procs"].append(subprocess.Popen(
            [sys.executable, "-m", "rowbowt_tpu_torch.tools.sharded_stream", path, fq,
             "--n-idx", str(n_idx), "-b", str(batch), "--device", device.type,
             "--backend", "gloo", *flags, *group, *(["--process-id", str(p)] if n > 1 else [])],
            cwd=HERE, env=env, stdout=out, stderr=err))
    return run


def finish_stream(run: dict) -> tuple:
    """(wall seconds from the start, each process's stdout, each process's
    `stream:` meter line from its stderr) of a started stream; raises if a
    process failed or outlasted PAR_TIMEOUT_S."""
    try:
        for p in run["procs"]:
            p.wait(timeout=PAR_TIMEOUT_S)
        wall = time.perf_counter() - run["t0"]
        outs, meters = [], []
        for p, (out, err) in zip(run["procs"], run["files"]):
            err.seek(0)
            text = err.read()
            check(p.returncode == 0,
                  f"sharded_stream {run['flags']} exited {p.returncode}: {text[-2000:]}")
            meters.append(json.loads(next(ln for ln in text.splitlines()
                                          if ln.startswith("stream: "))[8:]))
            out.seek(0)
            outs.append(out.read())
        return wall, outs, meters
    finally:
        for p in run["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in run["files"]:
            f[0].close()
            f[1].close()


def stream_marker_lines(names, lo, hi, buf, used) -> str:
    """sharded_stream -m's lines from window-marker buffers."""
    from rowbowt_tpu_torch.index import marker_allele, marker_pos

    K = buf.shape[1]
    out = []
    for b, name in enumerate(names):
        s, e = int(lo[b]), int(hi[b])
        v = buf[b, K - int(used[b]):]
        out.append(f"{name} ({s},{e}), count={e - s + 1 if e >= s else 0}\n\tmarkers: "
                   + "".join(f"{p}/{a} " for p, a in zip(marker_pos(v).tolist(),
                                                         marker_allele(v).tolist())) + "\n")
    return "".join(out)


def stream_greedy_lines(names, mvals, mcnt, ns) -> str:
    """sharded_stream --greedy's lines from the greedy engine's outputs over
    interleaved forward and reverse-complement lanes (with_rc_lanes)."""
    from rowbowt_tpu_torch.index import marker_allele, marker_pos

    out = []
    for b, name in enumerate(names):
        for strand, lane in (("+", 2 * b), ("-", 2 * b + 1)):
            v = np.concatenate([mvals[lane, s, :min(int(mcnt[lane, s]), mvals.shape[2])]
                                for s in range(mvals.shape[1])]).astype(np.int64)
            v = v[v >= 0]
            out.append(f"{name} {strand} seeds={int(ns[lane])} markers: "
                       + "".join(f"{p}/{a} " for p, a in zip(marker_pos(v).tolist(),
                                                             marker_allele(v).tolist())) + "\n")
    return "".join(out)


def stream_stats(wall: float, meters: list, n_idx: int) -> dict:
    """A stream group's wall seconds, reads/s over its slowest process's
    query seconds, its all-reduces, and each process's meter."""
    reads = sum(m["reads"] for m in meters)
    query_s = max(m["query_s"] for m in meters)
    return dict(processes=len(meters), n_idx=n_idx, reads=reads, wall_s=wall, query_s=query_s,
                reads_per_s=reads / query_s, allreduces=meters[0]["allreduces"],
                per_process=meters)


def phase_parallel_stream(device, card: dict, chr_: dict, count: dict, big_path: str) -> dict:
    """python -m rowbowt_tpu_torch.tools.sharded_stream on the card, gloo
    groups of processes on cuda:0, each with its own FASTQ shard.  Over chr
    with --n-idx 2: 2 processes with half of N_PAR_COUNT reads each; count
    mode prints phase main's lines for each process's reads; -m prints them
    with the window markers of the single-device find_ranges_w_markers
    (window MA_WSIZE, 32 a read: the JAX script's -m); --greedy, 2
    processes with half of N_PAR_GREEDY reads each, print the single-device
    greedy engine's lines over all of them (stream_greedy_lines); 4 processes (--n-idx 4) on the big_chr
    directory, a quarter of the reads each, print phase main's lines.  The
    four groups run at once.  Each group's wall seconds from its start,
    process start and index load included (they share the card and the
    host's cores)."""
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.markers import find_ranges_w_markers
    from rowbowt_tpu_torch.engine.seeds import markers_greedy_seeding

    idx, paths, reads = chr_["idx"], chr_["paths"], chr_["reads"]
    main_lines = count["lines"]

    def shards(n: int, total: int, tag: str):
        per = total // n
        fqs = [os.path.join(WORK, f"stream_{tag}_{p}.fq") for p in range(n)]
        for p, fq in enumerate(fqs):
            write_fastq(fq, reads[p * per:(p + 1) * per], first=p * per)
        return fqs, per

    names, qc, lens = next(iter_query_batches(idx, paths["reads.fq"], N_PAR_COUNT))
    tx = TorchIndex.from_index(idx, device)
    lo, hi, buf, used, _ = (t.cpu().numpy() for t in find_ranges_w_markers(
        tx, torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device),
        wsize=MA_WSIZE, max_k=PAR_MAX_K))
    one = os.path.join(WORK, "stream_greedy_all.fq")
    write_fastq(one, reads[:N_PAR_GREEDY])
    gnames, gqc, glens = next(iter_query_batches(idx, one, N_PAR_GREEDY))
    gq, gl = (torch.from_numpy(a).to(device) for a in with_rc_lanes(idx.alpha, gqc, glens))
    # the stream's index is loaded without its ftab
    _, _, _, _, mvals, mcnt, ns = (t.cpu().numpy() for t in markers_greedy_seeding(
        tx, gq, gl, wsize=MA_WSIZE, max_range=PAR_MAX_RANGE, use_ftab=False))
    want_g = stream_greedy_lines(gnames, mvals, mcnt, ns)
    del tx
    torch.cuda.empty_cache()
    fqs, per = shards(2, N_PAR_COUNT, "half")
    want_m = [stream_marker_lines(names[p * per:(p + 1) * per], lo[p * per:], hi[p * per:],
                                  buf[p * per:], used[p * per:]) for p in range(2)]
    gfqs, gper = shards(2, N_PAR_GREEDY, "greedy")
    g = ["--greedy", "--wsize", str(MA_WSIZE), "--max-range", str(PAR_MAX_RANGE)]
    qfqs, qper = shards(PAR_RANKS, N_PAR_COUNT, "quarter")
    runs = {"count": start_stream(device, paths["idx"], fqs, [], 2, per),
            "markers": start_stream(device, paths["idx"], fqs, ["-m", "--wsize", str(MA_WSIZE)],
                                    2, per),
            "greedy": start_stream(device, paths["idx"], gfqs, g, 2, gper),
            "big_chr_count": start_stream(device, big_path, qfqs, [], PAR_RANKS, qper)}
    out = {k: finish_stream(r) for k, r in runs.items()}
    check(all(out["count"][1][p] == "".join(main_lines[p * per:(p + 1) * per]) for p in range(2)),
          "sharded_stream count (2 processes): lines != phase main's")
    check(out["markers"][1] == want_m,
          "sharded_stream -m (2 processes): lines != the window-marker engine's")
    check("".join(out["greedy"][1]) == want_g,
          "sharded_stream --greedy (2 processes) != the single-device greedy engine's lines")
    outs = out["big_chr_count"][1]
    check(all(outs[p] == "".join(main_lines[p * qper:(p + 1) * qper]) for p in range(PAR_RANKS)),
          "sharded_stream on big_chr (4 processes): lines != phase main's")
    res = {k: stream_stats(w, m, PAR_RANKS if k == "big_chr_count" else 2 if len(m) > 1 else 1)
           for k, (w, _, m) in out.items()}
    res["concurrent"] = list(runs)
    res["markers"]["reads_with_markers"] = int((used > 0).sum())
    res["greedy"]["lines"] = len(want_g.splitlines())
    res["card"] = card["nvidia_smi"]
    emit("parallel_stream", **res)
    return res


SELECTABLE = ("probes", "parity", "k1", "phi_chain", "pfp_big", "build_small", "nodense_chr",
              "raw_chr", "big_chr", "greedy", "heuristic", "lmem", "locs", "parallel_dp",
              "parallel_sharded", "parallel_stream")


def main(argv: list[str]) -> int:
    if not os.path.isdir(os.path.join(HERE, "rowbowt_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 1
    only = set(argv)
    if only - set(SELECTABLE):
        print(f"usage: chip_smoke.py [{' '.join(SELECTABLE)}]...: with phase names, only those, "
              "in that order (after device and build), and no kernel record or last line",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    child = raw_child = small_child = chr_child = None
    try:
        if only:
            if only & {"pfp_big", "parallel_sharded"}:
                child = start_pfp_big_build()
            if "build_small" in only:
                small_child = start_small_builds()
            made: dict = {}

            def chr_main():
                """The chr index and phase main's lines, built once (and
                raw_chr's host build started beside what follows)."""
                nonlocal raw_child
                if not made:
                    made["chr"] = build_cli()
                    if "raw_chr" in only:
                        raw_child = start_raw_chr_build(made["chr"])
                    made["count"] = phase_main(device, card, made["chr"])
                return made["chr"], made["count"]

            def located():
                """Phases locate and markers on chr, run once."""
                if "loc" not in made:
                    chr_, count = chr_main()
                    made["loc"] = (phase_locate(device, card, chr_, count),
                                   phase_markers(device, card, chr_, count))
                return made["loc"]

            def big_chr_path():
                if "big" not in made:
                    made["big"] = build_big_chr(chr_main()[0])["path"]
                return made["big"]

            def k1_phase():
                """Phase k1 (with its dependent-load latencies), run once."""
                if "k1" not in made:
                    made["k1"] = phase_k1(device, card, chr_main()[0])
                return made["k1"]

            def seeding(tag):
                """The dense chr index's lines of a seeding phase (-f: greedy,
                --heuristic, --lmem, locs), the phase run once."""
                if tag not in made:
                    chr_ = chr_main()[0]
                    made[tag] = (
                        phase_greedy(device, card, chr_,
                                     k1_phase()["us_per_dependent_step"]["random_cycle"])
                        if tag == "-f" else phase_heuristic(device, card, chr_)
                        if tag == "--heuristic" else phase_lmem(device, card, chr_)
                        if tag == "--lmem" else phase_locs(device, card, chr_))["out_text"]
                return made[tag]

            for name in dict.fromkeys(argv):  # in the order given
                if name == "probes":
                    phase_probes(device)
                elif name == "parity":
                    phase_parity(device)
                elif name == "pfp_big":
                    # its bounds where phase k1 ran before it
                    phase_pfp_big(device, card, child, made.get("k1"))
                elif name == "build_small":
                    lat = made["k1"]["us_per_dependent_step"] if "k1" in made else None
                    phase_build_small(device, card, small_child, lat)
                elif name in ("nodense_chr", "raw_chr"):
                    chr_, count = chr_main()
                    k1 = k1_phase()
                    dense = {tag: seeding(tag) for tag in ("-f", "--heuristic", "--lmem",
                                                           "locs")}
                    if name == "raw_chr":
                        phase_raw_chr(device, card, chr_, count, *located(), k1, dense,
                                      raw_child)
                    else:
                        phase_nodense_chr(device, card, chr_, count, *located(), k1, dense)
                elif name == "big_chr":
                    chr_, count = chr_main()
                    phase_big_chr(device, card, chr_, count, k1_phase(), *located(),
                                  {"out_text": seeding("locs")})
                elif name == "phi_chain":
                    phase_phi_chain(device, card, located()[0], k1_phase())
                elif name in ("greedy", "heuristic", "lmem", "locs"):
                    seeding({"greedy": "-f", "heuristic": "--heuristic", "lmem": "--lmem",
                             "locs": "locs"}[name])
                elif name == "parallel_dp":
                    phase_parallel_dp(device, card, *chr_main())
                elif name == "parallel_sharded":
                    big = big_chr_path()
                    child["proc"].join()
                    check(child["proc"].exitcode == 0,
                          f"pfp_big's build exited {child['proc'].exitcode}")
                    phase_parallel_sharded(device, card, chr_main()[0], big, child["path"])
                elif name == "parallel_stream":
                    phase_parallel_stream(device, card, *chr_main(), big_chr_path())
                else:
                    k1_phase()
            return 0
        # the PFP panel's host build runs beside the phases before pfp_big,
        # and the small panel's builds beside those before build_small
        child = start_pfp_big_build()
        small_child = start_small_builds()
        # and chr's build beside probes and parity
        chr_child = start_chr_build()
        probes = phase_probes(device)
        par_err = phase_parity(device)
        chr_ = build_cli(child=chr_child)
        # the raw index's host build runs beside the phases before raw_chr
        raw_child = start_raw_chr_build(chr_)
        count = phase_main(device, card, chr_)
        k1 = phase_k1(device, card, chr_)
        loc = phase_locate(device, card, chr_, count)
        markers = phase_markers(device, card, chr_, count)
        chain = phase_phi_chain(device, card, loc, k1)
        greedy = phase_greedy(device, card, chr_, k1["us_per_dependent_step"]["random_cycle"])
        heuristic = phase_heuristic(device, card, chr_)
        lmem = phase_lmem(device, card, chr_)
        locs = phase_locs(device, card, chr_)
        # the same index without kval (raw) and without fused rows: the
        # dense index's lines of every phase above
        seeding = {"-f": greedy["out_text"], "--heuristic": heuristic["out_text"],
                   "--lmem": lmem["out_text"], "locs": locs["out_text"]}
        raw = phase_raw_chr(device, card, chr_, count, loc, markers, k1, seeding, raw_child)
        nodense = phase_nodense_chr(device, card, chr_, count, loc, markers, k1, seeding)
        big_chr = phase_big_chr(device, card, chr_, count, k1, loc, markers, locs)
        pfp_big = phase_pfp_big(device, card, child, k1)
        small = phase_build_small(device, card, small_child, k1["us_per_dependent_step"])
        phase_trace(device, card, chr_, loc)
        phase_greedy_trace(device, card, chr_, greedy)
        par_dp = phase_parallel_dp(device, card, chr_, count)
        phase_parallel_sharded(device, card, chr_, big_chr["path"], child["path"])
        phase_parallel_stream(device, card, chr_, count, big_chr["path"])
        print(json.dumps({"kernels": kernel_record(count, k1, probes, par_err, chain,
                                                   big_chr, pfp_big, par_dp, loc, raw,
                                                   nodense, small, greedy, lmem, locs)}))
        print(card["nvidia_smi"])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        for c in (child, raw_child, small_child, chr_child):
            stop_child(c)
        shutil.rmtree(WORK, ignore_errors=True)


def kernel_record(count: dict, k1: dict, probes: dict, par_err: dict, chain: dict,
                  big_chr: dict, pfp_big: dict, par_dp: dict, loc: dict, raw: dict,
                  nodense: dict, small: dict, greedy: dict, lmem: dict, locs: dict) -> list:
    """One entry per kernel of the port: launches on the main path, max |err|
    against the plain twin, call time (`ms`, CUDA events) beside the plain
    twin's and the library call's, device time alone (`device_us`, CUDA
    events just around the launch; `profiled_us`, one profiler trace, null
    where its records were wrong), and the
    bound: `bound_ms` from bytes or operations, whichever is larger, and
    `bound_us`, the larger of the byte bound and the latency bound; K1's
    entries also `issue_us`, the issue time of the two-level search's step
    loop in machine code (k1_bound's issue_bound_us, null over fused rows),
    beside the bound and not in it.  K1 over
    the two-level rows (lf_count_fb2) has its own entry, from phase big_chr
    (its main path: rbt_align count on the big directory), its max |err|
    also over phases parity and pfp_big; so has its record launch
    (lf_count_fb2_rec, main path rbt_align -s on the big directory).  K1's
    entry also counts its launches on the dp path of phase parallel_dp, over
    every rank (`parallel_dp_launches`).  P3's (gather_chain) names its
    design and every design's device µs; its bound_us is the larger of the
    chain's latency and its loads over the L2's random-load rate (phase
    probes).  The phi walk has an entry a route: phi_walk_kval (the kval
    kernel; main path rbt_align -s on dense chr, timed in phase phi_chain),
    phi_walk_phi1 (the chain over phi1; main path rbt_align -s on raw_chr,
    timed in its toehold_times) and phi_walk_rows (rbt_align -s on the
    big_chr directory), their max |err| also over phases parity (and
    pfp_big for the rows), and phi_walk_pred (main path rbt_align -s on
    nodense_chr).  Each walk entry also carries `floor_us`, the empty
    kernel's time by the same method.  K1's toehold launch (lf_toehold: main
    path rbt_align -s on raw_chr, timed on one of its batches) has its own
    entry, its max |err| also over phase parity.  The tables kernel has an
    entry a rank policy and instance: lf_tables_runs and
    lf_tables_runs_toehold (main paths rbt_align count and -s on
    nodense_chr, timed on one batch of each), lf_tables_dense (rbt_align
    count on build_small's index of 13 codes) and lf_tables_occ1 and
    lf_tables_occ1_toehold (build_small's raw index without its fused rows),
    their max |err| also over phase parity.  The seeding kernel has an entry
    a machine: seeds_greedy (main path rbt_markers -f on chr), seeds_lmem
    (rbt_markers --lmem), seeds_sample (rbt_locs), each timed on one batch
    of its path in phase greedy, and seeds_sample_rec (rbt_locs on the
    big_chr directory, timed there), seeds_sample_toe (the per-step toehold
    over fused rows: rbt_locs on raw_chr), seeds_greedy_runs, seeds_lmem_runs
    and seeds_sample_toe_runs (rbt_markers -f, --lmem and rbt_locs on
    nodense_chr), seeds_greedy_dense and seeds_sample_dense (rbt_markers -f
    and rbt_locs on build_small's 13-code index) and seeds_greedy_occ1 and
    seeds_sample_toe_occ1 (the engines on build_small's raw index without
    its rows), each timed on one batch of its path, their max |err| also
    over phase parity.  The five entries over nodense_chr's run-space
    tables (lf_tables_runs, lf_tables_runs_toehold, seeds_greedy_runs,
    seeds_lmem_runs, seeds_sample_toe_runs) also carry every directory
    span's device µs (run_span_times).  The walk kernel's breakpoint-table
    route
    (walk_phi_at: rbt_align -s on build_small's PFP directory with its phi
    rows withheld) has its entry too."""
    kernels = []
    for name, b, main, err, ms, plain_ms, dev_us, prof_us in (
            ("lf_count", k1["bound"], count,
             max(par_err["lf_count"], count["max_abs_err"], k1["max_abs_err"]),
             count["k1_call_ms"], count["plain_ms"], k1["k1_device_us"],
             k1["profiled_us"]["lf_count_kernel"]),
            ("lf_count_fb2", big_chr["bound"], big_chr,
             max(par_err["lf_count_fb2"], big_chr["max_abs_err"], pfp_big["max_abs_err"]),
             big_chr["fb2_call_ms"], big_chr["plain_ms"], big_chr["fb2_device_us"],
             big_chr["profiled_us"])):
        ops_ms, byte_ms = b["ops_bound_us"] / 1e3, b["byte_bound_us"] / 1e3
        kernels.append({"name": name, "route": "cuda", "source": "rowbowt_tpu_torch/csrc/lf.cu",
                        "replaces": "rowbowt_tpu/ops/pallas_lf.py:49", "launches": main["launches"],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(byte_ms, ops_ms),
                        "bound_by": "bytes" if byte_ms >= ops_ms else "operations",
                        "library_ms": None, "device_us": dev_us, "profiled_us": prof_us,
                        "bound_us": b["bound_us"], "bound_us_by": b["bound_by"],
                        "issue_us": b.get("issue_bound_us")})
    kernels[0]["parallel_dp_launches"] = par_dp["launches"]
    # the record launch: its main path is rbt_align -s on the big_chr directory
    r, b = big_chr["rec"], big_chr["rec"]["bound"]
    kernels.append({
        "name": "lf_count_fb2_rec", "route": "cuda", "source": "rowbowt_tpu_torch/csrc/lf.cu",
        "replaces": "rowbowt_tpu/ops/pallas_lf.py:49 and rowbowt_tpu/engine/locate.py:120 "
                    "(an XLA fori_loop in the JAX package)",
        "launches": big_chr["runs"]["-s"]["rec_launches"],
        "max_abs_err": max(par_err["lf_count_fb2_rec"], r["max_abs_err"],
                           pfp_big["rec_max_abs_err"]),
        "ms": r["call_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "device_us": r["device_us"],
        "profiled_us": r["profiled_us"], "bound_us": b["bound_us"], "bound_us_by": b["bound_by"],
        "issue_us": b["issue_bound_us"]})
    # the toehold launch: its main path is rbt_align -s on raw_chr
    t = raw["toehold"]
    kernels.append({
        "name": "lf_toehold", "route": "cuda", "source": "rowbowt_tpu_torch/csrc/lf.cu",
        "replaces": "rowbowt_tpu/ops/pallas_lf.py:49 and rowbowt_tpu/engine/locate.py:50 "
                    "(an XLA fori_loop of ops/rank.py lf_step_w_loc in the JAX package)",
        "launches": raw["runs"]["-s"]["launches"]["toe"],
        "max_abs_err": max(par_err["lf_toehold"], t["max_abs_err"]),
        "ms": t["call_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "device_us": t["device_us"],
        "profiled_us": t["profiled_us"], "bound_us": t["bound"]["bound_us"],
        "bound_us_by": t["bound"]["bound_by"]})
    # the tables kernel: the count and toehold searches of an index without
    # fused rows, by rank policy
    steps = {"runs": "ops/rank.py:302 lf_step (the run-space rank, :31-57)",
             "dense": "ops/rank.py:258 lf_step_dense", "occ1": "ops/rank.py:246 lf_step_occ1"}
    toe_steps = {"runs": "ops/rank.py:346 lf_step_w_loc", "occ1": "ops/rank.py:316 "
                 "lf_step_w_loc_occ1"}
    for name, t, launches in (
            ("runs", nodense["tables"]["count"], nodense["runs"]["count"]["launches"]["tab_runs"]),
            ("runs_toehold", nodense["tables"]["toehold"],
             nodense["runs"]["-s"]["launches"]["tab_toe_runs"]),
            ("dense", small["tables"]["dense"],
             small["iupac_runs"]["count"]["launches"]["tab_dense"]),
            ("occ1", small["tables"]["occ1"], small["occ1_route"]["tab_occ1"]),
            ("occ1_toehold", small["tables"]["occ1_toehold"], small["occ1_route"]["tab_toe_occ1"])):
        policy = name.split("_")[0]
        loop = toe_steps[policy] if t["toehold"] else steps[policy]
        kernels.append({
            "name": f"lf_tables_{name}", "route": "cuda", "source": "rowbowt_tpu_torch/csrc/lf.cu",
            "replaces": f"rowbowt_tpu/ops/pallas_lf.py:49 and rowbowt_tpu/engine/"
                        f"{'locate.py:64' if t['toehold'] else 'count.py:55'} (an XLA fori_loop "
                        f"of rowbowt_tpu/{loop} in the JAX package)",
            "launches": launches,
            "max_abs_err": max(par_err[f"lf_tables_{name}"], t["max_abs_err"]),
            "ms": t["call_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "device_us": t["device_us"],
            "profiled_us": t["profiled_us"], "bound_us": t["bound"]["bound_us"],
            "bound_us_by": t["bound"]["bound_us_by"]})
    # the seeding machines: their main paths are rbt_markers -f, --lmem and
    # rbt_locs on chr, rbt_locs on the big_chr directory; over the tables,
    # rbt_markers -f, --heuristic, --lmem and rbt_locs on nodense_chr, -f and
    # rbt_locs on build_small's 13-code index (dense) and the engines on its
    # raw index without rows (occ1); with the per-step toehold over rows,
    # rbt_locs on raw_chr
    loops = {"greedy": "seeds.py:348", "lmem": "seeds.py:500", "sample": "seeds.py:112-117",
             "sample_rec": "seeds.py:112-117",
             "sample_toe": "seeds.py:66-75 (the per-step toehold's step) and :112-117"}
    nd, sm = nodense["runs"], small["seeding"]
    occ1 = small["occ1_seeding"]["launches"]["occ1"]
    for name, t, launches in (
            ("greedy", greedy["seeds_times"]["greedy"], greedy["seed_launches"]["greedy"]),
            ("lmem", greedy["seeds_times"]["lmem"], lmem["seed_launches"]["lmem"]),
            ("sample", greedy["seeds_times"]["sample"], locs["seed_launches"]["sample"]),
            ("sample_rec", big_chr["seeds_rec"],
             big_chr["runs"]["locs"]["seed_launches"]["sample_rec"]),
            ("sample_toe", raw["seeds_times"]["sample"],
             raw["runs"]["locs"]["seed_launches"]["sample_toe"]),
            ("greedy_runs", nodense["seeds_times"]["greedy"],
             nd["-f"]["seed_launches"]["greedy_runs"]),
            ("lmem_runs", nodense["seeds_times"]["lmem"],
             nd["--lmem"]["seed_launches"]["lmem_runs"]),
            ("sample_toe_runs", nodense["seeds_times"]["sample"],
             nd["locs"]["seed_launches"]["sample_toe_runs"]),
            ("greedy_dense", small["seeds_times"]["dense_greedy"],
             sm["rbt_markers_iupac"]["seed_launches"]["greedy_dense"]),
            ("sample_dense", small["seeds_times"]["dense_sample"],
             sm["rbt_locs_iupac"]["seed_launches"]["sample_dense"]),
            ("greedy_occ1", small["seeds_times"]["occ1_greedy"], occ1["greedy_occ1"]),
            ("sample_toe_occ1", small["seeds_times"]["occ1_sample"], occ1["sample_toe_occ1"])):
        b = t["bound"]
        machine = name if name in loops else name.rsplit("_", 1)[0]
        step = ("K1's rank, each step" if name in loops else
                f"K1's rank, each step; here the {name.rsplit('_', 1)[1]} tables' step")
        kernels.append({
            "name": f"seeds_{name}", "route": "cuda", "source": "rowbowt_tpu_torch/csrc/seeds.cu",
            "replaces": f"rowbowt_tpu/ops/pallas_lf.py:49 ({step}) and "
                        f"rowbowt_tpu/engine/{loops[machine]} (an XLA fori_loop in the JAX "
                        f"package)",
            "launches": launches, "max_abs_err": max(par_err[f"seeds_{name}"], t["max_abs_err"]),
            "ms": t["call_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "device_us": t["device_us"],
            "profiled_us": t["profiled_us"], "bound_us": b["bound_us"],
            "bound_us_by": b["bound_us_by"]})
    # the run-space step over the directory's spans, side by side at nodense_chr
    spans = nodense["run_spans"]["spans_us"]
    for k in kernels:
        path = {"lf_tables_runs": "count", "lf_tables_runs_toehold": "toehold",
                "seeds_greedy_runs": "greedy", "seeds_lmem_runs": "lmem",
                "seeds_sample_toe_runs": "sample"}.get(k["name"])
        if path:
            k["spans_device_us"] = {t: v[path] for t, v in spans.items()}
    byte_us = probe_byte_us()
    for name, line in (("gather_rows", 51), ("gather_cols", 76), ("gather_chain", 92)):
        p = probes[name]
        # the gathers do no arithmetic: bytes bound them, and P3 also its
        # chain's latency or its loads over the L2's random-load rate
        bound_us, by = byte_us[name], "bytes"
        if name == "gather_chain" and p["bound_us"] > bound_us:
            bound_us, by = p["bound_us"], p["bound_us_by"]
        kernels.append({"name": name, "route": "cuda",
                        "source": "rowbowt_tpu_torch/csrc/gather_probe.cu",
                        "replaces": f"tools/vmem_gather_probe.py:{line}",
                        "launches": p["launches"],
                        "max_abs_err": max(p["max_abs_err"],
                                           chain["max_abs_err"] if name == "gather_chain" else 0),
                        "ms": p["ms"], "plain_ms": p["plain_ms"],
                        "bound_ms": byte_us[name] / 1e3, "bound_by": "bytes",
                        "library_ms": p["library_ms"], "device_us": p["device_us"],
                        "profiled_us": p["profiled_us"], "bound_us": bound_us,
                        "bound_us_by": by})
    kernels[-1]["design"] = probes["gather_chain"]["design"]
    kernels[-1]["designs_device_us"] = {d: v["device_us"] for d, v in
                                        probes["gather_chain"]["designs"].items()}
    # the phi walk: its main paths are rbt_align -s on dense chr (the kval
    # kernel), on raw_chr (the chain over phi1), on the big_chr directory
    # (phi rows) and on nodense_chr (the predecessor search)
    chained = ("tools/vmem_gather_probe.py:92 (P3's chain, carrying the phi walk of "
               "rowbowt_tpu/engine/locate.py:177, an XLA fori_loop in the JAX package)")
    for name, w, launches, err, replaces in (
            ("phi_walk_kval", chain["walk"], loc["walks"]["kval"],
             max(par_err["phi_walk_kval"], chain["walk"]["max_abs_err"]),
             "tools/vmem_gather_probe.py:92 (P3's chain, which carried this walk before; "
             "the phi walk of rowbowt_tpu/engine/locate.py:206 locate_ragged, an XLA "
             "fori_loop in the JAX package)"),
            ("phi_walk_phi1", raw["toehold"]["walk"], raw["runs"]["-s"]["walks"]["walk"],
             max(par_err["phi_walk_phi1"], chain["max_abs_err"],
                 raw["toehold"]["walk"]["max_abs_err"]), chained),
            ("phi_walk_rows", big_chr["walk"], big_chr["runs"]["-s"]["walks"]["walk"],
             max(par_err["phi_walk_rows"], big_chr["walk"]["max_abs_err"],
                 pfp_big["walk"]["max_abs_err"]), chained),
            ("phi_walk_pred", nodense["walk"], nodense["runs"]["-s"]["walks"]["walk"],
             max(par_err["phi_walk_pred"], nodense["walk"]["max_abs_err"]), chained),
            ("walk_phi_at", small["phi_at"], small["phi_at"]["launches"],
             max(par_err["walk_phi_at"], small["phi_at"]["max_abs_err"]), chained)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "rowbowt_tpu_torch/csrc/phi_walk.cu", "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": w["call_ms"],
                        "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
                        "bound_by": w["bound_by"], "library_ms": None,
                        "device_us": w["device_us"], "profiled_us": w["profiled_us"],
                        "floor_us": w["floor_us"], "bound_us": w["bound_us"],
                        "bound_us_by": w["bound_us_by"]})
    return kernels


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
