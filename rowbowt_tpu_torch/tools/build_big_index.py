"""Build the n > 2^31 synthetic-pangenome index (bench 'big' config), v2.

    python -m rowbowt_tpu_torch.tools.build_big_index

300 Mbp reference + 7 haplotypes -> n = 2,400,000,081 symbols (> 2^31 =
2,147,483,648): the regime the reference serves with u64 indices throughout
(rowbowt:include/toehold_sa.hpp:133-155) and pfbwt-f construction.
Construction is the chunked insertion merge (construct/merge.py) — whole-text
SA-IS cannot run in int32 at this n — carrying the FULL suffix array as
uint32 (n < 2^32), from which the v2 artifact gets the complete capability
matrix the reference has at any scale:

  * O(R) run-boundary SA samples + phi predecessor tables (the .ssa/.esa
    role, toehold_sa.hpp:105-131) -> toehold locate;
  * O(M) marker CSR (the pfbwt-f MarkerArray role) -> rb_markers genotyping;
  * doclist -> rb_align -s doc:offset resolution.

Also samples query reads, encodes them, and records CPU/host oracle
expectations (count ranges, toeholds, phi-walk locations, final-range
markers) for device parity at full scale.

Output: .cache/bench_idx_big/ (a BigIndex directory, its fb2_64 repack, the
query reads and the oracle's arrays).  build(out, ...) takes the script's
constants as keyword arguments, so a smaller panel builds through the same
code (below 2^31 only with RBT_BIG_ALLOW_SMALL set, as in the original).
The copy of scripts/build_big_index.py, imports renamed.
"""

import json
import os
import resource
import shutil
import sys
import time

import numpy as np

from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.construct.merge import merge_construct

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_LEN = 300_000_000
N_HAPS = 7
N_VARS = 900_000  # one variant site per ~333 bp, like the chr config
SEED = 77_711
W = 10
N_READS = 131_072
READ_LEN = 100
N_PARITY = 512
OUT = os.path.join(REPO, ".cache", "bench_idx_big")


def gen_parts(rng, ref_len=REF_LEN, n_haps=N_HAPS, n_vars=N_VARS, w=W):
    """Documents + marker arrays (same scheme as bench.py's small/chr configs:
    ref doc carries allele 0 at every variant site, hap docs allele 1 where
    the variant is carried else 0; marker pos is the 0-based ref position)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    var_pos = np.sort(rng.choice(ref_len, size=n_vars, replace=False)).astype(np.int64)
    var_alt = rng.choice(acgt, size=n_vars)
    sep = np.full(w, SEP_BYTE, dtype=np.uint8)
    parts = [np.concatenate([ref, sep])]
    doc_len = ref_len + w
    tpos, packed = [var_pos.copy()], [var_pos << 8]  # ref doc: allele 0
    for h in range(n_haps):
        hap = ref.copy()
        carry = rng.random(n_vars) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        tail = sep if h < n_haps - 1 else np.concatenate(
            [sep, np.array([TERM_BYTE], dtype=np.uint8)])
        parts.append(np.concatenate([hap, tail]))
        tpos.append((h + 1) * doc_len + var_pos)
        packed.append((var_pos << 8) | carry.astype(np.int64))
    doc_starts = np.arange(n_haps + 1, dtype=np.int64) * doc_len
    return (parts, np.concatenate(tpos), np.concatenate(packed), doc_starts)


def build(out=OUT, ref_len=REF_LEN, n_haps=N_HAPS, n_vars=N_VARS, seed=SEED, w=W,
          n_reads=N_READS, read_len=READ_LEN, n_parity=N_PARITY):
    """Build the panel's index into `out` (through out + ".building", renamed
    when complete).  Returns the build stats (build_stats.json)."""
    tmp = out + ".building"
    rng = np.random.default_rng(seed)
    t_all = time.perf_counter()
    print("generating panel documents ...", file=sys.stderr)
    parts, m_tpos, m_packed, doc_starts = gen_parts(rng, ref_len, n_haps, n_vars, w)
    n = sum(int(p.shape[0]) for p in parts)
    assert n > (1 << 31) or os.environ.get("RBT_BIG_ALLOW_SMALL"), n
    print(f"n = {n:,}, {len(parts)} documents, "
          f"{m_tpos.shape[0]:,} markers", file=sys.stderr)

    t0 = time.perf_counter()
    codes, sa, alpha = merge_construct(parts, with_sa=True, verbose=True,
                                       sa_dtype=np.uint32)
    t_merge = time.perf_counter() - t0
    print(f"merge_construct(with_sa): {t_merge:.1f}s", file=sys.stderr)

    # sample reads BEFORE freeing the documents (20% get one mutation)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    which = rng.integers(0, len(parts), size=n_reads)
    for i in range(n_reads):
        d = parts[int(which[i])]
        s = int(rng.integers(0, d.shape[0] - w - read_len - 1))
        reads[i] = d[s:s + read_len]
    bad = ~np.isin(reads, acgt).all(axis=1)
    for i in np.flatnonzero(bad):
        while True:
            d = parts[int(rng.integers(0, len(parts)))]
            s = int(rng.integers(0, d.shape[0] - w - read_len - 1))
            r = d[s:s + read_len]
            if np.isin(r, acgt).all():
                reads[i] = r
                break
    mut = rng.random(n_reads) < 0.2
    mpos = rng.integers(0, read_len, size=n_reads)
    mchar = rng.choice(acgt, size=n_reads)
    reads[np.arange(n_reads)[mut], mpos[mut]] = mchar[mut]
    del parts

    t0 = time.perf_counter()
    big = BigIndex.from_codes(codes, alpha, n_sup=8)
    t_pack = time.perf_counter() - t0
    print(f"fb2 pack: {t_pack:.1f}s ({big.fb2.nbytes / 2**30:.2f} GB)",
          file=sys.stderr)

    t0 = time.perf_counter()
    isa = np.empty(n, dtype=np.uint32)  # shared by locate + marker builds
    isa[sa] = np.arange(n, dtype=np.uint32)
    big.attach_locate(codes, sa, isa=isa)
    print(f"locate tables: {time.perf_counter() - t0:.1f}s "
          f"(R={big.R:,})", file=sys.stderr)
    del codes
    t0 = time.perf_counter()
    big.attach_markers(sa, m_tpos, m_packed, w, isa=isa)
    del isa
    print(f"marker CSR: {time.perf_counter() - t0:.1f}s "
          f"(M={big.ma_row.shape[0]:,})", file=sys.stderr)
    big.doc_starts = doc_starts
    big.doc_names = ["ref"] + [f"hap{h}" for h in range(n_haps)]

    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    big.save(tmp)

    # precompute the 64B-row repack the device engine loads (bigindex.py
    # caches it on disk; doing it here keeps query startup fast)
    from rowbowt_tpu_torch.construct.build import fblock_to_fb64
    t0 = time.perf_counter()
    fb64 = fblock_to_fb64(np.asarray(big.fb2), n)
    np.save(os.path.join(tmp, "fb2_64.npy"), fb64)
    print(f"fb2_64 repack: {time.perf_counter() - t0:.1f}s "
          f"({fb64.nbytes / 2**30:.2f} GB)", file=sys.stderr)
    del fb64

    tab = alpha.encode_table()
    qcodes = tab[reads.astype(np.int64)].astype(np.int16)
    qlens = np.full(n_reads, read_len, dtype=np.int32)
    np.save(os.path.join(tmp, "qcodes.npy"), qcodes)
    np.save(os.path.join(tmp, "qlens.npy"), qlens)

    from rowbowt_tpu_torch.cpu_backend import count_ranges_fb2

    t0 = time.perf_counter()
    exp_lo, exp_hi = count_ranges_fb2(big, qcodes[:n_parity], qlens[:n_parity])
    t_cpu = time.perf_counter() - t0
    print(f"cpu parity record: {n_parity} reads in {t_cpu:.1f}s "
          f"({n_parity / t_cpu:,.0f} reads/s 1t)", file=sys.stderr)
    nonempty = int((exp_hi >= exp_lo).sum())
    print(f"  nonempty ranges: {nonempty}/{n_parity}", file=sys.stderr)
    assert nonempty > n_parity // 2, "sampled reads should mostly hit"
    np.save(os.path.join(tmp, "expect_lo.npy"), exp_lo)
    np.save(os.path.join(tmp, "expect_hi.npy"), exp_hi)

    # locate oracle from SA adjacency: toehold k = SA[hi]; the phi chain from
    # k walks SA rows hi, hi-1, ... (phi(SA[j]) = SA[j-1]) — the reference's
    # exact output order (toehold first, toehold_sa.hpp:37-49)
    MH = 4
    ne = exp_hi >= exp_lo
    exp_k = np.where(ne, sa[np.where(ne, exp_hi, 0)].astype(np.int64), 0)
    exp_locs = np.full((n_parity, MH), -1, dtype=np.int64)
    for b in np.flatnonzero(ne):
        cnt = min(MH, int(exp_hi[b] - exp_lo[b] + 1))
        rows = exp_hi[b] - np.arange(cnt)
        exp_locs[b, :cnt] = sa[rows].astype(np.int64)
    np.save(os.path.join(tmp, "expect_k.npy"), exp_k)
    np.save(os.path.join(tmp, "expect_locs4.npy"), exp_locs)

    # final-range marker oracle (markers_at over the whole-read range)
    MK = 8
    s = np.searchsorted(big.ma_row, np.where(ne, exp_lo, 1).astype(np.uint32))
    e = np.searchsorted(big.ma_row, (np.where(ne, exp_hi, 0) + 1).astype(np.uint32))
    exp_mcnt = np.maximum(e - s, 0)
    exp_mvals = np.full((n_parity, MK), -1, dtype=np.int64)
    for b in range(n_parity):
        c = min(MK, int(exp_mcnt[b]))
        exp_mvals[b, :c] = big.ma_val[s[b]:s[b] + c]
    np.save(os.path.join(tmp, "expect_mcnt.npy"), exp_mcnt)
    np.save(os.path.join(tmp, "expect_mvals8.npy"), exp_mvals)
    del sa

    wall = time.perf_counter() - t_all
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    # children (prefetched SA-IS workers) peak separately
    rss_c = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / (1 << 20)
    stats = {"wall_s": round(wall, 1), "merge_s": round(t_merge, 1),
             "pack_s": round(t_pack, 1),
             "peak_rss_gb": round(rss, 2),
             "peak_rss_child_gb": round(rss_c, 2),
             "cpu_reads_per_s_1t": round(n_parity / t_cpu, 1),
             "n": n, "R": big.R,
             "M": int(big.ma_row.shape[0])}
    with open(os.path.join(tmp, "build_stats.json"), "w") as f:
        json.dump(stats, f)
    # atomic swap so a crashed build never leaves a half-written artifact
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    print(f"DONE: {wall:.1f}s total, peak RSS {rss:.2f} GB "
          f"(+{rss_c:.2f} GB SA worker)", file=sys.stderr)
    return stats


def main():
    build()


if __name__ == "__main__":
    main()
