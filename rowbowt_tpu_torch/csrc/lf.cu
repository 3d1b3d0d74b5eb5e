// K1: batched backward search (the count path: ftab start and LF loop) over
// fused-block rank rows, for Hopper (sm_90a).
//
// Replaces rowbowt_tpu/ops/pallas_lf.py:_lf_kernel (with its _swar_count)
// and computes what rowbowt_tpu/engine/count.py:find_ranges computes, the
// ftab start included: both row layouts, any alphabet of at most 8 codes.
// A second kernel, lf_count2_kernel (C entry rbt_lf_count_fb2), runs the
// search over the two-level rows of a big (n >= 2^31) index, which the JAX
// package computes with XLA gathers over rowbowt_tpu/ops/rank.py
// lf_step_fblock2: int64 lanes, superblock-local checkpoints completed by an
// int64 base per superblock and code, rows of 64, 128 or 256 symbols, and
// no ftab (big artifacts carry none).  Its rows are bit planes (lf_rank.cuh
// Planes; engine/device.py bit_planes repacks the artifact's nibbles at
// load), so a rank costs a thread two ands of xors, a popcount and a mask
// for each 32 of its symbols, where the nibbles' SWAR count took some 60
// instructions for them; its 256-symbol rows are 128 B, one line, for 160.
// With fewer registers the search is built for two 512-thread blocks an SM
// at every row width, so that a batch of 65,536 lanes runs in one wave
// (LfBounds); a row's superblock is a multiply and a shift (Sup), not a
// division, and row ids and in-row offsets stay ints.
// Given a record buffer, that entry's search (its REC instance) also writes
// each lane's pre-step hi of every step into an int64 [L, B] record:
// the step record of the trajectory toehold of a big index
// (rowbowt_tpu_torch/engine/locate.py _toehold_trajectory), which the JAX
// package runs as an XLA fori_loop (rowbowt_tpu/engine/locate.py:120).  The
// record runs to L: after a failure its entries are 0 (the empty range's
// hi), past the read's length the final hi.  Every lane of a warp steps to
// L with the others, its range held once its search has ended, so each
// step's stores of a warp fill neighbouring columns of one row of the
// record, and the stores are evict-first (st.global.cs), so that the 67 MB
// record of a chr batch does not push the rows out of the 50 MB L2.  Over
// the nibble rows, each lane filling its own tail after its loop, the
// record took 1.21x the search without it (PERF.md §6).

// What bounds it on the H100.  A lane's step is two ranks, each over one
// random row of a table that the 50 MB L2 does not hold (160 MB of fblock64
// rows at chr), and the next step's rows need this step's result.  A chr
// batch of 65,536 reads of 100 bp needs about 7.4 M distinct-row fetches
// (the two ranks of a step share a row in 4 steps of 5) over some 2.3 M
// distinct rows.  With every lane resident, tens of thousands of rows are in
// flight, so the pace is set by the rate at which the memory system serves
// random 64 B rows, not by one load's latency (about 0.49 us a dependent
// step).  What the design does about it (each part timed on an H100,
// PERF.md §6):
//   - two threads per lane (kG), each loading every other 16-byte part of a
//     row (half of the checkpoints and half of the symbols), the two shares
//     of a rank summed with one shuffle: a warp's load instruction covers 16
//     rows.  One thread a lane needs four loads a row and took 1.07-1.21x the
//     time; four threads a lane split checkpoints from symbols across
//     threads, which diverge, and took 1.56-1.58x;
//   - each block stages its lanes' codes once from the row-major [B, L]
//     batch into shared memory, one byte a code, with coalesced loads, so no
//     global load of a code sits on the loop's critical path (1.08x without)
//     and no [L, B] transpose precedes the launch;
//   - the ftab start runs here: a lane builds the k-mer code of its last k
//     codes from the staged bytes and reads its own ftab entry, which skips
//     k steps at the cost of one load and no torch ops;
//   - no row is loaded for hi + 1 == n (the code's total count).
//
// Row contract (rowbowt_tpu_torch/construct/build.py build_fblock and
// fblock_to_fb64): int32[8 + SYMS/8] per row = 8 exclusive per-code
// checkpoints, then SYMS 4-bit symbols packed 8 per word, symbol j of a word
// at bits [4j, 4j+4).  The words are uint32 stored in int32 lanes: they are
// reinterpreted as uint32 here, so shifts are logical and __popc counts them.
// On the two-level rows the checkpoints count from the start of the row's
// superblock (per_blk rows); base[s][c] (int64) is the count of c before
// superblock s.  A row id stays an int (n < 2^37 for 64-symbol rows), and
// only the lanes, F and base are 64-bit: one more 8-byte load a rank, from
// a table of n_sup x 64 bytes that stays in L1 and L2.  The rows' layouts,
// the staging, the ftab k-mer code and a step's two ranks (rank_pair, and
// rank_pair_planes over the two-level rows) live in lf_rank.cuh, which
// csrc/seeds.cu (the seeding machines of rbt_markers and rbt_locs) includes
// too.
//
// A third instance (TOE, C entry rbt_lf_toehold) is the search of
// `rbt_align -s` on an index built from run samples alone (raw, serialized,
// no kval): RowBowt::LF_w_loc (rowbowt.hpp:553-573), which the JAX package
// runs as an XLA fori_loop of rowbowt_tpu/ops/rank.py lf_step_w_loc or
// lf_step_w_loc_occ1 (rowbowt_tpu/engine/locate.py:50-67).  The toehold k
// of a step is 0 when the range empties, (k - 1) mod n when BWT[hi] == c
// (a trivial step) and a table value of (c, pre-step hi) otherwise: tk1[c *
// n + hi] where tk1 is resident, else ltk[c * R + run of hi].  So the final
// k of a lane is that value of its last non-trivial step less the trivial
// steps after it, mod n (from k0 = (samples_last[R - 1] + 1) mod n where
// there is none), and the loop carries only that step's c and hi and a
// count; one resolve a lane after the loop reads the table (and, for ltk,
// finds the run of hi through the bucket directory rs_off over run_start,
// engine/device.run_directory, which the load builds beside ltk).  The
// trivial test needs BWT[hi] == c, which holds exactly when rank(hi + 1, c)
// - rank(hi, c) == 1: hi + 1's rank is taken in hi's own row (at an in-row
// offset of up to the whole row), so hi's symbol is in the row fetched and
// its bit rides beside the rank in the rank's own shuffle (lf_rank.cuh
// rank_pair_toe), with no load of its own and no case for a row start or
// n.  Its bound is K1's plus the resolve: the directory's entry, at
// most `iters` probes of one bucket's starts and one table load a lane
// (under 1 MB a chr batch).  Timed on an H100 in turns on a raw chr batch
// (PERF.md §6), it takes 0.93x K1's count search of the same build.  The
// earlier design, hi + 1's rank in hi + 1's row and hi's symbol read apart
// (one more shuffle, and one more load where hi + 1 started a row or was
// n), took 1.12x; the test folded into that rank with the load hoisted
// beside the row fetches 1.09x; the resolve costs 0.025x.
//
// A second kernel, lf_tables_kernel (C entry rbt_lf_tables), runs the same
// search, count or toehold, over the rank tables of an index without fused
// rows (a `--no-dense` build; an alphabet of 9-16 codes, whose dense tables
// are bwt4 and occ_blk): what the JAX package computes as XLA loops of
// rowbowt_tpu/ops/rank.py lf_step (the run-space rank, :31-57), lf_step_dense
// (:59-89), lf_step_occ1 (:237-244) and, carrying the toehold,
// lf_step_w_loc (:346-381) or lf_step_w_loc_occ1 (:316-344) beside
// pallas_lf.py:49.  Codes staged as K1 stages them, the ftab start read in
// the kernel, the toehold carried and resolved once a lane as the TOE
// instance does.  Three rank policies, chosen by the wrapper in
// lf_step_auto's order:
//   - runs: the run of i through a bucket directory over run_start (rs_off,
//     engine/device.run_directory: rs_off[b] is the first run starting at or
//     after b << shift, 2^7 positions a bucket at chr, 1.25 M entries, in
//     the L2), then a binary search of the few starts in i + 1's bucket
//     (one or two 128 B lines, L1 after the first probe), then occ_flat and
//     run_head of that run.  lo's run and hi + 1's are found independently.
//     The trivial test is the code of hi's run: hi + 1's, or the one before
//     where hi + 1 starts it.  Two threads a lane (lf_tables.cuh
//     lane_threads): lo's rank on one, hi + 1's on the other, joined by a
//     shuffle.  Where the index has the run records (at most 6 codes, int32
//     lanes: engine/device.run_records) a run's start, head and counts come
//     from its 32-byte record (the REC instance), else from run_start,
//     run_head and occ_flat;
//   - dense: the checkpoint of c at block i >> 7 and the nibbles equal to c
//     among the block's first i & 127 symbols.  kDenseG = 2 threads a lane
//     (lf_tables.cuh lane_threads), each loading two 16-byte parts of the
//     64 B block and counting c among its eight words below the offset; the
//     shares of both ranks (and for the trivial test the symbol at hi) are
//     packed into one word and summed by one shuffle.  Where lo and hi + 1
//     lie in one block, one fetch and one checkpoint serve both ranks.  The
//     trivial test reads hi's nibble from a fetched block where hi lies in
//     it, else one word of bwt4;
//   - occ1: one load a rank, lo's on one thread of a pair and hi + 1's on
//     the other, joined by a shuffle; for the trivial test both load occ1
//     at hi.
// The dense and occ1 instances read F from shared memory, staged once a
// block (an alphabet of at most 16 codes).
// What bounds it: each step's loads depend on the step before, so no byte
// count comes near it; its bound is the shortest dependent chain any design
// of a step needs times the longest lane's steps.  Over the run-space
// tables that chain is the directory's entry and one run_start probe at the
// L2's latency, then one load beyond the L2.  The step it replaced, a binary
// search over all R starts (24 levels at R = 15.6 M) with hi + 1's confined
// to a window after lo's run, took 2.39 ms a chr batch on an H100: some 30
// dependent loads a step, their number and not their latency alone setting
// the pace.  The directory leaves a step an entry of a 5 MB table, a search
// of one bucket's few starts and the run's record: 0.61 ms a chr batch.
// One thread a lane, and the step without the records, were timed beside
// it and lost on every path (PERF.md §6).  Over the dense and occ1 tables
// the chain is one load: at the L2's latency where the policy's tables fit
// the 50 MB L2, at a random cycle's latency beyond it (occ1 is A * (n + 1)
// entries, 192 MB at n = 8 M).  The dense step on one thread a lane, the
// whole block loaded for each rank and its 16 words counted, took 268 us
// a batch of 16,384 reads and 670 us over chr's dense tables on an H100;
// on two threads it takes 137 and 282, and on four it lost to two in the
// seeding machines, whose body every thread of a lane runs.  occ1's ranks
// on a pair of threads took 0.72-0.76x their one thread's time (PERF.md
// §6).

#include <cstdint>

#include <cuda_runtime.h>

#include "lf_rank.cuh"    // the rows' layout, the staging, the ftab k-mer and the step's ranks
#include "lf_tables.cuh"  // the tables' step and the per-step toehold's resolve

namespace {

// The block size and blocks an SM this file's kernels are built for, by
// lane type.  int32 lanes: __launch_bounds__(1024), the bound they were
// tuned and timed under, with no blocks an SM asked (0), which keeps their
// machine code.  int64 lanes: 512 threads, the block ops/cuda_lf.py
// launch_plan gives every lane type, and 2 blocks an SM (64 registers),
// over the plane rows of every width: 256 lanes a block, so a batch of
// 65,536 lanes runs in one wave on 132 SMs.  Under the 1024-thread bound
// ptxas held two blocks to 32 registers and they spilled; over the nibble
// rows the 256-symbol instances needed 95-108 registers and so one block
// an SM, two waves for such a batch (PERF.md §6).  K1's toehold instances
// (TOE) are built for 512 threads and 2 blocks an SM too: with no blocks
// asked ptxas held them to the registers of more blocks an SM, 32 under
// the 1024-thread bound and 40 under 512, and they spilled.
template <typename Lane, bool TOE = false>
struct LfBounds {
  static constexpr int kThreads = sizeof(Lane) == 8 || TOE ? 512 : 1024;
  static constexpr int kBlocks = sizeof(Lane) == 4 && !TOE ? 0 : 2;
};

// ---------------------------------------------------------------------------
// The search over the single-level rows

// One block: blockDim.x / kG lanes, kG neighbouring threads a lane, int32
// lanes, with the ftab start.  STAGE reads the codes from shared memory
// (staged once per block), else from global memory at every step (for
// batches too wide to stage).  TOE (no ftab start) also writes each lane's
// toehold into toe.k[b], 0 for a failed search.
template <int SYMS, bool STAGE, bool TOE>
__global__ void __launch_bounds__(LfBounds<int32_t, TOE>::kThreads,
                                  LfBounds<int32_t, TOE>::kBlocks)
lf_count_kernel(const int4* __restrict__ fb, const int32_t* __restrict__ F, int A, int n,
                const int32_t* __restrict__ q, const int32_t* __restrict__ lengths, int B, int L,
                const int32_t* __restrict__ ftab, int k, uint32_t acgt,
                int32_t* __restrict__ lo_out, int32_t* __restrict__ hi_out, Toe toe) {
  extern __shared__ __align__(16) uint8_t s_code[];  // [lanes of the block][stride] when STAGE
  __shared__ int32_t sF[kCkpt + 1];

  const int lanes = blockDim.x / kG;
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, B - b0);
  const int stride = staged_stride(L);
  if (threadIdx.x <= (unsigned)A) sF[threadIdx.x] = F[threadIdx.x];
  if (STAGE) stage_codes(s_code, q + (size_t)b0 * L, nl, L, A, stride);
  __syncthreads();

  const int ll = threadIdx.x / kG;
  if (ll >= nl) return;
  const int sub = threadIdx.x % kG;
  const int b = b0 + ll;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = q + (size_t)b * L;
  auto code_at = [&](int col) -> int {
    return STAGE ? (int)mine[col] : code_byte(row_q[col], A);
  };

  // ftab start (count.py:33-40): k > 0 only with the ftab on and L >= k
  const int len = lengths[b];
  int lo = 0, hi = n - 1;
  int j = 0;
  if (k > 0 && len >= k) {
    const int kc = kmer_code(code_at, L, k, acgt);
    if (kc >= 0) {
      const int flo = ftab[2 * (size_t)kc];
      if (flo >= 0) {
        lo = flo;
        hi = ftab[2 * (size_t)kc + 1];
        j = k;
      }
    }
  }

  // the kG threads of a lane: neighbouring lanes of one warp
  const unsigned pair = ((1u << kG) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(kG - 1));
  const int jend = min(len, L);
  // TOE: the code, pre-step hi and step of the last non-trivial step (tc <
  // 0, tj = -1: none yet); the trivial steps after it are the rest
  int tc = -1, tj = -1, thi = 0;
  for (; j < jend; ++j) {
    const int c = code_at(L - 1 - j);
    if (c >= A) {  // absent code: empty range, lane done
      lo = 1;
      hi = 0;
      break;
    }
    int cb, ce;
    bool trivial = false;  // BWT[hi] == c
    if constexpr (TOE) {
      rank_pair_toe<SYMS>(fb, lo, hi, c, sub, pair, cb, ce, trivial);
    } else {
      // rank(n, c) is the code's total count; hi + 1 does reach n
      int4 w[Layout<SYMS>::kPer];
      rank_pair<SYMS>(fb, n, sF[c + 1] - sF[c], lo, hi + 1, c, sub, pair, w, cb, ce);
    }
    const int ci = ce - cb;
    if (ci <= 0) {
      lo = 1;
      hi = 0;
      break;
    }
    if constexpr (TOE) {
      tc = trivial ? tc : c;
      thi = trivial ? thi : hi;
      tj = trivial ? tj : j;
    }
    lo = sF[c] + cb;
    hi = lo + ci - 1;
  }
  if (sub == 0) {
    lo_out[b] = lo;
    hi_out[b] = hi;
    // a lane whose search did not fail took every step to jend
    if constexpr (TOE)
      static_cast<int32_t*>(toe.k)[b] =
          hi < lo ? 0 : (int32_t)resolve_toehold(toe, n, tc, thi, jend - 1 - tj);
  }
}

// The record's stores: st.global.cs (__stcs, evict first), so that the L2
// lets their lines go before the rows'.  Timed on an H100 in turns and
// dropped (PERF.md §6): plain stores (1.001-1.004x the record's time), the
// stores split over a lane's two threads (0.99-1.003x), and the count's
// lanes of a warp stepping together as the record's do (0.99-1.04x).
__device__ __forceinline__ void store_rec(int64_t* p, int64_t v) {
  __stcs(reinterpret_cast<long long*>(p), (long long)v);
}

// The search over the two-level plane rows of a big index (lf_rank.cuh
// Planes): blockDim.x / kG lanes a block, kG neighbouring threads a lane,
// int64 lanes, F and base, no ftab start.  REC writes hi_rec[j][b], lane
// b's hi before step j, for every j in [0, L): every lane of a warp runs to
// L in step with the others, its range held once its search has ended (the
// empty range's hi 0 after a failure, the final hi past its read), so that
// each step's stores of a warp's lanes fill neighbouring columns of one row
// of the record.
template <int SYMS, bool STAGE, bool REC>
__global__ void __launch_bounds__(LfBounds<int64_t>::kThreads, LfBounds<int64_t>::kBlocks)
lf_count2_kernel(const int4* __restrict__ fb, const int64_t* __restrict__ F, Sup sup, int A,
                 int64_t n, const int32_t* __restrict__ q, const int32_t* __restrict__ lengths,
                 int B, int L, int64_t* __restrict__ lo_out, int64_t* __restrict__ hi_out,
                 int64_t* __restrict__ hi_rec) {
  extern __shared__ __align__(16) uint8_t s_code[];  // [lanes of the block][stride] when STAGE
  __shared__ int64_t sF[kCkpt + 1];

  const int lanes = blockDim.x / kG;
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, B - b0);
  const int stride = staged_stride(L);
  if (threadIdx.x <= (unsigned)A) sF[threadIdx.x] = F[threadIdx.x];
  if (STAGE) stage_codes(s_code, q + (size_t)b0 * L, nl, L, A, stride);
  __syncthreads();

  const int ll = threadIdx.x / kG;
  if (ll >= nl) return;
  const int sub = threadIdx.x % kG;
  const int b = b0 + ll;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = q + (size_t)b * L;
  auto code_at = [&](int col) -> int {
    return STAGE ? (int)mine[col] : code_byte(row_q[col], A);
  };
  const unsigned pair = ((1u << kG) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(kG - 1));
  const int jend = min(lengths[b], L);
  int64_t lo = 0, hi = n - 1;
  bool trivial = false;  // unused: no per-step toehold over the two-level rows
  if constexpr (REC) {
    bool live = true;  // the search has not failed
    for (int j = 0; j < L; ++j) {
      if (sub == 0) store_rec(hi_rec + (size_t)j * B + b, hi);
      if (live && j < jend)
        live = lf_step_rows<int64_t, SYMS>(fb, sF, sup, A, n, sub, pair, code_at(L - 1 - j), lo,
                                           hi, trivial);
    }
  } else {
    for (int j = 0; j < jend; ++j)
      if (!lf_step_rows<int64_t, SYMS>(fb, sF, sup, A, n, sub, pair, code_at(L - 1 - j), lo, hi,
                                       trivial))
        break;
  }
  if (sub == 0) {
    lo_out[b] = lo;
    hi_out[b] = hi;
  }
}

// The single-level search's arguments.
struct Args {
  const int4* fb;
  const int32_t* F;
  int A;
  int32_t n;
  const int32_t* q;
  const int32_t* lengths;
  int B, L;
  const int32_t* ftab;
  int k;
  uint32_t acgt;
  int32_t* lo;
  int32_t* hi;
  Toe toe;  // the toehold's tables (TOE instances), else zeros
};

template <int SYMS, bool STAGE, bool TOE>
int launch(const Args& a, int threads, cudaStream_t s) {
  if (threads > LfBounds<int32_t, TOE>::kThreads) return (int)cudaErrorInvalidValue;
  const int lanes = threads / kG;
  const size_t smem = STAGE ? (size_t)lanes * staged_stride(a.L) : 0;
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.B + lanes - 1) / lanes));
  lf_count_kernel<SYMS, STAGE, TOE><<<grid, threads, smem, s>>>(
      a.fb, a.F, a.A, a.n, a.q, a.lengths, a.B, a.L, a.ftab, a.k, a.acgt, a.lo, a.hi, a.toe);
  return (int)cudaGetLastError();
}

template <int SYMS, bool TOE = false>
int launch_staged(const Args& a, int threads, bool stage, cudaStream_t s) {
  return stage ? launch<SYMS, true, TOE>(a, threads, s) : launch<SYMS, false, TOE>(a, threads, s);
}

// The two-level search, with the step record where hi_rec is not null.
struct Args2 {
  const int4* fb;
  const int64_t* F;
  Sup sup;
  int A;
  int64_t n;
  const int32_t* q;
  const int32_t* lengths;
  int B, L;
  int64_t* lo;
  int64_t* hi;
  int64_t* hi_rec;  // [L, B], or null for no step record
};

template <int SYMS, bool STAGE, bool REC>
int launch2(const Args2& a, int threads, cudaStream_t s) {
  if (threads > LfBounds<int64_t>::kThreads) return (int)cudaErrorInvalidValue;
  const int lanes = threads / kG;
  const size_t smem = STAGE ? (size_t)lanes * staged_stride(a.L) : 0;
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.B + lanes - 1) / lanes));
  lf_count2_kernel<SYMS, STAGE, REC><<<grid, threads, smem, s>>>(
      a.fb, a.F, a.sup, a.A, a.n, a.q, a.lengths, a.B, a.L, a.lo, a.hi, a.hi_rec);
  return (int)cudaGetLastError();
}

template <int SYMS>
int launch_fb2(const Args2& a, int threads, bool stage, cudaStream_t s) {
  if (a.hi_rec)
    return stage ? launch2<SYMS, true, true>(a, threads, s) : launch2<SYMS, false, true>(a, threads, s);
  return stage ? launch2<SYMS, true, false>(a, threads, s) : launch2<SYMS, false, false>(a, threads, s);
}

bool bad_launch(int A, int B, int L, int threads) {
  return A < 1 || A > kCkpt || B < 0 || L < 0 || threads < 32 || threads > 1024 ||
         threads % 32 != 0;
}

// ---------------------------------------------------------------------------
// The search over the rank tables of an index without fused rows

// blockDim.x / G lanes a block, G = lane_threads(POLICY) neighbouring
// threads a lane, the first of them writing.  The count search of
// rowbowt_tpu_torch/ops/cuda_lf.py lf_loop_plain over the POLICY tables
// (REC: the run-space tables through the run records), from the ftab start where k > 0
// (ftab int32 or int64, ftab_bytes); TOE (no ftab) also carries the
// per-step toehold as lf_count_kernel's TOE instance does and writes it
// into toe.k.  The codes come from shared memory when `stage` (staged once
// per block), else from global memory at every step.
template <typename Lane, int POLICY, bool TOE, bool REC>
__global__ void __launch_bounds__(LfBounds<Lane>::kThreads, LfBounds<Lane>::kBlocks)
lf_tables_kernel(Tabs t, const Lane* __restrict__ F, int A, Lane n,
                 const int32_t* __restrict__ q, const int32_t* __restrict__ lengths, int B,
                 int L, bool stage, const void* ftab, int ftab_bytes, int k, uint32_t acgt,
                 Lane* __restrict__ lo_out, Lane* __restrict__ hi_out, Toe toe) {
  constexpr int G = lane_threads(POLICY);
  extern __shared__ __align__(16) uint8_t s_code[];  // [lanes of the block][stride] when stage
  const int lanes = blockDim.x / G;
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, B - b0);
  const int stride = staged_stride(L);
  stage_F<POLICY>(F, A);  // the dense and occ1 steps' F, in shared memory
  if (stage) stage_codes(s_code, q + (size_t)b0 * L, nl, L, A, stride);
  __syncthreads();
  const int ll = threadIdx.x / G;
  if (ll >= nl) return;
  const int sub = threadIdx.x % G;
  const unsigned pair = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(G - 1));
  const int b = b0 + ll;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = q + (size_t)b * L;
  auto code_at = [&](int col) -> int {
    return stage ? (int)mine[col] : code_byte(row_q[col], A);
  };

  const int len = lengths[b];
  Lane lo = 0, hi = n - 1;
  int j = 0;
  if (k > 0 && len >= k) {
    const int kc = kmer_code(code_at, L, k, acgt);
    if (kc >= 0) {
      const int64_t flo = load_at(ftab, ftab_bytes, 2 * (int64_t)kc);
      if (flo >= 0) {
        lo = (Lane)flo;
        hi = (Lane)load_at(ftab, ftab_bytes, 2 * (int64_t)kc + 1);
        j = k;
      }
    }
  }
  const int jend = min(len, L);
  // TOE: the code and pre-step hi of the last non-trivial step (tc < 0:
  // none yet), and the trivial steps since it (since the start while none)
  int tc = -1, triv = 0;
  Lane thi = 0;
  for (; j < jend; ++j) {
    const int c = code_at(L - 1 - j);
    const Lane h0 = hi;
    bool trivial = false;  // BWT[hi] == c
    if (!lf_step_tables<Lane, POLICY, TOE, REC>(t, step_F<POLICY>(F), A, n, sub, pair, c, lo,
                                                hi, trivial))
      break;
    if constexpr (TOE) {
      if (trivial) {
        ++triv;
      } else {
        tc = c;
        thi = h0;
        triv = 0;
      }
    }
  }
  if (sub != 0) return;
  lo_out[b] = lo;
  hi_out[b] = hi;
  if constexpr (TOE)
    static_cast<Lane*>(toe.k)[b] = hi < lo ? 0 : (Lane)resolve_toehold(toe, n, tc, thi, triv);
}

template <typename Lane>
struct TabArgs {
  Tabs t;
  const Lane* F;
  int A;
  Lane n;
  const int32_t* q;
  const int32_t* lengths;
  int B, L;
  const void* ftab;
  int ftab_bytes, k;
  uint32_t acgt;
  Lane* lo;
  Lane* hi;
  Toe toe;  // the toehold's tables and k (TOE instances), else zeros
};

template <typename Lane, int POLICY, bool TOE, bool REC = false>
int launch_tables(const TabArgs<Lane>& a, int threads, bool stage, cudaStream_t s) {
  if (threads > LfBounds<Lane>::kThreads) return (int)cudaErrorInvalidValue;
  const int lanes = threads / lane_threads(POLICY);
  const size_t smem = stage ? (size_t)lanes * staged_stride(a.L) : 0;
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.B + lanes - 1) / lanes));
  lf_tables_kernel<Lane, POLICY, TOE, REC><<<grid, threads, smem, s>>>(
      a.t, a.F, a.A, a.n, a.q, a.lengths, a.B, a.L, stage, a.ftab, a.ftab_bytes, a.k, a.acgt,
      a.lo, a.hi, a.toe);
  return (int)cudaGetLastError();
}

template <typename Lane, bool TOE>
int launch_policy(int policy, const TabArgs<Lane>& a, int threads, bool stage, cudaStream_t s) {
  if (policy == kRuns) {
    if constexpr (sizeof(Lane) == 4) {  // the run records are int32
      if (a.t.rec != nullptr) return launch_tables<Lane, kRuns, TOE, true>(a, threads, stage, s);
    }
    return launch_tables<Lane, kRuns, TOE>(a, threads, stage, s);
  }
  if (policy == kDense) return launch_tables<Lane, kDense, TOE>(a, threads, stage, s);
  return launch_tables<Lane, kOcc1, TOE>(a, threads, stage, s);
}

template <typename Lane>
int launch_lanes(int policy, const TabArgs<Lane>& a, int threads, bool stage, cudaStream_t s) {
  return a.toe.k != nullptr ? launch_policy<Lane, true>(policy, a, threads, stage, s)
                            : launch_policy<Lane, false>(policy, a, threads, stage, s);
}

}  // namespace

extern "C" {

// Runs K1 on `stream` over the B lanes of the row-major [B, L] codes q and
// writes each lane's range to lo and hi; returns cudaGetLastError() after
// the launch (0 on success, nothing launched for B == 0).  syms_per_row is 64
// (fblock64) or 128 (fblock).  ftab is int32 [4^k, 2] and k its k-mer length,
// or k = 0 for no ftab start; acgt holds the codes of A, C, G, T, one byte
// each (0xFF for a base absent from the alphabet).  `threads` is the block
// size (two threads a lane; at most 1024, 512 over the two-level rows:
// LfBounds); `stage` reads the codes from shared memory (threads
// / 2 * staged stride bytes, at most 47 KB).  Both come from ops/cuda_lf.py
// launch_plan.
int rbt_lf_count(const void* fb, int syms_per_row, const void* F, int A, int n,
                 const void* q, const void* lengths, int B, int L,
                 const void* ftab, int k, int acgt, void* lo, void* hi,
                 int threads, int stage, void* stream) {
  if (bad_launch(A, B, L, threads) || n < 1 || k < 0 || k > 15 ||
      (k > 0 && (ftab == nullptr || L < k)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{static_cast<const int4*>(fb), static_cast<const int32_t*>(F), A, n,
               static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B, L,
               static_cast<const int32_t*>(ftab), k, (uint32_t)acgt, static_cast<int32_t*>(lo),
               static_cast<int32_t*>(hi), {}};
  cudaStream_t s = (cudaStream_t)stream;
  if (syms_per_row == 64) return launch_staged<64>(a, threads, stage, s);
  if (syms_per_row == 128) return launch_staged<128>(a, threads, stage, s);
  return (int)cudaErrorInvalidValue;
}

// K1 over the two-level plane rows of a big index (lf_rank.cuh Planes,
// 128-byte aligned): int64 F [A + 1], base int64 [n_sup, 8], and a row's
// superblock (row * blk_mul) >> blk_shift (ops/rank.py superblock_magic of
// the layout's own rows a superblock: twice the artifact's per_blk for the
// 64-symbol repack), n as 64 bits, int64 lo and hi out; syms_per_row is 64
// (from fb2_64), 128 (fb2) or 256 (fb2_256).  No ftab.  With hi_rec (int64
// [L, B]) it also writes the step record: hi_rec[j][b] is lane b's hi
// before step j, 0 after the step at which the lane's range became empty,
// and the final hi for j >= its length; a null hi_rec writes none.  The
// other arguments and the return value are rbt_lf_count's.
int rbt_lf_count_fb2(const void* fb, int syms_per_row, const void* F, const void* base,
                     unsigned blk_mul, int blk_shift, int A, long long n, const void* q,
                     const void* lengths, int B, int L, void* lo, void* hi, void* hi_rec,
                     int threads, int stage, void* stream) {
  const int shift = syms_per_row == 64 ? 6 : syms_per_row == 128 ? 7 : 8;
  if (bad_launch(A, B, L, threads) || n < 1 || ((n - 1) >> shift) >= INT32_MAX ||
      blk_shift < 31 || blk_shift > 62 || blk_mul < (1u << 31) || base == nullptr ||
      ((uintptr_t)fb & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args2 a{static_cast<const int4*>(fb), static_cast<const int64_t*>(F),
                Sup{static_cast<const int64_t*>(base), blk_mul, blk_shift}, A, (int64_t)n,
                static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B, L,
                static_cast<int64_t*>(lo), static_cast<int64_t*>(hi),
                static_cast<int64_t*>(hi_rec)};
  cudaStream_t s = (cudaStream_t)stream;
  if (syms_per_row == 64) return launch_fb2<64>(a, threads, stage, s);
  if (syms_per_row == 128) return launch_fb2<128>(a, threads, stage, s);
  if (syms_per_row == 256) return launch_fb2<256>(a, threads, stage, s);
  return (int)cudaErrorInvalidValue;
}

// The per-step toehold search (TOE) over the single-level rows: from the
// full range (no ftab start), lo, hi and k (int32 [B]) out, k the toehold
// of rbt_align -s on an index without kval and 0 for a failed search.  The
// toehold's tables are each int32 or int64 (*_bytes 4 or 8): tk1 [A * n]
// where resident (ltk, run_start and rs_off are then not read and may be
// null), else ltk [A * R], run_start [R] and its bucket directory rs_off
// [n_off] (off_bytes; n_off == (n >> shift) + 2, at most `iters` halvings a
// bucket: engine/device.run_directory); samples_last [R] always.  `threads`
// is at most 512 (LfBounds).  The other arguments and the return value are
// rbt_lf_count's.
int rbt_lf_toehold(const void* fb, int syms_per_row, const void* F, int A, int n,
                   const void* q, const void* lengths, int B, int L, const void* tk1,
                   int tk1_bytes, const void* ltk, int ltk_bytes, const void* run_start,
                   int rs_bytes, const void* rs_off, int off_bytes, long long n_off, int shift,
                   int iters, const void* samples_last, int sl_bytes, int R, void* lo, void* hi,
                   void* k, int threads, int stage, void* stream) {
  const Toe toe{tk1, ltk, run_start, samples_last, rs_off, tk1_bytes, ltk_bytes, rs_bytes,
                sl_bytes, off_bytes, R, n_off, shift, iters, k};
  if (bad_launch(A, B, L, threads) || n < 1 || !valid_toe(toe, n) || k == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{static_cast<const int4*>(fb), static_cast<const int32_t*>(F), A, n,
               static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B, L,
               nullptr, 0, 0u, static_cast<int32_t*>(lo), static_cast<int32_t*>(hi), toe};
  cudaStream_t s = (cudaStream_t)stream;
  if (syms_per_row == 64) return launch_staged<64, true>(a, threads, stage, s);
  if (syms_per_row == 128) return launch_staged<128, true>(a, threads, stage, s);
  return (int)cudaErrorInvalidValue;
}

// The search over the rank tables of an index without fused rows: `policy`
// 0 (runs: occ = occ_flat, run_start, run_head, R, and the bucket directory
// rs_off [n_off] over run_start, n_off == (n >> shift) + 2, searched in at
// most `iters` halvings a bucket), 1 (dense: occ = occ_blk_flat, bwt4 int32
// [nb * 16] 16-byte aligned, A at most 16) or 2 (occ1: occ = occ1_flat, A at
// most 16); the toehold over ltk reads run_start and rs_off too, under
// every policy;
// each table int32 or int64 (*_bytes), run_head and rs_off too.  `rec`
// (runs only, else null) is null or the run records (int32 [R * 8], 32-byte
// aligned; A at most 6, int32 lanes), which the step then reads instead of
// run_start, run_head and occ_flat.  Lanes, F [A + 1], lo and hi
// are int32 or int64 (lane_bytes), the codes and lengths int32.  With k_out
// null it is the count search, from the ftab start where kf > 0 (ftab int32
// or int64 [4^kf, 2], acgt as rbt_lf_count's); with k_out, the toehold
// search (kf 0) over tk1 [A * n] where given, else ltk [A * R] with
// run_start and rs_off, and samples_last [R], each int32 or int64, k_out in
// the lane type.  `threads` is the block size (lane_threads(policy), two
// threads a lane; at most 1024 with int32 lanes, 512 with int64:
// LfBounds); `stage` reads the codes from shared memory (lanes a block *
// staged stride bytes, at most 47 KB); both from ops/cuda_lf.py
// launch_plan.  Returns
// cudaGetLastError() after the launch (0 on success, nothing launched for B
// == 0).
int rbt_lf_tables(int policy, const void* occ, int occ_bytes, const void* run_start,
                  int rs_bytes, const void* run_head, int rh_bytes, const void* rs_off,
                  int off_bytes, long long n_off, int shift, int iters, const void* rec,
                  const void* bwt4, long long nb, int R, const void* F, int lane_bytes, int A,
                  long long n, const void* q, const void* lengths, int B, int L,
                  const void* ftab, int ftab_bytes, int kf, int acgt, const void* tk1,
                  int tk1_bytes, const void* ltk, int ltk_bytes, const void* samples_last,
                  int sl_bytes, void* lo, void* hi, void* k_out, int threads, int stage,
                  void* stream) {
  auto width = [](int bytes) { return bytes == 4 || bytes == 8; };
  const bool runs = policy == kRuns && run_start != nullptr && run_head != nullptr &&
                    width(rs_bytes) && width(rh_bytes) && R >= 1 &&
                    valid_directory(rs_off, off_bytes, n_off, shift, iters, n) &&
                    (rec == nullptr || valid_records(rec, A, lane_bytes));
  const bool dense = policy == kDense && rec == nullptr && bwt4 != nullptr && A < kMaxF &&
                     ((uintptr_t)bwt4 & 15) == 0 && nb >= (n + 127) / 128;
  const bool tables = occ != nullptr && width(occ_bytes) &&
                      (runs || dense || (policy == kOcc1 && rec == nullptr && A < kMaxF));
  const Toe te{tk1, ltk, run_start, samples_last, rs_off, tk1_bytes, ltk_bytes, rs_bytes,
               sl_bytes, off_bytes, R, n_off, shift, iters, k_out};
  const bool toe_tables = k_out == nullptr || (kf == 0 && valid_toe(te, n));
  if (!tables || !toe_tables || A < 1 || A > 254 || B < 0 || L < 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || n < 1 || kf < 0 || kf > 15 ||
      (kf > 0 && (ftab == nullptr || !width(ftab_bytes) || L < kf)) ||
      (lane_bytes == 4 ? n >= INT32_MAX : lane_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Tabs t{occ, run_start, run_head, static_cast<const int4*>(bwt4), rs_off,
               static_cast<const int4*>(rec), occ_bytes, rs_bytes, rh_bytes, off_bytes, R, nb,
               n_off, shift, iters};
  cudaStream_t s = (cudaStream_t)stream;
  const auto* q32 = static_cast<const int32_t*>(q);
  const auto* len = static_cast<const int32_t*>(lengths);
  if (lane_bytes == 4) {
    const TabArgs<int32_t> a{t, static_cast<const int32_t*>(F), A, (int32_t)n, q32, len, B, L,
                             ftab, ftab_bytes, kf, (uint32_t)acgt, static_cast<int32_t*>(lo),
                             static_cast<int32_t*>(hi), te};
    return launch_lanes(policy, a, threads, stage != 0, s);
  }
  const TabArgs<int64_t> a{t, static_cast<const int64_t*>(F), A, (int64_t)n, q32, len, B, L,
                           ftab, ftab_bytes, kf, (uint32_t)acgt, static_cast<int64_t*>(lo),
                           static_cast<int64_t*>(hi), te};
  return launch_lanes(policy, a, threads, stage != 0, s);
}

// Threads a lane of the tables kernels' `policy` step (lf_tables.cuh
// lane_threads), or 0 for a policy outside 0..2.
int rbt_lane_threads(int policy) {
  return policy == kRuns || policy == kDense || policy == kOcc1 ? lane_threads(policy) : 0;
}

const char* rbt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
