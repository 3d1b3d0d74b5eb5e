// The LF step over the rank tables of an index without fused rows, and the
// per-step toehold's resolve, shared by the kernels that step on them:
// lf.cu (the tables kernel, lf_tables_kernel, and K1's toehold instance)
// and seeds.cu (the seeding state machines over those tables, and the
// sampled machine's per-step toehold).
//
// Everything here sits in an anonymous namespace: each .cu file that
// includes it builds into a library of its own.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lf_rank.cuh"

namespace {

// The rank policy (ops/cuda_lf.py TABLE_POLICIES), lf_step_auto's choice
// among an index's tables: the run-space tables, the dense blocks, or occ1.
enum Policy : int { kRuns = 0, kDense = 1, kOcc1 = 2 };
constexpr int kDenseVec = 4;  // int4 parts of a dense block: 16 words, 128 symbols
constexpr int kDenseG = 2;    // threads a lane of the dense step, two parts of a block each
constexpr int kDensePer = kDenseVec / kDenseG;  // parts of a block a thread holds
static_assert(kDenseVec % kDenseG == 0, "each thread of a lane holds as many parts");
// F entries the dense and occ1 steps read from shared memory: their tables
// hold at most 16 codes (bwt4's nibbles; a raw build writes occ1 beside them)
constexpr int kMaxF = 17;

// Threads a lane of the POLICY step: the run-space and occ1 steps rank lo
// on the first of two neighbouring threads and hi + 1 on the second,
// joined by a shuffle (65,536 lanes fill under a quarter of an H100's
// thread slots, so both ranks' loads are in flight at once, and each
// thread's step is half as long); the dense step splits each 64 B block
// over kDenseG threads, which count their words and sum them by shuffle.
__host__ __device__ constexpr int lane_threads(int policy) {
  return policy == kDense ? kDenseG : 2;
}

// F [A + 1] of the dense and occ1 steps: each block's copy in shared
// memory, which stage_F fills before the block's __syncthreads(); the
// run-space step reads F from global memory (step_F).
template <typename Lane>
__device__ __forceinline__ Lane* shared_F() {
  __shared__ Lane sF[kMaxF];
  return sF;
}

template <int POLICY, typename Lane>
__device__ __forceinline__ void stage_F(const Lane* F, int A) {
  if constexpr (POLICY != kRuns) {
    if (threadIdx.x <= (unsigned)A) shared_F<Lane>()[threadIdx.x] = F[threadIdx.x];
  }
}

template <int POLICY, typename Lane>
__device__ __forceinline__ const Lane* step_F(const Lane* F) {
  if constexpr (POLICY == kRuns) {
    return F;
  } else {
    return shared_F<Lane>();
  }
}

// The rank tables, each int32 or int64 as the index holds it (*_bytes): occ
// is occ_flat [A * R] (runs), occ_blk_flat [A * nb] (dense) or occ1_flat
// [A * (n + 1)] (occ1); run_start and run_head [R], and the bucket
// directory rs_off [n_off] over run_start with its (shift, iters) (runs);
// rec [R * 8], 32-byte aligned, or null: the run records (int32 run_start,
// run_head, occ[0..6) a run; A <= 6, int32 lanes), which the REC instances
// read instead of run_start, run_head and occ_flat; bwt4 [nb * 16], the
// dense blocks' words of 8 nibbles (dense).
struct Tabs {
  const void* occ;
  const void* run_start;
  const void* run_head;
  const int4* bwt4;
  const void* rs_off;
  const int4* rec;
  int occ_bytes, rs_bytes, rh_bytes, off_bytes;
  int R;
  long long nb;
  long long n_off;
  int shift, iters;
};

// Whether rs_off is a bucket directory the run-space step can search: int32
// or int64, n_off == (n >> shift) + 2 entries (ops/cuda_lf.py checks that
// they are run_directory's over this run_start), at most iters halvings a
// bucket.
inline bool valid_directory(const void* rs_off, int off_bytes, long long n_off, int shift,
                            int iters, long long n) {
  return rs_off != nullptr && (off_bytes == 4 || off_bytes == 8) && shift >= 0 && shift < 63 &&
         iters >= 1 && iters <= 32 && n_off == (n >> shift) + 2;
}

// Whether rec can hold the run records: 32-byte aligned, an alphabet of at
// most 6 codes, int32 lanes.
inline bool valid_records(const void* rec, int A, int lane_bytes) {
  return rec != nullptr && ((uintptr_t)rec & 31) == 0 && A >= 1 && A <= 6 && lane_bytes == 4;
}

// The per-step toehold's tables (TOE instances), each int32 or int64 as the
// index holds it on the card (*_bytes): tk1 [A * n] where it is resident,
// else ltk [A * R] with run_start [R] and its bucket directory rs_off
// [n_off] with (shift, iters) (engine/device.run_directory); samples_last
// [R] for k0; and k, the toehold out, in the lane type (K1's and the tables
// kernel's).
struct Toe {
  const void* tk1;
  const void* ltk;
  const void* run_start;
  const void* samples_last;
  const void* rs_off;
  int tk1_bytes, ltk_bytes, rs_bytes, sl_bytes, off_bytes;
  int R;
  long long n_off;
  int shift, iters;
  void* k;
};

// Whether t holds the tables a resolve over an index of n positions reads:
// samples_last, and tk1, or ltk with run_start and a valid directory.
inline bool valid_toe(const Toe& t, long long n) {
  auto width = [](int bytes) { return bytes == 4 || bytes == 8; };
  return t.samples_last != nullptr && width(t.sl_bytes) && t.R >= 1 &&
         (t.tk1 != nullptr ? width(t.tk1_bytes)
                           : t.ltk != nullptr && t.run_start != nullptr && width(t.ltk_bytes) &&
                                 width(t.rs_bytes) &&
                                 valid_directory(t.rs_off, t.off_bytes, t.n_off, t.shift,
                                                 t.iters, n));
}

// The run of position x (0 <= x < n) over run_start [*] (rs_bytes) and its
// bucket directory rs_off [n_off] (off_bytes, 2^shift positions a bucket):
// ops/rank.py bucketed_lower_bound(run_start, rs_off, shift, iters, x + 1) -
// 1.  rs_off[b] is the first run starting at or after b << shift, so the
// runs starting in x + 1's bucket are the only ones left to search: at most
// `iters` halvings of a segment of a few starts, one or two 128 B lines that
// the first probe brings into L1.  With START, `start` receives the run's
// start: the last probe below x + 1 where there was one, else one more load.
template <bool START>
__device__ __forceinline__ int run_search(const void* run_start, int rs_bytes, const void* rs_off,
                                          int off_bytes, long long n_off, int shift, int iters,
                                          int64_t x, int64_t& start) {
  const int64_t q = x + 1;
  const int64_t last = n_off - 2;  // the last bucket takes q == n
  const int64_t b = (q >> shift) < last ? (q >> shift) : last;
  int lo = (int)load_at(rs_off, off_bytes, b);
  int hi = (int)load_at(rs_off, off_bytes, b + 1);
  bool known = false;
  for (int it = 0; it < iters && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;
    const int64_t v = load_at(run_start, rs_bytes, mid);
    if (v < q) {
      lo = mid + 1;
      start = v;
      known = true;
    } else {
      hi = mid;
    }
  }
  if (START && !known) start = load_at(run_start, rs_bytes, lo - 1);
  return lo - 1;
}

// k of a lane whose search did not fail: the table value of its last
// non-trivial step (code tc >= 0, pre-step hi thi), or k0 where it had none
// (tc < 0), less its `triv` trivial steps since, mod n.  The ltk route finds
// the run of thi as ops/rank.py lf_step_w_loc does: the run of min(thi + 1,
// n - 1) through the directory (run_search), one less where thi + 1 < n
// starts that run: the directory's entry, at most `iters` probes of one
// bucket and the ltk load, in place of a search over all R starts.
__device__ int64_t resolve_toehold(const Toe& t, int64_t n, int tc, int64_t thi, int triv) {
  int64_t base;
  if (tc < 0) {
    base = (load_at(t.samples_last, t.sl_bytes, t.R - 1) + 1) % n;
  } else if (t.tk1 != nullptr) {
    base = load_at(t.tk1, t.tk1_bytes, (int64_t)tc * n + thi);
  } else {
    const int64_t x = thi + 1 < n ? thi + 1 : n - 1;
    int64_t start;
    int r = run_search<true>(t.run_start, t.rs_bytes, t.rs_off, t.off_bytes, t.n_off, t.shift,
                             t.iters, x, start);
    if (thi + 1 < n && start == thi + 1) --r;
    base = load_at(t.ltk, t.ltk_bytes, (int64_t)tc * t.R + r);
  }
  const int64_t k = (base - triv) % n;
  return k < 0 ? k + n : k;
}

// The run of position x (0 <= x < n) through the tables' directory
// (run_search).
template <bool START>
__device__ __forceinline__ int run_of(const Tabs& t, int64_t x, int64_t& start) {
  return run_search<START>(t.run_start, t.rs_bytes, t.rs_off, t.off_bytes, t.n_off, t.shift,
                           t.iters, x, start);
}

// The code of run r: from its record (REC) or run_head.
template <bool REC>
__device__ __forceinline__ int head_of(const Tabs& t, int r) {
  if constexpr (REC) return __ldg(t.rec + 2 * (size_t)r).y;
  return (int)load_at(t.run_head, t.rh_bytes, r);
}

// rank(i, c) over the run-space tables (ops/rank.py rank_at_run, i < n):
// the count of c before i's run, plus i - start where the run is of c.
// `head` receives the run's code, `start` its start.  REC reads all three
// from the run's record, one 32-byte sector (occ[c] in its first half for c
// < 2, else its second); else run_start (where the search left no start),
// run_head and occ_flat, independent loads.
template <bool REC>
__device__ __forceinline__ int64_t rank_runs(const Tabs& t, int64_t i, int c, int& r,
                                             int64_t& start, int& head) {
  int64_t occ;
  if constexpr (REC) {
    r = run_of<false>(t, i, start);
    const int4* p = t.rec + 2 * (size_t)r;
    const int4 a = __ldg(p);
    start = a.x;
    head = a.y;
    occ = c < 2 ? lane_of(a, 2 + c) : lane_of(__ldg(p + 1), c - 2);
  } else {
    r = run_of<true>(t, i, start);
    head = (int)load_at(t.run_head, t.rh_bytes, r);
    occ = load_at(t.occ, t.occ_bytes, (int64_t)c * t.R + r);
  }
  return occ + (head == c ? i - start : 0);
}

// The nibbles of the word x equal to c (pat = c in every nibble): the top
// bit of each matching nibble.  A nibble t of x ^ pat is 0 exactly where
// neither (t & 7) + 7 nor t sets its top bit, and no sum carries out of its
// nibble.
__device__ __forceinline__ uint32_t nibble_matches(uint32_t x, uint32_t pat) {
  const uint32_t t = x ^ pat;
  return ~(((t & 0x77777777u) + 0x77777777u) | t) & 0x88888888u;
}

// The matches of a word below bit `shift` (4 * the symbols of the word
// counted, any int): the word's low min(max(shift, 0), 32) bits.
__device__ __forceinline__ int count_below(uint32_t matches, int shift) {
  return __popc(matches & __funnelshift_lc(0xFFFFFFFFu, 0u, (unsigned)max(shift, 0)));
}

// This thread's shares of a dense step, packed: bits 0-7 the nibbles equal
// to c among the first off0 symbols of block v0, bits 8-15 among the first
// off1 of block v1 (v0's own registers and matches where `one`), and with
// TOE bits 16-19 the symbol at offset soff of v1 (in1) or v0 (in0) where
// this thread holds its word.  The thread holds part sub + m * kDenseG of
// each block in v0[m] and v1[m], symbols 32 * part on, so the kDenseG
// shares of a lane sum to the two in-block counts (at most 127 each) and
// the symbol.
template <bool TOE>
__device__ __forceinline__ uint32_t dense_shares(const int4 (&v0)[kDensePer],
                                                 const int4 (&v1)[kDensePer], bool one, int sub,
                                                 uint32_t pat, int off0, int off1, bool in0,
                                                 bool in1, int soff) {
  uint32_t s0 = 0, s1 = 0, sym = 0;
#pragma unroll
  for (int m = 0; m < kDensePer; ++m) {
    const int part = sub + m * kDenseG;
    const int a0 = 4 * (off0 - 32 * part), a1 = 4 * (off1 - 32 * part);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t m0 = nibble_matches((uint32_t)lane_of(v0[m], e), pat);
      const uint32_t m1 = one ? m0 : nibble_matches((uint32_t)lane_of(v1[m], e), pat);
      s0 += count_below(m0, a0 - 32 * e);
      s1 += count_below(m1, a1 - 32 * e);
      if (TOE && (in0 || in1) && soff >> 3 == 4 * part + e)
        sym = ((uint32_t)lane_of(in1 ? v1[m] : v0[m], e) >> (4 * (soff & 7))) & 15u;
    }
  }
  return s0 | s1 << 8 | sym << 16;
}

// rank(x, c) of one thread over the run-space tables, the code's total
// where x == n; with HEAD, `head` receives the code at x - 1 (BWT[hi] for x
// = hi + 1): x's run's, or the run's before where x starts its run, or the
// last run's where x == n.
template <bool REC, bool HEAD, typename Lane>
__device__ __forceinline__ Lane rank_or_total(const Tabs& t, Lane n, Lane total, Lane x, int c,
                                              int& head) {
  if (x >= n) {
    if constexpr (HEAD) head = head_of<REC>(t, t.R - 1);
    return total;
  }
  int r, h;
  int64_t s;
  const Lane rk = (Lane)rank_runs<REC>(t, x, c, r, s, h);
  if constexpr (HEAD) head = s == x ? head_of<REC>(t, r - 1) : h;
  return rk;
}

// One LF step of a lane over the POLICY tables: (lo, hi) becomes LF((lo,
// hi), c), or the empty range (1, 0) where that is empty or c lies outside
// [0, A); returns whether it is non-empty.  F [A + 1] is global memory for
// the run-space step, shared memory (at most kMaxF entries) for the dense
// and occ1 steps.  A lane runs on its lane_threads(POLICY) neighbouring
// threads (sub 0 .. G - 1 of the warp's `pair` mask), which take the same
// branches.  The run-space and occ1 steps rank lo on sub 0 and hi + 1 on
// sub 1, and a shuffle gives both the pair.  The dense step fetches lo's
// 64 B block and hi + 1's, kDensePer 16-byte parts a thread, once where
// both lie in one block; each thread counts c among its words below each
// offset, and the lane's shares are summed by shuffle, with the
// checkpoints of c (one entry for one block) added after.
// TOE also sets `trivial` to BWT[hi] == c for the pre-step hi, from the
// policy's own tables: hi + 1's run (runs), the fetched block that holds hi
// or else one word of bwt4 (dense), occ1 at hi (occ1).  REC (run-space,
// int32 lanes) reads the run records.
template <typename Lane, int POLICY, bool TOE, bool REC = false>
__device__ __forceinline__ bool lf_step_tables(const Tabs& t, const Lane* __restrict__ F, int A,
                                               Lane n, int sub, unsigned pair, int c, Lane& lo,
                                               Lane& hi, bool& trivial) {
  static_assert(POLICY == kRuns || !REC, "the run records are the run-space step's");
  if (c >= A) {  // absent code: empty range
    lo = 1;
    hi = 0;
    return false;
  }
  Lane fc;
  if constexpr (POLICY == kRuns) {
    fc = (Lane)load_at(F, sizeof(Lane), c);
  } else {
    fc = F[c];
  }
  const Lane i1 = hi + 1;
  Lane cb, ce;
  if constexpr (POLICY == kOcc1) {
    // one load a rank (row c of occ1 has n + 1 entries): lo's on sub 0,
    // hi + 1's on sub 1, joined by a shuffle; for TOE both load occ1 at hi
    // (one sector) for BWT[hi] == c
    const int64_t row = (int64_t)c * ((int64_t)n + 1);
    const Lane mine = (Lane)load_at(t.occ, t.occ_bytes, row + (sub ? i1 : lo));
    const Lane at_hi = TOE ? (Lane)load_at(t.occ, t.occ_bytes, row + hi) : 0;
    const Lane other = __shfl_xor_sync(pair, mine, 1);
    cb = sub ? other : mine;
    ce = sub ? mine : other;
    if constexpr (TOE) trivial = ce - at_hi == 1;
  } else if constexpr (POLICY == kDense) {
    // rank(n, c) is the code's total count
    const Lane total = F[c + 1] - fc;
    const bool has0 = lo < n, has1 = i1 < n;
    const int64_t b0 = (int64_t)lo >> 7, b1 = (int64_t)i1 >> 7;
    const bool one = has0 && has1 && b0 == b1;  // one fetch serves both ranks
    int4 v0[kDensePer], v1[kDensePer];
#pragma unroll
    for (int m = 0; m < kDensePer; ++m) {
      const int part = sub + m * kDenseG;
      v0[m] = has0 ? __ldg(t.bwt4 + b0 * kDenseVec + part) : make_int4(0, 0, 0, 0);
      v1[m] = has1 && !one ? __ldg(t.bwt4 + b1 * kDenseVec + part) : v0[m];
    }
    const int64_t k0 = has0 ? load_at(t.occ, t.occ_bytes, (int64_t)c * t.nb + b0) : 0;
    const int64_t k1 = one ? k0 : has1 ? load_at(t.occ, t.occ_bytes, (int64_t)c * t.nb + b1) : 0;
    // BWT[hi]: in hi + 1's block unless hi + 1 starts it or is n, else in
    // lo's where hi lies there, else one word of bwt4
    const bool in1 = TOE && has1 && (i1 & 127) != 0;
    const bool in0 = TOE && !in1 && has0 && ((int64_t)hi >> 7) == b0;
    uint32_t word = 0;
    if (TOE && !in0 && !in1)
      word = (uint32_t)__ldg(reinterpret_cast<const int32_t*>(t.bwt4) + (hi >> 3));
    uint32_t s = dense_shares<TOE>(v0, v1, one, sub, (uint32_t)c * 0x11111111u, (int)(lo & 127),
                                   (int)(i1 & 127), in0, in1,
                                   in1 ? (int)(i1 & 127) - 1 : (int)(hi & 127));
#pragma unroll
    for (int d = 1; d < kDenseG; d <<= 1) s += __shfl_xor_sync(pair, s, d);
    cb = has0 ? (Lane)(k0 + (s & 0xFFu)) : total;
    ce = has1 ? (Lane)(k1 + ((s >> 8) & 0xFFu)) : total;
    if constexpr (TOE) {
      const uint32_t sym = in0 || in1 ? s >> 16 : (word >> (4 * (int)(hi & 7))) & 15u;
      trivial = (int)sym == c;
    }
  } else {
    // lo's rank on sub 0, hi + 1's (and BWT[hi]) on sub 1
    const Lane total = (Lane)load_at(F, sizeof(Lane), c + 1) - fc;
    int head = -1;
    const Lane mine = sub ? rank_or_total<REC, TOE>(t, n, total, i1, c, head)
                          : rank_or_total<REC, false>(t, n, total, lo, c, head);
    const Lane other = __shfl_xor_sync(pair, mine, 1);
    cb = sub ? other : mine;
    ce = sub ? mine : other;
    if constexpr (TOE) trivial = __shfl_sync(pair, head, (int)(threadIdx.x & 31) | 1) == c;
  }
  const Lane ci = ce - cb;
  if (ci <= 0) {
    lo = 1;
    hi = 0;
    return false;
  }
  lo = fc + cb;
  hi = lo + ci - 1;
  return true;
}

}  // namespace
