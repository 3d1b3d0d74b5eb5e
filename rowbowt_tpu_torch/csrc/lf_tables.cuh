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

// The rank tables, each int32 or int64 as the index holds it (*_bytes): occ
// is occ_flat [A * R] (runs), occ_blk_flat [A * nb] (dense) or occ1_flat
// [A * (n + 1)] (occ1); run_start and run_head [R] (runs); bwt4 [nb * 16],
// the dense blocks' words of 8 nibbles (dense).
struct Tabs {
  const void* occ;
  const void* run_start;
  const void* run_head;
  const int4* bwt4;
  int occ_bytes, rs_bytes, rh_bytes;
  int R;
  long long nb;
};

// The per-step toehold's tables (TOE instances), each int32 or int64 as the
// index holds it on the card (*_bytes): tk1 [A * n] where it is resident,
// else ltk [A * R] with run_start [R]; samples_last [R] for k0; and k, the
// toehold out, in the lane type (K1's and the tables kernel's).
struct Toe {
  const void* tk1;
  const void* ltk;
  const void* run_start;
  const void* samples_last;
  int tk1_bytes, ltk_bytes, rs_bytes, sl_bytes;
  int R;
  void* k;
};

// k of a lane whose search did not fail: the table value of its last
// non-trivial step (code tc >= 0, pre-step hi thi), or k0 where it had none
// (tc < 0), less its `triv` trivial steps since, mod n.  The ltk route finds
// the run of thi as ops/rank.py lf_step_w_loc does: the run of min(thi + 1,
// n - 1) by an upper bound over run_start, one less where thi + 1 < n
// starts that run.
__device__ int64_t resolve_toehold(const Toe& t, int64_t n, int tc, int64_t thi, int triv) {
  int64_t base;
  if (tc < 0) {
    base = (load_at(t.samples_last, t.sl_bytes, t.R - 1) + 1) % n;
  } else if (t.tk1 != nullptr) {
    base = load_at(t.tk1, t.tk1_bytes, (int64_t)tc * n + thi);
  } else {
    const int64_t x = thi + 1 < n ? thi + 1 : n - 1;
    int first = 0, count = t.R;  // upper bound of x
    while (count > 0) {
      const int half = count >> 1;
      if (load_at(t.run_start, t.rs_bytes, first + half) <= x) {
        first += half + 1;
        count -= half + 1;
      } else {
        count = half;
      }
    }
    int r = first - 1;
    if (thi + 1 < n && load_at(t.run_start, t.rs_bytes, r) == thi + 1) --r;
    base = load_at(t.ltk, t.ltk_bytes, (int64_t)tc * t.R + r);
  }
  const int64_t k = (base - triv) % n;
  return k < 0 ? k + n : k;
}

// The run of position x, the last r' in [r, last] with run_start[r'] <= x,
// given start == run_start[r] <= x: a binary search, which leaves start at
// that run's start.
__device__ __forceinline__ int run_search(const Tabs& t, int64_t x, int r, int last,
                                          int64_t& start) {
  int end = last + 1;  // run_start[end] > x, or end == R
  while (end - r > 1) {
    const int mid = r + ((end - r) >> 1);
    const int64_t v = load_at(t.run_start, t.rs_bytes, mid);
    if (v <= x) {
      r = mid;
      start = v;
    } else {
      end = mid;
    }
  }
  return r;
}

// rank(i, c) in run r starting at `start` (ops/rank.py rank_at_run, i < n):
// the count of c before the run, plus i - start where the run is of c.  head
// receives the run's code.
__device__ __forceinline__ int64_t rank_in_run(const Tabs& t, int64_t i, int c, int r,
                                               int64_t start, int& head) {
  head = (int)load_at(t.run_head, t.rh_bytes, r);
  const int64_t occ = load_at(t.occ, t.occ_bytes, (int64_t)c * t.R + r);
  return occ + (head == c ? i - start : 0);
}

// rank(i, c) over the dense blocks (ops/rank.py rank_dense, i < n): the
// checkpoint of c at block i >> 7, plus the nibbles equal to c among the
// block's first i & 127 symbols (one 64 B block, four 16-byte loads).
__device__ __forceinline__ int64_t rank_dense(const Tabs& t, int64_t i, int c) {
  const int64_t blk = i >> 7;
  const int off = (int)(i & 127);
  const int64_t occ = load_at(t.occ, t.occ_bytes, (int64_t)c * t.nb + blk);
  const uint32_t pat = (uint32_t)c * 0x11111111u;
  int in_blk = 0;
#pragma unroll
  for (int m = 0; m < kDenseVec; ++m) {
    const int4 v = __ldg(t.bwt4 + blk * kDenseVec + m);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      in_blk += nibbles_below((uint32_t)lane_of(v, e), pat, off - 8 * (4 * m + e));
  }
  return occ + in_blk;
}

// One LF step of a lane (one thread) over the POLICY tables: (lo, hi)
// becomes LF((lo, hi), c), or the empty range (1, 0) where that is empty or
// c lies outside [0, A); returns whether it is non-empty.  F [A + 1] is read
// from global memory.  rs0 is run_start[0] (runs).  The run-space search of
// hi + 1 is confined to its window after lo's run.  TOE also sets `trivial`
// to BWT[hi] == c for the pre-step hi, from the policy's own tables.
template <typename Lane, int POLICY, bool TOE>
__device__ __forceinline__ bool lf_step_tables(const Tabs& t, const Lane* __restrict__ F, int A,
                                               Lane n, int64_t rs0, int c, Lane& lo, Lane& hi,
                                               bool& trivial) {
  if (c >= A) {  // absent code: empty range
    lo = 1;
    hi = 0;
    return false;
  }
  const Lane fc = (Lane)load_at(F, sizeof(Lane), c);
  const Lane i1 = hi + 1;
  Lane cb, ce;
  if constexpr (POLICY == kOcc1) {
    // one load a rank: row c of occ1 has n + 1 entries
    const int64_t row = (int64_t)c * ((int64_t)n + 1);
    cb = (Lane)load_at(t.occ, t.occ_bytes, row + lo);
    ce = (Lane)load_at(t.occ, t.occ_bytes, row + i1);
    if constexpr (TOE) trivial = ce - (Lane)load_at(t.occ, t.occ_bytes, row + hi) == 1;
  } else if constexpr (POLICY == kDense) {
    // rank(n, c) is the code's total count
    const Lane total = (Lane)load_at(F, sizeof(Lane), c + 1) - fc;
    cb = lo < n ? (Lane)rank_dense(t, lo, c) : total;
    ce = i1 < n ? (Lane)rank_dense(t, i1, c) : total;
    if constexpr (TOE) {
      const uint32_t w = (uint32_t)__ldg(reinterpret_cast<const int32_t*>(t.bwt4) + (hi >> 3));
      trivial = (int)((w >> (4 * (int)(hi & 7))) & 15u) == c;
    }
  } else {
    const Lane total = (Lane)load_at(F, sizeof(Lane), c + 1) - fc;
    int r0 = 0, head = -1;
    int64_t s0 = rs0;
    if (lo < n) {
      r0 = run_search(t, lo, 0, t.R - 1, s0);
      cb = (Lane)rank_in_run(t, lo, c, r0, s0, head);
    } else {
      cb = total;
    }
    if (i1 < n) {
      // hi + 1's run is lo's or a later one, and no more than i1 - s0
      // runs later: a run holds at least one position
      int r1 = 0, last = t.R - 1;
      int64_t s1 = rs0;
      if (lo < n && lo <= i1) {
        r1 = r0;
        s1 = s0;
        const int64_t far = (int64_t)r0 + (i1 - s0);
        last = far < t.R - 1 ? (int)far : t.R - 1;
      }
      r1 = run_search(t, i1, r1, last, s1);
      ce = (Lane)rank_in_run(t, i1, c, r1, s1, head);
      if constexpr (TOE) {
        // hi's run: hi + 1's, or the one before where hi + 1 starts it
        if (s1 == i1) head = (int)load_at(t.run_head, t.rh_bytes, r1 - 1);
      }
    } else {
      ce = total;
      if constexpr (TOE) head = (int)load_at(t.run_head, t.rh_bytes, t.R - 1);
    }
    if constexpr (TOE) trivial = head == c;
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
