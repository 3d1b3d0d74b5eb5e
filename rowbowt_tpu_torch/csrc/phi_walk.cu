// The phi walk of `rbt_align -s` (ToeholdSA::locate_range, toehold_sa.hpp:
// 37-49) over a whole batch in one launch, for Hopper (sm_90a).
//
// Computes what rowbowt_tpu/engine/locate.py locate and locate_ragged compute
// with an XLA fori_loop of rowbowt_tpu/ops/rank.py phi_step, one phi step of
// every lane per iteration (the JAX package has no Pallas kernel for it).
// It is P3's chained gather (csrc/gather_probe.cu gather_chain_kernel,
// tools/vmem_gather_probe.py:92 kernelC) carrying the walk: lane b writes
// out[off[b] + j] for j < size[b], j = 0 the toehold k[b] and each later j
// the phi of the one before, with the step loop inside the thread.  Four
// routes, the four that ops/rank.py phi_step takes:
//   - phi1 (dense, raw and serialized indexes): i <- phi1[clamp(i, 0, n-1)],
//     one dependent load a step, int32 or int64 table;
//   - phi_rows + phi_delta (a BigIndex, bigindex.phi_pack_tables): one 64 B
//     row [breakpoints before the row | 15 words of breakpoint bits] per 480
//     positions, the popcount of the row's bits at or below i's offset gives
//     the rank of i's breakpoint, and i <- (i + phi_delta[rank]) mod n: two
//     dependent loads a step, int64 lanes (n above 2^31);
//   - the breakpoint table phi_at (a BigIndex with 2^31 or more
//     breakpoints, whose bitmap rows would overflow their int32
//     checkpoints; bigindex.big_locate_tables): rk = lower_bound(pred_pos,
//     i + 1) - 1 by the bucketed search of ops/rank.py
//     bucketed_lower_bound (pp_off bounds the search to i + 1's bucket of
//     2^shift positions, then `iters` fixed halvings), and i <- (phi_at[rk]
//     + i - pred_pos[rk]) mod n: 2 + iters dependent loads a step, int64
//     lanes (rowbowt_tpu/ops/rank.py:414-426);
//   - the predecessor search over the run-start samples (an index with
//     neither table: `--no-dense`, ToeholdSA::phi, toehold_sa.hpp:56-72): rk
//     the lower bound of i in pred_pos, jr = rk - 1 (R - 1 for rk == 0), j =
//     pred_pos[jr], and i <- (samples_last[pred_to_run[jr] - 1] + (j < i ? i
//     - j : i + 1)) mod n, index -1 reading the last sample as the JAX
//     package's gather does.  rk is bucketed_lower_bound(pred_pos, pred_off,
//     shift, iters, i) through the bucket directory pred_off over pred_pos
//     (engine/device.run_directory, built where the index goes to the card),
//     the same search as phi_at's: 1 + iters + 2 dependent loads a step, the
//     bucket's few entries one or two 128 B lines, in place of a binary
//     search over all R entries (log2(R) + 2 loads, 26 at chr: a chr batch
//     of at most 7 steps a lane took 57.5 us on an H100, PERF.md §6).
// A fifth kernel, kval_walk_kernel (C entry rbt_phi_walk_kval), walks
// without a chain where the index's kval is the full SA and the caller
// hands each lane's hi, its toehold being kval[hi] (every dense build's
// rbt_align -s): phi(SA[i]) = SA[i - 1] (construct/build.py builds phi1 so),
// so lane b's positions are kval[hi[b] - j], one contiguous read and one
// contiguous write a lane with no dependent load.  What bounds it is bytes:
// kval[hi - size + 1 .. hi] of each lane read once, the positions written
// once, and hi, size and off.  On a dense chr batch it took 0.43x the
// chain over phi1 on an H100, in turns (PERF.md §6).
//
// What bounds it on the H100.  A lane's chain is serial: each step's address
// is the previous step's result, so the longest lane takes its steps times
// the dependent-load latency of the table (phi1 at chr is 640 MB, the phi
// rows of a 2.2 G panel 294 MB: both beyond the 50 MB L2), and the batch is
// done when that lane is.  The other lanes' loads hide behind it as long as
// the memory system serves them.  What the design does about it:
//   - one thread a lane, the step loop inside the thread (as P3), so no
//     launch or host round trip sits between two steps;
//   - thread t takes lane t: a batch's lanes are one wave (65,536 lanes
//     in 256 blocks of 256 threads), so every chain starts at once and
//     the longest one ends the launch whatever lanes share its warp.  The
//     lanes in descending size order (one device sort a launch, and a
//     dependent load of that order before a lane's first) took 1.02-1.07x
//     as long on an H100 (PERF.md §6);
//   - a grid sized from the SM count (ops/cuda_phi.launch_plan, as P1-P3's):
//     the least multiple of 32 threads, up to 256, with which one block per
//     SM covers the lanes;
//   - the table loads take the read-only path without allocating in L1
//     (ld.global.nc.L1::no_allocate, as P1-P3): a random row is not read
//     again by the SM that read it; a phi row is four 16-byte loads issued
//     together, and its popcount needs no other memory.
// Every position is written once, in the lane's own contiguous segment.
//
// Indices are not checked here: every toehold must lie in [0, n) and the
// tables must be the index's own.  The wrapper checks shapes, types and
// devices.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // launch_plan's block size bound
constexpr int kPhiPos = 480;      // positions a phi row covers (ops/rank.py _PHI_POS)

__device__ __forceinline__ int32_t load_nc(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int64_t load_nc(const int64_t* p) {
  int64_t v;
  asm("ld.global.nc.L1::no_allocate.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int4 load_nc(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// phi over phi1: the table's value at i clamped into [0, n), widened.
template <typename Tab>
struct Phi1 {
  const Tab* phi1;
  int64_t n;
  __device__ __forceinline__ int64_t operator()(int64_t i) const {
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    return (int64_t)load_nc(phi1 + i);
  }
};

// phi over the bitmap rows: ops/rank.py phi_step's "phi_rows" branch.
struct PhiRows {
  const int4* rows;  // [nb, 4] int4 = [nb, 16] int32
  const int64_t* delta;
  int64_t n;
  __device__ __forceinline__ int64_t operator()(int64_t i) const {
    const int64_t blk = i / kPhiPos;
    const int off = (int)(i - blk * kPhiPos);
    const int4* r = rows + blk * 4;
    const int4 a = load_nc(r), b = load_nc(r + 1), c = load_nc(r + 2), d = load_nc(r + 3);
    const uint32_t w[15] = {(uint32_t)a.y, (uint32_t)a.z, (uint32_t)a.w,
                            (uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z, (uint32_t)b.w,
                            (uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z, (uint32_t)c.w,
                            (uint32_t)d.x, (uint32_t)d.y, (uint32_t)d.z, (uint32_t)d.w};
    // bits with local index <= off: whole words before word q, the low
    // (off & 31) + 1 bits of word q, none after
    const int q = off >> 5;
    const uint32_t low = (off & 31) == 31 ? 0xFFFFFFFFu : (2u << (off & 31)) - 1u;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 15; ++j)
      cnt += __popc(w[j] & (j < q ? 0xFFFFFFFFu : (j == q ? low : 0u)));
    int64_t rk = (int64_t)a.x + cnt - 1;
    rk = rk < 0 ? 0 : rk;
    int64_t v = (i + load_nc(delta + rk)) % n;
    return v < 0 ? v + n : v;
  }
};

// One entry of an int32 or int64 table (bytes 4 or 8), widened.
__device__ __forceinline__ int64_t entry(const void* t, int bytes, int64_t i) {
  return bytes == 8 ? (int64_t)__ldg(static_cast<const long long*>(t) + i)
                    : (int64_t)__ldg(static_cast<const int32_t*>(t) + i);
}

// ops/rank.py bucketed_lower_bound(vals, off, shift, iters, q): the first
// index of the sorted table vals [M] (vbytes a value) whose value is >= q,
// searched in q's bucket of the directory off [n_off] (off_bytes a value,
// 2^shift values a bucket) by `iters` fixed halvings.
__device__ __forceinline__ int64_t bucketed_lower_bound(const void* vals, int vbytes, int64_t M,
                                                        const void* off, int off_bytes,
                                                        int64_t n_off, int shift, int iters,
                                                        int64_t q) {
  int64_t b = q >> shift;
  b = b < 0 ? 0 : (b > n_off - 2 ? n_off - 2 : b);
  int64_t lo = entry(off, off_bytes, b), hi = entry(off, off_bytes, b + 1);
  for (int it = 0; it < iters; ++it) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t at = mid < 0 ? 0 : (mid > M - 1 ? M - 1 : mid);
    const bool take = entry(vals, vbytes, at) < q && lo < hi;
    hi = take || lo >= hi ? hi : mid;
    lo = take ? mid + 1 : lo;
  }
  return lo;
}

// phi over the breakpoint table: ops/rank.py phi_step's "phi_at" branch with
// its bucket table pp_off [n_off] (each table int32 or int64, *_bytes).
struct PhiAt {
  const void* pred_pos;
  const void* phi_at;
  const void* pp_off;
  int pp_bytes, at_bytes, off_bytes;
  int64_t M;      // breakpoints (pred_pos and phi_at entries)
  int64_t n_off;  // pp_off entries
  int shift, iters;
  int64_t n;
  __device__ __forceinline__ int64_t operator()(int64_t i) const {
    const int64_t lo =
        bucketed_lower_bound(pred_pos, pp_bytes, M, pp_off, off_bytes, n_off, shift, iters, i + 1);
    // pred_pos[0] == 0, so rk >= 0; a torch gather reads index -1 as M - 1
    int64_t rk = lo - 1;
    rk = rk < 0 ? rk + M : rk;
    int64_t v = (entry(phi_at, at_bytes, rk) + (i - entry(pred_pos, pp_bytes, rk))) % n;
    return v < 0 ? v + n : v;
  }
};

// phi by the predecessor search: ops/rank.py phi_step's last branch, over
// pred_pos, pred_to_run and samples_last of one type T (int32 or int64),
// summed in int64, the lower bound of i in pred_pos through its bucket
// directory pred_off [n_off] (off_bytes a value).
template <typename T>
struct Pred {
  const T* pred_pos;
  const T* pred_to_run;
  const T* samples_last;
  const void* pred_off;
  int off_bytes;
  int64_t n_off;
  int shift, iters;
  int64_t R, n;
  __device__ __forceinline__ int64_t operator()(int64_t i) const {
    const int64_t first = bucketed_lower_bound(pred_pos, (int)sizeof(T), R, pred_off, off_bytes,
                                               n_off, shift, iters, i);
    const int64_t jr = first == 0 ? R - 1 : first - 1;
    const int64_t j = (int64_t)__ldg(pred_pos + jr);
    const int64_t delta = j < i ? i - j : i + 1;
    int64_t r = (int64_t)__ldg(pred_to_run + jr) - 1;
    r = r < 0 ? r + R : r;
    int64_t v = ((int64_t)__ldg(samples_last + r) + delta) % n;
    return v < 0 ? v + n : v;
  }
};

template <typename Step>
__global__ void __launch_bounds__(kMaxThreads)
phi_walk_kernel(Step phi, const int64_t* __restrict__ k, const int64_t* __restrict__ size,
                const int64_t* __restrict__ off, int64_t* __restrict__ out, int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const int64_t s = size[t];
  if (s <= 0) return;
  int64_t* o = out + off[t];
  int64_t i = k[t];
  o[0] = i;
  for (int64_t j = 1; j < s; ++j) {
    i = phi(i);
    o[j] = i;
  }
}

template <typename Step>
int launch(const Step& phi, const void* k, const void* size, const void* off, void* out,
           int B, int threads, void* stream) {
  if (B < 0 || threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  phi_walk_kernel<Step><<<(unsigned)((B + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
      phi, static_cast<const int64_t*>(k), static_cast<const int64_t*>(size),
      static_cast<const int64_t*>(off), static_cast<int64_t*>(out), B);
  return (int)cudaGetLastError();
}

// Positions a thread of the kval walk takes at once: their loads are in
// flight together.
constexpr int kUnroll = 4;

// The walk of an index whose kval is the full SA, from toeholds that are
// kval[hi[b]] (the CLI's, engine/locate.find_ranges_w_toehold): phi(SA[i])
// = SA[i - 1], so lane b's chain is kval[hi[b] - j] for j < size[b], and
// no step waits for another.  Each warp takes 32 neighbouring lanes and
// treats their segments as one run of positions (a running sum of their
// sizes by shuffles), so that its threads take neighbouring positions:
// position v is thread v % 32's, its lane found by a binary search of the
// 32 running sums by shuffles, and its read of kval and its write of out
// fall next to its neighbours' within a lane (coalesced), kUnroll of them
// in flight a thread.  Lanes with size 0 hold no position.
template <typename Tab>
__global__ void __launch_bounds__(kMaxThreads)
kval_walk_kernel(const Tab* __restrict__ kval, const int64_t* __restrict__ hi,
                 const int64_t* __restrict__ size, const int64_t* __restrict__ off,
                 int64_t* __restrict__ out, int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int me = threadIdx.x & 31;
  if (t - me >= B) return;  // the whole warp is past the lanes
  constexpr unsigned kAll = 0xFFFFFFFFu;
  int64_t s = 0, h = 0, o = 0;
  if (t < B) {
    s = size[t];
    s = s > 0 ? s : 0;
    h = hi[t];
    o = off[t];
  }
  // end: the warp's positions up to this lane's last, start = end - s
  int64_t end = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t x = __shfl_up_sync(kAll, (long long)end, d);
    end += me >= d ? x : 0;
  }
  const int64_t total = __shfl_sync(kAll, (long long)end, 31);
  // position v of this lane: out[dst + v], kval[src - v]
  const int64_t dst = o - (end - s), src = h + (end - s);
  for (int64_t first = 0; first < total; first += 32 * kUnroll) {
    int64_t to[kUnroll];
    Tab val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = first + 32 * u + me;
      // its lane: the number of lanes whose segment ends at or below v
      int lane = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        lane += __shfl_sync(kAll, (long long)end, lane + step - 1) <= v ? step : 0;
      const int64_t d = __shfl_sync(kAll, (long long)dst, lane);
      const int64_t r = __shfl_sync(kAll, (long long)src, lane);
      to[u] = v < total ? d + v : -1;
      val[u] = v < total ? load_nc(kval + (r - v)) : Tab(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (to[u] >= 0) out[to[u]] = (int64_t)val[u];
  }
}

template <typename Tab>
int launch_kval(const Tab* kval, const void* hi, const void* size, const void* off, void* out,
                int B, int threads, void* stream) {
  if (B < 0 || threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  kval_walk_kernel<Tab><<<(unsigned)((B + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
      kval, static_cast<const int64_t*>(hi), static_cast<const int64_t*>(size),
      static_cast<const int64_t*>(off), static_cast<int64_t*>(out), B);
  return (int)cudaGetLastError();
}

// A kernel that does nothing: launched as a walk of B lanes is, its device
// time is what a launch and the timing around it cost (chip_smoke.py
// walk_times' floor).
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Each entry walks the B int64 lanes (toehold k, size and off; lane t on
// thread t) on `stream` and returns cudaGetLastError() after the launch (0
// on success; nothing is launched for B == 0).  `threads` is
// ops/cuda_phi.launch_plan's.

// phi1 of `phi1_bytes` (4: int32, 8: int64) a value, n entries.
int rbt_phi_walk_phi1(const void* phi1, int phi1_bytes, long long n, const void* k,
                      const void* size, const void* off, void* out,
                      int B, int threads, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (phi1_bytes == 4)
    return launch(Phi1<int32_t>{static_cast<const int32_t*>(phi1), n}, k, size, off,
                  out, B, threads, stream);
  if (phi1_bytes == 8)
    return launch(Phi1<int64_t>{static_cast<const int64_t*>(phi1), n}, k, size, off,
                  out, B, threads, stream);
  return (int)cudaErrorInvalidValue;
}

// phi_rows int32 [n / 480 + 2, 16] (16-byte aligned), phi_delta int64.
int rbt_phi_walk_rows(const void* rows, const void* delta, long long n, const void* k,
                      const void* size, const void* off, void* out,
                      int B, int threads, void* stream) {
  if (n < 1 || (uintptr_t)rows % 16) return (int)cudaErrorInvalidValue;
  return launch(PhiRows{static_cast<const int4*>(rows), static_cast<const int64_t*>(delta), n},
                k, size, off, out, B, threads, stream);
}

// The predecessor search over pred_pos, pred_to_run and samples_last, R
// entries each, all `bytes` (4: int32, 8: int64) a value, through pred_off
// [n_off] (off_bytes 4 or 8), the bucket directory over pred_pos of
// engine/device.run_directory: n_off == (n >> shift) + 2, at most `iters`
// halvings a bucket.
int rbt_phi_walk_pred(const void* pred_pos, const void* pred_to_run, const void* samples_last,
                      int bytes, long long R, const void* pred_off, int off_bytes,
                      long long n_off, int shift, int iters, long long n, const void* k,
                      const void* size, const void* off, void* out, int B,
                      int threads, void* stream) {
  if (n < 1 || R < 1 || pred_off == nullptr || (off_bytes != 4 && off_bytes != 8) ||
      shift < 0 || shift > 62 || iters < 1 || iters > 32 || n_off != (n >> shift) + 2)
    return (int)cudaErrorInvalidValue;
  if (bytes == 4)
    return launch(Pred<int32_t>{static_cast<const int32_t*>(pred_pos),
                                static_cast<const int32_t*>(pred_to_run),
                                static_cast<const int32_t*>(samples_last), pred_off, off_bytes,
                                n_off, shift, iters, R, n},
                  k, size, off, out, B, threads, stream);
  if (bytes == 8)
    return launch(Pred<long long>{static_cast<const long long*>(pred_pos),
                                  static_cast<const long long*>(pred_to_run),
                                  static_cast<const long long*>(samples_last), pred_off,
                                  off_bytes, n_off, shift, iters, R, n},
                  k, size, off, out, B, threads, stream);
  return (int)cudaErrorInvalidValue;
}

// The breakpoint table: pred_pos and phi_at (M entries, pp_bytes and
// at_bytes a value), its bucket table pp_off (n_off >= 2 entries, off_bytes)
// and (shift, iters), the index's pp_bs.
int rbt_phi_walk_phi_at(const void* pred_pos, int pp_bytes, const void* phi_at, int at_bytes,
                        long long M, const void* pp_off, int off_bytes, long long n_off,
                        int shift, int iters, long long n, const void* k, const void* size,
                        const void* off, void* out, int B, int threads,
                        void* stream) {
  auto width = [](int bytes) { return bytes == 4 || bytes == 8; };
  if (n < 1 || M < 1 || n_off < 2 || shift < 0 || shift > 62 || iters < 0 || iters > 64 ||
      !width(pp_bytes) || !width(at_bytes) || !width(off_bytes) || pred_pos == nullptr ||
      phi_at == nullptr || pp_off == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(PhiAt{pred_pos, phi_at, pp_off, pp_bytes, at_bytes, off_bytes, M, n_off, shift,
                      iters, n},
                k, size, off, out, B, threads, stream);
}

// The walk where kval (kval_bytes 4 or 8 a value, n entries) is the full SA
// and each lane's toehold is kval[hi[b]]: out[off[b] + j] = kval[hi[b] - j]
// for j < size[b], hi, size and off int64 [B]; every hi[b] - size[b] + 1
// must be at least 0.
int rbt_phi_walk_kval(const void* kval, int kval_bytes, long long n, const void* hi,
                      const void* size, const void* off, void* out, int B, int threads,
                      void* stream) {
  if (n < 1 || kval == nullptr) return (int)cudaErrorInvalidValue;
  if (kval_bytes == 4)
    return launch_kval(static_cast<const int32_t*>(kval), hi, size, off, out, B, threads, stream);
  if (kval_bytes == 8)
    return launch_kval(static_cast<const int64_t*>(kval), hi, size, off, out, B, threads, stream);
  return (int)cudaErrorInvalidValue;
}

// The empty kernel in the grid of a walk of B lanes at `threads` a block.
int rbt_phi_walk_empty(int B, int threads, void* stream) {
  if (B < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* rbt_phi_walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
