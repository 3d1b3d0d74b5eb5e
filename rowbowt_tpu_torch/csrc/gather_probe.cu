// P1-P3: the three gather probes of tools/vmem_gather_probe.py, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of tools/vmem_gather_probe.py:
//   P1 gather_rows  <- main.runA / kernelA (:51-65): out[b] = tab[idx[b] >> 7, idx[b] & 127]
//   P2 gather_cols  <- main.runB / kernelB (:76-86): out[k, l] = tab[idx[k, l], l]
//   P3 gather_chain <- main.runC / kernelC (:92-107): steps dependent gathers i <- tab[i]
//
// On the TPU the probes measured which in-VMEM gather forms Mosaic lowers and
// at what rate.  Here the table lives in device memory: 4 MB at the probe's
// shape, inside the 50 MB L2.
//
// P1 and P2 (one kernel, gather_vec_kernel).  At the probe's 32,768 outputs a
// call touches about 1 MB of 32-byte L2 sectors, so bandwidth does not bound
// it.  What does: the launch itself, then two dependent latencies per output
// (the index load, then a random 4-byte table load).  On an H100 (80GB HBM3,
// 700 W; CUPTI kernel times) an empty kernel of the same grid takes about
// 0.83 us, the index load and store alone 1.06 us, the gather 1.5 us.  From
// about a million outputs the rate of random L2 sectors bounds it instead
// (2,097,152 outputs in 18 us).  The design:
//   - each thread takes kVec = 4 consecutive outputs: one 16-byte index load,
//     four independent table loads in flight, one 16-byte store.  A warp thus
//     covers 128 outputs (a whole P2 row at 128 columns), with a quarter of
//     the index and store instructions of one thread per output;
//   - table loads take the read-only path without allocating in L1
//     (ld.global.nc.L1::no_allocate): a random row is not read again, so an
//     L1 line would only evict another.  __ldg and __ldcs measured the same,
//     and staging the loads through shared memory with 4-byte cp.async (which
//     must allocate in L1) 1-3% slower;
//   - the wrapper picks the block size from the card's SM count
//     (ops/cuda_gather.launch_plan): the least multiple of 32 with which one
//     block per SM covers the grid, so a short grid spreads over as many SMs
//     as it can (64 threads at the probe's shape: 128 blocks), and a long one
//     runs 256-thread blocks.  Larger blocks at the probe's shape were slower
//     (256 threads: +16%).
// The 16-byte path needs idx and out 16-byte aligned.  The wrapper's output
// always is; a view such as idx[1:] is only 4-byte aligned, and then every
// element takes one thread (groups = 0), as do the n % 4 elements after the
// last whole group.  P2's column is each element's flat index modulo `cols`,
// so a group may cross a row and any width is exact.
//
// P3 (gather_chain_kernel) runs `steps` dependent loads a lane: 3,276,800 random
// 4-byte loads into the 4 MB table at the probe's shape.  Its bound is the
// larger of two times: the chain's latency (100 steps times the dependent-
// load latency of a table the L2 holds) and the loads over the rate at
// which the L2 serves random sectors, which P1 over 2^22 indices into the
// same table measures (chip_smoke.py phase probes; PERF.md §6 says which
// binds).  The design:
//   - the step loop stays inside the thread (as the LF kernel keeps its L
//     loop): no launch between two steps;
//   - C independent chains a thread (lanes t, t + T, ..., T the thread
//     count), their loads issued together in each step, so a warp keeps C
//     loads in flight with a C-th of the threads;
//   - table loads without allocating in L1, as P1 and P2;
//   - the block size from the card's SM count, as P1 and P2
//     (ops/cuda_gather.chain_plan).
// The first design (one chain a thread, __ldg loads that allocate in L1,
// 256-thread blocks) is the instance <1, true> at 256 threads; the wrapper's
// design (ops/cuda_gather.CHAIN) is the variant that ran fastest on an H100.
// Each thread ends with its chains' values; the phi walk of rbt_align -s
// (csrc/phi_walk.cu) carries the same loop with a store a step.
//
// P1 and P3 keep the TPU kernel's row/column split of the index, row i >> 7
// of 128 columns and column i & 127: over a contiguous table that is the flat
// element i, so the table may have any shape (P3 also walks the port's
// one-dimensional phi1 table).  P2's rows have `cols` columns.
//
// Indices are not clamped, as the TPU kernels do not clamp them: every index
// must lie in the table (P1/P3: [0, T) with T the table's element count; P2:
// [0, rows)).  The wrapper (ops/cuda_gather.py) checks shapes, types and
// devices; the probe tool checks the index range once where it builds them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;             // outputs per thread on the 16-byte path
constexpr int kMaxThreads = 256;    // block size bound (launch_plan's, chain_plan's)

__device__ __forceinline__ int32_t load_table(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The table offset of index i at column l (P2), advancing l along the flat
// output; P1's offset is i itself.
template <bool kCols>
__device__ __forceinline__ int64_t offset(int32_t i, int& l, int cols) {
  if (!kCols) return i;
  const int64_t a = (int64_t)i * cols + l;
  if (++l == cols) l = 0;
  return a;
}

// Threads [0, groups) take outputs [4t, 4t + 4) on the 16-byte path; threads
// [groups, groups + n - 4 * groups) take the remaining outputs one each.
template <bool kCols>
__global__ void __launch_bounds__(kMaxThreads)
gather_vec_kernel(const int32_t* __restrict__ tab,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int n, int groups, int cols) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < groups) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx) + t);
    int l = kCols ? (int)(t * kVec % cols) : 0;
    int4 v;
    v.x = load_table(tab + offset<kCols>(i.x, l, cols));
    v.y = load_table(tab + offset<kCols>(i.y, l, cols));
    v.z = load_table(tab + offset<kCols>(i.z, l, cols));
    v.w = load_table(tab + offset<kCols>(i.w, l, cols));
    reinterpret_cast<int4*>(out)[t] = v;
    return;
  }
  const int64_t e = t + (int64_t)(kVec - 1) * groups;
  if (e >= n) return;
  int l = kCols ? (int)(e % cols) : 0;
  out[e] = load_table(tab + offset<kCols>(idx[e], l, cols));
}

// One step of a chain: the table's element i, through L1 (the first design)
// or past it.
template <bool kL1>
__device__ __forceinline__ int32_t chain_load(const int32_t* p) {
  return kL1 ? __ldg(p) : load_table(p);
}

// Thread t < items walks lanes t + c * items (c < C, lane < B) from idx; a
// thread whose c-th lane lies past B walks its first lane's chain again and
// writes nothing for it.
template <int C, bool kL1>
__global__ void __launch_bounds__(kMaxThreads)
gather_chain_kernel(const int32_t* __restrict__ tab,
                    const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                    int B, int items, int steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= items) return;
  int32_t i[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t lane = t + (int64_t)c * items;
    i[c] = idx[lane < B ? lane : t];
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) i[c] = chain_load<kL1>(tab + i[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t lane = t + (int64_t)c * items;
    if (lane < B) out[lane] = i[c];
  }
}

template <int C, bool kL1>
int launch_chain(const void* tab, const void* idx, void* out, int B, int steps,
                 int threads, void* stream) {
  const int items = (int)(((int64_t)B + C - 1) / C);
  gather_chain_kernel<C, kL1>
      <<<(unsigned)((items + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>(static_cast<const int32_t*>(tab),
                                 static_cast<const int32_t*>(idx),
                                 static_cast<int32_t*>(out), B, items, steps);
  return (int)cudaGetLastError();
}

template <bool kCols>
int launch_vec(const void* tab, const void* idx, void* out, int64_t n,
               int groups, int cols, int threads, void* stream) {
  if (n < 0 || n > INT32_MAX || groups < 0 || groups > n / kVec ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      (groups && ((uintptr_t)idx | (uintptr_t)out) % 16))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t items = n - (int64_t)(kVec - 1) * groups;
  gather_vec_kernel<kCols>
      <<<(unsigned)((items + threads - 1) / threads), threads, 0,
         (cudaStream_t)stream>>>(static_cast<const int32_t*>(tab),
                                 static_cast<const int32_t*>(idx),
                                 static_cast<int32_t*>(out), (int)n, groups,
                                 cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); an empty output launches nothing, and a negative
// size, or a plan the kernel cannot take, returns cudaErrorInvalidValue.
// `groups` and `threads` are ops/cuda_gather.launch_plan's.

int rbt_gather_rows(const void* tab, const void* idx, void* out, int B,
                    int groups, int threads, void* stream) {
  return launch_vec<false>(tab, idx, out, B, groups, 1, threads, stream);
}

int rbt_gather_cols(const void* tab, const void* idx, void* out, int K,
                    int cols, int groups, int threads, void* stream) {
  if (K < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  return launch_vec<true>(tab, idx, out, (int64_t)K * cols, groups, cols,
                          threads, stream);
}

// P3: `chains` lanes a thread (1, 2 or 4), loads through L1 when `l1` is
// not 0; `threads` is ops/cuda_gather.chain_plan's (or 256 for the first
// design).
int rbt_gather_chain(const void* tab, const void* idx, void* out, int B,
                     int steps, int chains, int l1, int threads, void* stream) {
  if (B < 0 || steps < 0 || threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (chains * 2 + (l1 != 0)) {
    case 2: return launch_chain<1, false>(tab, idx, out, B, steps, threads, stream);
    case 3: return launch_chain<1, true>(tab, idx, out, B, steps, threads, stream);
    case 4: return launch_chain<2, false>(tab, idx, out, B, steps, threads, stream);
    case 8: return launch_chain<4, false>(tab, idx, out, B, steps, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* rbt_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
