// K1: batched backward search (the count path's LF loop) over fused-block
// rank rows, for Hopper (sm_90a).
//
// Replaces rowbowt_tpu/ops/pallas_lf.py:_lf_kernel (with its _swar_count),
// and covers what rowbowt_tpu/engine/count.py:find_ranges runs: both row
// layouts, any alphabet of at most 8 codes, and a per-lane start (lo, hi,
// startj) that the wrapper takes from the ftab (ops/cuda_lf.py).
//
// One thread per lane, with the whole L loop inside the thread: a lane that
// finishes (empty range, or past its length) stops and costs nothing more.
// Each step is two ranks, each one dependent random load of one row
// (64 B = 4 int4 loads for fblock64, 96 B = 6 for fblock) from L2 or HBM by
// table size, then integer bit work.  The kernel is bound by the latency of
// those dependent row loads: 2 per lane-step, and the next step's addresses
// need this step's result.  This first version does nothing about that beyond
// 16-byte vector loads and enough resident lanes to keep loads in flight.
//
// Row contract (rowbowt_tpu_torch/construct/build.py build_fblock and
// fblock_to_fb64): int32[8 + SYMS/8] per row = 8 exclusive per-code
// checkpoints, then SYMS 4-bit symbols packed 8 per word, symbol j of a word
// at bits [4j, 4j+4).  The words are uint32 stored in int32 lanes: they are
// reinterpreted as uint32 here, so shifts are logical and __popc counts them.
//
// Launch contract: qT is the [L, B] transpose of the right-aligned [B, L]
// code matrix (-1 pad), so that at step j the threads of a warp read
// neighbouring words of row L-1-j.  lo/hi hold each lane's start on entry and
// its range on exit; the empty range is (1, 0).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCkpt = 8;

template <int SYMS>
struct Layout {
  static constexpr int kWords = SYMS / 8;         // packed words per row
  static constexpr int kRow = kCkpt + kWords;     // int32 lanes per row
  static constexpr int kVec = kRow / 4;           // int4 loads per row
  static constexpr int kShift = SYMS == 64 ? 6 : 7;
  static_assert(SYMS == 64 || SYMS == 128, "fblock64 or fblock rows");
  static_assert(kRow % 4 == 0, "rows are whole 16-byte vectors");
};

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Count of the nibbles equal to c (pat = c in every nibble) among the kn
// lowest nibbles of one word, kn in [0, 8].
__device__ __forceinline__ int match_below(uint32_t w, uint32_t pat, int kn) {
  uint32_t x = w ^ pat;
  uint32_t t = x | (x >> 1) | (x >> 2) | (x >> 3);
  uint32_t match = ~t & 0x11111111u;  // bit 4j set where nibble j == c
  // kn == 8 takes the whole word: 1u << 32 is undefined in C++
  uint32_t mask = kn >= 8 ? 0xFFFFFFFFu : ((1u << (4 * kn)) - 1u);
  return __popc(match & mask);
}

// rank(i, c) = number of code c in BWT[0, i), for i in [0, n - 1] and c in
// [0, A).  The caller handles i == n (the code's total count).
template <int SYMS>
__device__ __forceinline__ int rank_row(const int4* __restrict__ fb, int i,
                                        int c) {
  using Lo = Layout<SYMS>;
  const int4* row = fb + (size_t)(i >> Lo::kShift) * Lo::kVec;
  const int off = i & (SYMS - 1);
  int4 v[Lo::kVec];
#pragma unroll
  for (int k = 0; k < Lo::kVec; ++k) v[k] = __ldg(row + k);

  // checkpoint of c: lanes 0..7 are v[0] and v[1]; selected without a
  // dynamically indexed register array (which would go to local memory)
  int occ = 0;
#pragma unroll
  for (int k = 0; k < kCkpt; ++k) {
    if (k == c) occ = lane_of(v[k / 4], k % 4);
  }
  const uint32_t pat = (uint32_t)c * 0x11111111u;
#pragma unroll
  for (int w = 0; w < Lo::kWords; ++w) {
    const int kn = min(max(off - 8 * w, 0), 8);
    const int k = kCkpt + w;
    occ += match_below((uint32_t)lane_of(v[k / 4], k % 4), pat, kn);
  }
  return occ;
}

template <int SYMS>
__global__ void __launch_bounds__(256)
lf_count_kernel(const int4* __restrict__ fb, const int32_t* __restrict__ F,
                int A, int n, const int32_t* __restrict__ qT,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ startj, int B, int L,
                int32_t* __restrict__ lo_io, int32_t* __restrict__ hi_io) {
  __shared__ int32_t sF[kCkpt + 1];
  if (threadIdx.x <= (unsigned)A) sF[threadIdx.x] = F[threadIdx.x];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int lo = lo_io[b];
  int hi = hi_io[b];
  const int jend = min(lengths[b], L);  // length-0 pad lanes never step
  for (int j = startj[b]; j < jend; ++j) {
    const int c = qT[(size_t)(L - 1 - j) * B + b];
    if (c < 0 || c >= A) {  // absent code: empty range, lane done
      lo = 1;
      hi = 0;
      break;
    }
    // rank(n, c) is the code's total count; hi + 1 does reach n
    const int total = sF[c + 1] - sF[c];
    const int cb = lo >= n ? total : rank_row<SYMS>(fb, lo, c);
    const int ce = hi + 1 >= n ? total : rank_row<SYMS>(fb, hi + 1, c);
    const int ci = ce - cb;
    if (ci <= 0) {
      lo = 1;
      hi = 0;
      break;
    }
    lo = sF[c] + cb;
    hi = lo + ci - 1;
  }
  lo_io[b] = lo;
  hi_io[b] = hi;
}

}  // namespace

extern "C" {

// Runs K1 on `stream` over B lanes; returns cudaGetLastError() after the
// launch (0 on success).  syms_per_row is 64 (fblock64) or 128 (fblock).
int rbt_lf_count(const void* fb, int syms_per_row, const void* F, int A, int n,
                 const void* qT, const void* lengths, const void* startj,
                 int B, int L, void* lo, void* hi, void* stream) {
  if (A < 1 || A > kCkpt || B < 0 || L < 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((B + threads - 1) / threads));
  cudaStream_t s = (cudaStream_t)stream;
  auto* fb4 = static_cast<const int4*>(fb);
  auto* F32 = static_cast<const int32_t*>(F);
  auto* q = static_cast<const int32_t*>(qT);
  auto* len = static_cast<const int32_t*>(lengths);
  auto* sj = static_cast<const int32_t*>(startj);
  auto* lo32 = static_cast<int32_t*>(lo);
  auto* hi32 = static_cast<int32_t*>(hi);
  if (syms_per_row == 64)
    lf_count_kernel<64><<<grid, threads, 0, s>>>(fb4, F32, A, n, q, len, sj, B,
                                                 L, lo32, hi32);
  else if (syms_per_row == 128)
    lf_count_kernel<128><<<grid, threads, 0, s>>>(fb4, F32, A, n, q, len, sj,
                                                  B, L, lo32, hi32);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* rbt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
