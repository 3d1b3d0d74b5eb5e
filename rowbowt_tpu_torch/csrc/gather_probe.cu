// P1-P3: the three gather probes of tools/vmem_gather_probe.py, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of tools/vmem_gather_probe.py:
//   P1 gather_rows  <- main.runA / kernelA (:51-65): out[b] = tab[idx[b] >> 7, idx[b] & 127]
//   P2 gather_cols  <- main.runB / kernelB (:76-86): out[k, l] = tab[idx[k, l], l]
//   P3 gather_chain <- main.runC / kernelC (:92-107): steps dependent gathers i <- tab[i]
//
// On the TPU the probes measured which in-VMEM gather forms Mosaic lowers and
// at what rate.  Here the table lives in device memory (4 MB at the probe's
// shape: inside the 50 MB L2), and each probe is one thread per output
// element.  P1 and P2 are bound by the rate of independent 4-byte random
// loads; P3 by the latency of a chain of dependent loads, one per step, so
// its design keeps the whole step loop inside the thread (as the LF kernel
// keeps its L loop) and relies on many resident threads to keep loads in
// flight.  Loads go through the read-only path (__ldg).
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

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t row_col(const int32_t* __restrict__ tab,
                                           int32_t i) {
  return __ldg(tab + ((size_t)(i >> 7) << 7) + (i & 127));
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int32_t* __restrict__ tab,
                   const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                   int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) out[b] = row_col(tab, idx[b]);
}

// One thread per (k, l); consecutive threads take consecutive l, so a warp's
// index loads and output stores are coalesced and only the table loads scatter.
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const int32_t* __restrict__ tab,
                   const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                   int K, int cols) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)K * cols) return;
  const int l = (int)(e % cols);
  out[e] = __ldg(tab + (size_t)idx[e] * cols + l);
}

__global__ void __launch_bounds__(kThreads)
gather_chain_kernel(const int32_t* __restrict__ tab,
                    const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                    int B, int steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t i = idx[b];
  for (int s = 0; s < steps; ++s) i = row_col(tab, i);
  out[b] = i;
}

unsigned blocks_for(size_t elems) {
  return (unsigned)((elems + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); an empty output launches nothing.

int rbt_gather_rows(const void* tab, const void* idx, void* out, int B,
                    void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  gather_rows_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), B);
  return (int)cudaGetLastError();
}

int rbt_gather_cols(const void* tab, const void* idx, void* out, int K,
                    int cols, void* stream) {
  if (K < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)K * cols == 0) return 0;
  gather_cols_kernel<<<blocks_for((size_t)K * cols), kThreads, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), K, cols);
  return (int)cudaGetLastError();
}

int rbt_gather_chain(const void* tab, const void* idx, void* out, int B,
                     int steps, void* stream) {
  if (B < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  gather_chain_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), B, steps);
  return (int)cudaGetLastError();
}

const char* rbt_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
