// The seeding state machines of rbt_markers and rbt_locs, one launch a
// batch, for Hopper (sm_90a).
//
// Each lane runs its read's whole seeding loop inside the kernel, stepping
// on K1's LF step (lf_rank.cuh: two ranks over a fused-block row by the
// lane's two threads) with real per-lane control flow where the torch loops
// of rowbowt_tpu_torch/engine/seeds.py select with masks over [B] tensors,
// L steps of tens of kernel launches each.  The JAX package runs the same
// loops as XLA fori_loops: rowbowt_tpu/engine/seeds.py:348
// (markers_greedy_seeding), :500 (markers_lmem_lanes) and :112-117
// (seeds_greedy_w_sample).  MODE selects the machine, each transcribed from
// the port's torch loop (its *_records_plain twin, which the kernel is held
// against):
//   - GREEDY, RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482):
//     the ftab start, then per step the window probe on success and the
//     seed-final probe and the seed on failure, and after a failure the
//     ftab restart as a k-step replay from the full range, with
//     search_ftab's miss -> full-range quirk (rowbowt.hpp:757) as an empty
//     range mid-replay that holds the full range for the rest of it; then
//     the final probe and seed.  Out: the range of every probe and its
//     owning seed slot (rlo, rhi, rseed [W, B], nrec [B]) and the seeds
//     (slo, shi, sqs, sqe [S, B], ns [B]);
//   - LMEM, the inner loop of RowBowt::get_markers_lmems (rowbowt.hpp:
//     341-404): one search a lane from the ftab start until it fails, the
//     ranges it would probe (rlo, rhi [W, B], nrec) and its one seed (elo,
//     ehi, eqs in slo, shi, sqs with S = 1);
//   - SAMPLE, RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256): a
//     seed at each failure of at least min_length codes, the search
//     restarting from the full range, and the tail seed; with hi_rec it
//     also writes each lane's pre-step hi of every step into an [L, B]
//     record, the step record of a big index's trajectory toehold.
// A probe's marker count is a pure function of its range, so the probes run
// as one bulk markers_bounds after the launch (ops/cuda_seeds.py), not in
// the machine.  A record slot is min(count, capacity - 1), so an overflow
// overwrites the last slot, and the counts run on past the capacity, as in
// the torch loops; a seed is put only while ns < S, and a probe's owner is
// ns even past S (the expansion drops those).  The slots a lane leaves
// unwritten get the tables' fill values (the empty range (1, 0), zeros).
// Every [W, B], [S, B] and [L, B] table is written column b by lane b, so
// the lanes of a warp write neighbouring words.
//
// What bounds it: K1's row loads, one step after another, and for GREEDY a
// replay of k steps after each failure; the record writes are a few words a
// lane.  Lanes are int32 over the single-level rows (fblock64, fblock) and
// int64 over the two-level rows of a big index (fb2_64, fb2, fb2_256).

#include <cstdint>

#include <cuda_runtime.h>

#include "lf_rank.cuh"

namespace {

enum Mode : int { kGreedy = 0, kLmem = 1, kSample = 2 };

// The output tables, in the lane type; null where the mode writes none.
template <typename Lane>
struct Out {
  Lane* rlo;    // [W, B] probe ranges
  Lane* rhi;
  Lane* rseed;  // [W, B] owning seed slot (GREEDY)
  Lane* nrec;   // [B] probes counted
  Lane* slo;    // [S, B] seeds
  Lane* shi;
  Lane* sqs;
  Lane* sqe;    // GREEDY, SAMPLE
  Lane* ns;     // [B] seeds counted (GREEDY, SAMPLE)
  Lane* hi_rec;  // [L, B] pre-step hi (SAMPLE, optional)
  int W, S;
};

template <typename Lane>
struct Params {
  const int4* fb;
  const Lane* F;
  const int64_t* base;
  int per_blk;
  int A;
  Lane n;
  const int32_t* q;
  const int32_t* lengths;
  int B, L;
  bool stage;
  const void* ftab;
  int ftab_bytes, k;
  uint32_t acgt;
  int wsize;
  long long max_range;
  int min_length;
  Out<Lane> out;
};

// One block: blockDim.x / kG lanes, kG neighbouring threads a lane, both
// running the lane's machine (their ranks are summed by shuffle, so they
// take the same branches); the first of them writes.
template <typename Lane, int SYMS, int MODE>
__global__ void __launch_bounds__(1024) seed_machine_kernel(const Params<Lane> p) {
  extern __shared__ __align__(16) uint8_t s_code[];  // [lanes of the block][stride] when staged
  __shared__ Lane sF[kCkpt + 1];

  const int lanes = blockDim.x / kG;
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, p.B - b0);
  const int L = p.L;
  const int stride = staged_stride(L);
  if (threadIdx.x <= (unsigned)p.A) sF[threadIdx.x] = p.F[threadIdx.x];
  if (p.stage) stage_codes(s_code, p.q + (size_t)b0 * L, nl, L, p.A, stride);
  __syncthreads();

  const int ll = threadIdx.x / kG;
  if (ll >= nl) return;
  const int sub = threadIdx.x % kG;
  const bool writer = sub == 0;
  const int b = b0 + ll;
  const int B = p.B;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = p.q + (size_t)b * L;
  auto code_at = [&](int col) -> int {
    return p.stage ? (int)mine[col] : code_byte(row_q[col], p.A);
  };
  const unsigned pair = ((1u << kG) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(kG - 1));
  auto step = [&](int c, Lane& lo, Lane& hi) -> bool {
    return lf_step_rows<Lane, SYMS>(p.fb, sF, p.base, p.per_blk, p.A, p.n, sub, pair, c, lo,
                                    hi);
  };
  // the ftab range of the lane's last k codes: false on a miss (a k-mer
  // with a code other than A, C, G, T, or none in the text)
  auto ftab_range = [&](Lane& lo, Lane& hi) -> bool {
    const int kc = kmer_code(code_at, L, p.k, p.acgt);
    if (kc < 0) return false;
    const int64_t flo = load_at(p.ftab, p.ftab_bytes, 2 * (int64_t)kc);
    if (flo < 0) return false;
    lo = (Lane)flo;
    hi = (Lane)load_at(p.ftab, p.ftab_bytes, 2 * (int64_t)kc + 1);
    return true;
  };
  // the torch loops' column of step i: clamp(L - 1 - i, 0, L - 1)
  auto col_of = [&](Lane i) -> int {
    const Lane col = L - 1 - i;
    return col < 0 ? 0 : col > L - 1 ? L - 1 : (int)col;
  };
  const Out<Lane>& o = p.out;
  auto record = [&](int slot, Lane lo, Lane hi, Lane owner) {
    if (!writer) return;
    const size_t at = (size_t)min(slot, o.W - 1) * B + b;
    o.rlo[at] = lo;
    o.rhi[at] = hi;
    if (MODE == kGreedy) o.rseed[at] = owner;
  };
  auto put = [&](int slot, Lane lo, Lane hi, Lane qs, Lane qe) {
    if (!writer || slot >= o.S) return;
    const size_t at = (size_t)slot * B + b;
    o.slo[at] = lo;
    o.shi[at] = hi;
    o.sqs[at] = qs;
    o.sqe[at] = qe;
  };
  auto in_range = [&](Lane lo, Lane hi) { return (long long)hi - lo + 1 <= p.max_range; };

  const Lane n1 = p.n - 1;
  const Lane m = (Lane)p.lengths[b];
  const int wsize = p.wsize;
  int nrec = 0, ns = 0;

  if constexpr (MODE == kGreedy) {
    Lane lo = 0, hi = n1, i = 0;
    const int k = p.k;  // the ftab's k-mer length, 0 without the ftab start
    if (k > 0 && m >= k && ftab_range(lo, hi)) i = k;
    Lane plo = lo, phi = hi, seed_ei = m, window_ei = m;
    int rp = 0;           // chars of an ftab restart left to replay (0: a normal step)
    bool rpmiss = false;  // the replay met an empty range: it holds the full range
    for (int t = 0; t < L && i < m; ++t) {
      const int c = code_at(col_of(i));
      const bool normal = rp == 0;
      Lane nlo = lo, nhi = hi;
      // a held replay step ignores its LF step: no row is loaded for it
      const bool ne = normal || !rpmiss ? step(c, nlo, nhi) : false;
      const bool ok = normal && ne, fail = normal && !ne;
      const Lane mi = m - i;
      // success: the window probe (rowbowt.hpp:472-478); failure: the
      // seed-final probe of prev (rowbowt.hpp:448)
      const bool w_trigger = ok && window_ei - (mi - 1) >= wsize;
      const bool f_probe = fail && seed_ei - mi >= wsize;
      if (w_trigger || f_probe) {
        const Lane tlo = fail ? plo : nlo, thi = fail ? phi : nhi;
        if (in_range(tlo, thi)) record(nrec++, tlo, thi, (Lane)ns);
      }
      if (w_trigger) window_ei = mi - 1;
      if (fail) {
        // the seed (prev, (m - i, seed_ei - 1)), then the reset
        // (rowbowt.hpp:450-453)
        put(ns++, plo, phi, mi, seed_ei - 1);
        plo = 0;
        phi = n1;
        seed_ei = mi - 1;
        window_ei = mi - 1;
      }
      if (k > 0) {
        // the restart (rowbowt.hpp:454-464) as a k-step replay from the
        // full range (the torch loop's rp/rpmiss)
        const bool hit = fail && mi - 1 >= k;
        const bool rstep = rp > 0;
        const bool held = rpmiss || (rstep && !ne);
        if (ok) {
          lo = plo = nlo;
          hi = phi = nhi;
        } else if (fail) {
          lo = 0;
          hi = n1;
        } else if (rstep) {
          lo = plo = held ? 0 : nlo;
          hi = phi = held ? n1 : nhi;
        }
        rpmiss = hit ? false : held;
        rp = hit ? k : rstep ? rp - 1 : rp;
      } else if (ok) {
        lo = plo = nlo;
        hi = phi = nhi;
      } else if (fail) {
        lo = 0;
        hi = n1;
      }
      ++i;
    }
    // the final emission (rowbowt.hpp:477-481)
    if (hi >= lo && seed_ei - (m - i) >= wsize && in_range(lo, hi))
      record(nrec++, lo, hi, (Lane)ns);
    if (m > 0) put(ns++, lo, hi, m - i, seed_ei - 1);
  } else if constexpr (MODE == kLmem) {
    Lane lo = 0, hi = n1, i = 0;
    const int k = p.k;
    // every lane of at least k codes jumps k, its range the full one on
    // a miss (rowbowt.hpp:369-377); k is 0 where L < k (no lane jumps)
    if (k > 0 && m >= k) {
      ftab_range(lo, hi);
      i = k;
    }
    Lane window_ei = m;
    bool done = false;
    Lane elo = 1, ehi = 0, eqs = 0;
    for (int t = 0; t < L && i < m; ++t) {
      const int c = code_at(col_of(i));
      Lane nlo = lo, nhi = hi;
      const bool ok = step(c, nlo, nhi);
      const Lane mi = m - i;
      const bool f_probe = !ok && i >= wsize;
      const bool w_trigger = ok && window_ei - (mi - 1) >= wsize;
      if (f_probe || w_trigger) {
        // prev_range of a failure is the pre-step range
        const Lane tlo = ok ? nlo : lo, thi = ok ? nhi : hi;
        if (in_range(tlo, thi)) record(nrec++, tlo, thi, 0);
      }
      if (w_trigger) window_ei = mi - 1;
      if (!ok) {
        elo = lo;
        ehi = hi;
        eqs = mi;
        done = true;
        break;
      }
      lo = nlo;
      hi = nhi;
      ++i;
    }
    if (!done) {
      // completed without a failure: the final probe and the seed
      // (rowbowt.hpp:399-403)
      if (hi >= lo && i >= wsize && m > 0 && in_range(lo, hi)) record(nrec++, lo, hi, 0);
      elo = lo;
      ehi = hi;
      eqs = m - i;
    }
    if (writer) {
      o.slo[b] = elo;
      o.shi[b] = ehi;
      o.sqs[b] = eqs;
    }
  } else {
    Lane lo = 0, hi = n1, plo = 0, phi = n1, ei = m;
    const int jend = m < L ? (int)m : L;
    int j = 0;
    for (; j < jend; ++j) {
      const int c = code_at(L - 1 - j);
      if (o.hi_rec != nullptr && writer) o.hi_rec[(size_t)j * B + b] = hi;  // pre-step hi
      Lane nlo = lo, nhi = hi;
      if (step(c, nlo, nhi)) {
        lo = plo = nlo;
        hi = phi = nhi;
      } else {
        // the seed (prev, [m - j, ei)) if long enough, then a restart from
        // the full range
        if (ei - (m - j) >= p.min_length) put(ns++, plo, phi, m - j, ei);
        lo = plo = 0;
        hi = phi = n1;
        ei = m - j - 1;
      }
    }
    if (o.hi_rec != nullptr && writer)
      for (; j < L; ++j) o.hi_rec[(size_t)j * B + b] = hi;
    // the tail seed (rowbowt.hpp:252-254)
    if (ei >= p.min_length) put(ns++, plo, phi, 0, ei);
  }

  if (!writer) return;
  if (o.nrec != nullptr) {
    o.nrec[b] = nrec;
    for (int w = min(nrec, o.W); w < o.W; ++w) {
      o.rlo[(size_t)w * B + b] = 1;
      o.rhi[(size_t)w * B + b] = 0;
      if (MODE == kGreedy) o.rseed[(size_t)w * B + b] = 0;
    }
  }
  if (o.ns != nullptr) {
    o.ns[b] = ns;
    for (int s = min(ns, o.S); s < o.S; ++s) {
      const size_t at = (size_t)s * B + b;
      o.slo[at] = 1;
      o.shi[at] = 0;
      o.sqs[at] = 0;
      o.sqe[at] = 0;
    }
  }
}

template <typename Lane, int SYMS, int MODE>
int launch(const Params<Lane>& p, int threads, cudaStream_t s) {
  const int lanes = threads / kG;
  const size_t smem = p.stage ? (size_t)lanes * staged_stride(p.L) : 0;
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.B + lanes - 1) / lanes));
  seed_machine_kernel<Lane, SYMS, MODE><<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename Lane, int SYMS>
int launch_mode(int mode, const Params<Lane>& p, int threads, cudaStream_t s) {
  if (mode == kGreedy) return launch<Lane, SYMS, kGreedy>(p, threads, s);
  if (mode == kLmem) return launch<Lane, SYMS, kLmem>(p, threads, s);
  return launch<Lane, SYMS, kSample>(p, threads, s);
}

}  // namespace

extern "C" {

// Runs the seeding machine `mode` (0 GREEDY, 1 LMEM, 2 SAMPLE) on `stream`
// over the B lanes of the row-major [B, L] int32 codes q (right-aligned, -1
// pad) with int32 lengths.  Rows `fb` of syms_per_row symbols: with
// lane_bytes 4 the single-level rows (64 or 128 symbols) with int32 F [A +
// 1], n below 2^31 - 1 and no base; with lane_bytes 8 the two-level rows (64,
// 128 or 256) with int64 F and base [n_sup, 8], per_blk rows a superblock.
// The ftab start (int32 or int64 ftab [4^k, 2], acgt as rbt_lf_count's)
// runs where k > 0: GREEDY's and LMEM's (whose caller passes k = 0 where L
// is below the ftab's k), never SAMPLE's.
// Outputs in the lane type: GREEDY rlo, rhi, rseed [W, B], nrec, slo, shi,
// sqs, sqe [S, B], ns; LMEM rlo, rhi [W, B], nrec, and its seed's elo, ehi
// and eqs [B] in slo, shi and sqs with S = 1 (rseed, sqe, ns null); SAMPLE
// slo, shi, sqs, sqe [S, B] and ns (W = 0, no records), and with hi_rec
// ([L, B]) the step record.  wsize, max_range (the probes' range cap) and
// min_length (SAMPLE's) are the machines' parameters.  `threads` is the
// block size (two threads a lane), `stage` reads the codes from shared
// memory (threads / 2 * staged stride bytes, at most 47 KB); both from
// ops/cuda_lf.py launch_plan.  Returns cudaGetLastError() after the launch
// (0 on success, nothing launched for B == 0), cudaErrorInvalidValue for
// arguments the mode does not take.
int rbt_seed_machine(int mode, const void* fb, int syms_per_row, const void* F, const void* base,
                     int per_blk, int A, long long n, int lane_bytes, const void* q,
                     const void* lengths, int B, int L, const void* ftab, int ftab_bytes, int k,
                     int acgt, int wsize, long long max_range, int min_length, int W, void* rlo,
                     void* rhi, void* rseed, void* nrec, int S, void* slo, void* shi, void* sqs,
                     void* sqe, void* ns, void* hi_rec, int threads, int stage, void* stream) {
  const bool greedy = mode == kGreedy, lmem = mode == kLmem, sample = mode == kSample;
  const bool seeds = slo != nullptr && shi != nullptr && sqs != nullptr;
  const bool outs =
      greedy ? W >= 1 && S >= 1 && rlo && rhi && rseed && nrec && seeds && sqe && ns && !hi_rec
      : lmem ? W >= 1 && S == 1 && rlo && rhi && !rseed && nrec && seeds && !sqe &&
                   !ns && !hi_rec
      : sample ? k == 0 && W == 0 && S >= 1 && !rlo && !rhi && !rseed && !nrec && seeds && sqe &&
                     ns
               : false;
  const int shift = syms_per_row == 64 ? 6 : syms_per_row == 128 ? 7 : 8;
  const bool rows = lane_bytes == 4 ? (syms_per_row == 64 || syms_per_row == 128) &&
                                          n < INT32_MAX && base == nullptr
                  : lane_bytes == 8 ? (syms_per_row == 64 || syms_per_row == 128 ||
                                       syms_per_row == 256) &&
                                          ((n - 1) >> shift) < INT32_MAX && base != nullptr &&
                                          per_blk >= 1
                                    : false;
  if (!outs || !rows || fb == nullptr || F == nullptr || A < 1 || A > kCkpt || B < 0 || L < 0 ||
      n < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 || k < 0 || k > 15 ||
      (k > 0 && (ftab == nullptr || (ftab_bytes != 4 && ftab_bytes != 8) || L < k)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lane_bytes == 4) {
    using Lane = int32_t;
    const Out<Lane> o{(Lane*)rlo, (Lane*)rhi, (Lane*)rseed, (Lane*)nrec, (Lane*)slo,
                      (Lane*)shi, (Lane*)sqs, (Lane*)sqe, (Lane*)ns, (Lane*)hi_rec, W, S};
    const Params<Lane> p{static_cast<const int4*>(fb), static_cast<const Lane*>(F), nullptr, 0, A,
                         (Lane)n, static_cast<const int32_t*>(q),
                         static_cast<const int32_t*>(lengths), B, L, stage != 0, ftab,
                         ftab_bytes, k, (uint32_t)acgt, wsize, max_range, min_length, o};
    return syms_per_row == 64 ? launch_mode<Lane, 64>(mode, p, threads, s)
                              : launch_mode<Lane, 128>(mode, p, threads, s);
  }
  using Lane = int64_t;
  const Out<Lane> o{(Lane*)rlo, (Lane*)rhi, (Lane*)rseed, (Lane*)nrec, (Lane*)slo,
                    (Lane*)shi, (Lane*)sqs, (Lane*)sqe, (Lane*)ns, (Lane*)hi_rec, W, S};
  const Params<Lane> p{static_cast<const int4*>(fb), static_cast<const Lane*>(F),
                       static_cast<const int64_t*>(base), per_blk, A, (Lane)n,
                       static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B,
                       L, stage != 0, ftab, ftab_bytes, k, (uint32_t)acgt, wsize, max_range,
                       min_length, o};
  if (syms_per_row == 64) return launch_mode<Lane, 64>(mode, p, threads, s);
  if (syms_per_row == 128) return launch_mode<Lane, 128>(mode, p, threads, s);
  return launch_mode<Lane, 256>(mode, p, threads, s);
}

const char* rbt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
