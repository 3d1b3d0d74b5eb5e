// The seeding state machines of rbt_markers and rbt_locs, one launch a
// batch, for Hopper (sm_90a).
//
// Each lane runs its read's whole seeding loop inside the kernel, with real
// per-lane control flow where the torch loops of
// rowbowt_tpu_torch/engine/seeds.py select with masks over [B] tensors, L
// steps of tens of kernel launches each.  The JAX package runs the same
// loops as XLA fori_loops: rowbowt_tpu/engine/seeds.py:348
// (markers_greedy_seeding), :500 (markers_lmem_lanes) and :112-117
// (seeds_greedy_w_sample).  The machine body is written once (machine()),
// templated on its LF step, the step policy:
//   - Rows: K1's LF step (lf_rank.cuh: two ranks over a fused-block row by
//     the lane's two threads), over the single-level rows with int32 lanes
//     (fblock64, fblock) and the two-level bit-plane rows of a big index
//     with int64 lanes (made from fb2_64, fb2, fb2_256; rank_pair_planes);
//   - Tables: the tables kernel's step (lf_tables.cuh: the run-space, dense
//     or occ1 ranks, on two threads a lane, lane_threads), over an index
//     without fused rows (a --no-dense build, 9-16 codes, a raw build's
//     occ1), int32 lanes.
// MODE selects the machine, each transcribed from the port's torch loop
// (its *_records_plain twin, which the kernel is held against):
//   - GREEDY, RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482):
//     the ftab start, then per step the window probe on success and the
//     seed-final probe and the seed on failure, and after a failure that
//     leaves at least k codes the ftab restart (rowbowt.hpp:454-464) as a
//     k-step replay from the full range, with search_ftab's miss ->
//     full-range quirk (rowbowt.hpp:757) as an empty range mid-replay that
//     holds the full range for the rest of it; then the final probe and
//     seed.  Out: the range of every probe and its owning seed slot (rlo,
//     rhi, rseed [W, B], nrec [B]) and the seeds (slo, shi, sqs, sqe [S,
//     B], ns [B]);
//   - LMEM, the inner loop of RowBowt::get_markers_lmems (rowbowt.hpp:
//     341-404): one search a lane from the ftab start until it fails, the
//     ranges it would probe (rlo, rhi [W, B], nrec) and its one seed (elo,
//     ehi, eqs in slo, shi, sqs with S = 1);
//   - SAMPLE, RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256): a
//     seed at each failure of at least min_length codes, the search
//     restarting from the full range, and the tail seed; with hi_rec it
//     also writes each lane's pre-step hi of every step into an [L, B]
//     record, the step record of a big index's trajectory toehold.  Its TOE
//     instance (an index without kval: RowBowt::LF_w_loc, rowbowt.hpp:
//     553-573) also writes each seed's toehold into ssamp [S, B], as K1's
//     toehold launch carries it: the code and pre-step hi of the run's last
//     non-trivial step and the trivial steps since (the run restarting at
//     each failure from k0), copied after every successful step; a seed
//     takes the copy's toehold, resolved once from tk1 or ltk, or -1 where
//     the lane had no successful step yet.  The copy survives a failure, so
//     a degenerate seed under min_length 0 takes the stale toehold of the
//     run before, as the reference does.
// A probe's marker count is a pure function of its range, so the probes run
// as one bulk markers_bounds after the launch (ops/cuda_seeds.py), not in
// the machine.  A record slot is min(count, capacity - 1), so an overflow
// overwrites the last slot, and the counts run on past the capacity, as in
// the torch loops; a seed is put only while ns < S, and a probe's owner is
// ns even past S (the expansion drops those).  The slots a lane leaves
// unwritten get the tables' fill values (the empty range (1, 0), zeros).
// Every [W, B], [S, B] and [L, B] table is written column b by lane b, so
// the results do not depend on which thread group runs which lane.
//
// Lanes and warps: a block runs its lanes b0 .. b0 + nl - 1, but in GREEDY
// and SAMPLE, within each chunk of two warps' lanes, the first warp takes
// the chunk's even lanes and the second its odd ones (lane_of).
// rbt_markers -f lays a read's two strands side by side (lane 2r "+", 2r +
// 1 "-"), and a reverse strand's lane, its k-mers mostly absent from the
// index, fails every few codes, so a warp holds the lanes of one strand
// and does not wait on the other's.  Two other designs were timed against
// this one in turns on the same batches and dropped (PERF.md section 6):
// greedy's restart as one ftab lookup of the next k codes where they are
// A, C, G or T, and a persistent grid, one flat loop whose lane groups take
// their next lanes from a counter as their lanes end.  Together they were
// 0.95x and 0.98x this design's time on L-MEM and greedy over the
// run-space tables, and 1.01-1.11x on every other batch.
//
// What bounds it: the step's loads, one step after another (K1's row loads;
// over the run-space tables a bucket directory's entry, a search of the few
// run starts in one bucket and the run's count, on two threads a lane with
// the machine body run by both, as over rows; over the dense tables a 64 B
// block or two split over the lane's two threads, each counting its words;
// over occ1 one load a rank on each), each lane's chain waiting on their
// latency, so the most lanes resident at once is the fastest; for GREEDY a
// replay of k steps after each failure; the record writes are a few words
// a lane.  The machine body runs on every thread of a lane, so a warp's
// instructions serve 32 / G lanes: more threads a lane shorten the step's
// chain and lengthen the rest.  Each instance family is built for its
// block size and blocks an SM (Bounds), so that no instance spills.

#include <cstdint>

#include <cuda_runtime.h>

#include "lf_rank.cuh"
#include "lf_tables.cuh"

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
  Lane* ssamp;   // [S, B] each seed's toehold (SAMPLE's TOE instance)
  int W, S;
};

template <typename Lane>
struct Params {
  const int4* fb;  // the fused rows (Rows)
  const Lane* F;
  Sup sup;  // the two-level rows' superblocks (Rows, int64 lanes)
  Tabs t;   // the rank tables (Tables)
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
  Toe toe;  // the per-step toehold's tables (TOE), its k unused
  Out<Lane> out;
};

// K1's step over fused rows (int64 lanes: the two-level plane rows), by the
// lane's kG threads (their ranks are summed by shuffle, so both take the
// same branches); sF is F in shared memory.
template <typename LaneT, int SYMS>
struct Rows {
  using Lane = LaneT;
  static constexpr int kGroup = kG;
  const int4* fb;
  const Lane* sF;
  Sup sup;
  int A;
  Lane n;
  int sub;
  unsigned pair;
  template <bool TOE>
  __device__ __forceinline__ bool step(int c, Lane& lo, Lane& hi, bool& trivial) const {
    return lf_step_rows<Lane, SYMS, TOE>(fb, sF, sup, A, n, sub, pair, c, lo, hi, trivial);
  }
};

// The tables kernel's step over the POLICY tables (REC: the run-space
// tables through the run records) by the lane's lane_threads(POLICY) = 2
// threads (they take the same branches; sub and pair as Rows's).  F is
// global memory over the run-space tables, the block's staged copy in
// shared memory over the dense and occ1 tables (step_F).
template <typename LaneT, int POLICY, bool REC>
struct Tables {
  using Lane = LaneT;
  static constexpr int kGroup = lane_threads(POLICY);
  Tabs t;
  const Lane* F;
  int A;
  Lane n;
  int sub;
  unsigned pair;
  template <bool TOE>
  __device__ __forceinline__ bool step(int c, Lane& lo, Lane& hi, bool& trivial) const {
    return lf_step_tables<Lane, POLICY, TOE, REC>(t, F, A, n, sub, pair, c, lo, hi, trivial);
  }
};

// The block size and the blocks an SM each instance family is built for
// (__launch_bounds__), so that the register cap they set, 65,536 / (threads
// * blocks), leaves every instance without a spill: 64 registers for the
// int32 lanes (SYMS 0: the tables), 85 for the int64 lanes of the two-level
// plane rows of every width (over the nibble rows the 256-symbol instances
// needed 128, two blocks an SM).  A launch of more than kThreads threads a
// block is refused (ops/cuda_seeds.py plans within it).
template <typename Lane, int SYMS>
struct Bounds {
  static constexpr int kThreads = sizeof(Lane) == 8 ? 256 : 512;
  static constexpr int kBlocks = sizeof(Lane) == 4 ? 2 : 3;
};

// The lane (of the block's `lanes`) of lane group g, G threads a group, in
// machine MODE: g, but for GREEDY and SAMPLE the order within each chunk of
// two warps' groups, where the block holds whole chunks: the first warp
// takes the chunk's even lanes, the second its odd ones (the header's
// strands).  LMEM's lanes are one read's prefixes in turn (rbt_markers
// --lmem), whose searches end near each other: a warp takes neighbours.
template <int G, int MODE>
__device__ __forceinline__ int lane_of(int g, int lanes) {
  constexpr int chunk = 64 / G;
  if (MODE == kLmem || lanes % chunk != 0) return g;
  const int r = g % chunk;
  return g + (r < chunk / 2 ? r : r - chunk + 1);
}

// The machine MODE of lane b on the step policy `st`; code_at(col) is the
// lane's code at column col.  Only the `writer` thread of a lane writes.
template <int MODE, bool TOE, typename Step, typename CodeAt>
__device__ __forceinline__ void machine(const Params<typename Step::Lane>& p, const Step& st,
                                        const CodeAt& code_at, int b, bool writer) {
  using Lane = typename Step::Lane;
  static_assert(!TOE || MODE == kSample, "the per-step toehold is the sampled machine's");
  const int L = p.L;
  const int B = p.B;
  bool trivial = false;
  auto step = [&](int c, Lane& lo, Lane& hi) -> bool {
    return st.template step<TOE>(c, lo, hi, trivial);
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
    if (!writer || slot >= o.S) return false;
    const size_t at = (size_t)slot * B + b;
    o.slo[at] = lo;
    o.shi[at] = hi;
    o.sqs[at] = qs;
    o.sqe[at] = qe;
    return true;
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
      // a held replay step ignores its LF step: no table is loaded for it
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
    // TOE: the current run's last non-trivial step (code tc, pre-step hi
    // thi; tc < 0: none since the restart) and its trivial steps since,
    // and their copy after the last successful step (pc == kNone: none)
    constexpr int kNone = -2;
    int tc = -1, triv = 0, pc = kNone, ptriv = 0;
    Lane thi = 0, pthi = 0;
    // a seed and, for TOE, its toehold from the copy
    auto seed = [&](int slot, Lane qs, Lane qe) {
      if (!put(slot, plo, phi, qs, qe)) return;
      if constexpr (TOE)
        o.ssamp[(size_t)slot * B + b] =
            pc == kNone ? (Lane)-1 : (Lane)resolve_toehold(p.toe, p.n, pc, pthi, ptriv);
    };
    const int jend = m < L ? (int)m : L;
    int j = 0;
    for (; j < jend; ++j) {
      const int c = code_at(L - 1 - j);
      if (o.hi_rec != nullptr && writer) o.hi_rec[(size_t)j * B + b] = hi;  // pre-step hi
      Lane nlo = lo, nhi = hi;
      if (step(c, nlo, nhi)) {
        if constexpr (TOE) {
          if (trivial) {
            ++triv;
          } else {
            tc = c;
            thi = hi;
            triv = 0;
          }
          pc = tc;
          pthi = thi;
          ptriv = triv;
        }
        lo = plo = nlo;
        hi = phi = nhi;
      } else {
        // the seed (prev, [m - j, ei)) if long enough, then a restart from
        // the full range
        if (ei - (m - j) >= p.min_length) seed(ns++, m - j, ei);
        lo = plo = 0;
        hi = phi = n1;
        ei = m - j - 1;
        tc = -1;
        triv = 0;
      }
    }
    if (o.hi_rec != nullptr && writer)
      for (; j < L; ++j) o.hi_rec[(size_t)j * B + b] = hi;
    // the tail seed (rowbowt.hpp:252-254)
    if (ei >= p.min_length) seed(ns++, 0, ei);
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
      if constexpr (TOE) o.ssamp[at] = 0;
    }
  }
}

// Over fused rows: blockDim.x / kG lanes a block, kG neighbouring threads a
// lane (lane_of's order), both running the lane's machine; the first of
// them writes.
template <typename Lane, int SYMS, int MODE, bool TOE>
__global__ void __launch_bounds__(Bounds<Lane, SYMS>::kThreads, Bounds<Lane, SYMS>::kBlocks)
    seed_machine_kernel(const Params<Lane> p) {
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

  const int ll = lane_of<kG, MODE>(threadIdx.x / kG, lanes);
  if (ll >= nl) return;
  const int sub = threadIdx.x % kG;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = p.q + (size_t)(b0 + ll) * L;
  auto code_at = [&](int col) -> int {
    return p.stage ? (int)mine[col] : code_byte(row_q[col], p.A);
  };
  const unsigned pair = ((1u << kG) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(kG - 1));
  const Rows<Lane, SYMS> st{p.fb, sF, p.sup, p.A, p.n, sub, pair};
  machine<MODE, TOE>(p, st, code_at, b0 + ll, sub == 0);
}

// Over the POLICY tables of an index without fused rows (REC: through the
// run records): blockDim.x / G lanes a block, G neighbouring threads a lane
// (G = Tables::kGroup, lane_of's order), as the tables kernel runs; the
// first writes.
template <typename Lane, int POLICY, int MODE, bool TOE, bool REC>
__global__ void __launch_bounds__(Bounds<Lane, 0>::kThreads, Bounds<Lane, 0>::kBlocks)
    seed_tables_kernel(const Params<Lane> p) {
  using Step = Tables<Lane, POLICY, REC>;
  constexpr int G = Step::kGroup;
  extern __shared__ __align__(16) uint8_t s_code[];  // [lanes of the block][stride] when staged
  const int lanes = blockDim.x / G;
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, p.B - b0);
  const int L = p.L;
  const int stride = staged_stride(L);
  stage_F<POLICY>(p.F, p.A);  // the dense and occ1 steps' F, in shared memory
  if (p.stage) stage_codes(s_code, p.q + (size_t)b0 * L, nl, L, p.A, stride);
  __syncthreads();
  const int ll = lane_of<G, MODE>(threadIdx.x / G, lanes);
  if (ll >= nl) return;
  const int sub = threadIdx.x % G;
  const uint8_t* mine = s_code + ll * stride;
  const int32_t* row_q = p.q + (size_t)(b0 + ll) * L;
  auto code_at = [&](int col) -> int {
    return p.stage ? (int)mine[col] : code_byte(row_q[col], p.A);
  };
  const unsigned pair = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(G - 1));
  const Step st{p.t, step_F<POLICY>(p.F), p.A, p.n, sub, pair};
  machine<MODE, TOE>(p, st, code_at, b0 + ll, sub == 0);
}

// Launches `kernel`, built for blocks of at most `most` threads, over B
// lanes, `group` threads a lane.
template <typename Lane, typename Kernel>
int launch(Kernel kernel, int most, const Params<Lane>& p, int threads, int group,
           cudaStream_t s) {
  if (threads > most) return (int)cudaErrorInvalidValue;
  const int lanes = threads / group;
  const size_t smem = p.stage ? (size_t)lanes * staged_stride(p.L) : 0;
  if (smem > (size_t)kMaxStagedBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.B + lanes - 1) / lanes));
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename Lane, int SYMS>
int launch_rows(int mode, bool toe, const Params<Lane>& p, int threads, cudaStream_t s) {
  constexpr int most = Bounds<Lane, SYMS>::kThreads;
  if (mode == kGreedy)
    return launch(seed_machine_kernel<Lane, SYMS, kGreedy, false>, most, p, threads, kG, s);
  if (mode == kLmem)
    return launch(seed_machine_kernel<Lane, SYMS, kLmem, false>, most, p, threads, kG, s);
  if constexpr (sizeof(Lane) == 4) {
    if (toe)
      return launch(seed_machine_kernel<Lane, SYMS, kSample, true>, most, p, threads, kG, s);
  }
  return launch(seed_machine_kernel<Lane, SYMS, kSample, false>, most, p, threads, kG, s);
}

template <int POLICY, bool REC = false>
int launch_tables(int mode, bool toe, const Params<int32_t>& p, int threads, cudaStream_t s) {
  constexpr int G = lane_threads(POLICY);
  constexpr int most = Bounds<int32_t, 0>::kThreads;
  if (mode == kGreedy)
    return launch(seed_tables_kernel<int32_t, POLICY, kGreedy, false, REC>, most, p, threads, G,
                  s);
  if (mode == kLmem)
    return launch(seed_tables_kernel<int32_t, POLICY, kLmem, false, REC>, most, p, threads, G, s);
  if (toe)
    return launch(seed_tables_kernel<int32_t, POLICY, kSample, true, REC>, most, p, threads, G,
                  s);
  return launch(seed_tables_kernel<int32_t, POLICY, kSample, false, REC>, most, p, threads, G, s);
}

bool width(int bytes) { return bytes == 4 || bytes == 8; }

// Whether the outputs fit the mode (see rbt_seed_machine), and the ftab and
// the per-step toehold's tables over an index of n positions (ssamp given:
// SAMPLE only, valid_toe).
bool valid_outputs(int mode, int k, int W, int S, const void* rlo, const void* rhi,
                   const void* rseed, const void* nrec, const void* slo, const void* shi,
                   const void* sqs, const void* sqe, const void* ns, const void* hi_rec,
                   const void* ssamp, const Toe& toe, long long n) {
  const bool seeds = slo != nullptr && shi != nullptr && sqs != nullptr;
  const bool outs =
      mode == kGreedy
          ? W >= 1 && S >= 1 && rlo && rhi && rseed && nrec && seeds && sqe && ns && !hi_rec
      : mode == kLmem
          ? W >= 1 && S == 1 && rlo && rhi && !rseed && nrec && seeds && !sqe && !ns && !hi_rec
      : mode == kSample
          ? k == 0 && W == 0 && S >= 1 && !rlo && !rhi && !rseed && !nrec && seeds && sqe && ns
          : false;
  const bool toe_ok =
      ssamp == nullptr || (mode == kSample && hi_rec == nullptr && valid_toe(toe, n));
  return outs && toe_ok;
}

bool bad_common(int A, int amax, int B, int L, long long n, int threads, int k,
                const void* ftab, int ftab_bytes) {
  return A < 1 || A > amax || B < 0 || L < 0 || n < 1 || threads < 32 || threads > 1024 ||
         threads % 32 != 0 || k < 0 || k > 15 ||
         (k > 0 && (ftab == nullptr || !width(ftab_bytes) || L < k));
}

}  // namespace

extern "C" {

// Runs the seeding machine `mode` (0 GREEDY, 1 LMEM, 2 SAMPLE) on `stream`
// over the B lanes of the row-major [B, L] int32 codes q (right-aligned, -1
// pad) with int32 lengths.  Rows `fb` of syms_per_row symbols: with
// lane_bytes 4 the single-level rows (64 or 128 symbols) with int32 F [A +
// 1], n below 2^31 - 1 and no base; with lane_bytes 8 the two-level plane
// rows (64, 128 or 256 symbols; lf_rank.cuh Planes) with int64 F and base
// [n_sup, 8], a row's superblock (row * blk_mul) >> blk_shift (ops/rank.py
// superblock_magic).
// The ftab start (int32 or int64 ftab [4^k, 2], acgt as rbt_lf_count's)
// runs where k > 0: GREEDY's and LMEM's (whose caller passes k = 0 where L
// is below the ftab's k), never SAMPLE's.
// Outputs in the lane type: GREEDY rlo, rhi, rseed [W, B], nrec, slo, shi,
// sqs, sqe [S, B], ns; LMEM rlo, rhi [W, B], nrec, and its seed's elo, ehi
// and eqs [B] in slo, shi and sqs with S = 1 (rseed, sqe, ns null); SAMPLE
// slo, shi, sqs, sqe [S, B] and ns (W = 0, no records), and with hi_rec
// ([L, B]) the step record, or with ssamp ([S, B], single-level rows only)
// each seed's per-step toehold over tk1 (tk1_bytes) where given, else ltk
// with run_start and its bucket directory rs_off [n_off] (n_off == (n >>
// shift) + 2, at most `iters` halvings a bucket), and samples_last, each
// int32 or int64 (*_bytes), R runs.
// wsize, max_range (the probes' range cap) and min_length (SAMPLE's) are
// the machines' parameters.  `threads` is the block size (two threads a
// lane; at most 512, 256 over two-level rows), `stage` reads the codes from
// shared memory (threads / 2 * staged stride bytes, at most 47 KB); both
// from ops/cuda_lf.py launch_plan.
// Returns cudaGetLastError() after the launch (0 on success, nothing
// launched for B == 0), cudaErrorInvalidValue for arguments the mode does
// not take.
int rbt_seed_machine(int mode, const void* fb, int syms_per_row, const void* F, const void* base,
                     unsigned blk_mul, int blk_shift, int A, long long n, int lane_bytes,
                     const void* q,
                     const void* lengths, int B, int L, const void* ftab, int ftab_bytes, int k,
                     int acgt, int wsize, long long max_range, int min_length, int W, void* rlo,
                     void* rhi, void* rseed, void* nrec, int S, void* slo, void* shi, void* sqs,
                     void* sqe, void* ns, void* hi_rec, const void* tk1, int tk1_bytes,
                     const void* ltk, int ltk_bytes, const void* run_start, int rs_bytes,
                     const void* rs_off, int off_bytes, long long n_off, int shift, int iters,
                     const void* samples_last, int sl_bytes, int R, void* ssamp, int threads,
                     int stage, void* stream) {
  const Toe toe{tk1, ltk, run_start, samples_last, rs_off, tk1_bytes, ltk_bytes, rs_bytes,
                sl_bytes, off_bytes, R, n_off, shift, iters, nullptr};
  const int row_shift = syms_per_row == 64 ? 6 : syms_per_row == 128 ? 7 : 8;
  const bool rows = lane_bytes == 4 ? (syms_per_row == 64 || syms_per_row == 128) &&
                                          n < INT32_MAX && base == nullptr
                  : lane_bytes == 8 ? (syms_per_row == 64 || syms_per_row == 128 ||
                                       syms_per_row == 256) &&
                                          ((n - 1) >> row_shift) < INT32_MAX && base != nullptr &&
                                          blk_shift >= 31 && blk_shift <= 62 &&
                                          blk_mul >= (1u << 31) && ssamp == nullptr
                                    : false;
  if (!valid_outputs(mode, k, W, S, rlo, rhi, rseed, nrec, slo, shi, sqs, sqe, ns, hi_rec, ssamp,
                     toe, n) ||
      !rows || fb == nullptr || F == nullptr ||
      bad_common(A, kCkpt, B, L, n, threads, k, ftab, ftab_bytes))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool te = ssamp != nullptr;
  if (lane_bytes == 4) {
    using Lane = int32_t;
    const Out<Lane> o{(Lane*)rlo, (Lane*)rhi, (Lane*)rseed, (Lane*)nrec, (Lane*)slo,
                      (Lane*)shi, (Lane*)sqs, (Lane*)sqe, (Lane*)ns, (Lane*)hi_rec,
                      (Lane*)ssamp, W, S};
    const Params<Lane> p{static_cast<const int4*>(fb), static_cast<const Lane*>(F), {},
                         {}, A, (Lane)n, static_cast<const int32_t*>(q),
                         static_cast<const int32_t*>(lengths), B, L, stage != 0, ftab,
                         ftab_bytes, k, (uint32_t)acgt, wsize, max_range, min_length, toe, o};
    return syms_per_row == 64 ? launch_rows<Lane, 64>(mode, te, p, threads, s)
                              : launch_rows<Lane, 128>(mode, te, p, threads, s);
  }
  using Lane = int64_t;
  const Out<Lane> o{(Lane*)rlo, (Lane*)rhi, (Lane*)rseed, (Lane*)nrec, (Lane*)slo,
                    (Lane*)shi, (Lane*)sqs, (Lane*)sqe, (Lane*)ns, (Lane*)hi_rec, nullptr, W, S};
  const Params<Lane> p{static_cast<const int4*>(fb), static_cast<const Lane*>(F),
                       Sup{static_cast<const int64_t*>(base), blk_mul, blk_shift}, {}, A, (Lane)n,
                       static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B,
                       L, stage != 0, ftab, ftab_bytes, k, (uint32_t)acgt, wsize, max_range,
                       min_length, toe, o};
  if (syms_per_row == 64) return launch_rows<Lane, 64>(mode, false, p, threads, s);
  if (syms_per_row == 128) return launch_rows<Lane, 128>(mode, false, p, threads, s);
  return launch_rows<Lane, 256>(mode, false, p, threads, s);
}

// The same machines over the rank tables of an index without fused rows,
// int32 lanes (n below 2^31 - 1): `policy` and its tables as rbt_lf_tables
// takes them (0 runs: occ = occ_flat, run_start, run_head, R and the bucket
// directory rs_off [n_off] with (shift, iters), and the run records rec or
// null; 1 dense: occ = occ_blk_flat, bwt4 int32 [nb * 16] 16-byte aligned,
// A at most 16; 2 occ1: occ = occ1_flat, A at most 16), each int32 or int64
// (*_bytes);
// int32 F [A + 1].  The ftab, the outputs and the per-step toehold (ssamp,
// over tk1, or ltk with run_start and its directory, here the step's rs_off
// with (shift, iters), given under every policy, and samples_last) are
// rbt_seed_machine's;
// `threads` (lane_threads(policy), two threads a lane; at most 512) and
// `stage` from ops/cuda_lf.py launch_plan (lanes a block * staged stride
// bytes, at most 47 KB).
// Returns as rbt_seed_machine does.
int rbt_seed_machine_tables(int mode, int policy, const void* occ, int occ_bytes,
                            const void* run_start, int rs_bytes, const void* run_head,
                            int rh_bytes, const void* rs_off, int off_bytes, long long n_off,
                            int shift, int iters, const void* rec, const void* bwt4,
                            long long nb, int R, const void* F, int A, long long n,
                            const void* q, const void* lengths, int B, int L, const void* ftab,
                            int ftab_bytes, int k, int acgt, int wsize, long long max_range,
                            int min_length, int W, void* rlo, void* rhi, void* rseed, void* nrec,
                            int S, void* slo, void* shi, void* sqs, void* sqe, void* ns,
                            const void* tk1, int tk1_bytes, const void* ltk, int ltk_bytes,
                            const void* samples_last, int sl_bytes, void* ssamp, int threads,
                            int stage, void* stream) {
  const Toe toe{tk1, ltk, run_start, samples_last, rs_off, tk1_bytes, ltk_bytes, rs_bytes,
                sl_bytes, off_bytes, R, n_off, shift, iters, nullptr};
  const bool runs = policy == kRuns && run_start != nullptr && run_head != nullptr &&
                    width(rs_bytes) && width(rh_bytes) && R >= 1 &&
                    valid_directory(rs_off, off_bytes, n_off, shift, iters, n) &&
                    (rec == nullptr || valid_records(rec, A, 4));
  const bool dense = policy == kDense && rec == nullptr && bwt4 != nullptr && A < kMaxF &&
                     ((uintptr_t)bwt4 & 15) == 0 && nb >= (n + 127) / 128;
  const bool tables = occ != nullptr && width(occ_bytes) &&
                      (runs || dense || (policy == kOcc1 && rec == nullptr && A < kMaxF));
  if (!tables || F == nullptr || n >= INT32_MAX ||
      !valid_outputs(mode, k, W, S, rlo, rhi, rseed, nrec, slo, shi, sqs, sqe, ns, nullptr,
                     ssamp, toe, n) ||
      bad_common(A, 254, B, L, n, threads, k, ftab, ftab_bytes))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  using Lane = int32_t;
  const Tabs t{occ, run_start, run_head, static_cast<const int4*>(bwt4), rs_off,
               static_cast<const int4*>(rec), occ_bytes, rs_bytes, rh_bytes, off_bytes, R, nb,
               n_off, shift, iters};
  const Out<Lane> o{(Lane*)rlo, (Lane*)rhi, (Lane*)rseed, (Lane*)nrec, (Lane*)slo, (Lane*)shi,
                    (Lane*)sqs, (Lane*)sqe, (Lane*)ns, nullptr, (Lane*)ssamp, W, S};
  const Params<Lane> p{nullptr, static_cast<const Lane*>(F), {}, t, A, (Lane)n,
                       static_cast<const int32_t*>(q), static_cast<const int32_t*>(lengths), B, L,
                       stage != 0, ftab, ftab_bytes, k, (uint32_t)acgt, wsize, max_range,
                       min_length, toe, o};
  cudaStream_t s = (cudaStream_t)stream;
  const bool te = ssamp != nullptr;
  if (policy == kRuns)
    return rec != nullptr ? launch_tables<kRuns, true>(mode, te, p, threads, s)
                          : launch_tables<kRuns>(mode, te, p, threads, s);
  if (policy == kDense) return launch_tables<kDense>(mode, te, p, threads, s);
  return launch_tables<kOcc1>(mode, te, p, threads, s);
}

const char* rbt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
