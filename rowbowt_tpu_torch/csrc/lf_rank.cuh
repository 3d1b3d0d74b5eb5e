// The LF step of K1 over fused-block rows, shared by the kernels that step
// on it: lf.cu (K1, lf_count_kernel and lf_count2_kernel, and the tables
// kernel's staging) and seeds.cu (the seeding state machines of rbt_markers
// and rbt_locs), with the per-step toehold's trivial test (BWT[hi] == c)
// from the rows already loaded: K1's toehold instance folds it into hi +
// 1's rank (rank_pair_toe), the sampled machine reads hi's symbol from the
// row (bwt_at_hi).
//
// Single-level rows (rowbowt_tpu_torch/construct/build.py build_fblock and
// fblock_to_fb64): int32[8 + SYMS/8] per row = 8 exclusive per-code
// checkpoints, then SYMS 4-bit symbols packed 8 per word, symbol j of a word
// at bits [4j, 4j+4).  A lane's kG neighbouring threads of one warp share a
// rank: each loads every other 16-byte part of a row, and one shuffle sums
// their shares (lf.cu says why).
//
// Two-level rows of a big index (Planes; engine/device.py bit_planes makes
// them from the nibble rows): the 8 checkpoints count from the start of the
// row's superblock, base[s][c] (int64) is the count of c before superblock
// s, and the symbols are three bit planes, each thread of a lane holding in
// whole 16-byte parts its half of the checkpoints and all three planes of
// its half of the symbols, so that neither needs the other's words.  A code
// is below 8 (kCkpt), so three bits carry it; the artifact's pad nibble 15
// past n is 7 here, which no rank reaches: a rank at i < n counts only the
// positions below i, and rank(n, c) is F's.  Per 32 symbols a rank is
// (P0 ^ m0) & (P1 ^ m1) & (P2 ^ m2), m_k all ones where bit k of c is 0, and
// one __popc under the offset's mask: some 8 instructions, where the
// nibbles' SWAR count took some 60 for the same symbols.
//
// Everything here sits in an anonymous namespace: each .cu file that
// includes it builds into a library of its own.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCkpt = 8;
// staged codes per block: under the 48 KB a block may use without opting in,
// with room for the kernel's static shared memory
constexpr int kMaxStagedBytes = 47 * 1024;
constexpr int kAbsent = 0xFF;  // staged byte of code -1 (absent from the index, pad)
constexpr int kOther = 0xFE;   // staged byte of any other code outside [0, A)
constexpr int kG = 2;          // threads per lane, neighbours in a warp

template <int SYMS>
struct Layout {
  static constexpr int kWords = SYMS / 8;         // packed words per row
  static constexpr int kRow = kCkpt + kWords;     // int32 lanes per row
  static constexpr int kVec = kRow / 4;           // int4 parts per row
  static constexpr int kShift = SYMS == 64 ? 6 : SYMS == 128 ? 7 : 8;
  static_assert(SYMS == 64 || SYMS == 128 || SYMS == 256, "64-, 128- or 256-symbol rows");
  static_assert(kRow % 4 == 0, "rows are whole 16-byte vectors");
  static constexpr int kPer = kVec / kG;          // parts of a row per thread
  static_assert(kVec % kG == 0, "each thread of a lane holds as many parts");
};

// The bit-plane rows of the two-level layouts: int32 [kRow] a row = parts 0
// and 1 the checkpoints 0-3 and 4-7 (checkpoint c at int32 c), then for
// thread t of the lane's two, plane p of its 32-symbol word w (bit i = bit p
// of symbol t * SYMS / 2 + 32 w + i) as its flat word j = p * kW + w, in
// 16-byte part 2 * (1 + j / 4) + t, lane j % 4, the rest of its last part
// zero: 64 B (64 symbols), 96 B (128) or 128 B (256, one line) a row.
template <int SYMS>
struct Planes {
  static_assert(SYMS == 64 || SYMS == 128 || SYMS == 256, "64-, 128- or 256-symbol rows");
  static constexpr int kW = SYMS / 64;             // words of each plane a thread holds
  static constexpr int kPer = (3 * kW + 3) / 4;    // 16-byte parts of planes a thread holds
  static constexpr int kVec = kG * (1 + kPer);     // 16-byte parts a row
  static constexpr int kShift = SYMS == 64 ? 6 : SYMS == 128 ? 7 : 8;
};

// The superblocks of the two-level rows: base int64 [n_sup, kCkpt], and a
// row's superblock (row * mul) >> shift, which equals row / per_blk for every
// row id below 2^31 (ops/rank.py superblock_magic).
struct Sup {
  const int64_t* base;
  uint32_t mul;
  int shift;
};

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ int code_byte(int c, int A) {
  return (unsigned)c < (unsigned)A ? c : c == -1 ? kAbsent : kOther;
}

// Bytes per lane of the staged codes: L rounded up to whole words, with an
// odd number of words, so that the lanes of a warp read distinct banks.
__host__ __device__ __forceinline__ int staged_stride(int L) {
  return ((L + 3) & ~3) | 4;
}

// Mask of the kn lowest nibbles of a word, kn in [0, 8] (1u << 32 is
// undefined in C++, so kn == 8 takes the whole word).
__device__ __forceinline__ uint32_t below(int kn) {
  kn = min(max(kn, 0), 8);
  return kn >= 8 ? 0xFFFFFFFFu : (1u << (4 * kn)) - 1u;
}

// Count of the nibbles equal to c (pat = c in every nibble) among the kn
// lowest nibbles of the word x.
__device__ __forceinline__ int nibbles_below(uint32_t x, uint32_t pat, int kn) {
  x ^= pat;
  const uint32_t t = x | (x >> 1) | (x >> 2) | (x >> 3);
  return __popc(~t & 0x11111111u & below(kn));
}

// Stages the codes of a block's nl lanes, the rows of the [B, L] batch from
// src on, into shared memory: one byte a code (code_byte), `stride` bytes a
// lane, with 16-byte loads where the rows allow them.
__device__ __forceinline__ void stage_codes(uint8_t* s_code, const int32_t* __restrict__ src,
                                            int nl, int L, int A, int stride) {
  if ((L & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    // 16-byte loads: four codes in, one word of four bytes out
    const int4* src4 = reinterpret_cast<const int4*>(src);
    const int wpl = L / 4;  // words per lane
    for (int i = threadIdx.x; i < nl * wpl; i += blockDim.x) {
      const int4 c = src4[i];
      const int r = i / wpl;
      *reinterpret_cast<uint32_t*>(s_code + r * stride + 4 * (i - r * wpl)) =
          (uint32_t)code_byte(c.x, A) | (uint32_t)code_byte(c.y, A) << 8 |
          (uint32_t)code_byte(c.z, A) << 16 | (uint32_t)code_byte(c.w, A) << 24;
    }
  } else {
    // L not a multiple of 4, or a view that starts off a 16-byte boundary
    for (int i = threadIdx.x; i < nl * L; i += blockDim.x) {
      const int r = i / L;
      s_code[r * stride + i - r * L] = (uint8_t)code_byte(src[i], A);
    }
  }
}

// The ftab k-mer code of a lane's last k codes (two bits a base, the first
// code highest; the last match in acgt wins, as in ops/rank.py kmer_codes),
// or -1 where one of them is not A, C, G or T.
template <typename CodeAt>
__device__ __forceinline__ int kmer_code(const CodeAt& code_at, int L, int k, uint32_t acgt) {
  int kc = 0;
  for (int col = L - k; col < L; ++col) {
    const int c = code_at(col);
    int two_bits = -1;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (c == (int)((acgt >> (8 * t)) & 0xFF)) two_bits = t;
    }
    if (two_bits < 0) return -1;
    kc = (kc << 2) | two_bits;
  }
  return kc;
}

// This thread's share of rank(c) at in-row offset `off`, from the parts of
// one row it holds: part sub + m * kG of the row in v[m].  The shares of the
// kG threads of a lane sum to the checkpoint of c plus the count of c among
// the row's first `off` symbols.
template <int SYMS>
__device__ __forceinline__ int rank_share(const int4 (&v)[Layout<SYMS>::kPer], int sub,
                                          int c, int off) {
  const uint32_t pat = (uint32_t)c * 0x11111111u;
  int share = 0;
#pragma unroll
  for (int m = 0; m < Layout<SYMS>::kPer; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = 4 * (sub + m * kG) + e;  // int32 lane of the row
      const uint32_t x = (uint32_t)lane_of(v[m], e);
      if (lane < kCkpt) {
        share += lane == c ? (int)x : 0;
      } else {
        share += nibbles_below(x, pat, off - 8 * (lane - kCkpt));
      }
    }
  }
  return share;
}

__device__ __forceinline__ int64_t load_at(const void* p, int bytes, int64_t i) {
  return bytes == 8 ? (int64_t)__ldg(static_cast<const long long*>(p) + i)
                    : (int64_t)__ldg(static_cast<const int32_t*>(p) + i);
}

// This thread's share of rank(c) at in-row offset `off` (0 <= off <=
// SYMS) for K1's toehold instance: rank_share's count, with each word's
// mask of its symbols below off made by one funnel shift (the low min(4 *
// kn, 32) bits, kn that word's symbols below off; three instructions a
// word where below() takes six).  With LAST (off >= 1) the share doubled,
// plus 1 where this thread holds the word of the symbol at off - 1 and
// that symbol is c: the kG threads' values then sum to 2 * rank + [symbol
// at off - 1 == c], which one shuffle adds up (2 * rank + 1 < 2^32 for
// every rank below 2^31); the symbol's bit is its nibble's match in the
// word the rank counts, picked by one select a word and one shift.
template <int SYMS, bool LAST>
__device__ __forceinline__ uint32_t toe_share(const int4 (&v)[Layout<SYMS>::kPer], int sub,
                                              int c, int off) {
  const uint32_t pat = (uint32_t)c * 0x11111111u;
  const int at = off - 1;  // LAST: the symbol of the bit, word at >> 3, nibble at & 7
  uint32_t share = 0, held = 0;
#pragma unroll
  for (int m = 0; m < Layout<SYMS>::kPer; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = 4 * (sub + m * kG) + e;  // int32 lane of the row
      const uint32_t x = (uint32_t)lane_of(v[m], e);
      if (lane < kCkpt) {
        share += lane == c ? x : 0u;
      } else {
        const int word = lane - kCkpt;
        const uint32_t y = x ^ pat;
        const uint32_t match = ~(y | (y >> 1) | (y >> 2) | (y >> 3)) & 0x11111111u;
        share += (uint32_t)__popc(
            match & __funnelshift_lc(0xFFFFFFFFu, 0u, (unsigned)max(4 * off - 32 * word, 0)));
        if constexpr (LAST) held = word == (at >> 3) ? match : held;
      }
    }
  }
  return LAST ? 2 * share + ((held >> (4 * (at & 7))) & 1u) : share;
}

// One step's ranks and trivial test of K1's toehold instance over the
// single-level rows: cb = rank(lo, c), ce = rank(hi + 1, c) and `trivial` =
// BWT[hi] == c, for a range with lo <= hi < n.  BWT[hi] == c exactly when
// rank(hi + 1, c) - rank(hi, c) == 1, so the test rides in hi + 1's rank:
// that rank is taken in hi's own row, at in-row offset (hi & (SYMS - 1)) +
// 1, which is at most SYMS (the row's checkpoint and all its symbols where
// hi + 1 starts the next row; the code's total where hi + 1 == n), so hi's
// symbol is always in the row fetched, its bit packed into the rank's own
// shuffle (toe_share), and no position needs another load.
template <int SYMS>
__device__ __forceinline__ void rank_pair_toe(const int4* __restrict__ fb, int lo, int hi, int c,
                                              int sub, unsigned pair, int& cb, int& ce,
                                              bool& trivial) {
  using Lo = Layout<SYMS>;
  const int r0 = lo >> Lo::kShift, r1 = hi >> Lo::kShift;
  int4 v[Lo::kPer], w[Lo::kPer];
#pragma unroll
  for (int m = 0; m < Lo::kPer; ++m) {
    const int part = sub + m * kG;
    v[m] = __ldg(fb + (size_t)r0 * Lo::kVec + part);
    w[m] = __ldg(fb + (size_t)r1 * Lo::kVec + part);
  }
  uint32_t p0 = toe_share<SYMS, false>(v, sub, c, lo & (SYMS - 1));
  uint32_t p1 = toe_share<SYMS, true>(w, sub, c, (hi & (SYMS - 1)) + 1);
  p0 += __shfl_xor_sync(pair, p0, 1);
  p1 += __shfl_xor_sync(pair, p1, 1);
  cb = (int)p0;
  ce = (int)(p1 >> 1);
  trivial = (p1 & 1u) != 0;
}

// rank(lo, c) and rank(hi + 1, c) of one LF step over the single-level rows
// (i1 = hi + 1), summed over the lane's kG threads: cb and ce, each the
// code's total count `total` where its position is n.  The threads load
// their parts of lo's row into a register array and of i1's row into w,
// which the caller may read further (the sampled seeding machine's
// per-step toehold takes BWT[hi] from it).
template <int SYMS>
__device__ __forceinline__ void rank_pair(const int4* __restrict__ fb, int n, int total, int lo,
                                          int i1, int c, int sub, unsigned pair,
                                          int4 (&w)[Layout<SYMS>::kPer], int& cb, int& ce) {
  using Lo = Layout<SYMS>;
  const bool has0 = lo < n, has1 = i1 < n;
  // both rows are loaded even when they are one: the second load then
  // finds the row in L1, and loading it once was measured no faster.
  // Where i1 == n, w takes v's parts, so ptxas copies v's registers into
  // w's before w's predicated load, which then waits for v's to land (the
  // count instance's machine code); rank_pair_toe, which has no such case,
  // ran 0.93x this step's time (PERF.md §6)
  const int r0 = lo >> Lo::kShift, r1 = i1 >> Lo::kShift;
  int4 v[Lo::kPer];
#pragma unroll
  for (int m = 0; m < Lo::kPer; ++m) {
    const int part = sub + m * kG;
    v[m] = has0 ? __ldg(fb + (size_t)r0 * Lo::kVec + part) : make_int4(0, 0, 0, 0);
    w[m] = has1 ? __ldg(fb + (size_t)r1 * Lo::kVec + part) : v[m];
  }
  int p0 = rank_share<SYMS>(v, sub, c, lo & (SYMS - 1));
  int p1 = rank_share<SYMS>(w, sub, c, i1 & (SYMS - 1));
  p0 += __shfl_xor_sync(pair, p0, 1);
  p1 += __shfl_xor_sync(pair, p1, 1);
  cb = has0 ? p0 : total;
  ce = has1 ? p1 : total;
}

// This thread's count of c among its symbols of a plane row below in-row
// offset `off`, from its plane parts v (Planes: its flat word j in v[j / 4]);
// m0..m2 all ones where bit 0..2 of c is 0.
template <int SYMS>
__device__ __forceinline__ int plane_count(const int4 (&v)[Planes<SYMS>::kPer], int sub,
                                           uint32_t m0, uint32_t m1, uint32_t m2, int off) {
  using P = Planes<SYMS>;
  auto word = [&](int j) { return (uint32_t)lane_of(v[j / 4], j % 4); };
  int count = 0;
#pragma unroll
  for (int w = 0; w < P::kW; ++w) {
    const uint32_t match = (word(w) ^ m0) & (word(P::kW + w) ^ m1) & (word(2 * P::kW + w) ^ m2);
    // the low min(max(kn, 0), 32) bits: the symbols of the word below off
    const int kn = off - 32 * (sub * P::kW + w);
    count += __popc(match & __funnelshift_lc(0xFFFFFFFFu, 0u, (unsigned)max(kn, 0)));
  }
  return count;
}

// base[row's superblock][c] of the two-level rows, through the read-only path.
__device__ __forceinline__ int64_t base_of(const Sup& sup, int row, int c) {
  const int s = (int)(((uint64_t)(uint32_t)row * sup.mul) >> sup.shift);
  return (int64_t)__ldg(reinterpret_cast<const long long*>(sup.base) + (size_t)s * kCkpt + c);
}

// rank(lo, c) and rank(i1, c) over the two-level plane rows (i1 = hi + 1),
// summed over the lane's kG threads, each completed by its superblock's
// base: cb and ce, the code's total count `total` where a position is n.
// Each thread loads its 16-byte part of the checkpoints and its kPer plane
// parts of a row, once where lo and hi + 1 share it; row ids and in-row
// offsets are ints.  Timed on an H100 in turns and dropped (PERF.md §6):
// the thread that holds checkpoint c loading its 4-byte word alone, which
// took 1.03-1.37x this design's time over the rows of an index above 2^31
// (0.94-0.98x over chr's 160 MB of rows), and, beside that design, both
// rows loaded always (1.00-1.02x).
template <int SYMS>
__device__ __forceinline__ void rank_pair_planes(const int4* __restrict__ fb, const Sup& sup,
                                                 int64_t n, int64_t total, int64_t lo,
                                                 int64_t i1, int c, int sub, unsigned pair,
                                                 int64_t& cb, int64_t& ce) {
  using P = Planes<SYMS>;
  const bool has0 = lo < n, has1 = i1 < n;
  const int r0 = (int)(lo >> P::kShift), r1 = (int)(i1 >> P::kShift);
  const bool one = r1 == r0;
  const int4* row0 = fb + (size_t)r0 * P::kVec;
  const int4* row1 = fb + (size_t)r1 * P::kVec;
  const bool mine = (c >> 2) == sub;  // this thread holds checkpoint c
  int4 v[P::kPer], w[P::kPer];
#pragma unroll
  for (int m = 0; m < P::kPer; ++m) {
    const int part = kG * (1 + m) + sub;
    v[m] = has0 ? __ldg(row0 + part) : make_int4(0, 0, 0, 0);
    w[m] = has1 && !one ? __ldg(row1 + part) : v[m];
  }
  const int4 ck0 = has0 ? __ldg(row0 + sub) : make_int4(0, 0, 0, 0);
  const int4 ck1 = has1 && !one ? __ldg(row1 + sub) : ck0;
  const int k0 = mine ? lane_of(ck0, c & 3) : 0;
  const int k1 = mine ? lane_of(ck1, c & 3) : 0;
  const uint32_t m0 = c & 1 ? 0u : ~0u, m1 = c & 2 ? 0u : ~0u, m2 = c & 4 ? 0u : ~0u;
  int p0 = k0 + plane_count<SYMS>(v, sub, m0, m1, m2, (int)(lo & (SYMS - 1)));
  int p1 = k1 + plane_count<SYMS>(w, sub, m0, m1, m2, (int)(i1 & (SYMS - 1)));
  p0 += __shfl_xor_sync(pair, p0, 1);
  p1 += __shfl_xor_sync(pair, p1, 1);
  cb = has0 ? base_of(sup, r0, c) + p0 : total;
  ce = has1 ? base_of(sup, r1, c) + p1 : total;
}

// The symbol at in-row offset `off` from this thread's parts of the row
// (part sub + m * kG in v[m]), or 0 where another thread of the lane holds
// its word: the kG shares sum to the symbol.
template <int SYMS>
__device__ __forceinline__ int sym_share(const int4 (&v)[Layout<SYMS>::kPer], int sub,
                                         int off) {
  int s = 0;
#pragma unroll
  for (int m = 0; m < Layout<SYMS>::kPer; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = 4 * (sub + m * kG) + e;
      if (lane == kCkpt + (off >> 3))
        s = (int)(((uint32_t)lane_of(v[m], e) >> (4 * (off & 7))) & 15u);
    }
  }
  return s;
}

// BWT[hi] over the single-level rows, summed over the lane's kG threads: the
// symbol before i1 = hi + 1 in i1's row (w, as rank_pair loaded it), unless
// i1 starts a row or equals n: then one word of hi's own row.
template <typename Lane, int SYMS>
__device__ __forceinline__ int bwt_at_hi(const int4* __restrict__ fb,
                                         const int4 (&w)[Layout<SYMS>::kPer], int sub,
                                         unsigned pair, Lane n, Lane hi) {
  using Lo = Layout<SYMS>;
  const Lane i1 = hi + 1;
  const int o1 = (int)(i1 & (SYMS - 1));
  int s = sym_share<SYMS>(w, sub, max(o1 - 1, 0));
  s += __shfl_xor_sync(pair, s, 1);
  if (i1 >= n || o1 == 0) {
    const uint32_t word = (uint32_t)__ldg(reinterpret_cast<const int32_t*>(fb) +
                                          (size_t)(hi >> Lo::kShift) * Lo::kRow + kCkpt +
                                          (int)((hi & (SYMS - 1)) >> 3));
    s = (int)((word >> (4 * (int)(hi & 7))) & 15u);
  }
  return s;
}

// One LF step of a lane by its kG threads: (lo, hi) becomes LF((lo, hi), c),
// or the empty range (1, 0) where that is empty or c lies outside [0, A)
// (a staged absent or other code); returns whether it is non-empty.  sF is
// F [A + 1] in shared memory.  Lane int32: the single-level rows; int64: the
// two-level plane rows with their superblocks `sup`.  TOE (single-level
// rows) also sets `trivial` to BWT[hi] == c for the pre-step hi.
template <typename Lane, int SYMS, bool TOE = false>
__device__ __forceinline__ bool lf_step_rows(const int4* __restrict__ fb, const Lane* sF,
                                             const Sup& sup, int A, Lane n, int sub,
                                             unsigned pair, int c, Lane& lo, Lane& hi,
                                             bool& trivial) {
  static_assert(!TOE || sizeof(Lane) == 4, "the per-step toehold is the single-level rows'");
  if (c >= A) {
    lo = 1;
    hi = 0;
    return false;
  }
  Lane cb, ce;
  if constexpr (sizeof(Lane) == 8) {
    rank_pair_planes<SYMS>(fb, sup, n, sF[c + 1] - sF[c], lo, hi + 1, c, sub, pair, cb, ce);
  } else {
    int4 w[Layout<SYMS>::kPer];
    rank_pair<SYMS>(fb, n, sF[c + 1] - sF[c], lo, hi + 1, c, sub, pair, w, cb, ce);
    if constexpr (TOE) trivial = bwt_at_hi<Lane, SYMS>(fb, w, sub, pair, n, hi) == c;
  }
  const Lane ci = ce - cb;
  if (ci <= 0) {
    lo = 1;
    hi = 0;
    return false;
  }
  lo = sF[c] + cb;
  hi = lo + ci - 1;
  return true;
}

}  // namespace
