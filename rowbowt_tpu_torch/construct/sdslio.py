"""Readers for the reference's sdsl-serialized index binaries.

The reference serializes its index components with sdsl-lite's binary streams:

  <prefix>.rbwt  ri::rle_string (rle_string.hpp:248-260): n, R, B (u64 each),
                 `runs` sparse_sd_vector, 256 per-letter sparse_sd_vectors,
                 `run_heads` sdsl::wt_huff<>
  <prefix>.tsa   ToeholdSA (toehold_sa.hpp:74-91): r, n (u64 each), `pred_`
                 sparse_sd_vector, `samples_last_` + `pred_to_run_`
                 sdsl::int_vector<>

This module parses those formats directly (no sdsl dependency) so prebuilt
reference indexes — including the committed fixtures tests/data/small.fa.{rbwt,
tsa} and tests/greedy_seeding/ref.fa.{rbwt,tsa} which ship with no raw source —
load straight into RbtIndex via construct.rawio.build_index_from_bwt.  The
port's copy of rowbowt_tpu/construct/sdslio.py, imports renamed.

sdsl layouts handled (reverse-engineered byte-exactly from the committed
fixtures; this is the older sdsl serialization the reference's submodule pin
uses — int_vector headers pack width and bit-size into ONE u64):
  int_vector<any w>    u64 header = (width << 56) | size_in_bits, then
                       ceil(bits/64) u64 data words, values LSB-first
  bit_vector           same, width == 1
  sd_vector<>          size u64, wl u8, low int_vector, high bit_vector,
                       two select_support_mcl (parsed and discarded; supports
                       are rebuilt dense on our side)
  select_support_mcl   arg_cnt u64; if nonzero: superblock int_vector,
                       mini_or_long bit_vector (empty when no long blocks),
                       then per superblock one int_vector (long or mini)
"""

from __future__ import annotations

import numpy as np


class _Cur:
    __slots__ = ("d", "o")

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u64(self) -> int:
        v = int(np.frombuffer(self.d, "<u8", 1, self.o)[0])
        self.o += 8
        return v

    def u8(self) -> int:
        v = self.d[self.o]
        self.o += 1
        return v

    def words(self, nbits: int) -> np.ndarray:
        nw = (nbits + 63) // 64
        w = np.frombuffer(self.d, "<u8", nw, self.o)
        self.o += nw * 8
        return w

    def raw_u64(self, count: int) -> np.ndarray:
        w = np.frombuffer(self.d, "<u8", count, self.o)
        self.o += count * 8
        return w

    @property
    def remaining(self) -> int:
        return len(self.d) - self.o


def _unpack(words: np.ndarray, width: int, nvals: int) -> np.ndarray:
    """Decode nvals width-bit little-endian packed ints into int64."""
    if nvals == 0:
        return np.empty(0, dtype=np.int64)
    if width == 64:
        return words[:nvals].astype(np.int64)
    bitpos = np.arange(nvals, dtype=np.int64) * width
    wi = bitpos >> 6
    off = (bitpos & 63).astype(np.uint64)
    lo = words[wi] >> off
    spill = (off.astype(np.int64) + width) > 64
    hi_shift = (np.uint64(64) - off) % np.uint64(64)  # off > 0 wherever spill
    hi = np.where(spill, words[np.minimum(wi + 1, len(words) - 1)] << hi_shift,
                  np.uint64(0))
    mask = np.uint64((1 << width) - 1)
    return ((lo | hi) & mask).astype(np.int64)


def _bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """bit_vector words -> uint8 0/1 array of length nbits."""
    if nbits == 0:
        return np.empty(0, dtype=np.uint8)
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:nbits]


_BITS56 = (1 << 56) - 1


def read_int_vector(cur: _Cur) -> np.ndarray:
    h = cur.u64()
    width = h >> 56
    nbits = h & _BITS56
    words = cur.words(nbits)
    return _unpack(words, width, nbits // width if width else 0)


def read_bit_vector_raw(cur: _Cur) -> tuple[int, np.ndarray]:
    h = cur.u64()
    if h >> 56 != 1:
        raise ValueError(f"bit_vector header width {h >> 56} != 1")
    nbits = h & _BITS56
    return nbits, cur.words(nbits)


def _skip_select_mcl(cur: _Cur) -> None:
    """Parse (and discard) a select_support_mcl<b> payload."""
    arg_cnt = cur.u64()
    if arg_cnt == 0:
        return
    read_int_vector(cur)  # m_superblock
    sb = (arg_cnt + 4095) >> 12
    read_bit_vector_raw(cur)  # mini_or_long flags (empty when no long blocks)
    for _ in range(sb):
        read_int_vector(cur)  # long superblock or miniblock, one per superblock


def read_sd_vector(cur: _Cur) -> tuple[int, np.ndarray]:
    """-> (universe size, sorted positions of set bits)."""
    m_size = cur.u64()
    wl = cur.u8()
    low = read_int_vector(cur)
    nb, hw = read_bit_vector_raw(cur)
    _skip_select_mcl(cur)  # high_1_select
    _skip_select_mcl(cur)  # high_0_select
    m = low.shape[0]
    ones = np.flatnonzero(_bits(hw, nb))
    if ones.shape[0] != m:  # catches both too-few AND too-many set high bits
        raise ValueError(f"sd_vector: {ones.shape[0]} high ones != {m} lows")
    upper = ones - np.arange(m, dtype=np.int64)
    return m_size, (upper << wl) | low


def read_sparse_sd_vector(cur: _Cur) -> tuple[int, np.ndarray]:
    """ri::sparse_sd_vector (sparse_sd_vector.hpp:182-200)."""
    u = cur.u64()
    if u == 0:
        return 0, np.empty(0, dtype=np.int64)
    m_size, pos = read_sd_vector(cur)
    if m_size != u:
        raise ValueError(f"sparse_sd_vector: u={u} != sd size={m_size}")
    return u, pos


_UNDEF16 = 0xFFFF


def read_wt_huff(cur: _Cur) -> np.ndarray:
    """Parse sdsl::wt_huff<> and decode the full stored byte sequence.

    Layout: m_size u64, m_sigma u64, m_tree bit_vector, rank_support_v basic
    blocks (one int_vector<64>), two select_support_mcl, node count u64, nodes
    (22 bytes each: tree_pos u64, tree_pos_rank u64, parent/child0/child1
    u16 with 0xFFFF = none), c_to_leaf u16[256], path u64[256].
    """
    m_size = cur.u64()
    sigma = cur.u64()
    nb, bw = read_bit_vector_raw(cur)
    read_int_vector(cur)  # rank_support_v basic blocks
    _skip_select_mcl(cur)
    _skip_select_mcl(cur)
    n_nodes = cur.u64()
    rec = np.frombuffer(cur.d, dtype=np.uint8, count=n_nodes * 22,
                        offset=cur.o).reshape(n_nodes, 22)
    cur.o += n_nodes * 22
    bv_pos = rec[:, 0:8].copy().view("<u8").reshape(n_nodes).astype(np.int64)
    kids = rec[:, 16:22].copy().view("<u2").reshape(n_nodes, 3)[:, 1:3]
    c_to_leaf = np.frombuffer(cur.d, dtype="<u2", count=256, offset=cur.o)
    cur.o += 512
    cur.o += 2048  # m_path (redundant with the node table for decoding)

    if m_size == 0:
        return np.empty(0, dtype=np.uint8)
    leaf_char = {int(c_to_leaf[c]): c for c in range(256)
                 if c_to_leaf[c] != _UNDEF16}
    out = np.empty(m_size, dtype=np.uint8)
    if sigma == 1:
        out[:] = next(iter(leaf_char.values()))
        return out
    bits = _bits(bw, nb)
    stack = [(0, np.arange(m_size, dtype=np.int64))]
    while stack:
        v, idxs = stack.pop()
        if v in leaf_char:
            out[idxs] = leaf_char[v]
            continue
        seg = bits[bv_pos[v]: bv_pos[v] + idxs.shape[0]]
        stack.append((int(kids[v, 0]), idxs[seg == 0]))
        stack.append((int(kids[v, 1]), idxs[seg == 1]))
    return out


def load_rbwt(path: str) -> np.ndarray:
    """Serialized ri::rle_string (.rbwt) -> full BWT bytes (terminator = 1).

    Layout per rle_string.hpp:248-260 / constructor :44-97: `runs` marks every
    B-th run boundary (ignored here), `runs_per_letter[c]` marks the END of
    each c-run in c-projected space (so per-letter gaps are the run lengths),
    `run_heads` is the R-char wt_huff of one head char per run.  The index build
    re-derives its own dense tables from the expanded BWT.
    """
    with open(path, "rb") as f:
        cur = _Cur(f.read())
    n = cur.u64()
    R = cur.u64()
    cur.u64()  # B (block sampling rate of `runs`; irrelevant to us)
    if n == 0:
        return np.empty(0, dtype=np.uint8)
    read_sparse_sd_vector(cur)  # `runs` (B-sampled boundaries; rebuilt densely)
    letter_ends = [read_sparse_sd_vector(cur)[1] for _ in range(256)]
    run_heads = read_wt_huff(cur)
    if cur.remaining:
        raise ValueError(f".rbwt: {cur.remaining} trailing bytes")
    if run_heads.shape[0] != R:
        raise ValueError(f".rbwt run_heads {run_heads.shape[0]} != R={R}")
    run_len = np.zeros(R, dtype=np.int64)
    for c in range(256):
        ends = letter_ends[c]
        if ends.shape[0] == 0:
            continue
        runs_c = np.flatnonzero(run_heads == c)
        if runs_c.shape[0] != ends.shape[0]:
            raise ValueError(f".rbwt: char {c}: {runs_c.shape[0]} runs vs "
                             f"{ends.shape[0]} per-letter run ends")
        run_len[runs_c] = np.diff(np.concatenate([[-1], ends]))
    if int(run_len.sum()) != n:
        raise ValueError(f".rbwt: run lengths sum {int(run_len.sum())} != n={n}")
    return np.repeat(run_heads, run_len)


def load_tsa(path: str, expect_n: int | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
    """Serialized ToeholdSA (.tsa) -> (ssa, esa) biased run-boundary samples.

    Returns the same convention as rawio.read_sa_samples: stored value =
    SA[boundary]-1 with 0 -> n-1, ssa[r]/esa[r] for run r's first/last row.
    """
    with open(path, "rb") as f:
        cur = _Cur(f.read())
    r = cur.u64()
    n = cur.u64()
    if expect_n is not None and n != expect_n:
        raise ValueError(f".tsa n={n} != expected {expect_n}")
    u, pred_pos = read_sparse_sd_vector(cur)
    samples_last = read_int_vector(cur)
    pred_to_run = read_int_vector(cur)
    if cur.remaining:
        raise ValueError(f".tsa: {cur.remaining} trailing bytes")
    if u != n or pred_pos.shape[0] != r or samples_last.shape[0] != r:
        raise ValueError(".tsa field size mismatch")
    ssa = np.empty(r, dtype=np.int64)
    ssa[pred_to_run] = pred_pos
    return ssa, samples_last.astype(np.int64)


# MarkerT bit layout, inferred from the committed fixture (the authoritative
# header, pfbwt-f marker_array.hpp, is an empty submodule): the golden marker
# at VCF POS 290 appears as 0x0000000000000121 (allele 0 = REF) and
# 0x1000000000000121 (allele 1 = ALT) -> position in the low bits, allele in
# the top nibble (bits 60-63).  The seq field (get_seq, rb_markers.cpp:229) is
# taken as bits 40-59; the single-sequence fixture cannot pin its exact width,
# so the split below is an assumption documented here and asserted in tests
# only through pos/allele.
_MAB_POS_BITS = 40
_MAB_SEQ_BITS = 20


def _decode_marker_t(m: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    pos = m & ((1 << _MAB_POS_BITS) - 1)
    seq = (m >> _MAB_POS_BITS) & ((1 << _MAB_SEQ_BITS) - 1)
    allele = (m >> 60) & 0xF
    return seq, pos, allele


def load_mab(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Serialized pfbwt-f MarkerArray (.mab) -> (ma_row, ma_val, wsize).

    The layout (reverse-engineered byte-exactly from the committed fixture
    tests/data/small.fa.mab; consumed by rb_build -m via rowbowt_io.hpp:60-63
    and queried by MarkerArray::at_range at rowbowt.hpp:282-290):

      sd_vector   range starts  s1[i]  (BWT rows, K set bits)
      sd_vector   range ends    s2[i]  (inclusive, K set bits)
      u64         K  (number of ranges == number of stored markers)
      u8          flag (1 in the fixture; meaning unknown, not needed)
      bit_vector  scaffolding (K bits)        } rank/select acceleration of the
      bit_vector  scaffolding (~1.7K bits)    } original; rebuilt dense here
      select_mcl  x2 (parsed and discarded)
      u64 count, count x u64   packed MarkerT values, one per range in order
      u32         marker window size w

    Query semantics: BWT row r carries marker i iff s1[i] <= r <= s2[i]
    (ranges in the fixture are disjoint; overlap is handled generically).
    Returns the expanded per-row CSR arrays in this repo's packing
    (index.pack_marker), row-major sorted like construct.build.
    """
    from rowbowt_tpu_torch.index import pack_marker

    with open(path, "rb") as f:
        cur = _Cur(f.read())
    u1, s1 = read_sd_vector(cur)
    u2, s2 = read_sd_vector(cur)
    k = cur.u64()
    cur.u8()  # flag
    read_bit_vector_raw(cur)
    read_bit_vector_raw(cur)
    _skip_select_mcl(cur)
    _skip_select_mcl(cur)
    cnt = cur.u64()
    vals = cur.raw_u64(cnt).astype(np.int64)
    if cur.remaining != 4:
        raise ValueError(f".mab: {cur.remaining} trailing bytes (expected u32 wsize)")
    wsize = int(np.frombuffer(cur.d, "<u4", 1, cur.o)[0])
    if not (s1.shape[0] == s2.shape[0] == k == cnt):
        raise ValueError(
            f".mab: inconsistent counts: starts={s1.shape[0]} ends={s2.shape[0]} "
            f"k={k} values={cnt}")
    if np.any(s2 < s1):
        raise ValueError(".mab: range end < start")
    seq, pos, allele = _decode_marker_t(vals)
    packed = np.array([pack_marker(s, p, a) for s, p, a in
                       zip(seq, pos, allele)], dtype=np.int64)
    lens = (s2 - s1 + 1).astype(np.int64)
    ma_row = np.repeat(s1, lens) + _concat_aranges(lens)
    ma_val = np.repeat(packed, lens)
    srt = np.lexsort((ma_val, ma_row))
    return ma_row[srt], ma_val[srt], wsize


def _concat_aranges(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]) ++ [0..lens[1]) ++ ... without a Python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lens)
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    out[ends[:-1]] = 1 - lens[:-1]
    return np.cumsum(out)


def load_serialized_index(prefix: str, ftab_k: int = 0, dense: bool = True,
                          with_sa: bool = True, with_docs: bool = True,
                          with_ma: bool = True):
    """RbtIndex from a reference-serialized index: <prefix>.rbwt [.tsa .docs].

    The load_rowbowt equivalent for rb_build outputs (rowbowt_io.hpp:176-189):
    prebuilt reference indexes — including fixtures committed without their
    raw inputs, like tests/greedy_seeding — load directly.
    """
    import os

    from rowbowt_tpu_torch.construct.rawio import build_index_from_bwt, read_docs

    bwt = load_rbwt(prefix + ".rbwt")
    ssa = esa = None
    if with_sa and os.path.exists(prefix + ".tsa"):
        ssa, esa = load_tsa(prefix + ".tsa", expect_n=bwt.shape[0])
    doc_names = doc_starts = None
    if with_docs and os.path.exists(prefix + ".docs"):
        doc_names, doc_starts = read_docs(prefix + ".docs")
    ma_row = ma_val = None
    ma_wsize = 10
    if with_ma and os.path.exists(prefix + ".mab"):
        ma_row, ma_val, ma_wsize = load_mab(prefix + ".mab")
    return build_index_from_bwt(
        bwt, ssa, esa, doc_names=doc_names, doc_starts=doc_starts,
        ma_row=ma_row, ma_val=ma_val, ma_wsize=ma_wsize,
        ftab_k=ftab_k, dense=dense,
    )
