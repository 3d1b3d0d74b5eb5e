"""Writers for the reference's sdsl-serialized index binaries — the write
side of construct/sdslio.py, closing the one-way interop asymmetry: an index
built HERE can now be emitted as <prefix>.rbwt/.tsa/.mab, the files
rbwt::construct_and_serialize_rowbowt produces (rowbowt_io.hpp:49-125) and
load_rowbowt consumes (rowbowt_io.hpp:176-189).

Primary data structures (int_vector, bit_vector, sd_vector, the wt_huff node
table + wavelet bits, the MarkerT values) are emitted byte-faithfully to the
layouts reverse-engineered in sdslio.py; tests roundtrip them through those
readers bit-exactly, and the writers reproduce the committed reference
fixtures' own structures when fed their decoded content.  Acceleration
payloads the readers skip (select_support_mcl bodies, rank_support_v basic
blocks, wt_huff paths, the .mab scaffolding bit vectors) are emitted
structurally valid with best-effort content; the reference binaries are
unbuildable in this environment (empty sdsl submodule), so those support
bytes cannot be validated against a living sdsl and real sdsl consumers may
need to rebuild supports (sdsl::util::init_support) after load.

The port's copy of rowbowt_tpu/construct/sdslwrite.py, imports renamed: its
files are byte-identical to the JAX writer's, except a .mab whose marker
ranges nest so that the JAX writer's file would not read back (write_mab).
"""

from __future__ import annotations

import io

import numpy as np

_BITS56 = (1 << 56) - 1


def _pack(vals: np.ndarray, width: int) -> np.ndarray:
    """width-bit little-endian packed ints -> u64 words (sdsl int_vector)."""
    vals = np.asarray(vals, dtype=np.uint64)
    n = vals.shape[0]
    nbits = n * width
    nw = (nbits + 63) // 64
    words = np.zeros(nw, dtype=np.uint64)
    if n == 0:
        return words
    if width == 64:
        words[:n] = vals
        return words
    mask = np.uint64((1 << width) - 1)
    v = vals & mask
    bitpos = np.arange(n, dtype=np.int64) * width
    wi = bitpos >> 6
    off = (bitpos & 63).astype(np.uint64)
    np.bitwise_or.at(words, wi, v << off)
    spill = (off.astype(np.int64) + width) > 64
    hs = (np.uint64(64) - off[spill])
    np.bitwise_or.at(words, wi[spill] + 1, v[spill] >> hs)
    return words


def write_int_vector(out, vals, width: int) -> None:
    vals = np.asarray(vals)
    nbits = vals.shape[0] * width
    out.write(np.uint64((width << 56) | nbits).tobytes())
    out.write(_pack(vals, width).tobytes())


def write_bit_vector(out, bits: np.ndarray) -> None:
    """bits: uint8 0/1 array."""
    bits = np.asarray(bits, dtype=np.uint8)
    nbits = bits.shape[0]
    out.write(np.uint64((1 << 56) | nbits).tobytes())
    words = np.packbits(bits, bitorder="little")
    pad = (-words.shape[0]) % 8
    if pad:
        words = np.concatenate([words, np.zeros(pad, dtype=np.uint8)])
    out.write(words.tobytes())


def _width_for(maxval: int) -> int:
    return max(1, int(maxval).bit_length())


def write_select_mcl(out, positions: np.ndarray) -> None:
    """select_support_mcl<b> payload: superblock directory + miniblocks.

    Structure per sdslio._skip_select_mcl's grammar: arg_cnt u64; if nonzero
    a superblock int_vector (position of every 4096th b-bit), an empty
    mini_or_long bit_vector (no long blocks — the committed fixtures' shape),
    then one miniblock int_vector per superblock (position of every 64th
    b-bit, absolute — best-effort content, see module docstring)."""
    positions = np.asarray(positions, dtype=np.int64)
    cnt = positions.shape[0]
    out.write(np.uint64(cnt).tobytes())
    if cnt == 0:
        return
    sb = (cnt + 4095) >> 12
    superblock = positions[::4096]
    w = _width_for(int(positions[-1]) if cnt else 1)
    write_int_vector(out, superblock, w)
    write_bit_vector(out, np.empty(0, dtype=np.uint8))  # no long blocks
    for s in range(sb):
        seg = positions[s * 4096:(s + 1) * 4096:64]
        write_int_vector(out, seg, w)


def write_sd_vector(out, size: int, positions: np.ndarray) -> None:
    """Elias-Fano sd_vector<> with its two select supports."""
    positions = np.asarray(positions, dtype=np.int64)
    m = positions.shape[0]
    out.write(np.uint64(size).tobytes())
    wl = max(1, (size // m).bit_length() - 1) if m else 1
    out.write(np.uint8(wl).tobytes())
    low = positions & ((1 << wl) - 1)
    upper = positions >> wl
    write_int_vector(out, low, wl)
    nb = m + (size >> wl) + 1
    high = np.zeros(nb, dtype=np.uint8)
    ones = upper + np.arange(m, dtype=np.int64)
    high[ones] = 1
    write_bit_vector(out, high)
    write_select_mcl(out, ones)                      # high_1_select
    write_select_mcl(out, np.flatnonzero(high == 0))  # high_0_select


def write_sparse_sd_vector(out, size: int, positions: np.ndarray) -> None:
    """ri::sparse_sd_vector (sparse_sd_vector.hpp:182-200)."""
    out.write(np.uint64(size).tobytes())
    if size == 0:
        return
    write_sd_vector(out, size, positions)


def _huffman_tree(freqs: dict[int, int]):
    """(nodes, c_to_leaf): nodes = [(parent, child0, child1, char|None)] with
    root 0; stable two-queue Huffman so the shape is deterministic."""
    import heapq

    items = sorted(freqs.items())
    if len(items) == 1:
        c = items[0][0]
        return [(0xFFFF, 0xFFFF, 0xFFFF, c)], {c: 0}
    heap = [(f, i, ("leaf", c)) for i, (c, f) in enumerate(items)]
    heapq.heapify(heap)
    uid = len(items)
    while len(heap) > 1:
        f0, _, t0 = heapq.heappop(heap)
        f1, _, t1 = heapq.heappop(heap)
        heapq.heappush(heap, (f0 + f1, uid, ("node", t0, t1)))
        uid += 1
    # BFS numbering from the root (sdsl uses its own order; any consistent
    # numbering roundtrips through the reader's node table)
    nodes = []
    c_to_leaf = {}
    queue = [(heap[0][2], 0xFFFF)]
    while queue:
        t, parent = queue.pop(0)
        v = len(nodes)
        if t[0] == "leaf":
            nodes.append([parent, 0xFFFF, 0xFFFF, t[1]])
            c_to_leaf[t[1]] = v
        else:
            nodes.append([parent, None, None, None])
            queue.append((t[1], v))
            queue.append((t[2], v))
    # fix child pointers (BFS appended children after parents)
    kids: dict[int, list[int]] = {}
    for v, (parent, *_rest) in enumerate(nodes):
        if parent != 0xFFFF:
            kids.setdefault(parent, []).append(v)
    for v, ch in kids.items():
        nodes[v][1], nodes[v][2] = ch[0], ch[1]
    return [tuple(x) for x in nodes], c_to_leaf


def write_wt_huff(out, seq: np.ndarray) -> None:
    """sdsl::wt_huff<> of a byte sequence, per sdslio.read_wt_huff's layout."""
    seq = np.asarray(seq, dtype=np.uint8)
    m = seq.shape[0]
    chars, cnts = np.unique(seq, return_counts=True)
    sigma = chars.shape[0]
    out.write(np.uint64(m).tobytes())
    out.write(np.uint64(sigma).tobytes())
    nodes, c_to_leaf = _huffman_tree(
        {int(c): int(f) for c, f in zip(chars, cnts)})
    # route the sequence: per internal node, the bit segment
    segs: dict[int, np.ndarray] = {}
    idxs_of = {0: np.arange(m, dtype=np.int64)}
    order = []  # internal nodes in numbering order
    for v, (parent, c0, c1, ch) in enumerate(nodes):
        if ch is not None:
            continue
        order.append(v)
    code_of_char = {}

    def walk(v, idxs):
        parent, c0, c1, ch = nodes[v]
        if ch is not None:
            return
        bit = np.zeros(idxs.shape[0], dtype=np.uint8)
        right = np.isin(seq[idxs], _leaf_chars(nodes, c1))
        bit[right] = 1
        segs[v] = bit
        walk(c0, idxs[~right])
        walk(c1, idxs[right])

    def _leaf_chars(nodes, v):
        stack, res = [v], []
        while stack:
            u = stack.pop()
            p, a, b, ch = nodes[u]
            if ch is not None:
                res.append(ch)
            else:
                stack.extend([a, b])
        return res

    if sigma > 1:
        walk(0, np.arange(m, dtype=np.int64))
    bv_pos = {}
    pos = 0
    for v in order:
        bv_pos[v] = pos
        pos += segs[v].shape[0] if v in segs else 0
    allbits = (np.concatenate([segs[v] for v in order])
               if order else np.empty(0, dtype=np.uint8))
    write_bit_vector(out, allbits)
    # rank_support_v basic blocks: int_vector<64>, 2 words per 512-bit
    # superblock [abs rank | packed in-superblock ranks] (best-effort content)
    nsb = (allbits.shape[0] + 511) >> 9
    bb = np.zeros(2 * nsb, dtype=np.uint64)
    csum = np.concatenate([[0], np.cumsum(allbits, dtype=np.uint64)])
    for s in range(nsb):
        bb[2 * s] = csum[min(s << 9, allbits.shape[0])]
    write_int_vector(out, bb, 64)
    write_select_mcl(out, np.flatnonzero(allbits == 1))
    write_select_mcl(out, np.flatnonzero(allbits == 0))
    # node table
    out.write(np.uint64(len(nodes)).tobytes())
    rec = np.zeros((len(nodes), 22), dtype=np.uint8)
    for v, (parent, c0, c1, ch) in enumerate(nodes):
        p = bv_pos.get(v, 0)
        rec[v, 0:8] = np.frombuffer(np.uint64(p).tobytes(), np.uint8)
        rank_at = int(csum[min(p, allbits.shape[0])])
        rec[v, 8:16] = np.frombuffer(np.uint64(rank_at).tobytes(), np.uint8)
        rec[v, 16:18] = np.frombuffer(np.uint16(parent).tobytes(), np.uint8)
        rec[v, 18:20] = np.frombuffer(np.uint16(c0).tobytes(), np.uint8)
        rec[v, 20:22] = np.frombuffer(np.uint16(c1).tobytes(), np.uint8)
    out.write(rec.tobytes())
    c2l = np.full(256, 0xFFFF, dtype=np.uint16)
    for c, v in c_to_leaf.items():
        c2l[c] = v
    out.write(c2l.tobytes())
    # m_path: (length << 56) | bits, best-effort (readers skip)
    path = np.zeros(256, dtype=np.uint64)
    for c, v in c_to_leaf.items():
        bits_, ln = 0, 0
        u = v
        while nodes[u][0] != 0xFFFF:
            p = nodes[u][0]
            bits_ |= (1 if nodes[p][2] == u else 0) << ln
            ln += 1
            u = p
        path[c] = (np.uint64(ln) << np.uint64(56)) | np.uint64(bits_)
    out.write(path.tobytes())


def write_rbwt(path: str, bwt: np.ndarray, B: int = 2) -> None:
    """ri::rle_string (.rbwt) per rle_string.hpp:248-260: n, R, B, `runs`
    (every B-th run end in text space), 256 per-letter run-end vectors in
    c-projected space, run_heads wt_huff."""
    bwt = np.asarray(bwt, dtype=np.uint8)
    n = bwt.shape[0]
    brk = np.flatnonzero(np.diff(bwt.astype(np.int16)) != 0) + 1
    run_start = np.concatenate(([0], brk))
    R = run_start.shape[0]
    run_end = np.concatenate((run_start[1:] - 1, [n - 1]))
    heads = bwt[run_start]
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        f.write(np.uint64(R).tobytes())
        f.write(np.uint64(B).tobytes())
        # `runs`: end of every B-th run (the B-block boundaries)
        sel = run_end[B - 1::B]
        write_sparse_sd_vector(f, n, sel)
        lens = (run_end - run_start + 1).astype(np.int64)
        for c in range(256):
            mask = heads == c
            if not mask.any():
                write_sparse_sd_vector(f, 0, np.empty(0, dtype=np.int64))
                continue
            ends_c = np.cumsum(lens[mask]) - 1
            write_sparse_sd_vector(f, int(ends_c[-1]) + 1, ends_c)
        write_wt_huff(f, heads)


def write_tsa(path: str, ssa: np.ndarray, esa: np.ndarray, n: int) -> None:
    """ToeholdSA (.tsa) per toehold_sa.hpp:74-91: r, n, pred_ sparse_sd over
    the biased run-start samples, samples_last_ and pred_to_run_ int_vectors.
    ssa/esa use the stored convention (value-1 with 0 -> n-1), as
    rawio.read_sa_samples/sdslio.load_tsa return them."""
    ssa = np.asarray(ssa, dtype=np.int64)
    esa = np.asarray(esa, dtype=np.int64)
    r = ssa.shape[0]
    order = np.argsort(ssa, kind="stable")
    with open(path, "wb") as f:
        f.write(np.uint64(r).tobytes())
        f.write(np.uint64(n).tobytes())
        write_sparse_sd_vector(f, n, ssa[order])
        w = _width_for(max(int(esa.max(initial=0)), 1))
        write_int_vector(f, esa, w)
        w2 = _width_for(max(r - 1, 1))
        write_int_vector(f, order, w2)


def write_mab(path: str, ma_row: np.ndarray, ma_val: np.ndarray,
              wsize: int, n: int) -> None:
    """pfbwt-f MarkerArray (.mab) per sdslio.load_mab's layout: row ranges
    (s1/s2 sd_vectors) with one packed MarkerT value each; our CSR compresses
    into maximal same-value row runs (overlapping values become overlapping
    ranges, which the reader handles generically).

    The reader pairs the i-th start with the i-th end, and an sd_vector's
    high part reads back in order only where the high bits of its positions
    do not decrease, so the ends, in the order of the sorted starts, must
    not fall into a lower bucket.  A range nested inside another (a later
    start, an earlier end) can break that: the JAX package's writer stores
    the ends as they are and its file reads back other ranges, or none.
    Here the ranges are then cut at every range boundary into pieces that
    never nest (_unnest), the same rows and values.  Otherwise the file is
    the JAX writer's, byte for byte."""
    from rowbowt_tpu_torch.index import marker_allele, marker_pos, marker_seq
    from rowbowt_tpu_torch.construct.sdslio import _MAB_POS_BITS

    ma_row = np.asarray(ma_row, dtype=np.int64)
    ma_val = np.asarray(ma_val, dtype=np.int64)
    s1l, s2l, vl = [], [], []
    # group by value; compress each value's sorted rows into runs
    order = np.lexsort((ma_row, ma_val))
    rows = ma_row[order]
    vals = ma_val[order]
    if rows.shape[0]:
        new = np.concatenate(
            ([True], (vals[1:] != vals[:-1]) | (rows[1:] != rows[:-1] + 1)))
        starts = np.flatnonzero(new)
        ends = np.concatenate((starts[1:] - 1, [rows.shape[0] - 1]))
        s1 = rows[starts]
        s2 = rows[ends]
        v = vals[starts]
        # MarkerT encode: pos low bits, seq middle, allele in bits 60-63
        mt = (marker_pos(v).astype(np.uint64)
              | (marker_seq(v).astype(np.uint64) << np.uint64(_MAB_POS_BITS))
              | (marker_allele(v).astype(np.uint64) << np.uint64(60)))
        # ranges must be sorted by start for the sd_vectors
        o2 = np.argsort(s1, kind="stable")
        s1l, s2l, vl = s1[o2], s2[o2], mt[o2]
        wl = max(1, (n // s2l.shape[0]).bit_length() - 1)  # write_sd_vector's low width
        if np.any(np.diff(s2l >> wl) < 0):
            s1l, s2l, vl = _unnest(s1l, s2l, vl)
    k = len(s1l)
    with open(path, "wb") as f:
        write_sd_vector(f, n, np.asarray(s1l, dtype=np.int64))
        write_sd_vector(f, n, np.asarray(s2l, dtype=np.int64))
        f.write(np.uint64(k).tobytes())
        f.write(np.uint8(1).tobytes())
        write_bit_vector(f, np.zeros(k, dtype=np.uint8))      # scaffolding
        write_bit_vector(f, np.zeros(2 * k, dtype=np.uint8))  # scaffolding
        write_select_mcl(f, np.empty(0, dtype=np.int64))
        write_select_mcl(f, np.empty(0, dtype=np.int64))
        f.write(np.uint64(k).tobytes())
        f.write(np.asarray(vl, dtype=np.uint64).tobytes())
        f.write(np.uint32(wsize).tobytes())


def _unnest(s1: np.ndarray, s2: np.ndarray, v: np.ndarray):
    """Ranges [s1, s2] with values v cut at every range boundary: each piece
    lies between two consecutive boundaries, so pieces sorted by start have
    ends sorted too.  Returns (starts, ends, values) sorted by start."""
    bounds = np.unique(np.concatenate((s1, s2 + 1)))
    first = np.searchsorted(bounds, s1)
    npieces = np.searchsorted(bounds, s2 + 1) - first
    owner = np.repeat(np.arange(s1.shape[0]), npieces)
    j = np.repeat(first - np.cumsum(npieces) + npieces, npieces) + np.arange(owner.shape[0])
    starts, ends = bounds[j], bounds[j + 1] - 1
    o = np.argsort(starts, kind="stable")
    return starts[o], ends[o], v[owner][o]


def save_reference_format(idx, prefix: str) -> list[str]:
    """Emit <prefix>.rbwt [.tsa] [.mab] [.docs] from an RbtIndex — the write
    side of rowbowt_io (construct_and_serialize_rowbowt, rowbowt_io.hpp:49-89).
    Returns the written paths."""
    run_len = np.diff(np.append(np.asarray(idx.run_start), idx.n))
    bwt_codes = np.repeat(np.asarray(idx.run_head).astype(np.uint8), run_len)
    bwt = idx.alpha.decode(bwt_codes.astype(np.int64))
    # the reference stores terminator byte 1 (rle_string.hpp:59-62) — our
    # canonical TERM is already 0x01, so bytes pass through
    paths = [prefix + ".rbwt"]
    write_rbwt(prefix + ".rbwt", bwt)
    if idx.samples_last is not None:
        # stored convention: value = SA-1 with 0 -> n-1 == our samples tables
        ssa = np.empty(idx.R, dtype=np.int64)
        ssa[np.asarray(idx.pred_to_run)] = np.asarray(idx.pred_pos)
        esa = np.asarray(idx.samples_last).astype(np.int64)
        write_tsa(prefix + ".tsa", ssa, esa, idx.n)
        paths.append(prefix + ".tsa")
    if idx.ma_row is not None:
        write_mab(prefix + ".mab", idx.ma_row, idx.ma_val, idx.ma_wsize,
                  idx.n)
        paths.append(prefix + ".mab")
    if idx.doc_names is not None:
        with open(prefix + ".docs", "w") as f:
            for name, pos in zip(idx.doc_names, idx.doc_starts):
                f.write(f"{name} {int(pos)}\n")
        paths.append(prefix + ".docs")
    return paths
