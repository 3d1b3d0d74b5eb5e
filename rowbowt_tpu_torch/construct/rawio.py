"""Readers for the reference's raw pfbwt-f input formats + index assembly.

These are the files `rb_build` consumes (produced by pfbwt-f64 / vcf_to_bwt.py,
rowbowt:README.md:26-50):

  <prefix>.bwt   plain BWT bytes; byte 0 is the terminator, remapped to 1 like
                 rle_string's streaming ctor (rle_string.hpp:59-62)
  <prefix>.ssa   u64 pairs (idx, val): SA sample at each run START; stored
                 value = val-1 with 0 -> n-1 (toehold_sa.hpp:133-144)
  <prefix>.esa   u64 pairs likewise at each run END (toehold_sa.hpp:146-155)
  <prefix>.docs  text lines "name pos" (doclist.hpp:57-73)

build_index_from_raw() assembles a full RbtIndex from these without ever
seeing the text or a full suffix array — the toehold/phi tables come from the
run-boundary samples alone, exactly like ToeholdSA(n, r, ssa, esa).

The port's copy of rowbowt_tpu/construct/rawio.py, imports renamed: an index
assembled here equals the JAX package's, array for array.
"""

from __future__ import annotations

import os

import numpy as np

from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.construct.build import (
    FB_CKPT,
    OCC1_MAX_N,
    build_dense_tables,
    build_fblock,
    build_occ1,
    build_phi1,
    build_tk1_from_runs,
    build_toehold_tables,
    core_tables,
)
from rowbowt_tpu_torch.index import RbtIndex


def read_bwt(path: str) -> np.ndarray:
    """BWT bytes with the reference's 0 -> 1 terminator remap."""
    bwt = np.fromfile(path, dtype=np.uint8)
    bwt[bwt == 0] = 1
    return bwt


def read_sa_samples(path: str, n: int) -> np.ndarray:
    """Second u64 of each 16-byte record, biased: val-1 with 0 -> n-1."""
    raw = np.fromfile(path, dtype="<u8").reshape(-1, 2)
    vals = raw[:, 1].astype(np.int64)
    return np.where(vals == 0, n - 1, vals - 1)


def read_docs(path: str) -> tuple[list[str], np.ndarray]:
    names: list[str] = []
    starts: list[int] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            names.append(parts[0])
            starts.append(int(parts[1]))
    return names, np.asarray(starts, dtype=np.int64)


def write_raw(idx: RbtIndex, prefix: str) -> None:
    """Emit the reference raw formats from an RbtIndex (round-trip / interop).

    Inverts the readers: .bwt bytes (terminator byte written as 0), .ssa/.esa
    u64 pairs with the +1 bias (n-1 -> 0), .docs text.
    """
    n = idx.n
    R = idx.R
    run_len = np.diff(np.append(idx.run_start, n))
    bwt = np.repeat(idx.alpha.decode(idx.run_head.astype(np.int64)), run_len)
    out = bwt.copy()
    out[out == 1] = 0  # terminator byte back to pfbwt's 0
    out.tofile(prefix + ".bwt")
    if idx.samples_last is not None:
        sfirst = np.empty(R, dtype=np.int64)
        sfirst[idx.pred_to_run] = idx.pred_pos
        for vals, suffix in ((sfirst, ".ssa"), (idx.samples_last, ".esa")):
            y = np.where(vals == n - 1, 0, vals + 1).astype("<u8")
            rec = np.empty((R, 2), dtype="<u8")
            rec[:, 0] = np.arange(R, dtype=np.uint64)
            rec[:, 1] = y
            rec.tofile(prefix + suffix)
    if idx.doc_names is not None:
        with open(prefix + ".docs", "w") as f:
            for name, pos in zip(idx.doc_names, idx.doc_starts):
                f.write(f"{name} {int(pos)}\n")


_FTAB_LETTERS = b"ACGT"  # digit d of a kmer code <-> _FTAB_LETTERS[d]


def write_ftab_text(ftab: np.ndarray, k: int, path: str) -> None:
    """Emit the reference's text ftab: one "kmer s e" line per present entry
    (FTab::serialize, ftab.hpp:30-34).  Ascending kmer-code order equals the
    std::map's lexicographic order because A<C<G<T byte-order matches the
    big-endian 2-bit code order."""
    present = np.flatnonzero(ftab[:, 0] >= 0)
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    digits = (present[:, None].astype(np.int64) >> shifts) & 3
    kmers = np.frombuffer(_FTAB_LETTERS, dtype=np.uint8)[digits]
    with open(path, "w") as f:
        for row, code in enumerate(present):
            f.write(f"{kmers[row].tobytes().decode()} "
                    f"{int(ftab[code, 0])} {int(ftab[code, 1])}\n")


def read_ftab_text(path: str) -> tuple[np.ndarray, int]:
    """Parse the reference's text ftab (FTab::load, ftab.hpp:15-28) into the
    dense [4^k, 2] device table (absent kmers = -1).  k is inferred from the
    kmer strings, like the reference's `k = kmer.size()`."""
    code_of = np.full(256, -1, dtype=np.int64)
    for d, b in enumerate(_FTAB_LETTERS):
        code_of[b] = d
    k = None
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kmer, s, e = parts[0], int(parts[1]), int(parts[2])
            if k is None:
                k = len(kmer)
            elif len(kmer) != k:
                raise ValueError(f"inconsistent kmer length in {path}")
            digs = code_of[np.frombuffer(kmer.encode(), dtype=np.uint8)]
            if (digs < 0).any():
                raise ValueError(f"non-ACGT kmer {kmer!r} in {path}")
            code = 0
            for d in digs:
                code = code * 4 + int(d)
            entries.append((code, s, e))
    if k is None:
        raise ValueError(f"empty ftab file {path}")
    ftab = np.full((4 ** k, 2), -1, dtype=np.int64)
    for code, s, e in entries:
        ftab[code] = (s, e)
    return ftab, k


def build_index_from_bwt(
    bwt: np.ndarray,
    ssa: np.ndarray | None = None,
    esa: np.ndarray | None = None,
    doc_names: list[str] | None = None,
    doc_starts: np.ndarray | None = None,
    ma_row: np.ndarray | None = None,
    ma_val: np.ndarray | None = None,
    ma_wsize: int = 10,
    ftab_k: int = 0,
    dense: bool = True,
) -> RbtIndex:
    """RbtIndex from a BWT byte string + optional run-boundary SA samples.

    Equivalent of construct_and_serialize_rowbowt (rowbowt_io.hpp:49-89): the
    BWT itself provides runs/occ/F; .ssa/.esa provide locate support.
    """
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = int(bwt.shape[0])
    alpha = Alphabet.from_text(bwt)
    codes = alpha.encode(bwt).astype(np.int64)
    A = alpha.size
    run_start, run_head, occ, F, cruns_flat, cruns_off = core_tables(codes, A)
    R = run_start.shape[0]

    samples_last = pred_pos = pred_to_run = ltk = None
    if ssa is not None and esa is not None:
        if ssa.shape[0] != R or esa.shape[0] != R:
            raise ValueError(
                f".ssa/.esa sample counts ({ssa.shape[0]}/{esa.shape[0]}) "
                f"!= run count {R}"
            )
        samples_last = esa.astype(np.int64)
        pred_pos, pred_to_run, ltk = build_toehold_tables(
            run_head, samples_last, ssa.astype(np.int64), A
        )

    idx_dt = np.int32 if n < (1 << 31) - 2 else np.int64
    bwt4 = occ_blk = occ1 = tk1 = phi1 = fblock = None
    if dense and A <= 16:
        if A <= FB_CKPT and n < (1 << 31):
            fblock = build_fblock(codes, A)
        else:
            bwt4, occ_blk = build_dense_tables(codes, A)
        if n <= OCC1_MAX_N:
            occ1 = build_occ1(codes, A)
            if samples_last is not None:
                # tk1 is A*n — only worth it alongside occ1 (lf_step_w_loc_occ1
                # gathers occ1 rows); big-n raw builds use run-space ltk instead
                tk1 = build_tk1_from_runs(codes, run_start, samples_last, A,
                                          occ1.dtype)
        if samples_last is not None:
            phi1 = build_phi1(pred_pos, pred_to_run, samples_last, n, idx_dt)
    ma_start1 = None
    if ma_row is not None and dense and n < (1 << 31):
        ma_start1 = np.searchsorted(
            ma_row, np.arange(n + 1, dtype=np.int64), side="left"
        ).astype(np.int32 if ma_row.shape[0] < (1 << 31) else np.int64)

    idx = RbtIndex(
        n=n,
        alpha=alpha,
        run_start=run_start,
        run_head=run_head,
        occ=occ,
        F=F,
        cruns_flat=cruns_flat,
        cruns_off=cruns_off,
        samples_last=samples_last,
        pred_pos=pred_pos,
        pred_to_run=pred_to_run,
        ltk=ltk,
        ma_row=ma_row,
        ma_val=ma_val,
        ma_start1=ma_start1,
        ma_wsize=ma_wsize,
        doc_starts=doc_starts.astype(np.int64) if doc_starts is not None else None,
        doc_names=doc_names,
        bwt4=bwt4,
        occ_blk=occ_blk,
        occ1=occ1,
        tk1=tk1,
        phi1=phi1,
        fblock=fblock,
    )
    if ftab_k:
        from rowbowt_tpu_torch.engine.naive import build_ftab_dense

        idx.ftab = build_ftab_dense(idx, ftab_k)
        idx.ftab_k = ftab_k
    return idx


def build_index_from_raw(prefix: str, with_sa: bool = True, with_docs: bool = True,
                         with_ma: bool = True, ftab_k: int = 0,
                         dense: bool = True) -> RbtIndex:
    """rb_build's input contract: <prefix>.bwt [.ssa .esa] [.docs] [.mab].

    Markers load from a serialized <prefix>.mab when present (the reference's
    rb_build -m instead consumes the pfbwt-f intermediate <prefix>.ma, a format
    with no committed fixture anywhere in the reference; its serialized .mab
    output is what ships and what we parse, sdslio.load_mab)."""
    bwt = read_bwt(prefix + ".bwt")
    n = int(bwt.shape[0])
    ssa = esa = None
    if with_sa and os.path.exists(prefix + ".ssa"):
        ssa = read_sa_samples(prefix + ".ssa", n)
        esa = read_sa_samples(prefix + ".esa", n)
    doc_names = doc_starts = None
    if with_docs and os.path.exists(prefix + ".docs"):
        doc_names, doc_starts = read_docs(prefix + ".docs")
    ma_row = ma_val = None
    ma_wsize = 10
    if with_ma and os.path.exists(prefix + ".mab"):
        from rowbowt_tpu_torch.construct.sdslio import load_mab

        ma_row, ma_val, ma_wsize = load_mab(prefix + ".mab")
    # a reference-written text ftab takes precedence over rebuilding
    # (load_rowbowt's FT flag reads <prefix>.ftab, rowbowt_io.hpp:176-189)
    ftab = None
    if ftab_k and os.path.exists(prefix + ".ftab"):
        ftab, ftab_file_k = read_ftab_text(prefix + ".ftab")
        ftab_k = ftab_file_k
    idx = build_index_from_bwt(
        bwt, ssa, esa, doc_names=doc_names, doc_starts=doc_starts,
        ma_row=ma_row, ma_val=ma_val, ma_wsize=ma_wsize,
        ftab_k=0 if ftab is not None else ftab_k, dense=dense,
    )
    if ftab is not None:
        idx.ftab = ftab
        idx.ftab_k = ftab_k
    return idx
