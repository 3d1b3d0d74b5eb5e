"""The synthetic pangenome panel of a configuration, its reads and their codes.

A panel is a reference of uniform random bases and haplotypes drawn over
its SNP sites with the site density and the allele-frequency spectrum of
the 1000 Genomes Phase 3 panel: each site gets a frequency from the
configuration's spectrum, and each haplotype carries the site's
alternative base with that frequency.  The text is document 0 (the
reference), then each haplotype, each followed by `sep_len` SEP bytes, and
one final TERM: the layout of bench.py's panels and of
tools/build_giant_index.py, drawn from the configuration's own seed.  Reads
come from `--seed`: a document and an offset uniform over the panel, one
substitution at a uniform position in a `sub_rate` share of them
(bench.py:124-140).

This module imports nothing of the port: the plain reference works from
the same panel and reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# the text's separator and terminator bytes (rowbowt_tpu_torch/alphabet.py)
TERM_BYTE = 0x01
SEP_BYTE = 0x02


@dataclasses.dataclass
class Panel:
    ref: np.ndarray  # uint8 [ref_len]
    var_pos: np.ndarray  # int64 [S], sorted reference positions of the sites some haplotype carries
    var_alt: np.ndarray  # uint8 [S], each site's alternative base
    carry: np.ndarray  # bool [n_docs, S]: document d carries site s's alt (row 0, the reference, none)
    sep_len: int

    @property
    def n_docs(self) -> int:
        return int(self.carry.shape[0])

    @property
    def ref_len(self) -> int:
        return int(self.ref.shape[0])

    @property
    def doc_len(self) -> int:
        return self.ref_len + self.sep_len

    @property
    def n(self) -> int:
        return self.n_docs * self.doc_len + 1

    @property
    def doc_starts(self) -> np.ndarray:
        return np.arange(self.n_docs, dtype=np.int64) * self.doc_len

    @property
    def doc_names(self) -> list[str]:
        return ["ref"] + [f"hap{h}" for h in range(self.n_docs - 1)]

    def doc(self, d: int) -> np.ndarray:
        seq = self.ref.copy()
        c = self.carry[d]
        seq[self.var_pos[c]] = self.var_alt[c]
        return seq

    def parts(self):
        """Each document with its SEP run, the last one with the TERM byte
        too: the pieces of the text, one document in memory at a time."""
        sep = np.full(self.sep_len, SEP_BYTE, dtype=np.uint8)
        for d in range(self.n_docs):
            tail = [sep, np.array([TERM_BYTE], dtype=np.uint8)] if d == self.n_docs - 1 else [sep]
            yield np.concatenate([self.doc(d), *tail])

    def text(self) -> np.ndarray:
        return np.concatenate(list(self.parts()))

    def markers(self):
        """(text positions, packed values) of a marker at every site of
        every document: (seq 0 << 48) | (site << 8) | allele, the allele 1
        where the document carries the site's alt (index.pack_marker)."""
        site = np.broadcast_to(self.var_pos, self.carry.shape)
        tpos = (self.doc_starts[:, None] + site).ravel()
        packed = ((site.astype(np.int64) << 8) | self.carry.astype(np.int64)).ravel()
        return tpos, packed

    def windows(self, docs: np.ndarray, offs: np.ndarray, length: int) -> np.ndarray:
        """uint8 [N, length]: document docs[i]'s bases from offset offs[i],
        each window inside its document."""
        out = self.ref[offs[:, None] + np.arange(length)]
        for rows, ss, col in site_slots(self.var_pos, offs, length):
            c = self.carry[docs[rows], ss]
            out[rows[c], col[c]] = self.var_alt[ss[c]]
        return out


def site_slots(var_pos: np.ndarray, offs: np.ndarray, length: int):
    """Yield (rows, sites, columns) over the sites that lie in the windows
    [offs[i], offs[i] + length): the k-th site of each window that has k + 1
    or more, for k = 0, 1, ..."""
    s0 = np.searchsorted(var_pos, offs)
    s1 = np.searchsorted(var_pos, offs + length)
    for k in range(int((s1 - s0).max(initial=0))):
        rows = np.flatnonzero(s0 + k < s1)
        ss = s0[rows] + k
        yield rows, ss, var_pos[ss] - offs[rows]


def make_panel(cfg: dict) -> Panel:
    """The panel of configuration `cfg`, drawn from its panel_seed in this
    order: a reference of ref_len uniform bases; n_vars SNP sites placed
    uniformly, each with an alternative base uniform over the three that
    differ from its reference base; each site's allele frequency, a bin of
    the spectrum `af_bins` ([low, high, weight] each) chosen by weight, then
    log-uniform within it; then each of the n_haps haplotypes, carrying
    each site's alt with its frequency.  Sites that no haplotype carries
    are dropped, as a VCF of these haplotypes alone drops them."""
    rng = np.random.default_rng(cfg["panel_seed"])
    L, S = cfg["ref_len"], cfg["n_vars"]
    ref = rng.choice(ACGT, size=L)
    var_pos = np.sort(rng.choice(L, size=S, replace=False)).astype(np.int64)
    var_alt = ACGT[(np.searchsorted(ACGT, ref[var_pos]) + rng.integers(1, 4, size=S)) % 4]
    bins = np.asarray(cfg["af_bins"], dtype=np.float64)
    b = rng.choice(len(bins), size=S, p=bins[:, 2] / bins[:, 2].sum())
    lo, hi = np.log(bins[b, 0]), np.log(bins[b, 1])
    af = np.exp(lo + (hi - lo) * rng.random(S))
    carry = np.zeros((cfg["n_haps"] + 1, S), dtype=bool)
    for h in range(1, cfg["n_haps"] + 1):
        carry[h] = rng.random(S) < af
    keep = carry.any(axis=0)
    return Panel(ref=ref, var_pos=var_pos[keep], var_alt=var_alt[keep],
                 carry=np.ascontiguousarray(carry[:, keep]), sep_len=cfg["sep_len"])


@dataclasses.dataclass
class Reads:
    bases: np.ndarray  # uint8 [N, read_len]
    docs: np.ndarray  # int64 [N], the document each was drawn from
    offs: np.ndarray  # int64 [N], its offset there


def sample_reads(panel: Panel, rng, count: int, read_len: int, sub_rate: float) -> Reads:
    """`count` reads of read_len bases: a document and an offset uniform
    over the panel, then one substitution (a uniform base, which may be the
    one it replaces) at a uniform position in a sub_rate share of them."""
    docs = rng.integers(0, panel.n_docs, size=count)
    offs = rng.integers(0, panel.ref_len - read_len + 1, size=count)
    bases = panel.windows(docs, offs, read_len)
    mut = rng.random(count) < sub_rate
    mpos = rng.integers(0, read_len, size=count)
    mchar = rng.choice(ACGT, size=count)
    bases[np.flatnonzero(mut), mpos[mut]] = mchar[mut]
    return Reads(bases=bases, docs=docs, offs=offs)


def pow2_at_least(x: int, floor: int = 32) -> int:
    """The padded width of a batch whose longest read is x (the copy of
    cli/common.pow2_at_least)."""
    p = floor
    while p < x:
        p <<= 1
    return p


def encode(bases: np.ndarray, table: np.ndarray, width: int):
    """(codes int32 [N, width], lengths int32 [N]) of equal-length reads as
    cli/common.iter_query_batches yields them: each read's codes
    right-aligned, the columns before it -1."""
    N, L = bases.shape
    codes = np.full((N, width), -1, dtype=np.int32)
    codes[:, width - L:] = np.asarray(table)[bases]
    return codes, np.full(N, L, dtype=np.int32)
