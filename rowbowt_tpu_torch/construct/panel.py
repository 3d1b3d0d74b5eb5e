"""FASTA + VCF -> pangenome panel text, document list, and variant markers.

Replaces the reference's out-of-repo construction front end (pfbwt-f's
`vcf_to_bwt.py`, see rowbowt:README.md:37-44 and
rowbowt:scripts/vcf_to_rowbowt.sh).  The port's copy of
rowbowt_tpu/construct/panel.py, imports renamed.  Layout per DESIGN.md:

    text = ref_contigs ++ for each sample-haplotype: contigs-with-variants-applied,
    every document followed by w SEP bytes, single TERM byte at the very end.

Markers: every document (including the reference itself) carries one marker per
variant site it spans: (seq = contig id, pos = 0-based reference POS, allele =
the allele this document carries at the site).  Verified against the golden
marker expectations in rowbowt:tests/rb_tests.cpp:123-141 (e.g. VCF row
`ref 290 var0 C A GT 1|0` -> marker pos 289 allele 1 on hap0, allele 0 on the
reference document and hap1).
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterable, Sequence

import numpy as np

from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE


@dataclasses.dataclass
class Variant:
    contig: str
    pos0: int  # 0-based reference position of the first REF base
    ref: str
    alts: tuple[str, ...]  # alt alleles; allele index a>=1 selects alts[a-1]
    genotypes: dict[str, tuple[int, ...]]  # sample -> per-haplotype allele index

    def allele_seq(self, a: int) -> str:
        return self.ref if a == 0 else self.alts[a - 1]


@dataclasses.dataclass
class Marker:
    """A variant marker attached to one text position of the panel."""

    text_pos: int  # position of the variant's first base in the concatenated text
    seq: int  # contig id
    pos: int  # 0-based position on the *reference* contig
    allele: int  # allele index carried by this document at the site


@dataclasses.dataclass
class Panel:
    text: np.ndarray  # uint8[n], includes SEP pads and final TERM
    doc_names: list[str]
    doc_starts: np.ndarray  # int64[D]
    markers: list[Marker]
    wsize: int


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def parse_fasta(path: str) -> list[tuple[str, str]]:
    seqs: list[tuple[str, list[str]]] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                seqs.append((line[1:].split()[0], []))
            else:
                seqs[-1][1].append(line.upper())
    return [(name, "".join(parts)) for name, parts in seqs]


def parse_vcf(path: str, samples: Sequence[str] | None = None) -> tuple[list[Variant], list[str]]:
    """Parse a (gzipped) VCF with phased GTs.  Returns (variants, sample_names)."""
    variants: list[Variant] = []
    all_samples: list[str] = []
    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                all_samples = cols[9:]
                continue
            cols = line.rstrip("\n").split("\t")
            contig, pos1, _vid, ref, alt = cols[0], cols[1], cols[2], cols[3], cols[4]
            if alt in (".", ""):
                continue
            fmt = cols[8].split(":") if len(cols) > 8 else []
            gt_idx = fmt.index("GT") if "GT" in fmt else 0
            genos: dict[str, tuple[int, ...]] = {}
            for sname, field in zip(all_samples, cols[9:]):
                gt = field.split(":")[gt_idx]
                alleles = tuple(
                    0 if a in (".", "") else int(a)
                    for a in gt.replace("/", "|").split("|")
                )
                genos[sname] = alleles
            variants.append(
                Variant(
                    contig=contig,
                    pos0=int(pos1) - 1,
                    ref=ref,
                    alts=tuple(alt.split(",")),
                    genotypes=genos,
                )
            )
    if samples is not None:
        keep = set(samples)
        kept_samples = [s for s in all_samples if s in keep]
    else:
        kept_samples = all_samples
    return variants, kept_samples


def _apply_variants(
    ref_seq: str, variants: list[Variant], hap: Iterable[int]
) -> tuple[str, list[tuple[int, int, int]]]:
    """Apply per-haplotype alleles to one contig.

    Returns (haplotype sequence, [(hap_pos, ref_pos, allele)]) where hap_pos is the
    0-based position of the variant's first base in the haplotype sequence (handles
    indel coordinate shifts).
    """
    pieces: list[str] = []
    sites: list[tuple[int, int, int]] = []
    cur = 0  # cursor on reference
    out_len = 0
    for v, a in zip(variants, hap):
        if v.pos0 < cur:
            # overlapping variant (after an indel consumed past it): skip, like
            # standard consensus tools do.
            continue
        pieces.append(ref_seq[cur : v.pos0])
        out_len += v.pos0 - cur
        allele_seq = v.allele_seq(a)
        sites.append((out_len, v.pos0, a))
        pieces.append(allele_seq)
        out_len += len(allele_seq)
        cur = v.pos0 + len(v.ref)
    pieces.append(ref_seq[cur:])
    return "".join(pieces), sites


def build_panel(
    fasta_path: str,
    vcf_path: str | None = None,
    samples: Sequence[str] | None = None,
    wsize: int = 10,
    include_ref: bool = True,
) -> Panel:
    """Build the canonical panel text (see DESIGN.md) from FASTA (+ optional VCF)."""
    contigs = parse_fasta(fasta_path)
    contig_ids = {name: i for i, (name, _) in enumerate(contigs)}

    variants: list[Variant] = []
    sample_names: list[str] = []
    if vcf_path is not None:
        variants, sample_names = parse_vcf(vcf_path, samples)
        variants.sort(key=lambda v: (contig_ids.get(v.contig, 1 << 60), v.pos0))

    by_contig: dict[str, list[Variant]] = {name: [] for name, _ in contigs}
    for v in variants:
        if v.contig in by_contig:
            by_contig[v.contig].append(v)

    chunks: list[np.ndarray] = []
    doc_names: list[str] = []
    doc_starts: list[int] = []
    markers: list[Marker] = []
    pos = 0
    sep = np.full(wsize, SEP_BYTE, dtype=np.uint8)

    def add_doc(name: str, seq: str, sites: list[tuple[int, int, int]], contig: str):
        nonlocal pos
        doc_names.append(name)
        doc_starts.append(pos)
        arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        chunks.append(arr)
        cid = contig_ids[contig]
        for hap_pos, ref_pos, allele in sites:
            markers.append(Marker(text_pos=pos + hap_pos, seq=cid, pos=ref_pos, allele=allele))
        pos += len(arr)
        chunks.append(sep)
        pos += wsize

    if include_ref:
        for name, seq in contigs:
            sites = [(v.pos0, v.pos0, 0) for v in by_contig[name]]
            add_doc(name, seq, sites, name)

    n_haps = max((len(v.genotypes.get(s, ())) for v in variants for s in sample_names), default=0)
    for sname in sample_names:
        for h in range(n_haps):
            for cname, cseq in contigs:
                vs = by_contig[cname]
                hap_alleles = [
                    (v.genotypes.get(sname, (0,) * n_haps)[h] if h < len(v.genotypes.get(sname, ())) else 0)
                    for v in vs
                ]
                hseq, sites = _apply_variants(cseq, vs, hap_alleles)
                add_doc(f"{cname}_{sname}_{h}", hseq, sites, cname)

    chunks.append(np.array([TERM_BYTE], dtype=np.uint8))
    text = np.concatenate(chunks)
    return Panel(
        text=text,
        doc_names=doc_names,
        doc_starts=np.asarray(doc_starts, dtype=np.int64),
        markers=markers,
        wsize=wsize,
    )
