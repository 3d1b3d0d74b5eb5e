"""Pangenome panel records: the text, its documents and its variant markers.

Only the dataclasses that `construct.build` consumes; FASTA/VCF parsing
(`rowbowt_tpu.construct.panel.build_panel`) is not yet ported.  Layout per
DESIGN.md:

    text = ref_contigs ++ for each sample-haplotype: contigs-with-variants-applied,
    every document followed by w SEP bytes, single TERM byte at the very end.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
