"""Alphabet handling: canonical text bytes <-> compact device codes.

The canonical text model (DESIGN.md) uses byte values:
  TERM = 0x01   (single terminator at end of text; the reference's pfbwt emits 0x00
                 which rle_string remaps to 1, rowbowt:include/rle_string.hpp:59-62)
  SEP  = 0x02   (w copies after every document)
  'A' < 'C' < 'G' < 'T' (and any other uppercase bytes for general texts)

On device the text alphabet is compacted to codes 0..A-1 in byte order, so the
terminator is code 0 and compares smallest — the same total order the reference's
suffix array uses. Queries map through the same table; bytes absent from the index
map to -1 which makes every LF step produce the empty range (reference behavior:
rank of a char with no runs is 0 -> empty, rle_string.hpp:134).
"""

from __future__ import annotations

import dataclasses

import numpy as np

TERM_BYTE = 0x01
SEP_BYTE = 0x02

# N-normalization used by rb_markers (seq_ntoa_table, rowbowt:src/
# rb_markers.cpp:139-156): a/A->A c/C->C g/G->G t/T->T, n/N->A (matching
# pfbwt's --non-acgt-to-a index text), every other byte -> 'N'.
_NTOA = np.full(256, ord("N"), dtype=np.uint8)
for _b, _v in [
    (ord("a"), "A"), (ord("A"), "A"),
    (ord("c"), "C"), (ord("C"), "C"),
    (ord("g"), "G"), (ord("G"), "G"),
    (ord("t"), "T"), (ord("T"), "T"),
    (ord("n"), "A"), (ord("N"), "A"),
]:
    _NTOA[_b] = ord(_v)

# reverse-complement table over bytes (seqtk comp_tab semantics for ACGT + N)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
               ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a"),
               ("N", "N"), ("n", "n"), ("U", "A"), ("u", "a")]:
    _COMP[ord(_a)] = ord(_b)


def normalize_read(b: bytes | np.ndarray) -> np.ndarray:
    """seqtk-style normalization applied to reads before querying (rb_markers.cpp:396-398)."""
    arr = np.frombuffer(b, dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else b
    return _NTOA[arr]


def revcomp(b: bytes | np.ndarray) -> np.ndarray:
    arr = np.frombuffer(b, dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else b
    return _COMP[arr][::-1].copy()


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """Compact alphabet of an index: sorted unique byte values of the text."""

    bytes_: np.ndarray  # uint8[A], sorted ascending

    @staticmethod
    def from_text(text: np.ndarray) -> "Alphabet":
        return Alphabet(np.unique(text).astype(np.uint8))

    @property
    def size(self) -> int:
        return int(self.bytes_.shape[0])

    def encode_table(self) -> np.ndarray:
        """int16[256]: byte -> code, or -1 if byte not in alphabet."""
        tab = np.full(256, -1, dtype=np.int16)
        tab[self.bytes_.astype(np.int64)] = np.arange(self.size, dtype=np.int16)
        return tab

    def encode(self, data: np.ndarray) -> np.ndarray:
        """uint8 bytes -> int16 codes (-1 for absent bytes)."""
        return self.encode_table()[data.astype(np.int64)]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.bytes_[codes]
