"""Host-side marker-seed assembly, filters and output formatting.

Mirrors rb_markers' MarkerSeed / SeedVec pipeline exactly
(rowbowt src/rb_markers.cpp:228-315, out_fn :365-382 / :440-463):
the device kernels (engine.seeds) return raw per-seed marker buffers; this
module applies the reference's sort/unique, the min_range gate, the optional
heuristic filters, and prints MarkerSeed::print_buf lines.

uint64 wrap quirks preserved: query_len = qend-qstart+1 and range_size =
hi-lo+1 are computed mod 2^64 like the reference's size_t arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rowbowt_tpu_torch.index import marker_allele, marker_pos, marker_seq

_U64 = 1 << 64


def _u64(x: int) -> int:
    return int(x) % _U64


@dataclasses.dataclass
class MarkerSeed:
    """rb_markers.cpp:243-285."""

    name: str
    strand: str  # "+" or "-"
    range_size: int
    query_start: int
    query_len: int
    markers: list[int]

    def print_buf(self) -> str:
        parts = [self.name, str(self.range_size), self.strand,
                 str(self.query_start), str(self.query_len)]
        if self.markers:
            parts += [
                f"{int(marker_seq(np.int64(m)))}/{int(marker_pos(np.int64(m)))}/"
                f"{int(marker_allele(np.int64(m)))}"
                for m in self.markers
            ]
        else:
            parts.append(".")
        return " ".join(parts)

    def filter_identical_pos(self) -> None:
        """Remove markers sharing (seq, pos) with another marker — BOTH copies
        go (rb_markers.cpp:264-275 look-ahead/look-behind erase)."""
        if not self.markers:
            return
        keys = [(int(marker_seq(np.int64(m))), int(marker_pos(np.int64(m))))
                for m in self.markers]
        out = []
        for i, m in enumerate(self.markers):
            dup = (i > 0 and keys[i - 1] == keys[i]) or (
                i + 1 < len(keys) and keys[i + 1] == keys[i])
            if not dup:
                out.append(m)
        self.markers = out

    def clear_if_conflicting(self, read_len: int) -> None:
        """Markers spanning different contigs or >= read_len apart can't come
        from one alignment: drop them all (rb_markers.cpp:278-284)."""
        if not self.markers:
            return
        first, last = np.int64(self.markers[0]), np.int64(self.markers[-1])
        if int(marker_seq(last)) != int(marker_seq(first)) or (
                int(marker_pos(last)) - int(marker_pos(first)) >= read_len):
            self.markers = []


def assemble_seeds(
    name: str,
    strand: str,
    read_len: int,
    slo, shi, sqs, sqe, mvals, mcnt, nseeds,
    min_range: int = 0,
    max_k: int | None = None,
) -> list[MarkerSeed]:
    """out_fn for one lane (rb_markers.cpp:365-382): build MarkerSeeds from the
    kernel's per-seed arrays, applying the empty-range drop, strand-dependent
    query_start flip, min_range gate and sort+unique."""
    out: list[MarkerSeed] = []
    S = slo.shape[0]
    K = mvals.shape[1] if max_k is None else max_k
    for s in range(min(int(nseeds), S)):
        lo, hi = int(slo[s]), int(shi[s])
        if hi < lo:
            continue
        qs, qe = int(sqs[s]), _u64(int(sqe[s]))
        query_start = read_len - qs - 1 if strand == "-" else qs
        query_len = _u64(qe - qs + 1)
        range_size = _u64(hi - lo + 1)
        markers: list[int] = []
        if range_size >= min_range and int(mcnt[s]) > 0:
            markers = sorted(
                int(v) for v in mvals[s, : min(int(mcnt[s]), K)] if v != -1
            )
            # std::unique after marker_cmp sort == numeric dedup (pack order
            # makes numeric order the marker_cmp order, index.pack_marker)
            markers = sorted(set(markers))
        out.append(MarkerSeed(name, strand, range_size, query_start,
                              query_len, markers))
    return out


def heuristic_stop(ms: MarkerSeed, read_len: int, min_seed_len: int) -> bool:
    """Early stop: not enough sequence left on the other strand
    (rb_markers.cpp:460-463)."""
    return read_len - (ms.query_start + ms.query_len) < min_seed_len


def keep_seeds_best_strand(seeds: list[MarkerSeed]) -> list[MarkerSeed]:
    """SeedVec::keep_seeds_best_strand (rb_markers.cpp:291-296): keep the
    strand owning the longest seed (max_element: first max wins)."""
    if not seeds:
        return seeds
    best = max(seeds, key=lambda s: s.query_len)  # ties -> earliest
    return [s for s in seeds if s.strand == best.strand]


def keep_seeds_by_len(seeds: list[MarkerSeed], min_len: int) -> list[MarkerSeed]:
    return [s for s in seeds if s.query_len >= min_len]
