"""Positional marker index: the rle_window_arr / `.midx` equivalent.

The counterpart of rowbowt_tpu/midx.py.  The reference's rb_locs pipeline
(src/rb_markers_tsa.cpp:76-88) locates a read at text position l, then asks
a separate structure for the markers overlapping text span [l, l+readlen-1]
(pfbwt-f's rle_window_arr, built by build_midx from a text marker-position
file).  Here: sorted marker text positions + packed values, kept in numpy on
the host and queried on a torch device with searchsorted.

Text input format for rbt_midx (one marker site occurrence per line):
    <text_pos> <seq> <pos> <allele>
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rowbowt_tpu_torch.index import pack_marker


@dataclasses.dataclass
class PosMarkers:
    pos: np.ndarray  # int64[M] sorted text positions
    val: np.ndarray  # int64[M] packed markers (ties sorted by value)

    @staticmethod
    def from_pairs(positions, values) -> "PosMarkers":
        pos = np.asarray(positions, dtype=np.int64)
        val = np.asarray(values, dtype=np.int64)
        srt = np.lexsort((val, pos))
        return PosMarkers(pos[srt], val[srt])

    @staticmethod
    def from_panel(panel) -> "PosMarkers":
        return PosMarkers.from_pairs(
            [m.text_pos for m in panel.markers],
            [pack_marker(m.seq, m.pos, m.allele) for m in panel.markers],
        )

    @staticmethod
    def from_text_file(path: str) -> "PosMarkers":
        ps, vs = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                tpos, seq, pos, allele = (int(x) for x in parts[:4])
                ps.append(tpos)
                vs.append(pack_marker(seq, pos, allele))
        return PosMarkers.from_pairs(ps, vs)

    def at_range(self, l: int, r: int) -> np.ndarray:
        """Markers at text positions in [l, r] (rle_window_arr::at_range)."""
        s = int(np.searchsorted(self.pos, l, side="left"))
        e = int(np.searchsorted(self.pos, r + 1, side="left"))
        return self.val[s:e]

    def device(self, device):
        """(pos, val) as int64 tensors on `device` for at_ranges_batched."""
        return (torch.from_numpy(np.ascontiguousarray(self.pos)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.val)).to(device))

    def save(self, path: str) -> None:
        np.savez(path, pos=self.pos, val=self.val)

    @staticmethod
    def load(path: str) -> "PosMarkers":
        z = np.load(path)
        return PosMarkers(z["pos"], z["val"])


def at_ranges_batched(pos_dev, val_dev, l, r, max_k: int):
    """[N]-batched rle_window_arr::at_range: markers whose text position lies
    in [l[i], r[i]], two searchsorted + one bounded gather on the tensors'
    device (the per-read host loop of rb_markers_tsa.cpp:76-88).

    Returns (vals [N, max_k] packed int64, -1 pad; cnt [N] int64 true counts:
    cnt > max_k means truncation, the caller re-probes wider)."""
    N = l.shape[0]
    dev = pos_dev.device
    if pos_dev.shape[0] == 0:
        return (torch.full((N, max_k), -1, dtype=torch.int64, device=dev),
                torch.zeros(N, dtype=torch.int64, device=dev))
    s = torch.searchsorted(pos_dev, l.to(torch.int64), side="left")
    e = torch.searchsorted(pos_dev, r.to(torch.int64) + 1, side="left")
    cnt = e - s
    offs = torch.arange(max_k, dtype=torch.int64, device=dev)[None, :]
    idxs = torch.clamp(s[:, None] + offs, max=pos_dev.shape[0] - 1)
    vals = torch.where(offs < cnt[:, None], val_dev[idxs], -1)
    return vals, cnt
