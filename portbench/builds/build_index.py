"""A single-level index over the whole panel text, as rbt_build -s -m builds
it: the port's construct/build.build_index (SA-IS over the text, the run
tables, the fused-block rows and, as asked, the SA samples with kval and
phi1, the marker array and the document list)."""

from __future__ import annotations

import os


def build(panel, cfg: dict, flags: dict, out: str) -> dict:
    """Build the index of `panel` into directory `out` with what a query of
    `flags` (sa, ma, dl) reads; returns its n and R."""
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.construct.panel import Marker

    markers = None
    if flags["ma"]:
        tpos, packed = panel.markers()
        markers = [Marker(text_pos=t, seq=0, pos=(v >> 8) & 0xFFFFFFFFFF, allele=v & 0xFF)
                   for t, v in zip(tpos.tolist(), packed.tolist())]
    idx = build_index(panel.text(), markers=markers,
                      doc_starts=panel.doc_starts if flags["dl"] else None,
                      doc_names=panel.doc_names if flags["dl"] else None,
                      ma_wsize=cfg["ma_wsize"], with_sa_samples=flags["sa"], ftab_k=0)
    os.makedirs(out, exist_ok=True)
    idx.save(out)
    return dict(n=idx.n, R=idx.R)
