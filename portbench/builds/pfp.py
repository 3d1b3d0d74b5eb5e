"""A two-level BigIndex of the panel by prefix-free parsing, as
tools/build_giant_index.py builds it: the documents streamed to the port's
construct/pfp.pfp_construct, assemble_bigindex over rows of `row_syms`
symbols, attach_markers_from_probes, the document list, and the phi pack
the loader would otherwise derive on first use."""

from __future__ import annotations

import numpy as np


def build(panel, cfg: dict, flags: dict, out: str) -> dict:
    """Build the index of `panel` into directory `out` with what a query of
    `flags` (sa, ma, dl) reads; returns its n and R."""
    from rowbowt_tpu_torch.alphabet import Alphabet
    from rowbowt_tpu_torch.construct import pfp

    from portbench.panel import SEP_BYTE, TERM_BYTE

    w = cfg["ma_wsize"]
    probes = None
    if flags["ma"]:
        tpos, packed = panel.markers()
        probes = pfp.marker_window_positions(tpos, w)
    res = pfp.pfp_construct(panel.parts(), w=w, p=cfg["pfp_p"], probe_pos=probes)
    alpha = Alphabet(np.unique(np.concatenate(
        [np.unique(panel.ref), np.unique(panel.var_alt),
         np.array([SEP_BYTE, TERM_BYTE], dtype=np.uint8)])))
    big = pfp.assemble_bigindex(res, alpha, block=cfg["row_syms"])
    if flags["ma"]:
        pfp.attach_markers_from_probes(big, res, tpos, packed, w)
    if flags["dl"]:
        big.doc_starts = panel.doc_starts
        big.doc_names = panel.doc_names
    if not flags["sa"]:
        for k in ("run_start", "run_head", "samples_last", "pred_pos", "phi_at", "cruns_keys"):
            setattr(big, k, None)
    R = int(res.R)
    del res
    big.save(out)
    if flags["sa"]:
        big.prefix = out
        big._phi_pack()
    return dict(n=big.n, R=R)
