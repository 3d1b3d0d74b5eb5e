"""The plain reference that decides `correct`: which documents each read
occurs in, from the panel and the reads alone.

A read drawn from document d at offset q occurs in document d' at q iff it
equals d''s bases there: the reference's bases wherever no site lies, and at
each site the alt where d' carries it, else the reference base.  So the
occurrences follow from the panel's carry matrix (the analytic oracle of
tools/build_giant_index.py, extended to reads with a substitution).  An
occurrence at another offset would be a repeat of a 100-base window of a
uniform random reference, up to the few sites in it: at these sizes its
chance is below 1e-40, and the reference takes it to be none.  Positions
are text positions: document d' starts at d' * doc_len.

Imports numpy alone: nothing of the port and nothing of jax.
"""

from __future__ import annotations

import numpy as np

from portbench.panel import Panel, site_slots

BLOCK = 1 << 16  # reads matched at a time


def doc_matches(panel: Panel, bases: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """bool [N, n_docs]: read i equals document d''s window at offs[i]."""
    N, L = bases.shape
    out = np.empty((N, panel.n_docs), dtype=bool)
    for b0 in range(0, N, BLOCK):
        rd, off = bases[b0:b0 + BLOCK], offs[b0:b0 + BLOCK]
        differ = rd != panel.ref[off[:, None] + np.arange(L)]
        slots = list(site_slots(panel.var_pos, off, L))
        for rows, _, col in slots:
            differ[rows, col] = False  # a site is judged per document below
        m = np.repeat(~differ.any(axis=1)[:, None], panel.n_docs, axis=1)
        for rows, ss, col in slots:
            want = np.where(panel.carry[:, ss].T, panel.var_alt[ss][:, None],
                            panel.ref[panel.var_pos[ss]][:, None])  # [rows, n_docs]
            m[rows] &= want == rd[rows, col][:, None]
        out[b0:b0 + BLOCK] = m
    return out


def judge_counts(match: np.ndarray, reads: np.ndarray, count: np.ndarray) -> np.ndarray:
    """bool [m]: the count the program gave read reads[j] (count[j]) is not
    the number of its occurrences."""
    return count != match[reads].sum(axis=1)


def judge_locs(panel: Panel, match: np.ndarray, offs: np.ndarray, reads: np.ndarray,
               seg: np.ndarray, pos: np.ndarray, doc: np.ndarray, doff: np.ndarray):
    """(locs_wrong, docs_wrong), bool [m] each, for the occurrences the
    program gave read reads[j]: pos[seg[j]:seg[j + 1]], with their documents
    doc and offsets in the document doff.  locs_wrong: the positions are not
    exactly the read's occurrences, each once (in any order); docs_wrong: a
    position's document or offset is not the one its text position lies
    in."""
    m = reads.shape[0]
    nd = panel.n_docs
    size = np.diff(seg)
    lane = np.repeat(np.arange(m), size)
    d, o = np.divmod(pos, panel.doc_len)  # document d' starts at d' * doc_len
    dc = np.clip(d, 0, nd - 1)
    r = reads[lane]
    good = (d == dc) & (o == offs[r]) & match[r, dc]
    # each read's good occurrences by document, the rest in a last bin
    key = np.where(good, lane * nd + dc, m * nd)
    per_doc = np.bincount(key, minlength=m * nd + 1)[:-1].reshape(m, nd)
    want = match[reads].sum(axis=1)
    locs_wrong = (size != want) | (per_doc.sum(axis=1) != size) | ((per_doc > 0).sum(axis=1) != want)
    docs_wrong = np.bincount(lane[(doc != d) | (doff != o)], minlength=m) > 0
    return locs_wrong, docs_wrong
