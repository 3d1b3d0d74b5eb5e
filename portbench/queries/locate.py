"""rb_align -s with every occurrence (rbt_align -s, no --max-hits): each
batch's codes to the card, engine/locate.find_ranges_w_toehold, lo and hi
to the host, then cli/rbt_align.locate_hits unbounded (the walk, the flat
positions down, back up to resolve their documents, and down again), as
cli/rbt_align._query_loop calls them.  The index loads as the CLI loads it
for -s: SA samples and the document list, no markers."""

from __future__ import annotations

import numpy as np
import torch

from rowbowt_tpu_torch.cli.rbt_align import locate_hits
from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold

FLAGS = dict(sa=True, ma=False, dl=True)
CHECKS = ("count_wrong", "locs_wrong", "docs_wrong")  # each an exact comparison, limit 0
CONTROL_HITS = 16  # the control's cap on each read's occurrences (rbt_align --max-hits), under the documents


def run(tx, qc, lens, mark, max_hits=None):
    """One batch of the window: host arrays lo, hi, the flat positions, the
    offsets of each read's segment, and each position's document and offset
    in it."""
    with mark("h2d"):
        q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
    with mark("search"):
        lo, hi, k = find_ranges_w_toehold(tx, q, ln)
    nr = qc.shape[0]
    lo, hi = lo[:nr], hi[:nr]
    with mark("d2h"):
        lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
    with mark("locate"):
        flat, offs, docs, doff = locate_hits(tx, lo, hi, k[:nr], max_hits)
    return dict(lo=lo_h, hi=hi_h, flat=flat, offs=offs, docs=docs, doff=doff)


def control(tx, qc, lens, mark):
    """The control: the program's own bounded locate (--max-hits 64), which
    breaks the configuration's guarantee of every occurrence."""
    return run(tx, qc, lens, mark, max_hits=CONTROL_HITS)


def k1_record(tx) -> bool:
    """Whether the batch's K1 launch writes the step record: on an index
    without kval that keeps its toeholds by the search's trajectory (a big
    index)."""
    from rowbowt_tpu_torch.engine.seeds import _toehold_by_kval

    return _toehold_by_kval(tx, "locate") == "trajectory"


def collect(res, rows=None) -> dict:
    """The answers of `res` to check: each read's count, its occurrences'
    positions (segment j is pos[seg[j]:seg[j + 1]]), documents and offsets
    in the document (rows: the reads to take; all where None)."""
    lo, hi, offs = res["lo"], res["hi"], res["offs"]
    if rows is None:
        seg = offs - offs[0]
        take = slice(offs[0], offs[-1])
        pos, doc, doff = res["flat"][take], res["docs"][take], res["doff"][take]
    else:
        lo, hi = lo[rows], hi[rows]
        size = offs[rows + 1] - offs[rows]
        seg = np.zeros(rows.shape[0] + 1, dtype=np.int64)
        np.cumsum(size, out=seg[1:])
        idx = np.repeat(offs[rows] - seg[:-1], size) + np.arange(seg[-1])
        pos, doc, doff = res["flat"][idx], res["docs"][idx], res["doff"][idx]
    return dict(count=np.where(hi >= lo, hi - lo + 1, 0).astype(np.int64), seg=seg,
                pos=np.asarray(pos, dtype=np.int64), doc=np.asarray(doc, dtype=np.int64),
                doff=np.asarray(doff, dtype=np.int64))


def judge(panel, match, offs, reads, got) -> dict:
    """{check: bool [m]}: which of the reads `reads` each check finds wrong."""
    from portbench.reference import judge_counts, judge_locs

    locs, docs = judge_locs(panel, match, offs, reads, got["seg"], got["pos"], got["doc"],
                            got["doff"])
    return dict(count_wrong=judge_counts(match, reads, got["count"]), locs_wrong=locs,
                docs_wrong=docs)
