"""rb_align's count query (rbt_align without -s or -m): each batch's codes to
the card, engine/count.find_ranges, then lo and hi to the host, as
cli/rbt_align._query_loop calls them.  The index loads as the CLI loads it
for these flags: no SA samples, no markers, no document list, no ftab."""

from __future__ import annotations

import numpy as np
import torch

from rowbowt_tpu_torch.engine.count import find_ranges

FLAGS = dict(sa=False, ma=False, dl=False)
CHECKS = ("count_wrong",)  # each an exact comparison, limit 0
CONTROL_LEN = 64  # the control searches each read's last 64 bases only


def run(tx, qc, lens, mark):
    """One batch of the window: host arrays lo and hi of every read."""
    with mark("h2d"):
        q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
    with mark("search"):
        lo, hi = find_ranges(tx, q, ln)
    with mark("d2h"):
        return dict(lo=lo.cpu().numpy(), hi=hi.cpu().numpy())


def control(tx, qc, lens, mark):
    """The control: the same path with each search cut short after its
    read's last CONTROL_LEN bases, a count that breaks the configuration's
    guarantee of a count over the whole read."""
    return run(tx, qc, np.minimum(lens, CONTROL_LEN).astype(np.int32), mark)


def k1_record(tx) -> bool:
    """Whether the batch's K1 launch writes the step record: never here."""
    return False


def collect(res, rows=None) -> dict:
    """The answers of `res` to check: each read's count from its range
    (rows: the reads to take; all where None)."""
    lo, hi = (res["lo"], res["hi"]) if rows is None else (res["lo"][rows], res["hi"][rows])
    return dict(count=np.where(hi >= lo, hi - lo + 1, 0).astype(np.int64))


def judge(panel, match, offs, reads, got) -> dict:
    """{check: bool [m]}: which of the reads `reads` each check finds wrong."""
    from portbench.reference import judge_counts

    return dict(count_wrong=judge_counts(match, reads, got["count"]))
