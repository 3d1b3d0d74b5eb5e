"""k1_roofline: the count search kernel's share, in percent, of its bound:
the bound of each profiled batch (bounds.k1_bound over the work of a
counting replay, bounds.k1_work) over the device time of its record of
lf_count_kernel or, on the two-level rows, lf_count2_kernel (with the step
record where the query keeps its toeholds by trajectory), both summed over
the profiled batches.  Nothing unless the profile holds one record a
batch."""

import torch

from portbench import bounds

NAMES = ("lf_count_kernel", "lf_count2_kernel")


def read(run):
    from rowbowt_tpu_torch.ops import cuda_lf

    prof = run.profile
    recs = prof.kernels(*NAMES)
    if len(recs) != prof.batches:
        return None
    tx = run.tx
    layout = cuda_lf.row_layout(tx)
    record = run.query.k1_record(tx)
    table = tx.arrays["fb2_base"].numel() * 8 if layout in bounds.TWO_LEVEL else 0
    work = run.memo.setdefault("k1_work", {})
    bound_us = 0.0
    for slot in run.slots:
        qc, lens = run.pool.batches[slot]
        if slot not in work:
            q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
            work[slot] = bounds.k1_work(tx, q, ln, layout)
        B, L = qc.shape
        bound_us += bounds.k1_bound(work[slot], B, L, tx.A, layout, table, record)["bound_us"]
    device_us = sum(e - s for _, s, e in recs)
    return 100.0 * bound_us / device_us
