"""walk_roofline: the locate walk kernel's share, in percent, of its
bound: the bound of each profiled batch (bounds.walk_bound over the
positions the batch located, with the tables of the walk's route) over the
device time of its record of phi_walk_kernel or kval_walk_kernel, both
summed over the profiled batches.  Nothing unless the profile holds one
record a batch.  The profiled batches cycle over a few pool slots, whose
answers repeat, so each slot's bound is worked out once."""

import numpy as np

from portbench import bounds

NAMES = ("phi_walk_kernel", "kval_walk_kernel")


def read(run):
    from rowbowt_tpu_torch.ops import cuda_phi

    prof = run.profile
    recs = prof.kernels(*NAMES)
    if len(recs) != prof.batches:
        return None
    tx = run.tx
    route = cuda_phi.walk_route(tx, by_hi=True)
    breakpoints = np.asarray(run.idx.pred_pos, dtype=np.int64) if route == "phi_rows" else None
    entry = tx.arrays[route].element_size() if route in ("kval", "phi1") else 8
    per_slot = {}
    for slot, res in zip(run.slots, run.results):
        if slot not in per_slot:
            per_slot[slot] = bounds.walk_bound(route, res["lo"].shape[0], res["flat"], res["offs"],
                                               res["hi"], breakpoints, entry)["bound_us"]
    bound_us = sum(per_slot[slot] for slot in run.slots)
    device_us = sum(e - s for _, s, e in recs)
    return 100.0 * bound_us / device_us
