"""Batched backward search (count path).

The counterpart of rowbowt_tpu/engine/count.py, itself the batched form of
RowBowt::find_range (rowbowt.hpp:121-131): B reads start from the ftab
(search_ftab, rowbowt.hpp:745-758) or the full range, then advance one LF
step per query char with done-masks.  On a CUDA device the whole search,
ftab start included, is one launch of a hand-written kernel (ops/cuda_lf.py):
K1 when the index has fused-block rows, else the tables kernel over its
occ1, dense or run-space tables; on the CPU it is the plain torch path
(ops/cuda_lf.lf_start, then lf_loop_plain).
On a big (n >= 2^31) index the lanes are int64 (`idx_dtype` is F's dtype)
and there is no ftab: big artifacts carry none.
"""

from __future__ import annotations

import torch

from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf


def find_ranges(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True):
    """qcodes [B, L] right-aligned int32 (pad = -1), lengths [B], on tx.device.

    Returns (lo [B], hi [B]) of tx.idx_dtype with the reference's (1, 0)
    empty encoding.  The lengths go to the kernel as int32 on every layout.
    """
    return cuda_lf.find_ranges(tx, qcodes, lengths.to(torch.int32), use_ftab)


def counts_from_ranges(lo, hi):
    """count = hi-lo+1, 0 when empty — matches rb_align's unsigned-wrap print
    semantics (rb_align.cpp:122) where the (1,0) empty range yields 0."""
    return torch.where(hi >= lo, hi - lo + 1, torch.zeros_like(lo))
