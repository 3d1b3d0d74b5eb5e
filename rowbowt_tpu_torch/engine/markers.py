"""Batched marker queries over final ranges.

The counterpart of rowbowt_tpu/engine/markers.py:markers_for_ranges, the
rb_align -m path.  find_ranges_w_markers (the per-window marker walk of
rb_markers) is ROADMAP M4.
"""

from __future__ import annotations

from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R


def markers_for_ranges(tx: TorchIndex, lo, hi, max_k: int = 64):
    """Single-probe markers for final ranges (rb_align.cpp:138: one
    markers_at(range) call, CSR row order): (vals [B, max_k], count [B])."""
    return R.markers_at_range(tx, lo, hi, max_k)
