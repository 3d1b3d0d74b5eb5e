"""Read batching: encode + right-align reads into fixed [B, L] code matrices.

Backward search consumes chars right-to-left, so reads are RIGHT-aligned
(left-padded with -1): at loop step j every lane processes column L-1-j, which
is its own char j-from-the-end.  Lanes finish when j reaches their length.
"""

from __future__ import annotations

import numpy as np

from rowbowt_tpu_torch.index import RbtIndex


def encode_batch(idx: RbtIndex, reads: list[bytes | str], pad_to: int | None = None):
    """Returns (codes [B, L] int32 right-aligned, lengths [B] int32)."""
    tab = idx.alpha.encode_table()
    bs = [r.encode() if isinstance(r, str) else r for r in reads]
    lens = np.array([len(b) for b in bs], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (lens.max() if len(bs) else 0))
    out = np.full((len(bs), L), -1, dtype=np.int32)
    for i, b in enumerate(bs):
        arr = np.frombuffer(b, dtype=np.uint8)[:L]
        out[i, L - len(arr):] = tab[arr.astype(np.int64)]
    return out, np.minimum(lens, L)
