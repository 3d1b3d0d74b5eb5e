"""Shared CLI plumbing: index loading, shape-bucketed batching, timers.

The reference binaries stream one read at a time (rb_align.cpp:176-178); the
port gathers reads into fixed-shape batches (padded lengths bucketed to
powers of two) and keeps OUTPUT IN INPUT ORDER, identical to rb_align's
ordering.
"""

from __future__ import annotations

import json
import os
import sys
import time

from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.index import RbtIndex
from rowbowt_tpu_torch.io.fastq import batched, read_seqs


def eprint(*a):
    print(*a, file=sys.stderr)


def pow2_at_least(x: int, floor: int = 32) -> int:
    p = floor
    while p < x:
        p <<= 1
    return p


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        return time.perf_counter() - self.t0


def _is_big_dir(path: str) -> bool:
    """True when `path` is a two-level (n >= 2^31) BigIndex directory."""
    meta = os.path.join(path, "meta.json")
    if not os.path.isdir(path) or not os.path.exists(meta):
        return False
    try:
        with open(meta) as f:
            return json.load(f).get("format") == "rowbowt-tpu-bigindex"
    except (json.JSONDecodeError, OSError):
        return False


def load_index(prefix: str, sa=False, ma=False, dl=False):
    """Flag-gated index load (LoadRbwtFlag role, rowbowt_io.hpp:146-189): the
    SA samples, markers and document list only when asked for, and never the
    ftab, as the reference rb_align loads it."""
    if _is_big_dir(prefix):
        raise NotImplementedError(
            f"{prefix} is a two-level big (n >= 2^31) artifact: not yet ported "
            "in rowbowt_tpu_torch (ROADMAP M6)")
    eprint(f"loading: {prefix}")
    return RbtIndex.load(prefix, with_sa=sa, with_ma=ma, with_dl=dl, with_ft=False)


def device_index(idx: RbtIndex, device):
    """The index's tensors on `device` (the 64B-row layout)."""
    from rowbowt_tpu_torch.engine.device import TorchIndex

    return TorchIndex.from_index(idx, device)


def iter_query_batches(idx: RbtIndex, fastq: str, batch_size: int,
                       use_native: bool = True):
    """Yield (names, qcodes, lengths) per batch, the reads as they are (no
    normalization, no reverse complement).  Lane counts are padded to the
    fixed batch size (pad lanes have length 0).  Uses the native C++
    reader/encoder (native/fastq_reader.cpp) when it built, else the Python
    reader."""
    from rowbowt_tpu_torch.io.fastq import NativeBatchReader

    if use_native and NativeBatchReader.available():
        reader = NativeBatchReader(fastq, idx.alpha.encode_table(), batch_size)
        try:
            yield from reader
        finally:
            reader.close()
        return

    for recs in batched(read_seqs(fastq), batch_size):
        names = [name for name, _, _ in recs]
        seqs = [seq for _, seq, _ in recs]
        seqs += [b""] * (batch_size - len(seqs))
        L = pow2_at_least(max((len(s) for s in seqs), default=1))
        qc, lens = encode_batch(idx, seqs, pad_to=L)
        yield names, qc, lens
