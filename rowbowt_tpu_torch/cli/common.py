"""Shared CLI plumbing: index loading, shape-bucketed batching, timers.

The reference binaries stream one read at a time (rb_align.cpp:176-178) or
through a thread pool (rb_markers.cpp:318-535); the port gathers reads into
fixed-shape batches (padded lengths bucketed to powers of two) and keeps
OUTPUT IN INPUT ORDER, identical to rb_align's ordering and strictly
stronger than rb_markers' nondeterministic thread interleaving.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np

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


class StageClock:
    """Host-clock seconds per named stage of a query loop.  On a CUDA device
    a stage ends with a synchronize, so its device work counts in it and not
    in the stage that next waits for the card; the loop waits for the card
    once a batch anyway, when it copies the results back."""

    def __init__(self, device):
        self.seconds: dict[str, float] = {}
        self._cuda = device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda:
                import torch

                torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t

    def iterate(self, name: str, it):
        """Yield from `it`, each next() counted in stage `name`."""
        it = iter(it)
        while True:
            with self(name):
                try:
                    x = next(it)
                except StopIteration:
                    return
            yield x

    def line(self) -> str:
        """The `stages: {...}` stderr line (JSON, seconds)."""
        return "stages: " + json.dumps(self.seconds)


def load_index(prefix: str, sa=False, ma=False, dl=False, ft=False):
    """Flag-gated index load (LoadRbwtFlag role, rowbowt_io.hpp:146-189): the
    SA samples, markers, document list and ftab only when asked for.

    A two-level big (n >= 2^31) BigIndex directory, written by either
    package, is detected and loaded as the port's BigIndex (memory-mapped;
    its flag gating happens in device_index)."""
    from rowbowt_tpu_torch.bigindex import BigIndex

    if BigIndex.is_big_dir(prefix):
        eprint(f"loading (big two-level artifact): {prefix}")
        if ft:
            eprint("note: big artifacts carry no ftab; running without it")
        return BigIndex.load(prefix)
    eprint(f"loading: {prefix}")
    return RbtIndex.load(prefix, with_sa=sa, with_ma=ma, with_dl=dl, with_ft=ft)


def device_index(idx, device, sa=False, ma=False):
    """The index's tensors on `device` (the 64B-row layout).  An RbtIndex was
    gated at load; a BigIndex puts its locate and marker tables on the
    device only for the flags that ask for them; the seconds and device
    bytes of its two-level rows' repack into bit planes go to stderr as a
    `bit planes: {...}` line (JSON).  Where the load built the
    kernels' bucket directories and run records (TorchIndex.with_run_tables,
    with_pred_directory), their bytes and seconds, and each directory's
    (shift, iters) and bytes, go to stderr as a `run tables: {...}` line
    (JSON)."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.device import TorchIndex

    if isinstance(idx, BigIndex):
        tx = TorchIndex.from_big(idx, device, with_locate=sa and idx.has_locate,
                                 with_markers=ma and idx.has_markers)
    else:
        tx = TorchIndex.from_index(idx, device)
    if tx.planes_bytes:
        eprint("bit planes: " + json.dumps(dict(bytes=tx.planes_bytes, seconds=tx.planes_s)))
    if tx.rs_bs or tx.pred_bs:
        eprint("run tables: " + json.dumps(dict(bytes=tx.run_tables_bytes,
                                                seconds=tx.run_tables_s,
                                                records="run_rec" in tx.arrays,
                                                directories=tx.directories)))
    return tx


def iter_query_batches(idx, fastq: str, batch_size: int,
                       normalize: bool = False, with_rc: bool = False,
                       use_native: bool = True, max_read_len: int = 1024):
    """Yield (names, qcodes, lengths) per batch.  normalize maps the reads
    through rb_markers' N-normalization (alphabet.normalize_read); with_rc
    interleaves each read's forward and reverse complement as adjacent lanes
    (2 * batch_size lanes).  Lane counts are padded to the fixed lane count
    (pad lanes have length 0).  Uses the native C++ reader/encoder
    (native/fastq_reader.cpp) when it built, else the Python reader."""
    from rowbowt_tpu_torch.io.fastq import NativeBatchReader

    if use_native and NativeBatchReader.available():
        reader = NativeBatchReader(fastq, idx.alpha.encode_table(), batch_size,
                                   with_rc=with_rc, normalize=normalize,
                                   max_read_len=max_read_len)
        try:
            yield from reader
        finally:
            reader.close()
        return

    from rowbowt_tpu_torch.alphabet import normalize_read, revcomp

    for recs in batched(read_seqs(fastq), batch_size):
        names = [name for name, _, _ in recs]
        seqs = []
        for _, seq, _ in recs:
            s = normalize_read(seq) if normalize else np.frombuffer(seq, np.uint8)
            seqs.append(s)
            if with_rc:
                seqs.append(revcomp(s))
        full = batch_size * (2 if with_rc else 1)
        seqs += [np.empty(0, np.uint8)] * (full - len(seqs))
        L = pow2_at_least(max((len(s) for s in seqs), default=1))
        qc, lens = encode_batch(idx, [s.tobytes() for s in seqs], pad_to=L)
        yield names, qc, lens
