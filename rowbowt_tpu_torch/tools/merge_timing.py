"""Timing probe: chunked insertion-merge construction vs whole-text SA-IS
at chr scale (the bench 'chr' panel shape).

    python -m rowbowt_tpu_torch.tools.merge_timing [ref_len] [n_haps] [--no-sa]

The copy of tools/merge_timing.py, imports renamed."""

import resource
import sys
import time

import numpy as np

from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
from rowbowt_tpu_torch.construct.merge import merge_construct


def main():
    ref_len = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000_000
    n_haps = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    with_sa = "--no-sa" not in sys.argv
    rng = np.random.default_rng(4321)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    var_pos = np.sort(rng.choice(ref_len, size=ref_len // 333, replace=False))
    var_alt = rng.choice(acgt, size=var_pos.shape[0])
    w = 10
    sep = np.full(w, SEP_BYTE, dtype=np.uint8)
    parts = [np.concatenate([ref, sep])]
    for h in range(n_haps):
        hap = ref.copy()
        carry = rng.random(var_pos.shape[0]) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        tail = sep if h < n_haps - 1 else np.concatenate(
            [sep, np.array([TERM_BYTE], dtype=np.uint8)])
        parts.append(np.concatenate([hap, tail]))
    n = sum(len(p) for p in parts)
    print(f"n={n:,} docs={len(parts)} with_sa={with_sa}", file=sys.stderr)
    t0 = time.perf_counter()
    bwt, sa, alpha = merge_construct(parts, with_sa=with_sa, verbose=True)
    dt = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"merge_construct: {dt:.1f}s, peak RSS {rss:.2f} GB "
          f"({n/dt/1e6:.1f} M sym/s)")


if __name__ == "__main__":
    main()
