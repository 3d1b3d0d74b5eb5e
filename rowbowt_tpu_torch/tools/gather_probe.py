"""Gather probes P1-P3 on one torch device, and their rate.

    python -m rowbowt_tpu_torch.tools.gather_probe [--device cuda|cpu]

The counterpart of tools/vmem_gather_probe.py, with the same inputs (from
np.random.default_rng(0) in the same draw order), shapes and checks:

  A rows+tala   P1 gather_rows:  out[b] = tab[idx[b] >> 7, idx[b] & 127]
  B tala axis0  P2 gather_cols:  out[k, l] = tab[idx[k, l], l]
  C chained A   P3 gather_chain: STEPS dependent gathers i <- tab[i]

Each line reads `<name>: ok=<equal to numpy> <us> us/step, <ns> ns/elem`,
the best of 10 timed calls after one checked call.  On a CUDA device the
probes are the CUDA kernels of ops/cuda_gather.py, timed with CUDA events;
`--device cpu` runs their plain torch twins, timed on the host clock.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rowbowt_tpu_torch.ops import cuda_gather

B = 32768
T = 1 << 20  # 4 MB of int32
STEPS = 100
REPS = 10


def make_inputs():
    """(tab [T], idx [B], idxB [B//128, 128]) int32, drawn as the JAX tool draws them."""
    rng = np.random.default_rng(0)
    tab_np = rng.integers(0, T, size=T, dtype=np.int32)
    idx_np = rng.integers(0, T, size=B, dtype=np.int32)
    idxB_np = rng.integers(0, T // 128, size=(B // 128, 128)).astype(np.int32)
    return tab_np, idx_np, idxB_np


def expectations(tab_np, idx_np, idxB_np, steps: int = STEPS):
    """The numpy results of A, B and C."""
    expect_c = idx_np.copy()
    for _ in range(steps):
        expect_c = tab_np[expect_c]
    return (tab_np[idx_np],
            tab_np.reshape(T // 128, 128)[idxB_np, np.arange(128)[None, :]],
            expect_c)


def best_seconds(fn, device: torch.device, reps: int = REPS) -> float:
    """Least time of `reps` calls of fn: CUDA events on a CUDA device, the
    host clock on the CPU."""
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def probes(device: torch.device):
    """[(name, fn, expect, steps)] for A, B and C on `device`; each fn takes no
    argument and returns the probe's output tensor."""
    tab_np, idx_np, idxB_np = make_inputs()
    tab = torch.from_numpy(tab_np.reshape(T // 128, 128)).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    idxB = torch.from_numpy(idxB_np).to(device)
    cuda_gather.check_indices(idx, T)
    cuda_gather.check_indices(idxB, T // 128)
    ea, eb, ec = expectations(tab_np, idx_np, idxB_np)
    return [("A rows+tala", lambda: cuda_gather.gather_rows(tab, idx), ea, 1),
            ("B tala axis0", lambda: cuda_gather.gather_cols(tab, idxB), eb, 1),
            ("C chained A", lambda: cuda_gather.gather_chain(tab, idx, STEPS), ec, STEPS)]


def bench(name, fn, expect, device, steps: int = 1):
    """One checked call, then the best of REPS; prints and returns the line."""
    r = fn()
    ok = np.array_equal(r.cpu().numpy(), expect)
    per = best_seconds(fn, device) / steps
    line = f"{name}: ok={ok} {per*1e6:.1f} us/step, {per/r.numel()*1e9:.2f} ns/elem"
    print(line, flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; an error when CUDA is absent)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() is False")
    return [bench(name, fn, expect, device, steps)
            for name, fn, expect, steps in probes(device)]


if __name__ == "__main__":
    main()
