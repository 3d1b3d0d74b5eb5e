"""launches_per_batch: the kernel records a batch of the profiled stretch
(device trace), the port's hand-written kernels and torch's alike.  The
records of the port's own kernels are held to its launch counters over the
same batches (trace.port_launches); where they differ the profile dropped
records, and the metric is left out."""

import sys

from portbench.trace import PORT_KERNELS


def read(run):
    prof = run.profile
    kernels = prof.kernels()
    port = sum(1 for name, _, _ in kernels if any(k in name for k in PORT_KERNELS))
    print(f"launches: {len(kernels)} kernel records over {prof.batches} batches, "
          f"{port} of the port's kernels, its counters {prof.launches}", file=sys.stderr)
    if not kernels or port != prof.launches:
        return None
    return len(kernels) / prof.batches
