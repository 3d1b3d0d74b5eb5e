"""d2h_ms: milliseconds a batch in the traced run's span window of the "d2h"
spans, lo and hi copied back to the host (.cpu()), each closed by a
synchronize (host clock)."""


def read(run):
    return run.spans.ms_a_batch("d2h", run.span_batches)
