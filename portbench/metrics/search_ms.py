"""search_ms: milliseconds a batch in the traced run's span window of the
"search" spans, the count search (engine/count.find_ranges; for -s
engine/locate.find_ranges_w_toehold), each closed by a synchronize (host
clock)."""


def read(run):
    return run.spans.ms_a_batch("search", run.span_batches)
