"""h2d_ms: milliseconds a batch in the traced run's span window of the "h2d"
spans, the codes and lengths copied to the card (torch.from_numpy(..).to,
pageable), each closed by a synchronize (host clock)."""


def read(run):
    return run.spans.ms_a_batch("h2d", run.span_batches)
