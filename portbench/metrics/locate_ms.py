"""locate_ms: milliseconds a batch in the traced run's span window of the
"locate" spans, locate and doc resolve (cli/rbt_align.locate_hits:
engine/locate.locate_ragged with its copy of the positions down, then
hit_docs: their copy up, engine/locate.resolve_docs and the copy down), each
closed by a synchronize (host clock)."""


def read(run):
    return run.spans.ms_a_batch("locate", run.span_batches)
