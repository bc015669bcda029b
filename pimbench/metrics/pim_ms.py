"""pim_ms (ms): the mean ``QueryResult.pim_s`` (the program's host span of
its device stage, a linked launch's time shared over its queries) of the
queries the program computed, cache hits and coalesced duplicates left
out."""


def read(run):
    vals = [r.result.pim_s for r in run.dispatched()]
    return 1e3 * sum(vals) / len(vals) if vals else None
