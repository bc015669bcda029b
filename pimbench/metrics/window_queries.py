"""window_queries (queries/window): requests admitted over admission
windows dispatched (``QueryService.stats()["batcher"]``)."""


def read(run):
    b = run.service["batcher"]
    return b["items"] / b["windows"] if b["windows"] else None
