"""queue_wait_ms (ms): the mean wait of a query the program computed, from
its admission to the batcher to the start of its window on the dispatch
thread (the program's ``svc.queue`` spans, cut to the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "svc.queue"]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len({s.request for s in sel})
