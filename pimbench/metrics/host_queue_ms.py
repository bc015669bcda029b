"""host_queue_ms (ms): the mean wait of an end-to-end query's host stage
for a free host worker, from its hand-off on the dispatch thread to its
start (the program's ``host.queue`` spans, cut to the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "host.queue"]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len({s.request for s in sel})
