"""eager_window_ms (ms): the mean time of a degraded window's run on the
EAGER engine, its retries exhausted or the breaker open (the program's
``dispatch.eager`` spans that start in the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.spans() if s.name == "dispatch.eager"
           and run.t_start <= s.start < run.t_end]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len(sel)
