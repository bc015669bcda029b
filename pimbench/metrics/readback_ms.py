"""readback_ms (ms): the mean time a query the program computed spends
copying its masks or materialized values off the card (the program's
``db.readback`` spans, cut to the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "db.readback"]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len({s.request for s in sel})
