"""compile_ms (ms): each admission window's compile, link and lowering
(the program's ``db.compile`` spans, with ``verify_compile`` and the
tape's recording on a tape-cache miss), shared evenly over the window's
queries, mean over the queries (cut to the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "db.compile"]
    n = sum(s.attrs["n_queries"] for s in sel)
    return 1e3 * sum(s.seconds for s in sel) / n if n else None
