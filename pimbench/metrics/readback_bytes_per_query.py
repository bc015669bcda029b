"""readback_bytes_per_query (bytes/query): the mean bytes a query the
program computed copies off the card, masks and materialized values (the
``bytes`` of the program's ``db.readback`` spans in the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "db.readback"]
    if not sel:
        return None
    return (sum(s.attrs["bytes"] for s in sel)
            / len({s.request for s in sel}))
